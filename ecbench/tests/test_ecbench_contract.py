"""The benchmark's shape: what its files import, the names and keys of
BENCHMARK.json, files found by name, and the result line."""

import ast
import json
import os
import re
import sys

import pytest

from ecbench import run, workload

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
BENCH = workload.benchmark_file(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "seaweedfs_tpu"}


def _sources():
    for base, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def _top_imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = set(_top_imports(path)) & FORBIDDEN
        assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    got = set(_top_imports(os.path.join(HERE, "reference.py")))
    assert got <= {"__future__", "typing", "numpy", "torch"}, got


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "seaweedfs_tpu_torch_probe", object())
    assert "seaweedfs_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "seaweedfs_tpu.probe", object())
    assert "seaweedfs_tpu" in run.forbidden_modules()


def test_top_level_keys_and_command():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["ecbench"]
    assert BENCH["command"] == ["python3", "ecbench/run.py"]
    assert len(json.dumps(BENCH)) < 64 * 1024
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells: 2 + 14 x 24 runs of rs + 60 s, 2 x 90 s a cell, 1200 s spare
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert c["file"] == f"ecbench/configs/{c['name']}.json"
        names.add(c["name"])
    cells = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["name"] == f"{w['config']}.{w['traffic']}" and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
        cells.add(w["name"])
    assert len(cells) == len(BENCH["workloads"])
    metric_names = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["name"] not in metric_names
        metric_names.add(m["name"])
        assert set(m.get("workloads", [])) <= cells
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in run.metrics_for(BENCH, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = run.metrics_for(BENCH, w["name"], True)
        assert layer and all(m["moves"] in e2e for m in layer)


def test_each_per_layer_metric_moves_an_end_to_end_metric_its_cells_report():
    for m in BENCH["per_layer"]:
        for cell in m["workloads"]:
            assert m["moves"] in {e["name"] for e in run.metrics_for(BENCH, cell, False)}


def test_files_are_found_by_name():
    for w in BENCH["workloads"]:
        cfg = workload.config_file(w["config"])
        assert cfg["name"] == w["config"]
        workload.plan(cfg, workload.traffic_file(w["traffic"]))
    for c in BENCH["configs"]:
        assert workload.config_file(c["name"])["source"] == c["source"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(run.reader(m["name"]))


def test_readers_return_nothing_where_there_is_nothing_to_read():
    rec = {"op": "encode", "setup_s": 1.0, "trace": None, "peak": None,
           "window": {"seconds": 2.0, "in_bytes": 4e9, "latency_s": [], "enqueue_s": []}}
    assert run.reader("encode_GBps")(rec) == 2.0
    for name in ("rebuild_GBps", "call_p95_ms.encode", "enqueue_ms.encode", "h2d_GBps.encode",
                 "d2h_GBps.encode", "kernel_roofline.encode", "device_idle.encode"):
        assert run.reader(name)(rec) is None, name


def test_roofline_reader_counts_each_byte_once():
    trace = {"window_s": 1.0, "busy_s": 0.8, "kernel_s": 0.002, "h2d_s": 0.5, "d2h_s": 0.2,
             "min_bytes": 3.35e9, "in_bytes": 1e10, "out_bytes": 1e9}
    rec = {"op": "rebuild", "trace": trace, "peak": {"hbm_bytes_per_s": 3.35e12}}
    assert run.reader("kernel_roofline.rebuild")(rec) == pytest.approx(50.0)
    assert run.reader("device_idle.rebuild")(rec) == pytest.approx(20.0)
    assert run.reader("h2d_GBps.rebuild")(rec) == pytest.approx(20.0)


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    r = run.run_cell("rs10p4-30g.rebuild1", 2**31 + 3, 1.0, trace, device="cpu", max_width=2048)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0, r["compared"]
    want = {m["name"] for m in run.metrics_for(BENCH, "rs10p4-30g.rebuild1", trace)}
    got = set(r["metrics"])
    assert got <= want and (got == want if not trace else got)
    assert all(set(v) == {"value", "unit"} for v in r["metrics"].values())


def test_main_exits_without_a_card_and_prints_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "rs10p4-30g.encode", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""
