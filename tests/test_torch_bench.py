"""The port's measurement harness (`seaweedfs_tpu_torch/bench.py`) against
the reference's top-level `bench.py`, on the CPU: the deterministic smokes
(`xor --smoke`, `rebuild_batch --smoke`) run as child processes, as the
reference's tests run theirs (`test_xorsched.py`, `test_rebuild_fusion.py`),
the port's with `--device cpu`, and their JSON held to the reference's on
every deterministic field; the full `xor` run's `--out` file read back by
`pick_cpu_backend`; and that without a card and without `--device cpu`
every mode raises before it measures anything."""

import json
import os
import subprocess
import sys

import pytest
import torch

from seaweedfs_tpu_torch import bench
from seaweedfs_tpu_torch.ops import rs_codec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def last_json(stdout: bytes) -> dict:
    for line in reversed(stdout.decode(errors="replace").splitlines()):
        if line.strip().startswith("{"):
            return json.loads(line)
    raise AssertionError("no JSON line on the child's stdout")


def ref_smoke(mode: str) -> dict:
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "bench.py"), "--smoke"],
        env=dict(os.environ, BENCH_MODE=mode, JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, timeout=300)
    return last_json(proc.stdout)


def port_smoke(mode: str, *args: str) -> tuple[int, dict]:
    proc = subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch.bench", "--device", "cpu", "--smoke", *args],
        env=dict(os.environ, BENCH_MODE=mode), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, timeout=300)
    return proc.returncode, last_json(proc.stdout)


def test_xor_smoke_equals_the_reference_smoke():
    """`xor --smoke`: all four matrix forms byte-verified on both executors
    (and through the int8 kernel's plain version here), no timestamp, and
    the reference's own fields equal: the verification flags, the schedule
    counts, the cache and the host. Two runs of the port print the same
    line."""
    ref = ref_smoke("xor")
    rc, port = port_smoke("xor")
    assert rc == 0 and port["ok"] is True and port["match"] is True
    assert all(port["verify"].values()) and all(port["device_verify"].values())
    assert "when" not in port, "smoke output must be timestamp-free"
    assert port["cache"]["size"] == 4  # one schedule per matrix form
    for key in ("host", "native_level", "tile_kb", "verify", "match", "ok"):
        assert port[key] == ref[key], key
    assert port["cache"] == ref["cache"]
    assert port["compile"] == {k: v for k, v in ref["compile"].items() if not k.endswith("_ms")}
    assert (port["device"], port["card"], port["launches"]) == ("cpu", None, {})
    assert port_smoke("xor")[1] == port


def test_rebuild_batch_smoke_equals_the_reference_smoke():
    """`rebuild_batch --smoke`: one fused dispatch for the heterogeneous
    storm, one per signature unfused, one for the homogeneous control
    either way, every rebuilt shard equal to its golden; every field of
    the reference's JSON equal but the device and the card."""
    ref = ref_smoke("rebuild_batch")
    rc, port = port_smoke("rebuild_batch")
    assert rc == 0 and port["ok"] is True
    assert "when" not in port, "smoke output must be timestamp-free"
    assert port["fused"]["dispatch_groups"] == 1
    assert port["unfused"]["dispatch_groups"] == port["storm"]["signatures"] > 1
    assert port["homogeneous_fused"]["dispatch_groups"] == 1
    assert port["homogeneous_unfused"]["dispatch_groups"] == 1
    assert port["verify"]["fused_bytes_match"] is True
    assert port["verify"]["unfused_bytes_match"] is True
    assert port["rebuilt_bytes"] > 0
    assert (port.pop("device"), port.pop("card"), port.pop("launches")) == ("cpu", None, {})
    assert port == ref


def test_xor_full_run_writes_the_evidence_pick_cpu_backend_reads(tmp_path):
    """The full `xor` run writes its report only where `--out` names, as a
    BENCH round whose `xor` section `load_cpu_bench_evidence` unwraps; the
    factory's CPU decision then names that file, whichever codec wins."""
    out = tmp_path / "art" / "BENCH_r23.json"
    proc = subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch.bench", "--device", "cpu", "--out",
         str(out), "--round", "23"],
        env=dict(os.environ, BENCH_MODE="xor"), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, timeout=300)
    rep = last_json(proc.stdout)
    assert proc.returncode == 0 and rep["ok"] and rep["written"] == str(out), rep
    assert "when" in rep and rep["encode"]["native_gbps"] > 0 and rep["encode"]["xorsched_gbps"] > 0
    assert sorted(os.listdir(tmp_path)) == ["art"] and os.listdir(out.parent) == [out.name]
    with open(out, encoding="utf-8") as f:
        wrapper = json.load(f)
    assert (wrapper["n"], wrapper["rc"]) == (23, 0)
    assert wrapper["parsed"]["xor"] == {k: v for k, v in rep.items() if k != "written"}
    ev = rs_codec.load_cpu_bench_evidence(str(out.parent))
    assert ev["_file"] == out.name and ev["xor"]["match"] is True
    backend, decision = rs_codec.pick_cpu_backend(str(out.parent))
    assert decision["evidence_file"] == out.name
    assert decision["evidence_round"] == 23
    xs, nat = rep["encode"]["xorsched_gbps"], rep["encode"]["native_gbps"]
    assert backend == ("xorsched" if xs > nat else "native"), decision


def test_every_mode_raises_without_a_card_unless_the_cpu_is_named(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in bench.MODES:
        if mode == "probe":
            assert bench.run_mode("probe")["ok"] is False
            continue
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench.run_mode(mode)
    for fn in (bench._measure_rebuild_remote, bench._measure_rebuild_trace,
               bench._measure_ingest, bench._measure_convert):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(str(tmp_path))
    assert os.listdir(tmp_path) == []  # nothing measured, nothing written
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])


def test_a_child_without_a_card_exits_nonzero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the child would measure it")
    proc = subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch.bench", "--smoke"],
        env=dict(os.environ, BENCH_MODE="xor"), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, timeout=120)
    assert proc.returncode != 0
    assert not [x for x in proc.stdout.decode().splitlines() if x.startswith("{")]
    assert b"no CUDA device" in proc.stderr
