"""The port's trace ring (`seaweedfs_tpu_torch/obs/trace.py`) against the
reference's (`seaweedfs_tpu/obs/trace.py`): the unit cases of
tests/test_obs.py run on both packages, then the two are held to each
other — the same retained set and snapshot under a fixed seed for the same
offered traces, the same recorded tree, `render_trace` text and
`attribute_stages` — and the span catalog is pinned by a scan of every
call site in the port (the analog of the reference's obs-drift lint)."""

import ast
import logging
import os
import threading
import time

import numpy as np
import pytest

from seaweedfs_tpu.obs import trace as ref_trace
from seaweedfs_tpu.utils import config as ref_config
from seaweedfs_tpu.utils import glog as ref_glog
from seaweedfs_tpu_torch.obs import trace
from seaweedfs_tpu_torch.utils import config, glog

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {
    "port": (trace, glog, "seaweedfs_tpu_torch"),
    "ref": (ref_trace, ref_glog, "seaweedfs_tpu"),
}
KNOBS = ("WEEDTPU_TRACE", "WEEDTPU_TRACE_SAMPLE", "WEEDTPU_TRACE_RING",
         "WEEDTPU_TRACE_SLOWEST", "WEEDTPU_TRACE_SEED", "WEEDTPU_WIRE")
TIMING = ("t_ms", "dur_ms", "duration_s", "start")


@pytest.fixture(params=sorted(PACKAGES))
def tr(request, monkeypatch):
    """One package's trace module, tracing on, its global ring empty."""
    monkeypatch.setenv("WEEDTPU_TRACE", "on")
    mod = PACKAGES[request.param][0]
    mod.RING.clear()
    yield mod
    mod.RING.clear()


def _mk(tmod, dur, kind="http.read", klass="healthy", error=None, tid=None):
    """A completed trace with a pinned duration, wall start and offset (the
    ring orders and evicts on `dur`, never on wall time)."""
    st = tmod._TraceState(tid or tmod.new_trace_id(), kind, klass)
    st.wall0 = 1_700_000_000.0
    root = tmod.Span(kind, None, st)
    root.t0 = st.t0
    root.dur = dur
    return tmod._Completed(root, st, error)


def _untimed(node):
    """A snapshot with its clock readings dropped, for comparing packages."""
    if isinstance(node, list):
        return [_untimed(x) for x in node]
    if isinstance(node, dict):
        return {k: _untimed(v) for k, v in node.items() if k not in TIMING}
    return node


# -- the unit cases of tests/test_obs.py, on both packages -----------------------


def test_disabled_tracing_is_total_noop(tr, monkeypatch):
    monkeypatch.setenv("WEEDTPU_TRACE", "off")
    assert not tr.enabled()
    ctx = tr.start("http.read")
    assert ctx is tr._NULL  # shared singleton, no per-call allocation
    with ctx as root:
        assert root is None
        with tr.span("ec.recover", shard=1) as sp:
            assert sp is None  # no ambient trace -> span is a no-op
        assert tr.current_trace_id() is None
        tr.annotate(x=1)  # must not raise outside a trace
        tr.set_class("degraded")
    assert tr.continue_trace("rpc.server", "abc123") is tr._NULL
    assert tr.RING.stats()["offered"] == 0


def test_span_tree_records_nesting_attrs_and_errors(tr):
    ring = tr.TraceRing(capacity=8, slowest_n=1, sample=1.0, seed=1)
    with tr.start("http.read", klass="degraded", ring=ring) as root:
        tid = root.trace.trace_id
        with tr.span("ec.recover", shard=3):
            with tr.span("ec.gather", shard=3) as g:
                g.annotate(have=9)
            with pytest.raises(ValueError):
                with tr.span("ec.decode", backend="numpy"):
                    raise ValueError("boom")
    [t] = ring.snapshot()
    assert t["trace_id"] == tid and t["class"] == "degraded"
    assert t["error"] is None  # the root exited clean: only the SPAN errored
    (recover,) = t["root"]["spans"]
    assert recover["name"] == "ec.recover" and recover["attrs"] == {"shard": 3}
    gather, decode = recover["spans"]
    assert gather["attrs"] == {"shard": 3, "have": 9}
    assert decode["error"] == "ValueError"
    assert t["duration_s"] >= recover["dur_ms"] / 1e3 >= 0


def test_root_error_always_retained(tr):
    ring = tr.TraceRing(capacity=8, slowest_n=1, sample=0.0, seed=1)
    with pytest.raises(IOError):
        with tr.start("http.read", ring=ring):
            raise IOError("disk gone")
    errs = [t for t in ring.snapshot() if t["error"]]
    assert len(errs) == 1 and "disk gone" in errs[0]["error"]


def test_continue_trace_only_roots_with_propagated_id(tr):
    ring = tr.TraceRing(capacity=8, slowest_n=1, sample=1.0, seed=1)
    assert tr.continue_trace("rpc.server", None, ring=ring) is tr._NULL
    assert tr.continue_trace("rpc.server", "<script>", ring=ring) is tr._NULL
    with tr.continue_trace("rpc.server", "AbC123", ring=ring) as root:
        assert root.trace.trace_id == "abc123"  # sanitized lowercase
    assert ring.snapshot()[0]["trace_id"] == "abc123"


@pytest.mark.parametrize("tid", ["deadbeef01", "DEAD-BEEF", None, 7, "", "-leading",
                                 "zz not hex start" * 8, "x" * 80, "inj\nected", "a b",
                                 "f" * 64, "f" * 65])
def test_valid_id_rejects_wire_junk(tid):
    assert trace.valid_id(tid) == ref_trace.valid_id(tid)
    if tid in ("deadbeef01", "DEAD-BEEF"):
        assert trace.valid_id(tid) == tid.lower()
    elif tid != "f" * 64:
        assert trace.valid_id(tid) is None


def test_ensure_nests_under_ambient_else_roots(tr):
    ring = tr.TraceRing(capacity=8, slowest_n=1, sample=1.0, seed=1)
    with tr.start("rebuild.run", klass="maint", ring=ring):
        pass
    assert ring.snapshot()[0]["kind"] == "rebuild.run"
    ring.clear()
    with tr.start("shell.command", klass="shell", ring=ring) as root:
        tid = root.trace.trace_id
        with tr.ensure("rebuild.run"):
            pass
    [t] = ring.snapshot()
    assert t["trace_id"] == tid
    assert [s["name"] for s in t["root"]["spans"]] == ["rebuild.run"]


def test_attach_bridges_worker_threads(tr):
    ring = tr.TraceRing(capacity=8, slowest_n=1, sample=1.0, seed=1)
    seen = []
    with tr.start("http.read", ring=ring) as root:
        parent = tr.current()

        def worker():
            # a bare thread has no ambient span; attach adopts the parent
            seen.append(tr.current())
            with tr.attach(parent), tr.span("ec.fetch", shard=2):
                seen.append(tr.current_trace_id())

        t = threading.Thread(target=worker)
        t.start()
        t.join(10)
    assert seen == [None, root.trace.trace_id]
    [got] = ring.snapshot()
    assert [s["name"] for s in got["root"]["spans"]] == ["ec.fetch"]


def test_ring_keeps_errors_and_slowest_drops_the_rest_at_sample_zero(tr):
    ring = tr.TraceRing(capacity=16, slowest_n=2, sample=0.0, seed=7)
    for i in range(50):
        ring.offer(_mk(tr, dur=0.001 * (50 - i), tid=f"aa{i:04x}"))
    ring.offer(_mk(tr, dur=0.0005, error="IOError: x", tid="ee01"))
    snap = ring.snapshot()
    assert len(snap) == 3
    assert snap[0]["duration_s"] >= snap[1]["duration_s"]
    assert {t["trace_id"] for t in snap} == {"aa0000", "aa0001", "ee01"}
    st = ring.stats()
    assert st["offered"] == 51 and st["kept"] == 3
    assert st["sampled"] == 0 and st["errors"] == 1


def test_ring_slowest_is_per_kind_class_key(tr):
    ring = tr.TraceRing(capacity=4, slowest_n=1, sample=0.0, seed=7)
    ring.offer(_mk(tr, 0.9, klass="healthy", tid="aa01"))
    ring.offer(_mk(tr, 0.1, klass="degraded", tid="aa02"))
    ring.offer(_mk(tr, 0.2, kind="http.write", klass="put", tid="aa03"))
    assert {t["trace_id"] for t in ring.snapshot()} == {"aa01", "aa02", "aa03"}


def test_ring_sampled_fifo_is_bounded(tr):
    ring = tr.TraceRing(capacity=10, slowest_n=1, sample=1.0, seed=7)
    for i in range(200):
        ring.offer(_mk(tr, dur=0.001, tid=f"bb{i:04x}"))
    assert ring.stats()["sampled"] == 10  # FIFO capped
    assert len(ring.snapshot(limit=1000)) <= 10 + 1


def test_sampling_is_deterministic_under_seed(tr):
    def kept_ids(seed):
        ring = tr.TraceRing(capacity=64, slowest_n=1, sample=0.5, seed=seed)
        for i in range(64):
            ring.offer(_mk(tr, dur=0.001, tid=f"cc{i:04x}"))
        return [t["trace_id"] for t in ring.snapshot(limit=100)]

    assert kept_ids(42) == kept_ids(42)
    assert kept_ids(42) != kept_ids(43)  # 2^-64 flake odds, effectively zero


def test_snapshot_filters_and_debug_payload(tr):
    ring = tr.TraceRing(capacity=32, slowest_n=1, sample=1.0, seed=1)
    ring.offer(_mk(tr, 0.500, klass="degraded", tid="dd01"))
    ring.offer(_mk(tr, 0.010, klass="healthy", tid="dd02"))
    ring.offer(_mk(tr, 0.020, kind="http.write", klass="put", tid="dd03"))
    assert {t["trace_id"] for t in ring.snapshot(klass="degraded")} == {"dd01"}
    assert {t["trace_id"] for t in ring.snapshot(kind="http.write")} == {"dd03"}
    assert {t["trace_id"] for t in ring.snapshot(min_duration=0.1)} == {"dd01"}
    assert len(ring.snapshot(limit=2)) == 2
    assert [t["trace_id"] for t in ring.snapshot()][0] == "dd01"
    payload = tr.debug_payload("/debug/traces?class=degraded&min_ms=100&limit=5", ring=ring)
    assert payload["enabled"] is True
    assert [t["trace_id"] for t in payload["traces"]] == ["dd01"]
    junk = tr.debug_payload("/debug/traces?min_ms=zap&limit=zap", ring=ring)
    assert len(junk["traces"]) == 3


def _fake_trace():
    return {
        "trace_id": "4f1d0000", "kind": "http.read", "class": "degraded",
        "start": 0.0, "duration_s": 1.0, "error": None,
        "root": {
            "name": "http.read", "t_ms": 0.0, "dur_ms": 1000.0,
            "spans": [
                {
                    "name": "ec.recover", "t_ms": 50.0, "dur_ms": 900.0,
                    "attrs": {"shard": 3},
                    "spans": [
                        {"name": "ec.fetch", "t_ms": 51.0, "dur_ms": 600.0},
                        {"name": "ec.fetch", "t_ms": 51.0, "dur_ms": 600.0},
                    ],
                },
            ],
        },
    }


def test_render_trace_shows_tree_attrs_and_times(tr):
    lines = tr.render_trace(_fake_trace()).splitlines()
    assert lines[0] == "trace=4f1d0000 http.read class=degraded 1000.0ms"
    assert "ec.recover" in lines[1] and "shard=3" in lines[1]
    assert lines[2].startswith("|  +-") and "ec.fetch" in lines[2]
    err = dict(_fake_trace(), error="IOError: x")
    assert "ERROR=IOError: x" in tr.render_trace(err).splitlines()[0]
    assert tr.render_trace(err) == ref_trace.render_trace(err)


def test_attribute_stages_sums_exactly_to_e2e(tr):
    stages = tr.attribute_stages(_fake_trace())
    assert abs(sum(stages.values()) - 1.0) < 1e-9
    assert abs(stages["ec.fetch"] - 0.9) < 1e-9  # parallel fetches scaled to 0.9 s
    assert abs(stages["ec.recover"] - 0.0) < 1e-9
    assert abs(stages["other"] - 0.1) < 1e-9
    t = {
        "duration_s": 0.5,
        "root": {"name": "r", "dur_ms": 500.0, "spans": [
            {"name": "ec.decode", "t_ms": 0.0, "dur_ms": 200.0},
        ]},
    }
    s = tr.attribute_stages(dict(_fake_trace(), **t))
    assert abs(s["ec.decode"] - 0.2) < 1e-9 and abs(s["other"] - 0.3) < 1e-9


def test_attribution_aggregation_consistency(tr):
    """Per-class stage totals over many traces equal the summed end-to-end
    latencies (the reference's `slo.assemble_trace_attribution` gate,
    here on the attribution both packages compute), and the port's split
    equals the reference's exactly."""
    traces = [_fake_trace() for _ in range(10)]
    for i, t in enumerate(traces):
        t["trace_id"] = f"ab{i:02x}"
        t["duration_s"] = 0.1 * (i + 1)
    total: dict = {}
    for t in traces:
        stages = tr.attribute_stages(t)
        assert stages == ref_trace.attribute_stages(t)
        for k, v in stages.items():
            total[k] = total.get(k, 0.0) + v
    assert abs(sum(total.values()) - sum(0.1 * (i + 1) for i in range(10))) < 1e-9
    assert [s["name"] for s in tr.iter_spans(traces[0])] == [
        s["name"] for s in ref_trace.iter_spans(traces[0])]


def test_glog_lines_carry_the_active_trace_id(tr):
    gl, logger_name = next((g, n) for m, g, n in PACKAGES.values() if m is tr)
    records = []

    class _Capture(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logger = logging.getLogger(logger_name)
    h = _Capture(level=logging.INFO)
    logger.addHandler(h)
    try:
        ring = tr.TraceRing(capacity=8, slowest_n=1, sample=1.0, seed=1)
        gl.info("outside any trace")
        with tr.start("http.read", trace_id="feed0001", ring=ring):
            gl.info("inside span %s", gl.kv(vid=7))
    finally:
        logger.removeHandler(h)
    assert records[-2:] == ["outside any trace", "inside span vid=7 trace=feed0001"]


def test_disabled_span_path_is_cheap(tr, monkeypatch):
    """With tracing off, 50k span call sites cost well under a second."""
    monkeypatch.setenv("WEEDTPU_TRACE", "off")
    t0 = time.monotonic()
    for _ in range(50_000):
        with tr.span("ec.decode"):
            pass
    assert time.monotonic() - t0 < 1.0


# -- the port held to the reference ----------------------------------------------


def test_catalog_equals_the_reference():
    assert trace.SPAN_NAMES == ref_trace.SPAN_NAMES
    assert len(trace.SPAN_NAMES) == 28
    assert (trace.MD_KEY, trace.HTTP_HEADER, trace.READ_CLASS_HEADER) == (
        ref_trace.MD_KEY, ref_trace.HTTP_HEADER, ref_trace.READ_CLASS_HEADER)


@pytest.mark.parametrize("sample, slowest, capacity, seed", [
    (0.0, 2, 16, 7), (0.5, 1, 64, 42), (1.0, 3, 10, 1), (0.3, 2, 8, 9), (0.8, 5, 256, 3)])
def test_ring_retention_equals_reference_under_a_seed(sample, slowest, capacity, seed):
    """The same 400 seeded traces (durations, kinds, classes, errors)
    offered to both rings keep the same set, in the same order, with the
    same stats."""
    rng = np.random.default_rng(seed)
    kinds = ("http.read", "http.write", "rpc.server")
    classes = ("healthy", "degraded", "cached", "put")
    offered = [
        (float(rng.exponential(0.01)), kinds[int(rng.integers(3))],
         classes[int(rng.integers(4))],
         "IOError: x" if rng.random() < 0.05 else None, f"{i:08x}")
        for i in range(400)
    ]
    out = []
    for tmod in (trace, ref_trace):
        ring = tmod.TraceRing(capacity=capacity, slowest_n=slowest, sample=sample, seed=seed)
        kept = [ring.offer(_mk(tmod, *o)) for o in offered]
        out.append((kept, ring.stats(), ring.snapshot(limit=10_000),
                    ring.snapshot(klass="degraded", min_duration=0.005, limit=7)))
    assert out[0] == out[1]


def _record(tmod, ring):
    """One traced degraded read's shape, recorded by one package."""
    with tmod.start("http.read", klass="healthy", trace_id="c0ffee01", ring=ring) as root:
        root.annotate(fid="3,01637037d6")
        with tmod.span("cache.miss", shard=5):
            pass
        tmod.set_class("degraded")
        with tmod.span("ec.recover", shard=5, size=1024):
            with tmod.span("ec.gather", shard=5):
                gather = tmod.current()

                def fetch():
                    with tmod.attach(gather), tmod.span("ec.fetch", shard=7):
                        pass

                t = threading.Thread(target=fetch)
                t.start()
                t.join()
            with tmod.span("ec.decode", backend="cuda", width=1024) as sp:
                sp.annotate(launches=1)
        with pytest.raises(KeyError):
            with tmod.span("ec.hedge", shard=7):
                raise KeyError("gone")
    with pytest.raises(OSError):
        with tmod.start("scrub.cycle", klass="scrub", trace_id="c0ffee02", ring=ring):
            with tmod.ensure("scrub.repair"):
                raise OSError("bad shard")


def test_recorded_trees_render_and_attribute_as_the_reference():
    snaps = []
    for tmod in (trace, ref_trace):
        ring = tmod.TraceRing(capacity=8, slowest_n=2, sample=1.0, seed=5)
        _record(tmod, ring)
        snaps.append(ring.snapshot())
    assert _untimed(snaps[0]) == _untimed(snaps[1])
    for t in snaps[0]:
        assert trace.render_trace(t) == ref_trace.render_trace(t)
        assert trace.attribute_stages(t) == ref_trace.attribute_stages(t)
        assert abs(sum(trace.attribute_stages(t).values()) - t["duration_s"]) < 1e-9
    [read] = [t for t in snaps[0] if t["kind"] == "http.read"]
    assert read["class"] == "degraded"
    assert [s["name"] for s in trace.iter_spans(read)] == [
        "http.read", "ec.hedge", "ec.recover", "ec.decode", "ec.gather", "ec.fetch",
        "cache.miss"]


def test_collect_records_the_same_spans_flat():
    """`collect` (the port's test helper) records through ring-root Span
    objects: its flat records are the tree a ring root keeps, children
    before their parent, with the ambient id and class visible inside."""
    with trace.collect(klass="healthy") as spans:
        root = trace.current()
        assert isinstance(root, trace.Span) and trace.valid_id(trace.current_trace_id())
        with trace.span("ec.recover", shard=1):
            trace.set_class("degraded")
            with trace.span("ec.gather", shard=1):
                pass
            with trace.span("ec.decode", width=4096):
                pass
        assert trace.current_class() == "degraded"
        assert spans == []  # filled when the block ends
    assert [s["name"] for s in spans] == ["ec.gather", "ec.decode", "ec.recover"]
    assert spans[1]["width"] == 4096 and spans[2]["shard"] == 1
    assert all(s["seconds"] >= 0 for s in spans)
    assert spans[2]["seconds"] >= spans[0]["seconds"] + spans[1]["seconds"]
    assert trace.current() is None


@pytest.mark.parametrize("name", KNOBS)
@pytest.mark.parametrize("raw", [None, "", "0", "1", "-3", "0.25", "1.5", "9", "off", "ON",
                                 "proto", " Proto ", "json"])
def test_knobs_match_reference(monkeypatch, name, raw):
    if raw is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, raw)

    def value(mod):
        try:
            return mod.env(name)
        except ValueError:
            return "ValueError"

    assert value(config) == value(ref_config)
    assert config.ENV_REGISTRY[name].default == ref_config.ENV_REGISTRY[name].default


# -- the span catalog, pinned by its call sites -----------------------------------

_RECORDERS = ("span", "start", "ensure", "continue_trace", "traced")


def _call_site_names(path: str) -> set[str]:
    """First literal argument of every `<trace module>.span/start/ensure/
    continue_trace/traced(...)` call in one file."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    out = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr in _RECORDERS and isinstance(node.func.value, ast.Name)
                and "trace" in node.func.value.id and node.args
                and isinstance(node.args[0], ast.Constant)):
            continue
        out.add(node.args[0].value)
    return out


def _sites(pkg: str) -> dict[str, set[str]]:
    """{name: files (relative to the package) with a call site}."""
    found: dict[str, set[str]] = {}
    top = os.path.join(ROOT, pkg)
    for dirpath, dirnames, filenames in os.walk(top):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__", "_build")]
        for fn in filenames:
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                for name in _call_site_names(path):
                    found.setdefault(name, set()).add(os.path.relpath(path, top))
    return found


def test_every_call_site_names_a_registered_stage():
    port = _sites("seaweedfs_tpu_torch")
    for name in _call_site_names(os.path.join(ROOT, "chip_smoke.py")):
        port.setdefault(name, set()).add("../chip_smoke.py")
    assert {"ec.recover", "ingest.encode", "scrub.cycle", "rpc.server"} <= set(port)
    undeclared = {n: sorted(f) for n, f in port.items() if n not in trace.SPAN_NAMES}
    assert not undeclared, f"span names outside SPAN_NAMES: {undeclared}"


def test_every_registered_stage_has_a_call_site():
    """Each entry is recorded somewhere in the port, or every reference
    module that records it is one the port has not ported yet (the
    cluster, the shell, `ec/spread.py`): porting such a module without its
    spans fails here."""
    port = _sites("seaweedfs_tpu_torch")
    port_names = set(port) | _call_site_names(os.path.join(ROOT, "chip_smoke.py"))
    ref = _sites("seaweedfs_tpu")
    for name in trace.SPAN_NAMES:
        if name in port_names:
            continue
        assert name in ref, f"{name} is recorded nowhere"
        ported = [f for f in ref[name]
                  if os.path.exists(os.path.join(ROOT, "seaweedfs_tpu_torch", f))]
        assert not ported, f"{name}: the port has {ported} but records it nowhere"
