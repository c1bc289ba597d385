"""The harness's distributed-rebuild modes (`_measure_rebuild_remote`,
`_measure_rebuild_trace` in `seaweedfs_tpu_torch/bench.py`) against the
reference bench's, in one process on the CPU: the same seeded volume at
the reference smokes' sizes (`test_remote_rebuild.py`, `test_trace_repair.
py`) through in-process servers of each package (the port's on the plain
version, the reference's on its default encoder), each side held to the
reference smoke's assertions, then to each other on the byte counts and
the rebuilt shards' sha256. Both harnesses set the modelled RTT knob
`WEEDTPU_BENCH_RPC_DELAY_MS` for their run; each must leave it as it
found it."""

import glob
import hashlib
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench as ref_bench  # noqa: E402  (the reference's top-level harness)

from seaweedfs_tpu_torch import bench  # noqa: E402

DELAY = "WEEDTPU_BENCH_RPC_DELAY_MS"


def sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture
def delay_knob(monkeypatch):
    """The knob as an operator left it: each harness must restore it."""
    monkeypatch.setenv(DELAY, "")
    yield
    assert os.environ.get(DELAY) == ""


def test_rebuild_remote_smoke_equals_the_reference(tmp_path, delay_knob):
    ref = ref_bench._measure_rebuild_remote(str(tmp_path / "ref"), **bench.SMOKE_REMOTE)
    assert os.environ.get(DELAY) == ""
    port = bench._measure_rebuild_remote(str(tmp_path / "port"), **bench.SMOKE_REMOTE,
                                         device="cpu")
    assert os.environ.get(DELAY) == ""
    for out in (ref, port):  # the reference smoke's assertions, on each side
        assert out["ok"], out
        assert out["match"] is True
        assert out["rebuilt_shard_ids"] == [10, 11, 12, 13]
        assert out["remote_survivors"] == list(range(10))
        for key in ("remote_rebuild_gbps", "local_rebuild_gbps", "overlap_efficiency",
                    "pipelined_vs_serial_fetch_then_decode"):
            assert isinstance(out.get(key), float), f"missing metric {key}: {out}"
    for key in ("dat_mib", "missing", "n_batches", "rpc_delay_ms", "rebuilt_shard_ids",
                "remote_survivors", "match", "ok", "protocol"):
        assert port[key] == ref[key], key
    assert (port["device"], port["card"], port["backend"]) == ("cpu", None, "torch")
    rebuilt = {os.path.basename(p).split(".ec")[1]: sha256(p)
               for p in glob.glob(str(tmp_path / "ref" / "target" / "7.ec1*"))}
    assert rebuilt == {str(s): h for s, h in port["rebuilt_sha256"].items()}
    assert port["launches"] == {}


def test_rebuild_trace_smoke_equals_the_reference(tmp_path, delay_knob):
    ref = ref_bench._measure_rebuild_trace(str(tmp_path / "ref"), **bench.SMOKE_REMOTE)
    assert os.environ.get(DELAY) == ""
    port = bench._measure_rebuild_trace(str(tmp_path / "port"), **bench.SMOKE_REMOTE,
                                        device="cpu")
    assert os.environ.get(DELAY) == ""
    for out in (ref, port):  # the reference smoke's assertions, on each side
        assert out["ok"], out
        assert out["trace"]["match"] and out["slab"]["match"]
        assert out["trace"]["mode_reported"] == "trace"
        assert out["wire_ratio"] is not None and out["wire_ratio"] <= 0.6, out
        # survivors on two holders: the trace wire is 2 x repaired bytes
        # against 10 full slabs
        assert out["trace"]["wire_bytes"] == 2 * out["slab"]["wire_bytes"] // 10
    for key in ("dat_mib", "lost_shard", "shard_mib", "slab_baseline_bytes", "rpc_delay_ms",
                "wire_ratio", "ok", "protocol"):
        assert port[key] == ref[key], key
    for mode in ("trace", "slab"):
        for key in ("wire_bytes", "counter_bytes_2_runs", "mode_reported", "match",
                    "rebuilt_shard_ids"):
            assert port[mode][key] == ref[mode][key], (mode, key)
    assert port["trace"]["fallback"] == ref["trace"]["fallback"]
    # the holder groups name ephemeral ports: compare the shard sets
    assert sorted(g.split("=")[1] for g in port["trace"]["groups"]) == sorted(
        g.split("=")[1] for g in ref["trace"]["groups"])
    golden = sha256(str(tmp_path / "ref" / "target" / "11.ec03"))
    assert port["trace"]["rebuilt_sha256"] == port["slab"]["rebuilt_sha256"] == golden
