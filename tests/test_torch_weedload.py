"""The port's open-loop SLO harness (`seaweedfs_tpu_torch/scripts/weedload.py`)
against the reference's `scripts/weedload.py`: the stripe-math
classification on one EC base, the zipf key sequence from one seed, the
/metrics and /debug/traces scrapers on one served payload, a generator
worker's output, and the flags (all equal, tolerance 0); the smoke on
in-process CPU servers with every content assertion of the reference's
smoke case, and the `--front s3` smoke with the reference S3-front smoke
case's; the flags the S3 front refuses and a missing card, refused before
any server starts; and twins of the reference's three server cases that the harness
stands on (`tests/test_slo_harness.py`: the rebuild admission gate, the
503 of an unservable degraded read, the lookup leader's retries), each run
on a cluster of each package with the reference case's own assertions and
equal results."""

import hashlib
import http.server
import importlib.util
import json
import os
import random
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from seaweedfs_tpu_torch.ec import read_planner, suspicion
from seaweedfs_tpu_torch.ec import stripe as port_stripe
from seaweedfs_tpu_torch.ops.rs_codec import Encoder
from seaweedfs_tpu_torch.scripts import weedload as port_load
from seaweedfs_tpu_torch.storage import idx, types

from test_torch_cluster import blob, stop_all, twin
from test_torch_cuda import hold_s3_smoke_report, hold_smoke_report, run_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference(name: str):
    spec = importlib.util.spec_from_file_location(
        f"ref_{name}", os.path.join(ROOT, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref_load = _reference("weedload")
PACKAGES = {"ref": ref_load, "port": port_load}


@pytest.fixture(autouse=True)
def _fresh_port_state():
    yield
    read_planner.CACHE.clear()
    suspicion.GLOBAL.reset()


# -- classification and keys ---------------------------------------------------


def _ec_base(root, n: int, seed: int, large: int, small: int) -> str:
    """A volume of `n` needle records of 0.5-40 KB (one tombstone among
    them) as .dat + .idx, EC-encoded with the port's CPU encoder: .ecx,
    .eci and 14 shards."""
    rng = np.random.default_rng(seed)
    base = os.path.join(str(root), "1")
    chunks, entries, off = [b"\x03" + bytes(7)], [], 8
    for key in range(1, n + 1):
        size = int(rng.integers(500, 40_000))
        rec = rng.integers(0, 256, types.actual_size(size), np.uint8).tobytes()
        chunks.append(rec)
        entries.append((key, types.offset_to_bytes(off), size))
        off += len(rec)
    entries.append((n + 1, 0, types.TOMBSTONE_FILE_SIZE))
    with open(base + ".dat", "wb") as f:
        f.write(b"".join(chunks))
    idx.write_entries(entries, base + ".idx")
    port_stripe.write_ec_files(base, large_block_size=large, small_block_size=small,
                               encoder=Encoder(10, 4, device="cpu"))
    port_stripe.write_sorted_file_from_idx(base)
    return base


@pytest.mark.parametrize("dropped", [{0, 1}, {0, 1, 2, 3}, {5}, {9}])
@pytest.mark.parametrize("blocks", [(1 << 20, 16 << 10), (64 << 10, 4 << 10)])
def test_classify_needles_equals_the_reference(tmp_path, dropped, blocks):
    base = _ec_base(tmp_path, 120, 4, *blocks)
    got = {name: mod.classify_needles(base, dropped) for name, mod in PACKAGES.items()}
    assert got["port"] == got["ref"]
    degraded, everyone = got["port"]
    assert everyone == set(range(1, 121))  # the tombstone is left out
    assert degraded and degraded < everyone


@pytest.mark.parametrize("n,s", [(1, 1.1), (160, 1.1), (8000, 1.1), (500, 0.8)])
@pytest.mark.parametrize("seed", [7, 8])
def test_zipf_keys_equal_the_reference(n, s, seed):
    keys = [f"{i},{i:x}" for i in range(n)]
    out = {}
    for name, mod in PACKAGES.items():
        cdf = mod.zipf_cdf(n, s)
        rng = random.Random(seed)
        out[name] = (cdf, [mod.pick_zipf(rng, keys, cdf) for _ in range(2000)])
    assert out["port"] == out["ref"]


# -- scrapers and the generator worker ---------------------------------------------


METRICS = """# HELP weedtpu_degraded_read_seconds x
# TYPE weedtpu_degraded_read_seconds histogram
weedtpu_degraded_read_seconds_bucket{le="0.1"} 3.0
weedtpu_degraded_read_seconds_count 7.0
weedtpu_ec_reconstruct_seconds_count 5.0
weedtpu_read_cache_hits_total 11.0
weedtpu_hedge_fired_total{peer="a"} 2.0
weedtpu_hedge_fired_total{peer="b"} 1.0
weedtpu_ec_backend_selected{backend="torch",source="explicit"} 0.0
weedtpu_ec_backend_selected{backend="cuda",source="default"} 1.0
weedtpu_repair_dispatch_total{missing="2"} 4.0
"""
TRACES = {"traces": [
    {"trace_id": "a1", "kind": "http.read", "class": "degraded", "start": 1.0,
     "duration_s": 0.5, "root": {"name": "http.read", "spans": []}},
    {"trace_id": "a1", "kind": "rpc.server", "class": "degraded", "start": 1.1,
     "duration_s": 0.2, "root": {"name": "rpc.server", "spans": []}},
]}


@pytest.fixture
def served():
    """A loopback HTTP server answering /metrics and /debug/traces."""
    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            body = (METRICS.encode() if self.path.startswith("/metrics")
                    else json.dumps(TRACES).encode())
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv.server_address[1]
    srv.shutdown()
    srv.server_close()


def test_scrapers_equal_the_reference(served):
    """Two scrapes of one node: the counters the reference sums, and the
    trace records it keeps, are the port's; the port also sums them per
    server and records the backend selected at each scrape."""
    counters, traces = {}, {}
    for name, mod in PACKAGES.items():
        c, t = mod.CounterScraper(), mod.TraceScraper()
        for _ in range(2):
            c.scrape(served)
            t.scrape(served)
        c.scrape(1)  # a dead node scrapes as nothing
        counters[name] = {k: v for k, v in c.totals.items() if k in ref_load.SCRAPED_COUNTERS}
        traces[name] = t.traces
    assert counters["port"] == counters["ref"]
    assert counters["port"]["weedtpu_hedge_fired_total"] == 6.0
    assert traces["port"] == traces["ref"] and len(traces["port"]) == 2
    port = port_load.CounterScraper()
    port.scrape(served, "n0")
    port.scrape(served, "n0")
    port.scrape(served)
    assert port.by_server["n0"]["weedtpu_ec_reconstruct_seconds_count"] == 10.0
    assert port.totals["weedtpu_ec_reconstruct_seconds_count"] == 15.0
    assert port.backends == {"n0": [["cuda"], ["cuda"]]}


def test_generator_worker_output_equals_the_reference(tmp_path):
    """A worker with nothing to offer (no phases) runs to its end in both
    packages and writes the same output: nothing issued, no cells, nothing
    lost."""
    spec = {"master": "127.0.0.1:1", "client_timeout": 1.0, "rps": 10.0, "zipf": 1.1,
            "concurrency": 2, "seed": 7, "phases": [], "start_at": 0.0,
            "fids": {"1,1": {"klass": "healthy", "sha256": hashlib.sha256(b"x").hexdigest()}}}
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(spec))
    out = {}
    for name, mod in PACKAGES.items():
        dest = tmp_path / f"{name}.json"
        assert mod.main(["--gen-worker", str(path), "--worker-out", str(dest),
                         "--worker-index", "1"]) == 0
        out[name] = json.loads(dest.read_text())
    assert out["port"] == out["ref"] == {"issued": 0, "cells": {}, "lost": []}


def test_flags_parse_as_the_reference():
    argv = ["--seconds", "30", "--rps", "1000", "--procs", "4", "--objects", "8000",
            "--zipf", "1.2", "--concurrency", "32", "--client-timeout", "3",
            "--put-fraction", "0.1", "--dropped-shards", "0", "2", "--ec-large-block", "65536",
            "--ec-small-block", "4096", "--chaos", "--rebuild-storm", "--corrupt",
            "--wedge-seconds", "5", "--slo-factor", "4", "--require-slo", "--seed", "3"]
    ref, port = vars(ref_load.parse_args(argv)), vars(port_load.parse_args(argv))
    assert port.pop("device") == "cuda"
    assert port == ref
    assert port_load.parse_args(["--device", "cpu"]).device == "cpu"


# -- the smoke, and what is refused ----------------------------------------------


def test_smoke_holds_the_reference_smoke_assertions(tmp_path):
    """`--smoke --device cpu`: three in-process volume servers on the port's
    plain version. Every content assertion of the reference's smoke case;
    its 30 s budget and `trace_overhead.ok` are timings, held by the card
    test with no other process on the host."""
    report, took = run_smoke(tmp_path, "cpu")
    hold_smoke_report(report, took, timed=False)
    assert report["workload"]["servers"] == "in-process"
    assert report["server_backends"]["n0"] == [["torch"]]
    assert set(report["stage_seconds"]) == {"cluster_form", "preload_ec", "encode_spread",
                                            "preload_healthy", "warmup", "load", "verify"}


@pytest.fixture
def no_server(monkeypatch):
    """Fails the test if a master or a volume server is built."""
    from seaweedfs_tpu_torch.cluster import master, volume_server

    def refuse(*a, **k):
        raise AssertionError("a server started")

    monkeypatch.setattr(master.MasterServer, "__init__", refuse)
    monkeypatch.setattr(volume_server.VolumeServer, "__init__", refuse)


def test_s3_front_smoke_holds_the_reference_s3_smoke_assertions(tmp_path):
    """`--smoke --front s3 --device cpu`: signed V4 requests through the
    port's filer and S3 gateway into bucket `load`, whose EC'd volume lies
    in the bucket's collection (`load_<vid>` on disk). Every assertion of
    the reference's S3-front smoke case but its 40 s wall budget, which is
    timing-bound under parallel test workers: the card test holds it."""
    report, took = run_smoke(tmp_path, "cpu", front="s3")
    hold_s3_smoke_report(report, took, timed=False)


@pytest.mark.parametrize("argv", [["--front", "s3", "--procs", "2"],
                                  ["--front", "s3", "--corrupt"],
                                  ["--front", "s3", "--rebuild-storm"],
                                  ["--front", "s3", "--put-fraction", "0.1"]])
def test_s3_front_refuses_what_the_reference_refuses_before_any_server(no_server, argv):
    with pytest.raises(AssertionError, match="requires"):
        port_load.main([*argv, "--device", "cpu"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("argv", [[], ["--smoke"], ["--chaos", "--procs", "4"],
                                  ["--smoke", "--front", "s3"]])
def test_without_a_card_weedload_raises_before_any_server(no_server, argv):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_load.main(argv)


def test_default_reports_never_land_under_artifacts():
    src = open(port_load.__file__, encoding="utf-8").read()
    assert "artifacts" not in src.replace("never under artifacts/", "")
    args = port_load.parse_args([])
    assert args.out is None and args.trace_out is None  # resolved to the temp dir in main


# -- the server cases the harness stands on (test_slo_harness.py) ----------------


VID = 9


def _build_ec_volume(pkg, dirpath: str, size: int, seed: int = 3) -> dict:
    base = os.path.join(dirpath, str(VID))
    rng = np.random.default_rng(seed)
    with open(base + ".dat", "wb") as f:
        f.write(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
    with open(base + ".idx", "wb"):
        pass
    pkg.stripe.write_ec_files(base, large_block_size=16384, small_block_size=4096,
                              encoder=pkg.encoder())
    pkg.stripe.write_sorted_file_from_idx(base)
    golden = {}
    for s in range(14):
        with open(pkg.stripe.shard_file_name(base, s), "rb") as f:
            golden[s] = f.read()
    os.unlink(base + ".dat")
    return golden


def _admission_gate(pkg, root, mp):
    mp.setenv("WEEDTPU_REBUILD_MAX_INFLIGHT", "1")
    mp.setenv("WEEDTPU_REBUILD_YIELD_MS", "50")
    master = pkg.MasterServer(port=0, reap_interval=3600)
    master.start()
    d = root / "gated"
    d.mkdir()
    vs = pkg.VolumeServer([str(d)], master.address, heartbeat_interval=0.3,
                          encoder=pkg.encoder())
    vs.start()
    try:
        golden = _build_ec_volume(pkg, str(d), size=3_000_000)
        with pkg.rpc.RpcClient(vs.grpc_address) as c:
            c.call(pkg.VOLUME_SERVICE, "VolumeEcShardsMount", {"volume_id": VID})
        waits0 = pkg.stats.RebuildAdmissionWaits.value
        results: dict[int, bytes] = {}

        def pull(i: int) -> None:
            with pkg.rpc.RpcClient(vs.grpc_address) as c:
                frames = c.stream(
                    pkg.VOLUME_SERVICE, "VolumeEcShardSlabRead",
                    {"volume_id": VID, "shard_id": i, "offset": 0, "size": len(golden[i]),
                     "chunk_size": 64 * 1024},
                    timeout=60,
                )
                results[i] = b"".join(pkg.rpc.crc_unframe(f) for f in frames)

        threads = [threading.Thread(target=pull, args=(i,)) for i in (1, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert results[1] == golden[1] and results[2] == golden[2]
        waited = pkg.stats.RebuildAdmissionWaits.value - waits0
        assert waited >= 1, "second slab stream should have waited for the admission token"
        return {i: hashlib.sha256(b).hexdigest() for i, b in results.items()}
    finally:
        stop_all([vs, master])


def test_rebuild_admission_gate_counts_waits(tmp_path, monkeypatch):
    twin(_admission_gate, tmp_path, monkeypatch, mp=monkeypatch)


def _unservable_read_is_503(pkg, root):
    master = pkg.MasterServer(port=0, reap_interval=3600)
    master.start()
    d = root / "srv0"
    d.mkdir()
    vs = pkg.VolumeServer([str(d)], master.address, heartbeat_interval=0.3,
                          encoder=pkg.encoder())
    vs.start()
    client = pkg.MasterClient(master.address)
    try:
        fids = [client.submit(blob(40 + i, 12_000)).fid for i in range(8)]
        vid = int(fids[0].split(",", 1)[0])
        with pkg.rpc.RpcClient(vs.grpc_address) as c:
            c.call(pkg.VOLUME_SERVICE, "VolumeMarkReadonly", {"volume_id": vid})
            c.call(pkg.VOLUME_SERVICE, "VolumeEcShardsGenerate",
                   {"volume_id": vid, "large_block_size": 16384, "small_block_size": 4096},
                   timeout=120)
            c.call(pkg.VOLUME_SERVICE, "VolumeEcShardsMount", {"volume_id": vid})
            c.call(pkg.VOLUME_SERVICE, "VolumeDelete", {"volume_id": vid})
            c.call(pkg.VOLUME_SERVICE, "VolumeEcShardsDelete",
                   {"volume_id": vid, "shard_ids": [0, 1, 2, 3, 4]})
        errs0 = pkg.stats.DegradedReadErrors.labels("EcNoViableHolders").value
        answers = []
        for i, fid in enumerate(fids):
            try:
                with urllib.request.urlopen(f"http://{vs.url}/{fid}", timeout=30) as r:
                    answers.append((i, 200, r.read() == blob(40 + i, 12_000)))
            except urllib.error.HTTPError as e:
                assert e.code == 503, f"expected 503, got {e.code}"
                assert e.headers.get("Retry-After") is not None
                body = json.loads(e.read().decode())
                assert body["class"] in ("EcNoViableHolders", "EcDegradedReadTimeout")
                assert "attempted" in body and "suspected" in body
                answers.append((i, 503, body["class"]))
        assert any(code == 503 for _, code, _ in answers), "no needle hit the lost shards"
        assert pkg.stats.DegradedReadErrors.labels("EcNoViableHolders").value > errs0
        return answers
    finally:
        client.close()
        stop_all([vs, master])


def test_degraded_read_maps_to_503_with_retry_after(tmp_path, monkeypatch):
    twin(_unservable_read_is_503, tmp_path, monkeypatch)


def _lookup_retries(pkg, root, mp):
    master = pkg.MasterServer(port=0, reap_interval=3600)
    master.start()
    d = root / "srv0"
    d.mkdir()
    vs = pkg.VolumeServer([str(d)], master.address, heartbeat_interval=0.3,
                          encoder=pkg.encoder())
    vs.start()
    try:
        master.topology.ec_locations[77] = {0: {"127.0.0.1:1"}}
        calls = {"n": 0}
        real_query = vs._master_query

        def flaky(method, req, timeout=5.0):
            if method == "LookupEcVolume":
                calls["n"] += 1
                if calls["n"] <= 2:
                    raise RuntimeError("transient master hiccup")
            return real_query(method, req, timeout)

        mp.setattr(vs, "_master_query", flaky)
        mp.setenv("WEEDTPU_LOOKUP_RETRIES", "2")
        locs = vs._lookup_shard_locations(77)
        assert calls["n"] == 3, "leader should have retried twice then succeeded"
        assert isinstance(locs, dict)
        retried = calls["n"]

        vs._invalidate_shard_locations(77)
        calls["n"] = 0

        def always_down(method, req, timeout=5.0):
            if method == "LookupEcVolume":
                calls["n"] += 1
                raise RuntimeError("master down")
            return real_query(method, req, timeout)

        mp.setattr(vs, "_master_query", always_down)
        mp.setenv("WEEDTPU_LOOKUP_RETRIES", "0")
        with pytest.raises(RuntimeError, match="master down"):
            vs._lookup_shard_locations(77)
        assert calls["n"] == 1, "retries=0 must fail fast"
        return {"retried": retried, "fail_fast": calls["n"], "locs": locs}
    finally:
        stop_all([vs, master])


def test_lookup_retry_with_jitter_rides_out_transient_failures(tmp_path, monkeypatch):
    twin(_lookup_retries, tmp_path, monkeypatch, mp=monkeypatch)


@pytest.mark.slow
def test_storm_under_chaos_rebuilds_and_loses_nothing(tmp_path):
    """Subprocess servers on the CPU with the scheduler on (--chaos): the
    storm's two remote rebuilds each rebuild the dropped shards 0 and 1
    and no needle is lost. The reference's storm deleted a target's every
    shard when the scheduler had already rebuilt them (ROADMAP Queue 3)."""
    out = tmp_path / "SLO.json"
    saved = dict(os.environ)
    try:
        rc = port_load.main(["--seconds", "10", "--rps", "40", "--objects", "80", "--procs",
                             "2", "--chaos", "--rebuild-storm", "--device", "cpu",
                             "--out", str(out), "--trace-out", str(tmp_path / "TA.json")])
    finally:
        os.environ.clear()
        os.environ.update(saved)
    report = json.loads(out.read_text())
    assert rc == 0 and report["lost"] == [], report["lost"][:5]
    rebuilds = report["chaos"]["rebuilds"]
    assert len(rebuilds) == 2 and all(b.get("rebuilt") == [0, 1] for b in rebuilds), rebuilds
    assert all(g == ["torch"] for k, gens in report["server_backends"].items()
               if k.startswith("n") for g in gens)
