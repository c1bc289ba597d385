"""The port's master and volume servers against the reference's: each twin
runs one case of `tests/test_cluster.py` on a port cluster (volume servers
on `Encoder(10, 4, device="cpu")`) and on a reference cluster (the numpy
backend), with the same seeded inputs and the needle clock pinned, makes
the reference case's own assertions on both, and requires what comes out
to be equal: shard files, `.ecx`, rebuilt shards, HTTP bodies, and RPC
replies with addresses and timings taken out (tolerance 0).

The harness here (`REF`, `PORT`, `cluster`, `twin`, ...) is shared by
`test_torch_master.py` and `test_torch_volume_server.py`."""

import base64
import contextlib
import hashlib
import http.client
import itertools
import os
import re
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from seaweedfs_tpu import rpc as ref_rpc
from seaweedfs_tpu import stats as ref_stats
from seaweedfs_tpu.cluster import client as ref_client
from seaweedfs_tpu.cluster import master as ref_master
from seaweedfs_tpu.cluster import sequence as ref_sequence
from seaweedfs_tpu.cluster import volume_server as ref_vs
from seaweedfs_tpu.ec import placement as ref_placement
from seaweedfs_tpu.ec import scrub as ref_scrub
from seaweedfs_tpu.ec import stripe as ref_stripe
from seaweedfs_tpu.ops.rs_codec import Encoder as RefEncoder
from seaweedfs_tpu.pb import MASTER_SERVICE as REF_MASTER_SERVICE
from seaweedfs_tpu.pb import VOLUME_SERVICE as REF_VOLUME_SERVICE
from seaweedfs_tpu.storage import needle as ref_needle
from seaweedfs_tpu.storage.file_id import FileId as RefFileId
from seaweedfs_tpu_torch import rpc as port_rpc
from seaweedfs_tpu_torch import stats as port_stats
from seaweedfs_tpu_torch.cluster import client as port_client
from seaweedfs_tpu_torch.cluster import master as port_master
from seaweedfs_tpu_torch.cluster import sequence as port_sequence
from seaweedfs_tpu_torch.cluster import volume_server as port_vs
from seaweedfs_tpu_torch.ec import placement as port_placement
from seaweedfs_tpu_torch.ec import read_planner, suspicion
from seaweedfs_tpu_torch.ec import scrub as port_scrub
from seaweedfs_tpu_torch.ec import stripe as port_stripe
from seaweedfs_tpu_torch.ops.rs_codec import Encoder
from seaweedfs_tpu_torch.pb import MASTER_SERVICE as PORT_MASTER_SERVICE
from seaweedfs_tpu_torch.pb import VOLUME_SERVICE as PORT_VOLUME_SERVICE
from seaweedfs_tpu_torch.storage import needle as port_needle
from seaweedfs_tpu_torch.storage.file_id import FileId as PortFileId

LARGE, SMALL = 4096, 512


def _pkg(name, rpc, stats, client, master, sequence, vs, placement, scrub, stripe, needle,
         file_id, volume_service, master_service, encoder):
    return types.SimpleNamespace(
        name=name, rpc=rpc, stats=stats, client=client, master=master, sequence=sequence,
        vs=vs, placement=placement, scrub=scrub, stripe=stripe, needle=needle, FileId=file_id,
        MasterServer=master.MasterServer, VolumeServer=vs.VolumeServer,
        MasterClient=client.MasterClient, ClusterError=client.ClusterError,
        VOLUME_SERVICE=volume_service, MASTER_SERVICE=master_service, encoder=encoder,
    )


#: the reference cluster on its numpy backend, and the port's on the CPU
REF = _pkg("ref", ref_rpc, ref_stats, ref_client, ref_master, ref_sequence, ref_vs,
           ref_placement, ref_scrub, ref_stripe, ref_needle, RefFileId, REF_VOLUME_SERVICE,
           REF_MASTER_SERVICE, lambda: RefEncoder(10, 4, backend="numpy"))
PORT = _pkg("port", port_rpc, port_stats, port_client, port_master, port_sequence, port_vs,
            port_placement, port_scrub, port_stripe, port_needle, PortFileId,
            PORT_VOLUME_SERVICE, PORT_MASTER_SERVICE, lambda: Encoder(10, 4, device="cpu"))

#: reply keys that carry addresses, ids drawn at random, or timings
VOLATILE = frozenset({
    "url", "public_url", "publicUrl", "grpc_port", "grpc_address", "address", "leader",
    "Leader", "Peers", "fid",
    "auth", "seconds", "elapsed_s", "wall_s", "age_s", "lock_ts_ns", "token", "failed_over",
    "source", "holder", "holders", "peers", "servers", "source_data_node", "last_seen",
})


def strip(obj):
    """A reply with its VOLATILE keys removed and loopback addresses in its
    strings masked, at every depth."""
    if isinstance(obj, dict):
        return {k: strip(v) for k, v in obj.items() if k not in VOLATILE}
    if isinstance(obj, list):
        return [strip(v) for v in obj]
    if isinstance(obj, str):
        return re.sub(r"127\.0\.0\.1:\d+", "<addr>", obj)
    return obj


@pytest.fixture(autouse=True)
def _fresh_port_state():
    yield
    read_planner.CACHE.clear()
    suspicion.GLOBAL.reset()


def pin_clock(monkeypatch, pkg) -> None:
    """The package's needle stamps (`time.time_ns`) from a counter that
    starts at the same value for both packages, so their `.dat` bytes agree."""
    it = itertools.count(1_700_000_000_000_000_000, 1_000)
    shim = types.SimpleNamespace(**{k: getattr(time, k) for k in dir(time) if not k.startswith("_")})
    shim.time_ns = lambda: next(it)
    monkeypatch.setattr(pkg.needle, "time", shim)


def twin(scenario, tmp_path, monkeypatch, ref_tries=1, **kw):
    """Run `scenario(pkg, root, **kw)` on the reference, then on the port,
    each from a freshly pinned needle clock: both results must be equal.
    `ref_tries` > 1 reruns the reference side, on a fresh root, until its
    own checks pass: for a scenario whose reference side has a known race,
    so that the comparison is made with a run that met the case."""
    out = {}
    for pkg in (REF, PORT):
        for attempt in range(ref_tries if pkg is REF else 1):
            pin_clock(monkeypatch, pkg)
            root = tmp_path / f"{pkg.name}{attempt or ''}"
            root.mkdir()
            try:
                out[pkg.name] = scenario(pkg, root, **kw)
                break
            except AssertionError:
                if pkg is PORT or attempt == ref_tries - 1:
                    raise
    assert out["port"] == out["ref"]
    return out["port"]


def wait_for(cond, timeout=10.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timeout waiting for {msg}")


def stop_all(servers) -> None:
    """Stop servers side by side: each HTTP front waits up to its poll
    interval to notice the shutdown."""
    threads = [threading.Thread(target=s.stop) for s in servers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
        assert not t.is_alive()


@contextlib.contextmanager
def cluster(pkg, root, n=3, heartbeat=0.4, rack=lambda i: f"rack{i % 2}", master_kw=None,
            **vs_kw):
    """A master and `n` volume servers of one package, each on its own
    directory under `root`, on the package's CPU encoder."""
    master = pkg.MasterServer(port=0, reap_interval=3600, **(master_kw or {}))
    master.start()
    servers = []
    try:
        for i in range(n):
            d = root / f"srv{i}"
            d.mkdir(parents=True)
            vs = pkg.VolumeServer([str(d)], master.address, heartbeat_interval=heartbeat,
                                  rack=rack(i), encoder=pkg.encoder(), **vs_kw)
            vs.start()
            servers.append(vs)
        client = pkg.MasterClient(master.address)
        try:
            yield master, servers, client
        finally:
            client.close()
    finally:
        stop_all([*servers, master])


def blob(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def put(pkg, client, vid: int, key: int, data: bytes, **kw) -> str:
    """Upload `data` under a fid with a fixed key and cookie (the master's
    cookies are drawn at random), so both packages write the same needle."""
    fid = str(pkg.FileId(vid, key, 0x1000 + key))
    client.upload(fid, data, **kw)
    return fid


def sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def shard_shas(pkg, base: str, shard_ids=range(14)) -> dict:
    return {s: sha(pkg.stripe.shard_file_name(base, s)) for s in shard_ids}


def vid_of(fid: str) -> int:
    return int(fid.split(",")[0])


# -- tests/test_cluster.py twins ---------------------------------------------------------


def _assign_upload_read_delete(pkg, root):
    with cluster(pkg, root) as (master, servers, client):
        a = client.assign()
        assert a.fid and a.url
        payload = blob(1, 10_000)
        client.upload(a.fid, payload, mime="application/x-test")
        got = client.read(a.fid)
        assert got == payload
        deleted = client.delete(a.fid)
        assert deleted
        with pytest.raises(pkg.ClusterError):
            client.read(a.fid)
        return {"read": got, "deleted": deleted}


def test_assign_upload_read_delete(tmp_path, monkeypatch):
    twin(_assign_upload_read_delete, tmp_path, monkeypatch)


def _submit_and_statistics(pkg, root):
    with cluster(pkg, root) as (master, servers, client):
        res = client.submit(b"hello weed tpu")
        got = client.read(res.fid)
        assert got == b"hello weed tpu"
        st = client.statistics()
        assert st["node_count"] == 3
        assert st["volume_count"] >= 1
        return {"read": got, "statistics": strip(st)}


def test_submit_and_statistics(tmp_path, monkeypatch):
    twin(_submit_and_statistics, tmp_path, monkeypatch)


def _volume_list_shows_topology(pkg, root):
    with cluster(pkg, root) as (master, servers, client):
        client.submit(b"x")
        tree = client.volume_list()
        racks = set()
        for dc, rr in tree["data_centers"].items():
            racks.update(rr.keys())
        assert racks == {"rack0", "rack1"}
        return {"data_centers": sorted(tree["data_centers"]), "racks": sorted(racks)}


def test_volume_list_shows_topology(tmp_path, monkeypatch):
    twin(_volume_list_shows_topology, tmp_path, monkeypatch)


def _ec_lifecycle(pkg, root):
    """The encode-on-A, spread-to-B/C, read-through-EC, blob-delete and
    rebuild stacks end to end; -> every byte that came out."""
    VS = pkg.VOLUME_SERVICE
    with cluster(pkg, root) as (master, servers, client):
        vid = vid_of(client.assign().fid)
        payloads = {}
        for key, n in ((1, 20_000), (2, 9_000), (3, 9_000), (4, 9_000), (5, 9_000), (6, 9_000)):
            data = blob(100 + key, n)
            payloads[put(pkg, client, vid, key, data)] = data
        owner = next(s for s in servers if s.store.get_volume(vid) is not None)
        with pkg.rpc.RpcClient(owner.grpc_address) as oc:
            oc.call(VS, "VolumeMarkReadonly", {"volume_id": vid})
            gen = oc.call(VS, "VolumeEcShardsGenerate",
                          {"volume_id": vid, "large_block_size": LARGE, "small_block_size": SMALL})
        base = owner._base_path_for(vid)
        out = {"generate": gen, "shards": shard_shas(pkg, base), "ecx": sha(base + ".ecx"),
               "eci": sha(base + ".eci")}
        others = [s for s in servers if s is not owner]
        plan = {owner: [0, 1, 2, 3, 4], others[0]: [5, 6, 7, 8, 9], others[1]: [10, 11, 12, 13]}
        for target, shard_ids in plan.items():
            if target is not owner:
                with pkg.rpc.RpcClient(target.grpc_address) as tc:
                    tc.call(VS, "VolumeEcShardsCopy", {"volume_id": vid, "shard_ids": shard_ids,
                                                       "source_data_node": owner.grpc_address})
        with pkg.rpc.RpcClient(owner.grpc_address) as oc:
            for s in range(5, 14):
                os.remove(pkg.stripe.shard_file_name(base, s))
            oc.call(VS, "VolumeDelete", {"volume_id": vid})
        for target in plan:
            with pkg.rpc.RpcClient(target.grpc_address) as tc:
                tc.call(VS, "VolumeEcShardsMount", {"volume_id": vid})
        wait_for(lambda: len(master.topology.lookup_ec_shards(vid)) == 14,
                 msg="all 14 shards registered")
        assert master.topology.lookup(vid) == []
        out["copied"] = {s: sha(pkg.stripe.shard_file_name(t._base_path_for(vid), s))
                         for t, ids in plan.items() for s in ids}
        out["reads"] = {}
        for fid, want in payloads.items():
            got = client.read(fid)
            assert got == want, f"EC read mismatch for {fid}"
            out["reads"][fid] = got
        del_fid = sorted(payloads)[1]
        for target in plan:
            with pkg.rpc.RpcClient(target.grpc_address) as tc:
                tc.call(VS, "VolumeEcBlobDelete", {"volume_id": vid, "fid": del_fid})
        with pytest.raises(pkg.ClusterError):
            client.read(del_fid)
        out["ecj"] = sha(base + ".ecj")
        rebuilder = others[0]
        with pkg.rpc.RpcClient(rebuilder.grpc_address) as rc:
            rc.call(VS, "VolumeEcShardsCopy", {"volume_id": vid, "shard_ids": [0, 1, 2, 3, 4],
                                               "source_data_node": owner.grpc_address,
                                               "copy_ecx_file": False})
            resp = rc.call(VS, "VolumeEcShardsRebuild", {"volume_id": vid})
            assert resp["rebuilt_shard_ids"] == [10, 11, 12, 13]
            rc.call(VS, "VolumeEcShardsMount", {"volume_id": vid})
        out["rebuild"] = resp
        base_r, base_c = rebuilder._base_path_for(vid), others[1]._base_path_for(vid)
        out["rebuilt"] = shard_shas(pkg, base_r, (10, 11, 12, 13))
        assert out["rebuilt"] == shard_shas(pkg, base_c, (10, 11, 12, 13))
        return out


def test_ec_lifecycle_spread_degraded_read_rebuild(tmp_path, monkeypatch):
    out = twin(_ec_lifecycle, tmp_path, monkeypatch)
    assert out["rebuilt"] == {s: out["shards"][s] for s in (10, 11, 12, 13)}


def _shard_location_cache_and_invalidation(pkg, root, mp):
    with cluster(pkg, root) as (master, servers, client):
        A, B = servers[0], servers[1]
        calls = {"n": 0}
        real_query = A._master_query

        def counting_query(method, req, timeout=5.0):
            if method == "LookupEcVolume":
                calls["n"] += 1
            return real_query(method, req, timeout)

        mp.setattr(A, "_master_query", counting_query)
        master.topology.ec_locations[77] = {sid: {B.url} for sid in range(14)}
        A.ec_lookup_ttl = 30.0
        for _ in range(10):
            locs = A._lookup_shard_locations(77)
        seen = [calls["n"]]
        assert calls["n"] == 1, "repeated lookups within TTL must hit the cache"
        assert set(locs) == set(range(14))
        with A._shard_locs_lock:
            exp, data = A._shard_locs[77]
            A._shard_locs[77] = (time.monotonic() - 1, data)
        A._lookup_shard_locations(77)
        seen.append(calls["n"])
        assert calls["n"] == 2, "expired entry must refresh"
        reader = A._remote_reader_for(77)
        first = reader(0, 0, 16)
        assert first is None
        assert 77 not in A._shard_locs
        reader(0, 0, 16)
        assert calls["n"] >= 3, "post-failure read must re-lookup"
        return {"calls": seen, "first_read": first, "shards": sorted(locs)}


def test_shard_location_cache_and_invalidation(tmp_path, monkeypatch):
    twin(_shard_location_cache_and_invalidation, tmp_path, monkeypatch, mp=monkeypatch)


def _ec_shard_read_rpc_stream(pkg, root):
    VS = pkg.VOLUME_SERVICE
    with cluster(pkg, root) as (master, servers, client):
        vid = vid_of(client.assign().fid)
        put(pkg, client, vid, 1, blob(7, 30_000))
        owner = next(s for s in servers if s.store.get_volume(vid) is not None)
        with pkg.rpc.RpcClient(owner.grpc_address) as oc:
            oc.call(VS, "VolumeMarkReadonly", {"volume_id": vid})
            oc.call(VS, "VolumeEcShardsGenerate",
                    {"volume_id": vid, "large_block_size": LARGE, "small_block_size": SMALL})
            oc.call(VS, "VolumeEcShardsMount", {"volume_id": vid})
            base = owner._base_path_for(vid)
            with open(pkg.stripe.shard_file_name(base, 3), "rb") as f:
                f.seek(100)
                want = f.read(1000)
            got = b"".join(oc.stream(VS, "VolumeEcShardRead",
                                     {"volume_id": vid, "shard_id": 3, "offset": 100,
                                      "size": 1000}))
            assert got == want
        return {"range": got}


def test_ec_shard_read_rpc_stream(tmp_path, monkeypatch):
    twin(_ec_shard_read_rpc_stream, tmp_path, monkeypatch)


def _replicated_write_lands_on_all_replicas(pkg, root):
    with cluster(pkg, root) as (master, servers, client):
        res = client.submit(b"replicated-payload", replication="001")
        vid = vid_of(res.fid)
        holders = [s for s in servers if s.store.get_volume(vid) is not None]
        assert len(holders) == 2, "001 must create 2 copies"
        bodies = []
        for s in holders:
            with urllib.request.urlopen(f"http://{s.url}/{res.fid}", timeout=10) as r:
                bodies.append(r.read())
        assert bodies == [b"replicated-payload"] * 2
        deleted = client.delete(res.fid)
        assert deleted
        key = pkg.FileId.parse(res.fid).key
        gone = [s.store.get_volume(vid).nm.get(key) is None for s in holders]
        assert all(gone)
        return {"bodies": bodies, "deleted": deleted, "gone": gone}


def test_replicated_write_lands_on_all_replicas(tmp_path, monkeypatch):
    twin(_replicated_write_lands_on_all_replicas, tmp_path, monkeypatch)


def _replication_fanout_is_parallel_and_timeout_bounded(pkg, root, mp):
    with cluster(pkg, root) as (master, servers, client):
        barrier = {"delay": 0.0}
        orig = pkg.vs._Handler.do_POST

        def slow_replica_post(self):
            if "X-Weed-Replicate" in self.headers and barrier["delay"]:
                time.sleep(barrier["delay"])
            orig(self)

        mp.setattr(pkg.vs._Handler, "do_POST", slow_replica_post)
        barrier["delay"] = 0.4
        t0 = time.monotonic()
        res = client.submit(b"parallel-fanout", replication="011")
        elapsed = time.monotonic() - t0
        assert elapsed < 0.75, f"fan-out took {elapsed:.2f}s — replicas ran serially"
        vid = vid_of(res.fid)
        holders = [s for s in servers if s.store.get_volume(vid) is not None]
        assert len(holders) == 3
        bodies = []
        for s in holders:
            with urllib.request.urlopen(f"http://{s.url}/{res.fid}", timeout=10) as r:
                bodies.append(r.read())
        assert bodies == [b"parallel-fanout"] * 3
        for s in servers:
            s.replicate_timeout = 0.5
        barrier["delay"] = 3.0
        a = client.assign(replication="011")
        t0 = time.monotonic()
        with pytest.raises(pkg.ClusterError):
            client.upload(a.fid, b"stalled-replica")
        elapsed = time.monotonic() - t0
        assert elapsed < 2.5, f"dead replica stalled the write {elapsed:.2f}s"
        barrier["delay"] = 0.0
        mp.setattr(pkg.vs._Handler, "do_POST", orig)
        return {"bodies": bodies, "holders": len(holders)}


def test_replication_fanout_is_parallel_and_timeout_bounded(tmp_path, monkeypatch):
    twin(_replication_fanout_is_parallel_and_timeout_bounded, tmp_path, monkeypatch,
         mp=monkeypatch)


def _head_request_returns_no_body(pkg, root):
    with cluster(pkg, root) as (master, servers, client):
        res = client.submit(b"head-test-payload")
        vs = next(s for s in servers if s.store.get_volume(vid_of(res.fid)))
        conn = http.client.HTTPConnection(vs.host, vs.port, timeout=10)
        try:
            conn.request("HEAD", f"/{res.fid}")
            r1 = conn.getresponse()
            head = (r1.status, r1.read(), int(r1.headers["Content-Length"]))
            assert head == (200, b"", len(b"head-test-payload"))
            conn.request("GET", f"/{res.fid}")
            body = conn.getresponse().read()
            assert body == b"head-test-payload"
        finally:
            conn.close()
        return {"head": head, "get": body}


def test_head_request_returns_no_body(tmp_path, monkeypatch):
    twin(_head_request_returns_no_body, tmp_path, monkeypatch)


def _snowflake_monotonic_against_clock(pkg, root, mp):
    """At a pinned clock both sequencers hand out the same ids."""
    it = itertools.count(1_700_000_000_000_000_000, 250_000)
    shim = types.SimpleNamespace(time_ns=lambda: next(it))
    mp.setattr(pkg.sequence, "time", shim)
    sq = pkg.sequence.SnowflakeSequencer(5)
    ids = [sq.next_ids() for _ in range(100)]
    assert len(set(ids)) == 100
    assert ids == sorted(ids)
    sq._last_ms += 10_000
    a, b = sq.next_ids(), sq.next_ids()
    assert b > a >= ((sq._last_ms - sq.EPOCH_MS) << 22)
    with pytest.raises(ValueError):
        sq.next_ids(2)
    mem = pkg.sequence.MemorySequencer(start=5, state_path=str(root / "seq"))
    runs = [mem.next_ids(3), mem.next_ids(1), mem.watermark]
    mem.floor(50_000)
    runs += [mem.next_ids(2), open(root / "seq").read()]
    return {"ids": ids, "after_step": [a, b], "memory": runs}


def test_snowflake_monotonic_against_clock(tmp_path, monkeypatch):
    twin(_snowflake_monotonic_against_clock, tmp_path, monkeypatch, mp=monkeypatch)


def _master_auto_vacuum(pkg, root):
    with cluster(pkg, root, n=1, heartbeat=0.3,
                 master_kw={"garbage_threshold": 0.3, "vacuum_interval": 3600}) as (
            master, (vs,), client):
        vid = vid_of(client.assign().fid)
        fids = [put(pkg, client, vid, k, blob(200 + k, 3000)) for k in range(1, 21)]
        vol = vs.store.get_volume(vid)
        assert vol.garbage_ratio() < 0.05
        for fid in fids[:15]:
            client.delete(fid)
        ratio = vol.garbage_ratio()
        assert ratio > 0.3
        size_before = vol.content_size()
        wait_for(lambda: any(vi.garbage_ratio > 0.3 for n in master.topology.nodes.values()
                             for vi in n.volumes.values()),
                 msg="garbage ratio reaches the master via heartbeat")
        done = master.vacuum_once()
        assert vid in done
        vol2 = vs.store.get_volume(vid)
        assert vol2.content_size() < size_before / 2, "compaction did not shrink .dat"
        assert vol2.garbage_ratio() < 0.05
        reads = [client.read(fid) for fid in fids[15:]]
        assert reads == [blob(200 + k, 3000) for k in range(16, 21)]
        for fid in fids[:3]:
            with pytest.raises(pkg.ClusterError):
                client.read(fid)
        return {"ratio": ratio, "sizes": [size_before, vol2.content_size()], "done": done,
                "dat": sha(vol2.base_path + ".dat"), "reads": reads}


def test_master_auto_vacuum(tmp_path, monkeypatch):
    twin(_master_auto_vacuum, tmp_path, monkeypatch)


def _http_get(url, want=200):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        assert e.code == want, (url, e.code)
        return e.code, e.read()


def _master_http_api(pkg, root):
    import json

    with cluster(pkg, root, n=1, heartbeat=0.3) as (master, (vs,), client):
        base = f"http://{master.host}:{master.http_port}"
        out = {"healthz": _http_get(base + "/cluster/healthz")[0]}
        assign = json.loads(_http_get(base + "/dir/assign?count=2")[1])
        assert assign["fid"] and assign["url"] == vs.url and assign["count"] == 2
        out["assign"] = strip(assign)
        req = urllib.request.Request(f"http://{assign['url']}/{assign['fid']}",
                                     data=b"assigned over http", method="POST")
        with urllib.request.urlopen(req, timeout=10) as r:
            out["post"] = (r.status, r.read())
        vid = assign["fid"].split(",", 1)[0]
        for q in (vid, assign["fid"]):
            lk = json.loads(_http_get(f"{base}/dir/lookup?volumeId={q}")[1])
            assert lk["locations"][0]["url"] == vs.url, lk
        code, body = _http_get(base + "/dir/lookup?volumeId=9999", want=404)
        assert b"not found" in body
        out["lookup_missing"] = (code, body)
        topo = json.loads(_http_get(base + "/dir/status")[1])["Topology"]
        assert topo["data_centers"]
        st = json.loads(_http_get(base + "/cluster/status")[1])
        assert st["IsLeader"] is True and master.address in st["Leader"]
        out["cluster_status"] = strip(st)
        assert b"weedtpu" in _http_get(base + "/metrics")[1]
        out["grow"] = json.loads(_http_get(base + "/vol/grow?count=1&collection=httpgrow")[1])
        assert out["grow"]["grown"] == 1
        wait_for(lambda: any(vi.collection == "httpgrow" for n in master.topology.nodes.values()
                             for vi in n.volumes.values()), msg="the grown volume registered")
        deleted = json.loads(_http_get(base + "/col/delete?collection=httpgrow")[1])
        assert deleted["deleted"] >= 1
        out["nope"] = _http_get(base + "/nope", want=404)
        return out


def test_master_http_api(tmp_path, monkeypatch):
    twin(_master_http_api, tmp_path, monkeypatch)


def _status_ui_pages(pkg, root):
    with cluster(pkg, root, n=1, heartbeat=0.3) as (master, (vs,), client):
        client.submit(b"ui demo data")
        wait_for(lambda: sum(len(n.volumes) for n in master.topology.nodes.values())
                 == len(vs.store.volume_infos()), msg="every volume heartbeated")
        with urllib.request.urlopen(f"http://{master.host}:{master.http_port}/ui",
                                    timeout=10) as r:
            master_page = r.read().decode()
        assert "Master" in master_page and vs.url in master_page and "Topology" in master_page
        with urllib.request.urlopen(f"http://{vs.url}/ui", timeout=10) as r:
            vs_page = r.read().decode()
        assert "Volume Server" in vs_page and "<table>" in vs_page
        assert "volume" in vs_page.lower()
        # the pages' structure: their tags in order (addresses and uptimes aside)
        tags = [p.split(">")[0].split()[0] for p in master_page.split("<")[1:]]
        return {"master_tags": tags,
                "vs_tags": [p.split(">")[0].split()[0] for p in vs_page.split("<")[1:]]}


def test_status_ui_pages(tmp_path, monkeypatch):
    twin(_status_ui_pages, tmp_path, monkeypatch)


def _multipart_form_upload_stores_file_bytes(pkg, root):
    with cluster(pkg, root) as (master, servers, client):
        a = client.assign()
        payload = bytes(range(256)) * 40
        boundary = "------------------------deadbeefcafe"
        body = (f"--{boundary}\r\n"
                'Content-Disposition: form-data; name="file"; filename="blob.bin"\r\n'
                "Content-Type: application/x-payload\r\n\r\n").encode() + payload + \
            f"\r\n--{boundary}--\r\n".encode()
        req = urllib.request.Request(
            f"http://{a.url}/{a.fid}", data=body, method="POST",
            headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
        with urllib.request.urlopen(req, timeout=10) as r:
            status = r.status
        assert status == 201
        got = client.read(a.fid)
        assert got == payload
        b = client.assign()
        client.upload(b.fid, b"raw body bytes")
        raw = client.read(b.fid)
        assert raw == b"raw body bytes"
        return {"status": status, "read": got, "raw": raw}


def test_multipart_form_upload_stores_file_bytes(tmp_path, monkeypatch):
    twin(_multipart_form_upload_stores_file_bytes, tmp_path, monkeypatch)


def _multipart_filename_rides_replica_hop(pkg, root):
    with cluster(pkg, root) as (master, servers, client):
        a = client.assign()
        req = urllib.request.Request(
            f"http://{a.url}/{a.fid}", data=b"replica bytes", method="POST",
            headers={"X-Weed-Replicate": "1",
                     "X-Weed-Filename": base64.b64encode(b"fancy name.bin").decode()})
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.status == 201
        fid = pkg.FileId.parse(a.fid)
        holder = next(s for s in servers if s.store.get_volume(fid.volume_id))
        with pkg.rpc.RpcClient(holder.grpc_address) as c:
            resp = c.call(pkg.VOLUME_SERVICE, "ReadNeedle",
                          {"volume_id": fid.volume_id, "needle_id": fid.key})
        assert base64.b64decode(resp["name_b64"]) == b"fancy name.bin"
        boundary = "----bb"
        body = (f"--{boundary}\r\n"
                f'Content-Disposition: form-data; name="file"; filename="{"x" * 300}"\r\n'
                "\r\n").encode() + b"d" + f"\r\n--{boundary}--\r\n".encode()
        b2 = client.assign()
        req = urllib.request.Request(
            f"http://{b2.url}/{b2.fid}", data=body, method="POST",
            headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 400
        resp = {k: v for k, v in resp.items() if k not in ("cookie", "append_at_ns", "id")}
        return {"read_needle": strip(resp), "oversized": ei.value.code}


def test_multipart_filename_rides_replica_hop(tmp_path, monkeypatch):
    twin(_multipart_filename_rides_replica_hop, tmp_path, monkeypatch)
