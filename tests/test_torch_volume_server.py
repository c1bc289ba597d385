"""The port's volume server against the reference's on its EC RPCs: twins
of the server cases of `tests/test_remote_rebuild.py`,
`test_trace_repair.py`, `test_inline_ec.py`, `test_convert.py`,
`test_scrub.py` and `test_fleet.py`, each run on a port cluster
(`Encoder(10, 4, device="cpu")`) and a reference cluster (numpy backend)
with the same seeded volumes, each making the reference case's own
assertions, and their outputs (shard and rebuilt shard bytes, `.ecx`,
read bodies, RPC replies without addresses and timings) equal. A mixed
cluster, a reference volume server pulling shards and rebuild slabs from
port holders, shows that the wire is the same."""

import base64
import os
import shutil
import threading
import time
import urllib.request
import zlib

import grpc
import pytest

from test_torch_cluster import (
    PORT, REF, blob, cluster, pin_clock, put, sha, shard_shas, stop_all, strip, twin,
    vid_of, wait_for,
)

VID = 9
LARGE, SMALL = 16384, 4096


def build_ec_volume(pkg, dirpath, vid=VID, size=400_000, seed=3, large=LARGE, small=SMALL):
    """A full 14-shard EC volume (with .ecx/.eci) under `dirpath`, made by
    the package's stripe engine on its CPU encoder -> (base, {shard: bytes})."""
    base = os.path.join(str(dirpath), str(vid))
    os.makedirs(str(dirpath), exist_ok=True)
    with open(base + ".dat", "wb") as f:
        f.write(blob(seed, size))
    with open(base + ".idx", "wb"):
        pass
    pkg.stripe.write_ec_files(base, large_block_size=large, small_block_size=small,
                              encoder=pkg.encoder())
    pkg.stripe.write_sorted_file_from_idx(base)
    golden = {}
    for s in range(14):
        with open(pkg.stripe.shard_file_name(base, s), "rb") as f:
            golden[s] = f.read()
    os.unlink(base + ".dat")
    return base, golden


def move_shards(pkg, src_base, dst_base, shard_ids, with_index=True):
    for s in shard_ids:
        os.replace(pkg.stripe.shard_file_name(src_base, s), pkg.stripe.shard_file_name(dst_base, s))
    if with_index:
        for ext in (".ecx", ".eci"):
            if os.path.exists(src_base + ext) and not os.path.exists(dst_base + ext):
                shutil.copy(src_base + ext, dst_base + ext)


def mount(pkg, vs, vid=VID, **req):
    with pkg.rpc.RpcClient(vs.grpc_address) as c:
        return c.call(pkg.VOLUME_SERVICE, "VolumeEcShardsMount", {"volume_id": vid, **req})


def call(pkg, vs, method, req, timeout=120):
    with pkg.rpc.RpcClient(vs.grpc_address) as c:
        return c.call(pkg.VOLUME_SERVICE, method, req, timeout=timeout)


def same_rack(i):
    return "DefaultRack"


# -- tests/test_remote_rebuild.py twins ---------------------------------------------------


def _remote_rebuild_split_survivors(pkg, root):
    with cluster(pkg, root, heartbeat=0.3, rack=same_rack) as (master, (target, peer, _), _c):
        base_stage, golden = build_ec_volume(pkg, root / "stage")
        base_peer, base_target = peer._base_path_for(VID), target._base_path_for(VID)
        for s in (10, 11, 12, 13):
            os.unlink(pkg.stripe.shard_file_name(base_stage, s))
        move_shards(pkg, base_stage, base_peer, range(0, 7))
        move_shards(pkg, base_stage, base_target, range(7, 10))
        mount(pkg, peer)
        mount(pkg, target)
        wait_for(lambda: len(master.topology.lookup_ec_shards(VID)) == 10,
                 msg="10 survivor shards registered")
        resp = call(pkg, target, "VolumeEcShardsRebuild", {"volume_id": VID, "remote": True})
        assert resp["rebuilt_shard_ids"] == [10, 11, 12, 13]
        assert resp["local_survivors"] == [7, 8, 9]
        assert resp["remote_survivors"] == [0, 1, 2, 3, 4, 5, 6]
        rebuilt = {}
        for s in (10, 11, 12, 13):
            with open(pkg.stripe.shard_file_name(base_target, s), "rb") as f:
                rebuilt[s] = f.read()
            assert rebuilt[s] == golden[s], f"rebuilt shard {s} differs from golden"
        oracle = root / "oracle"
        oracle.mkdir()
        base_oracle = os.path.join(str(oracle), str(VID))
        for s in range(10):
            with open(pkg.stripe.shard_file_name(base_oracle, s), "wb") as f:
                f.write(golden[s])
        assert pkg.stripe.rebuild_ec_files_serial(base_oracle, encoder=pkg.encoder()) == [
            10, 11, 12, 13]
        for s in (10, 11, 12, 13):
            with open(pkg.stripe.shard_file_name(base_oracle, s), "rb") as f:
                assert f.read() == rebuilt[s], f"shard {s}: remote != serial oracle"
        mount(pkg, target, shard_ids=[10, 11, 12, 13])
        st = call(pkg, target, "VolumeStatus", {"volume_id": VID})
        assert set(st["shard_ids"]) >= {7, 8, 9, 10, 11, 12, 13}
        return {"rebuild": strip(resp), "rebuilt": rebuilt, "golden": golden,
                "status": strip(st)}


def test_remote_rebuild_byte_identical_split_survivors(tmp_path, monkeypatch):
    twin(_remote_rebuild_split_survivors, tmp_path, monkeypatch)


def _remote_rebuild_holder_failover(pkg, root):
    with cluster(pkg, root, heartbeat=0.3, rack=same_rack) as (master, servers, _c):
        target, holder_a, holder_b = servers
        base_stage, golden = build_ec_volume(pkg, root / "stage")
        for s in (10, 11, 12, 13):
            os.unlink(pkg.stripe.shard_file_name(base_stage, s))
        base_a, base_b = holder_a._base_path_for(VID), holder_b._base_path_for(VID)
        for s in range(10):
            for b in (base_a, base_b):
                shutil.copy(pkg.stripe.shard_file_name(base_stage, s),
                            pkg.stripe.shard_file_name(b, s))
        for ext in (".ecx", ".eci"):
            shutil.copy(base_stage + ext, base_a + ext)
            shutil.copy(base_stage + ext, base_b + ext)
        for vs in (holder_a, holder_b):
            mount(pkg, vs)
        wait_for(lambda: all(len(a) == 2 for a in master.topology.lookup_ec_shards(VID).values())
                 and len(master.topology.lookup_ec_shards(VID)) == 10,
                 msg="both holders registered for all survivors")
        served = {"n": 0}
        orig = holder_a._rpc_ec_slab_read

        def dying_slab_read(req, ctx):
            served["n"] += 1
            if served["n"] > 2:
                raise pkg.rpc.RpcFault("holder killed mid-rebuild")
            yield from orig(req, ctx)

        holder_a._rpc_ec_slab_read = dying_slab_read
        holder_a._grpc._services[pkg.VOLUME_SERVICE].add(
            "VolumeEcShardSlabRead", dying_slab_read, kind="unary_stream", resp_format="bytes")
        orig_lookup = target._lookup_shard_locations
        a_addr = holder_a.grpc_address

        def a_first(vid):
            return {sid: sorted(addrs, key=lambda a: a != a_addr)
                    for sid, addrs in orig_lookup(vid).items()}

        target._lookup_shard_locations = a_first
        resp = call(pkg, target, "VolumeEcShardsRebuild",
                    {"volume_id": VID, "remote": True, "trace_mode": "off"})
        assert resp["rebuilt_shard_ids"] == [10, 11, 12, 13]
        assert resp["failed_over"], "holder A died but no failover was recorded"
        assert all(f.endswith(a_addr) for f in resp["failed_over"])
        base_target = target._base_path_for(VID)
        rebuilt = shard_shas(pkg, base_target, (10, 11, 12, 13))
        for s in (10, 11, 12, 13):
            with open(pkg.stripe.shard_file_name(base_target, s), "rb") as f:
                assert f.read() == golden[s], f"shard {s} wrong after failover"
        return {"rebuild": strip(resp), "rebuilt": rebuilt}


def test_remote_rebuild_holder_failover_mid_rebuild(tmp_path, monkeypatch):
    twin(_remote_rebuild_holder_failover, tmp_path, monkeypatch)


def _remote_rebuild_faults(pkg, root, case):
    """The three preflight faults: too few survivors anywhere, a truncated
    local survivor, a truncated survivor behind healthy siblings remotely."""
    with cluster(pkg, root, heartbeat=0.3, rack=same_rack) as (master, (target, peer, _), _c):
        base_stage, _ = build_ec_volume(pkg, root / "stage")
        base_peer, base_target = peer._base_path_for(VID), target._base_path_for(VID)
        if case == "too_few":
            move_shards(pkg, base_stage, base_peer, range(0, 9))
            mount(pkg, peer)
            want, match = 9, "cannot rebuild"
        else:
            for s in (10, 11, 12, 13):
                os.unlink(pkg.stripe.shard_file_name(base_stage, s))
            if case == "local":
                move_shards(pkg, base_stage, base_peer, range(0, 7))
                move_shards(pkg, base_stage, base_target, range(7, 10))
                p = pkg.stripe.shard_file_name(base_target, 8)
                with open(p, "r+b") as f:
                    f.truncate(os.path.getsize(p) // 2)
                mount(pkg, peer)
                mount(pkg, target)
            else:
                move_shards(pkg, base_stage, base_peer, range(0, 10))
                mount(pkg, peer)
                p = pkg.stripe.shard_file_name(base_peer, 3)
                with open(p, "r+b") as f:
                    f.truncate(os.path.getsize(p) // 2)
            want, match = 10, "disagree"
        wait_for(lambda: len(master.topology.lookup_ec_shards(VID)) == want,
                 msg=f"{want} shards registered")
        with pytest.raises(grpc.RpcError, match=match) as ei:
            call(pkg, target, "VolumeEcShardsRebuild", {"volume_id": VID, "remote": True},
                 timeout=60)
        assert not os.path.exists(pkg.stripe.shard_file_name(base_target, 10))
        return {"code": ei.value.code(), "left": pkg.stripe.find_local_shards(base_target)}


@pytest.mark.parametrize("case", ["too_few", "local", "remote"])
def test_remote_rebuild_preflight_faults(tmp_path, monkeypatch, case):
    twin(_remote_rebuild_faults, tmp_path, monkeypatch, case=case)


def _slab_read_rpc_streams_crc_chunks_and_eof(pkg, root):
    with cluster(pkg, root, heartbeat=0.3, rack=same_rack) as (master, (_t, peer, _s), _c):
        base_stage, golden = build_ec_volume(pkg, root / "stage")
        move_shards(pkg, base_stage, peer._base_path_for(VID), range(14))
        with pkg.rpc.RpcClient(peer.grpc_address) as pc:
            pc.call(pkg.VOLUME_SERVICE, "VolumeEcShardsMount", {"volume_id": VID})
            frames = list(pc.stream(pkg.VOLUME_SERVICE, "VolumeEcShardSlabRead",
                                    {"volume_id": VID, "shard_id": 3, "offset": 100,
                                     "size": 30_000, "chunk_size": 64 * 1024}, timeout=30))
            got = b"".join(pkg.rpc.crc_unframe(f) for f in frames)
            assert got == golden[3][100:100 + 30_000]
            shard_len = len(golden[3])
            tail_frames = list(pc.stream(pkg.VOLUME_SERVICE, "VolumeEcShardSlabRead",
                                         {"volume_id": VID, "shard_id": 3,
                                          "offset": shard_len - 100, "size": 10_000},
                                         timeout=30))
            tail = b"".join(pkg.rpc.crc_unframe(f) for f in tail_frames)
            assert tail == golden[3][-100:]
        return {"frames": frames, "tail_frames": tail_frames}


def test_slab_read_rpc_streams_crc_chunks_and_eof(tmp_path, monkeypatch):
    twin(_slab_read_rpc_streams_crc_chunks_and_eof, tmp_path, monkeypatch)


def _lookup_single_flight(pkg, root, leader_fails):
    with cluster(pkg, root, heartbeat=0.3, rack=same_rack) as (master, (vs, peer, _), _c):
        vid = 99 if leader_fails else 88
        master.topology.ec_locations[vid] = (
            {0: {peer.url}} if leader_fails else {sid: {peer.url} for sid in range(14)})
        calls = {"n": 0}
        real_query = vs._master_query

        def query(method, req, timeout=5.0):
            if method == "LookupEcVolume":
                calls["n"] += 1
                if leader_fails and calls["n"] == 1:
                    time.sleep(0.05)
                    raise RuntimeError("master hiccup")
                if not leader_fails:
                    time.sleep(0.1)  # widen the race window
            return real_query(method, req, timeout)

        vs._master_query = query
        outcomes = []

        def one():
            try:
                outcomes.append(vs._lookup_shard_locations(vid))
            except Exception as e:  # noqa: BLE001
                outcomes.append(e)

        n = 4 if leader_fails else 8
        threads = [threading.Thread(target=one) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(15)
            assert not t.is_alive()
        assert len(outcomes) == n
        if leader_fails:
            assert any(isinstance(o, dict) for o in outcomes), "no caller recovered"
            return {"recovered": True}
        assert calls["n"] == 1, f"single-flight broken: {calls['n']} master lookups"
        assert all(set(r) == set(range(14)) for r in outcomes)
        return {"lookups": calls["n"], "shards": [sorted(r) for r in outcomes]}


@pytest.mark.parametrize("leader_fails", [False, True], ids=["single_flight", "leader_fails"])
def test_lookup_shard_locations_single_flight(tmp_path, monkeypatch, leader_fails):
    twin(_lookup_single_flight, tmp_path, monkeypatch, leader_fails=leader_fails)


# -- tests/test_trace_repair.py twins ---------------------------------------------------

TVID = 17


def _trace_cluster(pkg, root, case_fn):
    """A master, the rebuild target and two holders; data shard 3 is lost
    cluster-wide: holder A has 0-6 but 3, holder B 7-13."""
    with cluster(pkg, root, heartbeat=0.3, rack=same_rack) as (master, servers, _c):
        target, peer_a, peer_b = servers
        base_stage, golden = build_ec_volume(pkg, root / "stage", vid=TVID, seed=5)
        os.unlink(pkg.stripe.shard_file_name(base_stage, 3))
        base_a, base_b = peer_a._base_path_for(TVID), peer_b._base_path_for(TVID)
        move_shards(pkg, base_stage, base_a, (0, 1, 2, 4, 5, 6))
        move_shards(pkg, base_stage, base_b, range(7, 14))
        for vs in (peer_a, peer_b):
            mount(pkg, vs, TVID)
        wait_for(lambda: len(master.topology.lookup_ec_shards(TVID)) == 13,
                 msg="13 survivor shards registered")
        return case_fn(pkg, master, servers, golden)


def _trace_rebuild(pkg, target, mode):
    return call(pkg, target, "VolumeEcShardsRebuild",
                {"volume_id": TVID, "remote": True, "trace_mode": mode})


def _rebuilt_3(pkg, target):
    with open(pkg.stripe.shard_file_name(target._base_path_for(TVID), 3), "rb") as f:
        return f.read()


def _wire_bytes_below_slab(pkg, master, servers, golden):
    target = servers[0]
    shard_size = len(golden[0])
    trace_counter = pkg.stats.EcRepairNetworkBytes.labels("trace")
    slab_counter = pkg.stats.EcRepairNetworkBytes.labels("slab")
    t0 = trace_counter.value
    resp = _trace_rebuild(pkg, target, "on")
    assert resp["mode"] == "trace", resp
    assert resp["rebuilt_shard_ids"] == [3]
    assert resp["trace_fallback"] == ""
    assert len(resp["trace_groups"]) == 2, resp["trace_groups"]
    assert _rebuilt_3(pkg, target) == golden[3]
    assert resp["wire_bytes"] == 2 * shard_size
    assert trace_counter.value - t0 == resp["wire_bytes"]
    os.unlink(pkg.stripe.shard_file_name(target._base_path_for(TVID), 3))
    s0 = slab_counter.value
    resp_slab = _trace_rebuild(pkg, target, "off")
    assert resp_slab["mode"] == "slab"
    assert resp_slab["wire_bytes"] == 10 * shard_size
    assert slab_counter.value - s0 == resp_slab["wire_bytes"]
    assert _rebuilt_3(pkg, target) == golden[3]
    assert resp["wire_bytes"] / resp_slab["wire_bytes"] <= 0.6
    return {"trace": strip({k: v for k, v in resp.items() if k != "trace_groups"}),
            "groups": len(resp["trace_groups"]), "slab": strip(resp_slab), "shard": golden[3]}


def _auto_uses_projections(pkg, master, servers, golden):
    resp = _trace_rebuild(pkg, servers[0], "auto")
    assert resp["mode"] == "trace"
    assert _rebuilt_3(pkg, servers[0]) == golden[3]
    return {"mode": resp["mode"], "wire_bytes": resp["wire_bytes"]}


def _capability_falls_back(pkg, master, servers, golden):
    servers[2]._trace_repair = "off"
    resp = _trace_rebuild(pkg, servers[0], "auto")
    assert resp["mode"] == "slab", resp
    assert "projection-capable" in resp["trace_fallback"], resp
    assert _rebuilt_3(pkg, servers[0]) == golden[3]
    return {"mode": resp["mode"], "wire_bytes": resp["wire_bytes"]}


def _incapable_peer_refuses(pkg, master, servers, golden):
    peer_b = servers[2]
    peer_b._trace_repair = "off"
    with pkg.rpc.RpcClient(peer_b.grpc_address) as c:
        frames = c.stream(pkg.VOLUME_SERVICE, "VolumeEcShardSlabRead",
                          {"volume_id": TVID, "offset": 0, "size": 4096,
                           "projection": [{"shard_id": 7,
                                           "coeffs": base64.b64encode(b"\x01").decode()}],
                           "projection_rows": 1}, timeout=30)
        with pytest.raises(grpc.RpcError, match="disabled|UNIMPLEMENTED") as ei:
            list(frames)
    return {"code": ei.value.code()}


def _midrebuild_failure_falls_back(pkg, master, servers, golden, mp):
    def boom(*a, **kw):
        raise IOError("holder killed mid-rebuild")

    mp.setattr(pkg.stripe, "rebuild_ec_files_from_projections", boom)
    resp = _trace_rebuild(pkg, servers[0], "on")
    mp.undo()
    assert resp["mode"] == "slab", resp
    assert "holder killed mid-rebuild" in resp["trace_fallback"]
    assert _rebuilt_3(pkg, servers[0]) == golden[3]
    return {"mode": resp["mode"], "fallback": resp["trace_fallback"]}


def _torn_projection_stream(pkg, master, servers, golden):
    target = servers[0]

    class TornClient:
        def stream(self, service, method, req, timeout=None):
            good = pkg.rpc.crc_frame(b"\x00" * 128)
            torn = bytearray(pkg.rpc.crc_frame(b"\x11" * 128))
            torn[10] ^= 0x40
            return iter([good, bytes(torn)])

    class Pool:
        def get(self, addr):
            return TornClient()

    fetch = target._projection_fetcher("x:1", TVID, [], 1)
    target_pool, target._peer_pool = target._peer_pool, Pool()
    try:
        with pytest.raises(IOError, match="CRC mismatch") as ei:
            fetch(0, 4096)
    finally:
        target._peer_pool = target_pool
    return {"error": str(ei.value)}


def _status_advertises_projection(pkg, master, servers, golden):
    peer_a = servers[1]
    st = call(pkg, peer_a, "VolumeStatus", {"volume_id": TVID})
    assert "slab_projection" in st.get("capabilities", []), st
    peer_a._trace_repair = "off"
    st_off = call(pkg, peer_a, "VolumeStatus", {"volume_id": TVID})
    assert st_off.get("capabilities") == []
    return {"on": strip(st), "off": strip(st_off)}


TRACE_CASES = {
    "wire_bytes_below_slab": _wire_bytes_below_slab,
    "auto_uses_projections": _auto_uses_projections,
    "capability_falls_back": _capability_falls_back,
    "incapable_peer_refuses": _incapable_peer_refuses,
    "torn_projection_stream": _torn_projection_stream,
    "status_advertises_projection": _status_advertises_projection,
}


@pytest.mark.parametrize("case", sorted(TRACE_CASES))
def test_trace_repair_over_rpc(tmp_path, monkeypatch, case):
    twin(_trace_cluster, tmp_path, monkeypatch, case_fn=TRACE_CASES[case])


def test_trace_midrebuild_failure_falls_back_to_slab(tmp_path, monkeypatch):
    def scenario(pkg, master, servers, golden):
        return _midrebuild_failure_falls_back(pkg, master, servers, golden, pytest.MonkeyPatch())

    twin(_trace_cluster, tmp_path, monkeypatch, case_fn=scenario)


# -- tests/test_inline_ec.py server twins -----------------------------------------------

ILARGE, ISMALL = 8192, 2048


def _server_policy_off_by_default(pkg, root):
    with cluster(pkg, root, n=1, heartbeat=0.5) as (master, (vs,), _c):
        assert vs._ingest is None
        assert vs.store.on_write is None
        return {"ingest": vs._ingest, "on_write": vs.store.on_write}


def test_server_policy_off_by_default(tmp_path, monkeypatch):
    twin(_server_policy_off_by_default, tmp_path, monkeypatch)


def _inline_env(mp, seal_at=None):
    mp.setenv("WEEDTPU_INLINE_EC", "on")
    mp.setenv("WEEDTPU_INLINE_EC_LARGE_BLOCK", str(ILARGE))
    mp.setenv("WEEDTPU_INLINE_EC_SMALL_BLOCK", str(ISMALL))
    if seal_at is not None:
        mp.setenv("WEEDTPU_INLINE_EC_SEAL_BYTES", str(seal_at))


def _server_threshold_auto_seal(pkg, root):
    """PUTs stream through the builders; the volume crossing the seal
    threshold is sealed in place with shards equal to a warm encode of
    the same .dat by the reference's encoder; then an explicit inline
    generate on the next volume."""
    VS = pkg.VOLUME_SERVICE
    with cluster(pkg, root, n=1, heartbeat=0.4) as (master, (vs,), client):
        wait_for(lambda: master.topology.nodes, msg="cluster form-up")
        vid = vid_of(client.assign().fid)
        blobs = {}
        for key in range(1, 41):
            payload = blob(2100 + key, 6000)
            for _attempt in range(5):
                try:
                    blobs[put(pkg, client, vid, key, payload)] = payload
                    break
                except Exception:  # noqa: BLE001 — sealing race: the volume went read-only
                    time.sleep(0.3)
            else:
                break
        base = vs._base_path_for(vid)
        wait_for(lambda: pkg.stripe.find_local_shards(base) == list(range(14)), msg="auto-seal")
        st = call(pkg, vs, "VolumeStatus", {"volume_id": vid})
        assert st["kind"] == "normal" and st["read_only"]
        wbase = os.path.join(str(root), "warm", str(vid))
        os.makedirs(os.path.dirname(wbase))
        shutil.copy(base + ".dat", wbase + ".dat")
        shutil.copy(base + ".idx", wbase + ".idx")
        REF.stripe.write_ec_files(wbase, large_block_size=ILARGE, small_block_size=ISMALL,
                                  encoder=REF.encoder())
        REF.stripe.write_sorted_file_from_idx(wbase)
        sealed = shard_shas(pkg, base)
        assert sealed == shard_shas(REF, wbase)
        assert sha(base + ".ecx") == sha(wbase + ".ecx")
        reads = {fid: client.read(fid) for fid in blobs}
        assert reads == blobs
        vid2 = vid_of(client.assign().fid)
        put(pkg, client, vid2, 1, blob(99, 5000))
        call(pkg, vs, "VolumeMarkReadonly", {"volume_id": vid2})
        resp = call(pkg, vs, "VolumeEcShardsGenerate", {"volume_id": vid2, "inline": True})
        assert resp["mode"] in ("inline", "resumed"), resp
        assert resp["shard_ids"] == list(range(14))
        return {"sealed": sealed, "status": strip(st), "reads": reads, "generate": resp,
                "second": shard_shas(pkg, vs._base_path_for(vid2))}


def test_server_threshold_auto_seal_and_inline_generate(tmp_path, monkeypatch):
    _inline_env(monkeypatch, seal_at=ILARGE * 10 * 2 + 5000)
    twin(_server_threshold_auto_seal, tmp_path, monkeypatch)


def _server_inline_generate_mismatched_geometry(pkg, root):
    with cluster(pkg, root, n=1, heartbeat=0.4) as (master, (vs,), client):
        wait_for(lambda: master.topology.nodes, msg="cluster form-up")
        vid = vid_of(client.assign().fid)
        put(pkg, client, vid, 1, blob(4, 9000))
        call(pkg, vs, "VolumeMarkReadonly", {"volume_id": vid})
        resp = call(pkg, vs, "VolumeEcShardsGenerate",
                    {"volume_id": vid, "inline": True, "large_block_size": ILARGE * 2,
                     "small_block_size": ISMALL})
        assert resp["mode"] == "warm", resp
        base = vs._base_path_for(vid)
        info = pkg.stripe.read_ec_info(base)
        assert info["large_block_size"] == ILARGE * 2
        return {"generate": resp, "info": info, "shards": shard_shas(pkg, base)}


def test_server_inline_generate_mismatched_geometry_goes_warm(tmp_path, monkeypatch):
    _inline_env(monkeypatch)
    twin(_server_inline_generate_mismatched_geometry, tmp_path, monkeypatch)


# -- tests/test_convert.py:589 twin -------------------------------------------------------


def _convert_rpc_resume_and_counters(pkg, root):
    """A staged (no cut-over) conversion leaves the old geometry serving;
    the second call cuts over from the journal; the counters move."""
    with cluster(pkg, root, heartbeat=0.3, max_volume_count=50) as (master, servers, client):
        vid = vid_of(client.assign().fid)
        fid = put(pkg, client, vid, 1, b"x" * 5000)
        payload = client.read(fid)
        vs = next(s for s in servers if s.store.get_volume(vid) is not None)
        call(pkg, vs, "VolumeMarkReadonly", {"volume_id": vid})
        call(pkg, vs, "VolumeEcShardsGenerate",
             {"volume_id": vid, "large_block_size": 4096, "small_block_size": 512})
        mount(pkg, vs, vid)
        call(pkg, vs, "VolumeDelete", {"volume_id": vid})
        before = pkg.stats.EcConvertBytes.labels("written").value
        staged = call(pkg, vs, "VolumeEcShardsConvert",
                      {"volume_id": vid, "target_family": "merge_20_4", "cutover": False})
        assert staged["mode"] == "converted", staged
        assert pkg.stats.EcConvertBytes.labels("written").value > before
        assert client.read(fid) == payload
        resp = call(pkg, vs, "VolumeEcShardsConvert",
                    {"volume_id": vid, "target_family": "merge_20_4", "cutover": True})
        assert resp["mode"] in ("resumed", "converted")
        assert resp["shard_ids"] == list(range(24))
        assert client.read(fid) == payload
        base = vs._base_path_for(vid)
        return {"staged": strip(staged), "cutover": strip(resp), "read": payload,
                "shards": shard_shas(pkg, base, range(24)), "eci": sha(base + ".eci")}


def test_ec_convert_rpc_resume_and_counters(tmp_path, monkeypatch):
    twin(_convert_rpc_resume_and_counters, tmp_path, monkeypatch)


# -- tests/test_scrub.py server twins -----------------------------------------------------


def flip_byte(path, offset=None):
    size = os.path.getsize(path)
    offset = size // 2 if offset is None else offset
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0x40]))


def _quarantine_recovered_on_restart(pkg, root):
    srv = root / "srv"
    base, golden = build_ec_volume(pkg, srv)
    p = pkg.stripe.shard_file_name(base, 4)
    os.replace(p, p + ".bad")
    pkg.scrub.ScrubCursor(os.path.join(str(srv), ".scrub_cursor.json")).add_quarantine(
        VID, 4, pkg.scrub.CORRUPT)
    master = pkg.MasterServer(port=0, reap_interval=3600)
    master.start()
    ok0 = pkg.stats.ScrubRepairs.labels("ok").value
    vs = pkg.VolumeServer([str(srv)], master.address, heartbeat_interval=0.3,
                          encoder=pkg.encoder())
    vs.start()
    try:
        wait_for(lambda: pkg.stats.ScrubRepairs.labels("ok").value > ok0, timeout=30,
                 msg="restart-recovered repair")
        ev = vs.store.get_ec_volume(VID)
        wait_for(lambda: 4 in ev.shard_ids, msg="shard remounted")
        with open(p, "rb") as f:
            healed = f.read()
        assert healed == golden[4]
        assert not os.path.exists(p + ".bad")
        assert pkg.scrub.ScrubCursor(vs._scrub_cursor.path).quarantine == []
        return {"healed": healed}
    finally:
        stop_all([vs, master])


def test_quarantine_recovered_on_restart_with_scrubber_off(tmp_path, monkeypatch):
    twin(_quarantine_recovered_on_restart, tmp_path, monkeypatch)


def _verify_rpc_report_then_quarantine_repair(pkg, root):
    with cluster(pkg, root, n=1, heartbeat=0.3) as (master, (vs,), _c):
        base, golden = build_ec_volume(pkg, os.path.dirname(vs._base_path_for(VID)))
        mount(pkg, vs)
        flip_byte(pkg.stripe.shard_file_name(base, 6))
        report = call(pkg, vs, "VolumeEcShardsVerify", {"volume_id": VID}, timeout=60)
        assert report["has_crcs"] is True and report["verdicts"]["6"] == "corrupt"
        assert all(v == "ok" for s, v in report["verdicts"].items() if s != "6")
        assert report["quarantined"] == []
        ev = vs.store.get_ec_volume(VID)
        assert 6 in ev.shard_ids
        ok0 = pkg.stats.ScrubRepairs.labels("ok").value
        quarantined = call(pkg, vs, "VolumeEcShardsVerify",
                           {"volume_id": VID, "quarantine": True}, timeout=60)
        assert quarantined["quarantined"] == [6]
        wait_for(lambda: pkg.stats.ScrubRepairs.labels("ok").value > ok0, timeout=30,
                 msg="automatic repair of the quarantined shard")
        ev = vs.store.get_ec_volume(VID)
        wait_for(lambda: 6 in ev.shard_ids, msg="shard remounted")
        assert not ev.quarantined
        with open(pkg.stripe.shard_file_name(base, 6), "rb") as f:
            healed = f.read()
        assert healed == golden[6], "repair must restore exact bytes"
        assert not os.path.exists(pkg.stripe.shard_file_name(base, 6) + ".bad")
        clean = call(pkg, vs, "VolumeEcShardsVerify", {"volume_id": VID}, timeout=60)
        assert all(v == "ok" for v in clean["verdicts"].values())
        return {"report": strip(report), "quarantined": strip(quarantined),
                "clean": strip(clean), "healed": healed}


def test_verify_rpc_report_only_then_quarantine_repair(tmp_path, monkeypatch):
    twin(_verify_rpc_report_then_quarantine_repair, tmp_path, monkeypatch)


def _ec_needles(pkg, client, vs, n, size, seed):
    """n needles written through HTTP, the volume EC-encoded, mounted and
    its .dat dropped -> (vid, {fid: payload})."""
    vid = vid_of(client.assign().fid)
    blobs = {}
    for key in range(1, n + 1):
        payload = blob(seed + key, size)
        blobs[put(pkg, client, vid, key, payload)] = payload
    call(pkg, vs, "VolumeMarkReadonly", {"volume_id": vid})
    call(pkg, vs, "VolumeEcShardsGenerate",
         {"volume_id": vid, "large_block_size": LARGE, "small_block_size": SMALL})
    mount(pkg, vs, vid)
    call(pkg, vs, "VolumeDelete", {"volume_id": vid})
    return vid, blobs


def _verify_on_read_heals(pkg, root):
    with cluster(pkg, root, n=1, heartbeat=0.3) as (master, (vs,), client):
        vid, blobs = _ec_needles(pkg, client, vs, 10, 16_000, 500)
        base = vs._base_path_for(vid)
        golden = shard_shas(pkg, base)
        found0 = pkg.stats.ScrubCorruptionsFound.labels("corrupt").value
        flip_byte(pkg.stripe.shard_file_name(base, 0), 5000)
        bodies = {}
        for fid, want in blobs.items():
            with urllib.request.urlopen(f"http://{vs.url}/{fid}", timeout=30) as r:
                bodies[fid] = r.read()
            assert bodies[fid] == want
        assert pkg.stats.ScrubCorruptionsFound.labels("corrupt").value > found0
        ev = vs.store.get_ec_volume(vid)
        wait_for(lambda: 0 in ev.shard_ids and not ev.quarantined, timeout=30,
                 msg="quarantined shard repaired")
        assert shard_shas(pkg, base, [0]) == {0: golden[0]}
        return {"bodies": bodies, "shards": golden}


def test_verify_on_read_heals_corrupt_needle(tmp_path, monkeypatch):
    twin(_verify_on_read_heals, tmp_path, monkeypatch)


def _scrub_e2e(pkg, root):
    with cluster(pkg, root, n=1, heartbeat=0.3) as (master, (vs,), client):
        vid, blobs = _ec_needles(pkg, client, vs, 6, 20_000, 600)
        base = vs._base_path_for(vid)
        golden_crcs = pkg.stripe.read_ec_info(base)["shard_crc32"]
        found0 = pkg.stats.ScrubCorruptionsFound.labels("corrupt").value
        ok0 = pkg.stats.ScrubRepairs.labels("ok").value
        wait_for(lambda: pkg.stats.ScrubCycles.value > 0, timeout=20, msg="first scrub cycle")
        target = 1
        flip_byte(pkg.stripe.shard_file_name(base, target))
        wait_for(lambda: pkg.stats.ScrubCorruptionsFound.labels("corrupt").value > found0,
                 timeout=20, msg="scrub detects the bit-flip")
        wait_for(lambda: pkg.stats.ScrubRepairs.labels("ok").value > ok0, timeout=20,
                 msg="automatic repair completes")
        ev = vs.store.get_ec_volume(vid)
        wait_for(lambda: target in ev.shard_ids, msg="shard remounted")
        assert not ev.quarantined
        with open(pkg.stripe.shard_file_name(base, target), "rb") as f:
            assert zlib.crc32(f.read()) == golden_crcs[target]
        assert not os.path.exists(pkg.stripe.shard_file_name(base, target) + ".bad")
        bodies = {}
        for fid, want in blobs.items():
            with urllib.request.urlopen(f"http://{vs.url}/{fid}", timeout=30) as r:
                bodies[fid] = r.read()
            assert bodies[fid] == want
        assert pkg.stats.ScrubBytesScanned.value > 0
        assert os.path.exists(os.path.join(os.path.dirname(base), ".scrub_cursor.json"))
        return {"crcs": golden_crcs, "bodies": bodies}


def test_scrub_e2e_bitflip_detect_quarantine_repair(tmp_path, monkeypatch):
    monkeypatch.setenv("WEEDTPU_SCRUB", "on")
    monkeypatch.setenv("WEEDTPU_SCRUB_INTERVAL", "0.2")
    monkeypatch.setenv("WEEDTPU_SCRUB_RATE_MB", "0")
    monkeypatch.setenv("WEEDTPU_SCRUB_REPAIR_BACKOFF", "0.3")
    twin(_scrub_e2e, tmp_path, monkeypatch)


# -- tests/test_fleet.py server twins -----------------------------------------------------


def _batch_rpc_rebuilds_multiple_volumes(pkg, root):
    """VolumeEcShardsRebuildBatch on a plain cluster: two same-signature
    volumes in one RPC fuse into one dispatch group on the target."""
    with cluster(pkg, root, heartbeat=0.3, rack=lambda i: f"r{i}") as (master, servers, _c):
        _, s1, s2 = servers
        golden = {}
        for vid in (31, 32):
            base, golden[vid] = build_ec_volume(pkg, root / "stage", vid=vid, size=90_000,
                                                seed=vid)
            dst = os.path.join(s1.store.locations[0].directory, str(vid))
            for s in range(13):
                os.replace(pkg.stripe.shard_file_name(base, s), pkg.stripe.shard_file_name(dst, s))
            for ext in (".ecx", ".eci"):
                shutil.copy(base + ext, dst + ext)
            s1.store.mount_ec_volume(vid, dst)
        s1.heartbeat_once()
        resp = call(pkg, s2, "VolumeEcShardsRebuildBatch",
                    {"volumes": [{"volume_id": 31}, {"volume_id": 32}]})
        assert resp["dispatch_groups"] == 1
        assert sorted(r["volume_id"] for r in resp["results"]) == [31, 32]
        for r in resp["results"]:
            assert r["error"] == "" and r["rebuilt_shard_ids"] == [13]
        assert resp["wire_bytes"] > 0
        wait_for(lambda: all(13 in master.topology.lookup_ec_shards(v) for v in (31, 32)),
                 msg="rebuilt shards registered")
        rebuilt = {}
        for vid in (31, 32):
            with open(pkg.stripe.shard_file_name(s2._base_path_for(vid), 13), "rb") as f:
                rebuilt[vid] = f.read()
            assert rebuilt[vid] == golden[vid][13]
        return {"batch": strip(resp), "rebuilt": rebuilt}


def test_batch_rpc_rebuilds_multiple_volumes_one_call(tmp_path, monkeypatch):
    twin(_batch_rpc_rebuilds_multiple_volumes, tmp_path, monkeypatch)


def _inline_spread_owner_never_hosts_all_14(pkg, root):
    with cluster(pkg, root, heartbeat=0.3, rack=lambda i: f"r{i}") as (master, servers, _c):
        owner = servers[0]
        wait_for(lambda: len(master.topology.nodes) == 3, msg="cluster formed")
        vid = 41
        spread_before = pkg.stats.InlineEcSpreadBytes.value
        blobs = {}
        with pkg.rpc.RpcClient(owner.grpc_address) as c:
            c.call(pkg.VOLUME_SERVICE, "VolumeCreate", {"volume_id": vid})
            for k in range(1, 9):
                payload = blob(4100 + k, 20_000)
                fid = str(pkg.FileId(vid, k, 0x1234))
                c.call(pkg.VOLUME_SERVICE, "WriteNeedle",
                       {"fid": fid, "data": base64.b64encode(payload).decode()}, timeout=30)
                blobs[fid] = payload
        wait_for(lambda: owner.store.get_ec_volume(vid) is not None, timeout=60,
                 msg="auto-seal mounted the EC volume")
        ev = owner.store.get_ec_volume(vid)
        assert set(ev.shard_ids) == set(range(10)), ev.shard_ids
        wait_for(lambda: sorted(master.topology.lookup_ec_shards(vid)) == list(range(14)),
                 msg="spread parity registered")
        remote = {s: vs for vs in servers[1:] if vs.store.get_ec_volume(vid)
                  for s in vs.store.get_ec_volume(vid).shard_ids}
        assert set(remote) == {10, 11, 12, 13}
        assert pkg.stats.InlineEcSpreadBytes.value > spread_before
        shards = {**shard_shas(pkg, owner._base_path_for(vid), range(10)),
                  **{s: sha(pkg.stripe.shard_file_name(vs._base_path_for(vid), s))
                     for s, vs in remote.items()}}
        reads = {}
        with pkg.rpc.RpcClient(owner.grpc_address) as c:
            c.call(pkg.VOLUME_SERVICE, "VolumeEcShardsDelete", {"volume_id": vid,
                                                                "shard_ids": [0]})
            c.call(pkg.VOLUME_SERVICE, "VolumeDelete", {"volume_id": vid})
            for fid, want in blobs.items():
                got = c.call(pkg.VOLUME_SERVICE, "ReadNeedle",
                             {"volume_id": vid, "needle_id": pkg.FileId.parse(fid).key},
                             timeout=60)
                reads[fid] = base64.b64decode(got["data"])
                assert reads[fid] == want
        return {"shards": shards, "reads": reads}


def test_inline_spread_owner_never_hosts_all_14(tmp_path, monkeypatch):
    monkeypatch.setenv("WEEDTPU_INLINE_EC", "on")
    monkeypatch.setenv("WEEDTPU_INLINE_EC_SPREAD", "on")
    monkeypatch.setenv("WEEDTPU_INLINE_EC_LARGE_BLOCK", "4096")
    monkeypatch.setenv("WEEDTPU_INLINE_EC_SMALL_BLOCK", "512")
    monkeypatch.setenv("WEEDTPU_INLINE_EC_SEAL_BYTES", "150000")
    # the reference's spread poll can lose the race with its seal's rename
    # (ROADMAP Queue 3) and keep a parity shard on the owner: its side is
    # rerun until it meets the case, the port's must meet it at once
    twin(_inline_spread_owner_never_hosts_all_14, tmp_path, monkeypatch, ref_tries=4)


# -- a mixed cluster: a reference volume server pulls from port holders --------------------


def test_reference_server_pulls_shards_and_slabs_from_port_holders(tmp_path, monkeypatch):
    """Under a reference master, two port holders serve a volume's shards;
    a reference volume server copies shards from one (VolumeEcShardsCopy
    over the port's copy stream), then rebuilds the lost parity remotely
    over the port holders' slab and projection streams: every byte equals
    the golden set."""
    pin_clock(monkeypatch, REF)
    master = REF.MasterServer(port=0, reap_interval=3600)
    master.start()
    dirs = [tmp_path / n for n in ("ref", "port0", "port1")]
    for d in dirs:
        d.mkdir()
    target = REF.VolumeServer([str(dirs[0])], master.address, heartbeat_interval=0.3,
                              encoder=REF.encoder())
    holders = [PORT.VolumeServer([str(d)], master.address, heartbeat_interval=0.3,
                                 encoder=PORT.encoder()) for d in dirs[1:]]
    try:
        for vs in (target, *holders):
            vs.start()
        base_stage, golden = build_ec_volume(REF, tmp_path / "stage")
        for s in (10, 11, 12, 13):
            os.unlink(REF.stripe.shard_file_name(base_stage, s))
        move_shards(REF, base_stage, holders[0]._base_path_for(VID), range(0, 6))
        move_shards(REF, base_stage, holders[1]._base_path_for(VID), range(6, 10))
        for vs in holders:
            mount(PORT, vs)
        wait_for(lambda: len(master.topology.lookup_ec_shards(VID)) == 10,
                 msg="port holders registered with the reference master")
        copied = call(REF, target, "VolumeEcShardsCopy",
                      {"volume_id": VID, "shard_ids": [0, 1],
                       "source_data_node": holders[0].grpc_address})
        base_t = target._base_path_for(VID)
        for s in (0, 1):
            with open(REF.stripe.shard_file_name(base_t, s), "rb") as f:
                assert f.read() == golden[s]
        for mode, lost in (("off", (10, 11, 12, 13)), ("on", (12,))):
            for s in lost:
                p = REF.stripe.shard_file_name(base_t, s)
                if os.path.exists(p):
                    os.unlink(p)
            resp = call(REF, target, "VolumeEcShardsRebuild",
                        {"volume_id": VID, "remote": True, "trace_mode": mode})
            assert resp["rebuilt_shard_ids"] == list(lost), resp
            assert resp["mode"] == ("trace" if mode == "on" else "slab"), resp
            for s in lost:
                with open(REF.stripe.shard_file_name(base_t, s), "rb") as f:
                    assert f.read() == golden[s], f"{mode}: shard {s} differs"
        assert copied is not None
    finally:
        stop_all([target, *holders, master])


def test_spread_poll_racing_the_seal_rename_keeps_the_shard_spread(tmp_path, monkeypatch):
    """A poll whose parity partial is renamed into its final shard by the
    seal between the poll's look and its open must leave that shard to
    the seal's finalize, not mark its spread broken (which keeps the
    parity shard on the owner: the spread twin above then sees 11 local
    shards). The reference's poll checks `os.path.exists` and then opens,
    so the rename between the two breaks its spread; the port opens once."""
    from seaweedfs_tpu.ec import ingest as ref_ingest
    from seaweedfs_tpu.ec import spread as ref_spread
    from seaweedfs_tpu_torch.ec import ingest as port_ingest
    from seaweedfs_tpu_torch.ec import spread as port_spread

    class Pool:
        def __init__(self):
            self.shipped = []

        def get(self, addr):
            return self

        def call(self, service, method, req, timeout=None):
            self.shipped.append((req["shard_id"], req["offset"]))
            return {}

    broken = {}
    for name, spread, ingest in (("ref", ref_spread, ref_ingest),
                                 ("port", port_spread, port_ingest)):
        base = str(tmp_path / name / "41")
        os.makedirs(os.path.dirname(base))
        part = ingest.part_path(base, 12)
        with open(part, "wb") as f:
            f.write(blob(12, 2 * 4096))
        pool = Pool()
        session = spread.SpreadSession(41, "", base, {12: "t:1"}, pool, 10, 4096)
        real_open = open

        def racing_open(path, *a, **kw):
            if path == part and os.path.exists(part):  # the seal's rename lands now
                os.replace(part, base + ".ec12")
            return real_open(path, *a, **kw)

        monkeypatch.setattr(spread, "open", racing_open, raising=False)
        session.poll(2)
        monkeypatch.undo()
        broken[name] = session.shards[12].broken
        assert pool.shipped == [] and session.shards[12].shipped == 0
    assert broken == {"ref": True, "port": False}
