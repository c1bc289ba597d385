"""The port's operator shell (`seaweedfs_tpu_torch/shell`) against the
reference's: twins of `tests/test_shell.py`'s cluster and ec.* cases
(the volume.* cases are in `test_torch_shell_volume.py`). Each twin runs
the reference case on a reference cluster driven by the reference shell
(numpy backend) and on a port cluster driven by the port shell (volume
servers on `Encoder(10, 4, device="cpu")`), from the same seeded uploads
under fixed fids with the needle clock pinned, makes the case's own
assertions on both, and requires what comes out to be equal: command
output with addresses masked, shard and `.ecx` bytes, shard placement by
server index, read bodies (tolerance 0). The servers register one by one
on ports whose order is their index, and both masters draw writable
volumes from one seeded generator, so placement is the same on both.

Also: the port shell driving a reference cluster, `ec.backend` on the
CPU, what the port leaves out raising (the filer client, volume.fsck's
filer walk), and `python -m seaweedfs_tpu_torch shell -c` in a
subprocess."""

import contextlib
import io
import os
import random
import re
import socket
import subprocess
import sys
import threading
import time
import types

import pytest

import seaweedfs_tpu.shell as ref_shell
import seaweedfs_tpu.shell.command_ec as ref_cec
import seaweedfs_tpu.shell.command_volume as ref_cv
import seaweedfs_tpu_torch.shell as port_shell
import seaweedfs_tpu_torch.shell.command_ec as port_cec
import seaweedfs_tpu_torch.shell.command_volume as port_cv
from seaweedfs_tpu.ec.shard_bits import ShardBits as RefShardBits
from seaweedfs_tpu_torch.ec.shard_bits import ShardBits as PortShardBits

from test_torch_cluster import (
    PORT, REF, blob, pin_clock, put, sha, shard_shas, stop_all, twin, vid_of, wait_for,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LARGE, SMALL = 4096, 512

SHELL = {
    "ref": types.SimpleNamespace(shell=ref_shell, cec=ref_cec, cv=ref_cv, ShardBits=RefShardBits),
    "port": types.SimpleNamespace(shell=port_shell, cec=port_cec, cv=port_cv,
                                  ShardBits=PortShardBits),
}


def sh(pkg):
    return SHELL[pkg.name]


def ordered_ports(n: int) -> list[int]:
    """`n` free loopback ports whose "127.0.0.1:<port>" strings sort in
    list order (the shell and the planners break ties on url)."""
    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return sorted((s.getsockname()[1] for s in socks), key=str)
    finally:
        for s in socks:
            s.close()


@contextlib.contextmanager
def shell_cluster(pkg, root, n=4, rack=lambda i: f"rack{i % 2}", max_volume_count=50,
                  master_kw=None, env_pkg=None):
    """A master and `n` volume servers of `pkg` (test_shell.py's fixture:
    racks rack0/rack1, heartbeat 0.3 s), registered in index order on
    ordered ports, the master's volume draw seeded; a `MasterClient` and a
    `CommandEnv` of `env_pkg` (default `pkg`)."""
    master = pkg.MasterServer(port=0, reap_interval=3600, **(master_kw or {}))
    master._rng = random.Random(7)
    master.start()
    servers = []
    env = client = None
    try:
        for i, port in enumerate(ordered_ports(n)):
            d = root / f"srv{i}"
            d.mkdir(parents=True)
            vs = pkg.VolumeServer([str(d)], master.address, port=port, heartbeat_interval=0.3,
                                  rack=rack(i), max_volume_count=max_volume_count,
                                  encoder=pkg.encoder())
            vs.start()
            servers.append(vs)
            wait_for(lambda: vs.url in master.topology.nodes, msg=f"server {i} registered")
        client = pkg.MasterClient(master.address)
        env = sh(env_pkg or pkg).shell.CommandEnv(master.address)
        yield master, servers, client, env
    finally:
        if env is not None:
            env.close()
        if client is not None:
            client.close()
        stop_all([*servers, master])


def run(pkg, env, line) -> str:
    out = io.StringIO()
    sh(pkg).shell.run_command(env, line, out)
    return out.getvalue()


def mask(text: str, servers=()) -> str:
    """Output with each server's url replaced by its index and any other
    loopback address masked."""
    for i, vs in enumerate(servers):
        text = text.replace(vs.url, f"<s{i}>").replace(vs.grpc_address, f"<g{i}>")
        text = text.replace(f":{vs.grpc_address.rsplit(':', 1)[1]})", f":<g{i}>)")
    return re.sub(r"127\.0\.0\.1:\d+", "<addr>", text)


def upload_some(pkg, client, n=20, size=700, seed=0, **assign) -> dict:
    """`n` seeded blobs under fixed fids on the volume the master assigns
    (`assign`: its collection and replication)."""
    vid = vid_of(client.assign(**assign).fid)
    out = {}
    for k in range(1, n + 1):
        data = blob(seed * 1000 + k, size)
        out[put(pkg, client, vid, k, data)] = data
    return out


def spread(pkg, env, servers, vid) -> dict:
    """server index -> shard ids of `vid`, from the master's view."""
    idx = {vs.url: i for i, vs in enumerate(servers)}
    out = {}
    for n in env.topology_nodes():
        for e in n.get("ec_shards", []):
            if int(e["volume_id"]) == vid:
                out[idx[n["url"]]] = sh(pkg).ShardBits(e["shard_bits"]).shard_ids()
    return dict(sorted(out.items()))


def holder_shas(pkg, servers, vid, placement) -> dict:
    return {i: {**shard_shas(pkg, servers[i]._base_path_for(vid), sids),
                "ecx": sha(servers[i]._base_path_for(vid) + ".ecx")}
            for i, sids in placement.items()}


def reads(client, fids: dict) -> bool:
    return all(client.read(fid) == data for fid, data in fids.items())


# -- test_shell.py twins: lock, help, listings ---------------------------------------------


def _lock_required_and_contention(pkg, root):
    S = sh(pkg).shell
    with shell_cluster(pkg, root) as (master, servers, client, env):
        with pytest.raises(S.ShellError, match="lock the cluster") as e1:
            run(pkg, env, "volume.delete -volumeId 1")
        locked = run(pkg, env, "lock")
        assert "locked" in locked
        env2 = S.CommandEnv(master.address, client_name="intruder")
        try:
            with pytest.raises(Exception, match="held by") as e2:
                env2.lock()
        finally:
            env2.close()
        unlocked = run(pkg, env, "unlock")
        assert "unlocked" in unlocked
        env2 = S.CommandEnv(master.address, client_name="second")
        try:
            env2.lock()
            assert env2.is_locked
            env2.unlock()
        finally:
            env2.close()
        return [str(e1.value), mask(str(e2.value.details()), servers), locked, unlocked]


def test_lock_required_and_contention(tmp_path, monkeypatch):
    twin(_lock_required_and_contention, tmp_path, monkeypatch)


def _help_and_volume_list(pkg, root):
    with shell_cluster(pkg, root) as (master, servers, client, env):
        upload_some(pkg, client, n=3)
        helped = run(pkg, env, "help")
        assert "ec.encode" in helped and "volume.list" in helped
        listed = run(pkg, env, "volume.list")
        assert "DataCenter" in listed and "volume 1" in listed
        colls = run(pkg, env, "collection.list")
        assert "collection: ''" in colls
        checked = run(pkg, env, "cluster.check")
        assert "4 nodes" in checked and "unreachable" not in checked.replace("0 unreachable", "")
        one = run(pkg, env, "help ec.encode")
        # the port leaves out the filer, S3 and MQ families
        names = [ln.split()[0] for ln in helped.splitlines()]
        return {"names": names, "help_ec_encode": one, "collections": colls,
                "check": mask(checked, servers)}


def test_help_and_volume_list(tmp_path, monkeypatch):
    out = {}
    for pkg in (REF, PORT):
        root = tmp_path / pkg.name
        root.mkdir()
        out[pkg.name] = _help_and_volume_list(pkg, root)
    ref_names = out["ref"].pop("names")
    port_names = out["port"].pop("names")
    assert out["port"] == out["ref"]
    left_out = ("fs.", "s3.", "mq.")
    assert port_names == [n for n in ref_names if not n.startswith(left_out)]


def _ec_encode_read_rebuild_balance(pkg, root):
    with shell_cluster(pkg, root) as (master, servers, client, env):
        fids = upload_some(pkg, client, n=25, seed=1)
        vid = vid_of(next(iter(fids)))
        run(pkg, env, "lock")
        encoded = run(pkg, env, f"ec.encode -volumeId {vid} -largeBlockSize {LARGE} "
                                f"-smallBlockSize {SMALL}")
        assert f"ec.encode volume {vid}" in encoded
        placed = spread(pkg, env, servers, vid)
        assert sorted(s for sids in placed.values() for s in sids) == list(range(14))
        assert len(placed) == 4
        assert not any(int(v["id"]) == vid for n in env.topology_nodes()
                       for v in n.get("volumes", []))
        shas = holder_shas(pkg, servers, vid, placed)
        assert reads(client, fids)
        victim, victim_sids = next(iter(placed.items()))
        env.vs_call(servers[victim].grpc_address, "VolumeEcShardsDelete",
                    {"volume_id": vid, "shard_ids": victim_sids})
        rebuilt = run(pkg, env, "ec.rebuild")
        assert "rebuilt" in rebuilt
        after = spread(pkg, env, servers, vid)
        assert sorted(s for sids in after.values() for s in sids) == list(range(14))
        rebuilt_shas = holder_shas(pkg, servers, vid, after)
        assert reads(client, fids)
        balanced = run(pkg, env, "ec.balance")
        counts = [len(s) for s in spread(pkg, env, servers, vid).values()]
        assert max(counts) - min(counts) <= 1 or len(counts) == 4
        decoded = run(pkg, env, f"ec.decode -volumeId {vid}")
        assert "restored as normal volume" in decoded
        assert spread(pkg, env, servers, vid) == {}
        assert reads(client, fids)
        owner = next(vs for vs in servers if vs.store.get_volume(vid) is not None)
        return {"outputs": [mask(t, servers) for t in (encoded, rebuilt, balanced, decoded)],
                "placed": placed, "shas": shas, "after": after, "rebuilt_shas": rebuilt_shas,
                "decoded_dat": sha(owner.store.get_volume(vid).base_path + ".dat")}


def test_ec_encode_read_rebuild_balance(tmp_path, monkeypatch):
    twin(_ec_encode_read_rebuild_balance, tmp_path, monkeypatch)


def _make_second_volume(pkg, master, servers, client):
    """Two live volumes in the default collection: volume A filled and
    marked read-only until the master grows volume B for the next write."""
    fids_a = upload_some(pkg, client, n=6, seed=2)
    vid_a = vid_of(next(iter(fids_a)))
    owner = next(s for s in servers if s.store.get_volume(vid_a) is not None)
    owner.store.get_volume(vid_a).read_only = True
    wait_for(lambda: all(vi.read_only for n in master.topology.nodes.values()
                         for v, vi in n.volumes.items() if v == vid_a),
             msg="the master to see volume A read-only")
    fids_b = upload_some(pkg, client, n=3, seed=3)
    vid_b = vid_of(next(iter(fids_b)))
    assert vid_b != vid_a, "second volume never grew"
    owner.store.get_volume(vid_a).read_only = False
    return {**fids_a, **fids_b}, vid_a, vid_b


def _ec_encode_batch_resume(pkg, root, mp):
    cec = sh(pkg).cec
    with shell_cluster(pkg, root) as (master, servers, client, env):
        fids, vid_a, vid_b = _make_second_volume(pkg, master, servers, client)
        ckpt = str(root / "enc.ckpt")
        run(pkg, env, "lock")
        real = cec._do_ec_encode
        calls = {"n": 0}

        def dying(env_, nodes, vid, coll, w, **kw):
            calls["n"] += 1
            if calls["n"] >= 2:
                raise KeyboardInterrupt("simulated operator kill")
            return real(env_, nodes, vid, coll, w, **kw)

        mp.setattr(cec, "_do_ec_encode", dying)
        script = (f"ec.encode -collection '' -force -checkpoint {ckpt} "
                  f"-largeBlockSize {LARGE} -smallBlockSize {SMALL}")
        with pytest.raises(KeyboardInterrupt):
            run(pkg, env, script)
        with open(ckpt) as f:
            saved = f.read()
        assert '"done": [%d]' % vid_a in saved
        mp.setattr(cec, "_do_ec_encode", real)
        rerun = run(pkg, env, script)
        if f"volume {vid_a}" in rerun:
            assert f"ec.encode volume {vid_a}: skip (checkpointed)" in rerun
        assert f"ec.encode volume {vid_b}" in rerun
        assert not os.path.exists(ckpt)
        assert reads(client, fids)
        return {"checkpoint": saved, "rerun": mask(rerun, servers),
                "b": spread(pkg, env, servers, vid_b)}


def test_ec_encode_batch_resume_after_interrupt(tmp_path, monkeypatch):
    twin(_ec_encode_batch_resume, tmp_path, monkeypatch, mp=monkeypatch)


def _rebuild_copies_concurrently(pkg, root, mp):
    with shell_cluster(pkg, root) as (master, servers, client, env):
        fids = upload_some(pkg, client, n=10, seed=4)
        vid = vid_of(next(iter(fids)))
        run(pkg, env, "lock")
        run(pkg, env, f"ec.encode -volumeId {vid} -largeBlockSize {LARGE} -smallBlockSize {SMALL}")
        placed = spread(pkg, env, servers, vid)
        victim, victim_sids = next(iter(placed.items()))
        env.vs_call(servers[victim].grpc_address, "VolumeEcShardsDelete",
                    {"volume_id": vid, "shard_ids": victim_sids})
        orig = env.vs_call
        lock = threading.Lock()
        state = {"cur": 0, "max": 0, "copies": 0}

        def tracked(addr, method, req, timeout=300):
            if method != "VolumeEcShardsCopy":
                return orig(addr, method, req, timeout=timeout)
            with lock:
                state["cur"] += 1
                state["copies"] += 1
                state["max"] = max(state["max"], state["cur"])
            time.sleep(0.25)
            try:
                return orig(addr, method, req, timeout=timeout)
            finally:
                with lock:
                    state["cur"] -= 1

        mp.setattr(env, "vs_call", tracked)
        out = run(pkg, env, "ec.rebuild")
        assert "rebuilt" in out
        assert state["copies"] >= 2 and state["max"] >= 2
        assert reads(client, fids)
        return {"out": mask(out, servers), "copies": state["copies"],
                "after": spread(pkg, env, servers, vid)}


def test_rebuild_shard_copies_run_concurrently(tmp_path, monkeypatch):
    twin(_rebuild_copies_concurrently, tmp_path, monkeypatch, mp=monkeypatch)


def _lock_lost_after_steal(pkg, root):
    S = sh(pkg).shell
    with shell_cluster(pkg, root, n=1) as (master, servers, client, env):
        env.lock()
        assert env.is_locked
        with master._admin_lock_mu:
            master._admin_locks["admin"] = (999, time.monotonic() + 30, "thief")
        lost = env._renew_once()
        assert lost is False and not env.is_locked
        with pytest.raises(S.ShellError, match="lock the cluster") as e:
            run(pkg, env, "volume.delete -volumeId 1")
        return [lost, str(e.value)]


def test_lock_lost_after_lease_steal(tmp_path, monkeypatch):
    twin(_lock_lost_after_steal, tmp_path, monkeypatch)


def _ec_lifecycle_with_collection(pkg, root):
    with shell_cluster(pkg, root) as (master, servers, client, env):
        fids = upload_some(pkg, client, n=8, size=600, seed=5, collection="foo")
        vid = vid_of(next(iter(fids)))
        run(pkg, env, "lock")
        encoded = run(pkg, env, f"ec.encode -volumeId {vid} -largeBlockSize {LARGE} "
                                f"-smallBlockSize {SMALL}")
        assert f"ec.encode volume {vid}" in encoded
        assert env.volume_list().get("ec_collections", {}).get(str(vid)) == "foo"
        placed = spread(pkg, env, servers, vid)
        victim, victim_sids = next(iter(placed.items()))
        env.vs_call(servers[victim].grpc_address, "VolumeEcShardsDelete",
                    {"volume_id": vid, "collection": "foo", "shard_ids": victim_sids})
        rebuilt = run(pkg, env, "ec.rebuild")
        assert "rebuilt" in rebuilt
        after = spread(pkg, env, servers, vid)
        assert sorted(s for sids in after.values() for s in sids) == list(range(14))
        assert reads(client, fids)
        return {"out": [mask(encoded, servers), mask(rebuilt, servers)], "after": after}


def test_ec_lifecycle_with_collection(tmp_path, monkeypatch):
    twin(_ec_lifecycle_with_collection, tmp_path, monkeypatch)


def _run_script_multiple_commands(pkg, root):
    with shell_cluster(pkg, root, n=2) as (master, servers, client, env):
        out = io.StringIO()
        sh(pkg).shell.run_script(env, "lock; volume.list; unlock", out)
        s = out.getvalue()
        assert "locked" in s and "DataCenter" in s and "unlocked" in s
        return mask(s, servers)


def test_run_script_multiple_commands(tmp_path, monkeypatch):
    twin(_run_script_multiple_commands, tmp_path, monkeypatch)


def _cluster_ps_and_raft_ps(pkg, root):
    with shell_cluster(pkg, root) as (master, servers, client, env):
        raft = run(pkg, env, "cluster.raft.ps")
        assert "raft disabled" in raft and master.address in raft
        ps = run(pkg, env, "cluster.ps")
        assert ps.count("volume server") == 4
        assert f"master * {master.address}" in ps
        return [mask(raft, servers), mask(ps, servers)]


def test_cluster_ps_and_raft_ps(tmp_path, monkeypatch):
    twin(_cluster_ps_and_raft_ps, tmp_path, monkeypatch)


def _ec_encode_quiet_for_filter(pkg, root):
    with shell_cluster(pkg, root) as (master, servers, client, env):
        upload_some(pkg, client, n=4, seed=6)
        wait_for(lambda: any(v.get("last_modified") for n in env.topology_nodes()
                             for v in n.get("volumes", [])), msg="heartbeat carries mtime")
        run(pkg, env, "lock")
        quiet = run(pkg, env, "ec.encode -quietFor 3600 -force")
        assert "no matching volumes" in quiet
        forced = run(pkg, env, "ec.encode -force")
        assert "ec.encode volume" in forced
        return [quiet, mask(forced, servers)]


def test_ec_encode_quiet_for_filter(tmp_path, monkeypatch):
    twin(_ec_encode_quiet_for_filter, tmp_path, monkeypatch)


def _ec_balance_improves_rack_spread(pkg, root):
    with shell_cluster(pkg, root) as (master, servers, client, env):
        fids = upload_some(pkg, client, n=12, seed=7)
        vid = vid_of(next(iter(fids)))
        run(pkg, env, "lock")
        run(pkg, env, f"ec.encode -volumeId {vid} -force")
        rack0 = [i for i in range(4) if i % 2 == 0]
        rack1 = [i for i in range(4) if i % 2 == 1]
        placed = spread(pkg, env, servers, vid)
        for i in rack1:
            sids = placed.get(i, [])
            if not sids:
                continue
            env.vs_call(servers[0].grpc_address, "VolumeEcShardsCopy",
                        {"volume_id": vid, "collection": "", "shard_ids": sids,
                         "source_data_node": servers[i].grpc_address, "copy_ecx_file": False})
            env.vs_call(servers[0].grpc_address, "VolumeEcShardsMount",
                        {"volume_id": vid, "collection": "", "shard_ids": sids})
            env.vs_call(servers[i].grpc_address, "VolumeEcShardsDelete",
                        {"volume_id": vid, "collection": "", "shard_ids": sids})
        wait_for(lambda: not any(spread(pkg, env, servers, vid).get(i) for i in rack1),
                 msg="every shard in rack0")
        balanced = run(pkg, env, "ec.balance")
        after = spread(pkg, env, servers, vid)
        assert sum(len(after.get(i, [])) for i in rack1) >= 5, after
        assert reads(client, fids)
        return {"out": balanced, "after": after, "rack0": rack0}


def test_ec_balance_improves_rack_spread(tmp_path, monkeypatch):
    twin(_ec_balance_improves_rack_spread, tmp_path, monkeypatch)


def _pick_balance_move(pkg, root):
    pick = sh(pkg).cec.pick_balance_move
    by_url = {"a:1": {"rack": "r0"}, "b:1": {"rack": "r0"}, "c:1": {"rack": "r1"}}
    placement = {"a:1": {7: {0, 1, 2}, 9: {0, 1}}, "b:1": {7: {3, 4}}, "c:1": {9: {2, 3}}}
    first = pick(placement, by_url, "a:1", "c:1", {}, "")
    assert first is not None and first[0] == 7
    filtered = pick(placement, by_url, "a:1", "c:1", {7: "x", 9: "y"}, "y")
    assert filtered is not None and filtered[0] == 9
    assert pick({"a:1": {}, "c:1": {}}, by_url, "a:1", "c:1", {}, "") is None
    return [first, filtered]


def test_pick_balance_move_prefers_rack_spread(tmp_path, monkeypatch):
    twin(_pick_balance_move, tmp_path, monkeypatch)


# -- the pure helpers -------------------------------------------------------------------------


def _parse_flags_and_allocation(pkg, root):
    S, cec = sh(pkg).shell, sh(pkg).cec
    ns = S.parse_flags(["-volumeId", "7", "-collection=foo", "-force", "-fullPercent", "80.5",
                        "-node.name", "x"], volumeId=0, collection="", force=False,
                       fullPercent=95.0, node_name="")
    got = (ns.volumeId, ns.collection, ns.force, ns.fullPercent, ns.node_name)
    errors = []
    for bad in (["stray"], ["-nope", "1"], ["-volumeId"]):
        with pytest.raises(S.ShellError) as e:
            S.parse_flags(bad, volumeId=0)
        errors.append(str(e.value))
    nodes = [{"url": f"n{i}:80", "data_center": "dc", "rack": f"r{i % 3}",
              "ec_shards": [{"volume_id": 1, "shard_bits": (1 << i) - 1}]} for i in range(5)]
    alloc = cec.allocate_shards(nodes)
    assert sorted(s for sids in alloc.values() for s in sids) == list(range(14))
    with pytest.raises(S.ShellError):
        cec.allocate_shards([])
    grpc = S.grpc_addr({"url": "10.0.0.1:8080", "grpc_port": 18080})

    class Fc:  # a paged listing, as the filer's `list` pages it
        def list(self, path, start_from="", limit=1024):
            names = [f"e{i:03d}" for i in range(7)]
            picked = [n for n in names if n > start_from][:limit]
            return [types.SimpleNamespace(name=n) for n in picked]

    listed = [e.name for e in S.iter_entries(Fc(), "/d", page=3)]
    assert listed == [f"e{i:03d}" for i in range(7)]
    return {"flags": got, "errors": errors, "alloc": alloc, "grpc": grpc, "listed": listed}


def test_parse_flags_allocation_and_paging(tmp_path, monkeypatch):
    twin(_parse_flags_and_allocation, tmp_path, monkeypatch)


def _checkpoint_round_trip(pkg, root):
    Ck = sh(pkg).cec.EncodeCheckpoint
    path = str(root / "ck.json")
    ck = Ck(path, {"collection": "c", "fullPercent": 95.0})
    assert ck.load_done() == set()
    ck.mark_done({3, 1})
    with open(path) as f:
        raw = f.read()
    assert Ck(path, {"collection": "c", "fullPercent": 95.0}).load_done() == {1, 3}
    assert Ck(path, {"collection": "other"}).load_done() == set()
    ck.finish()
    assert not os.path.exists(path)
    ck.finish()  # idempotent
    return raw


def test_encode_checkpoint_round_trip(tmp_path, monkeypatch):
    twin(_checkpoint_round_trip, tmp_path, monkeypatch)


# -- the port shell on a reference cluster -------------------------------------------------


def test_port_shell_drives_a_reference_cluster(tmp_path, monkeypatch):
    """The port's shell over a reference master and reference volume
    servers (the reverse of test_torch_master.py's reference clients over
    port servers): lock, ec.encode, a lost server's shards, ec.rebuild
    -remote, ec.verify, ec.decode, unlock. The shards it leaves equal a
    reference shell's run of the same script on a twin reference cluster."""
    def scenario(env_pkg, root):
        with shell_cluster(REF, root, env_pkg=env_pkg) as (master, servers, client, env):
            fids = upload_some(REF, client, n=16, size=900, seed=8)
            vid = vid_of(next(iter(fids)))
            out = io.StringIO()
            S = sh(env_pkg).shell
            S.run_script(env, f"lock; ec.encode -volumeId {vid} -largeBlockSize {LARGE} "
                              f"-smallBlockSize {SMALL}", out)
            placed = spread(REF, env, servers, vid)
            shas = holder_shas(REF, servers, vid, placed)
            victim, victim_sids = next(iter(placed.items()))
            env.vs_call(servers[victim].grpc_address, "VolumeEcShardsDelete",
                        {"volume_id": vid, "shard_ids": victim_sids})
            S.run_script(env, "ec.rebuild -remote; ec.verify", out)
            after = spread(REF, env, servers, vid)
            assert sorted(s for sids in after.values() for s in sids) == list(range(14))
            rebuilt = holder_shas(REF, servers, vid, after)
            for sid in victim_sids:
                (i,) = [i for i, sids in after.items() if sid in sids]
                assert rebuilt[i][sid] == next(h[sid] for h in shas.values() if sid in h)
            assert "all shards verified clean" in out.getvalue()
            assert reads(client, fids)
            S.run_script(env, f"ec.decode -volumeId {vid}; unlock", out)
            assert reads(client, fids)
            owner = next(vs for vs in servers if vs.store.get_volume(vid) is not None)
            return {"out": mask(out.getvalue(), servers), "placed": placed, "shas": shas,
                    "after": after, "rebuilt": rebuilt,
                    "dat": sha(owner.store.get_volume(vid).base_path + ".dat")}

    out = {}
    for env_pkg in (REF, PORT):
        root = tmp_path / env_pkg.name
        root.mkdir()
        pin_clock(monkeypatch, REF)
        out[env_pkg.name] = scenario(env_pkg, root)
    assert out["port"] == out["ref"]


# -- ec.backend, and what the port leaves out ------------------------------------------------


def test_ec_backend_names_the_plain_version_on_the_cpu():
    out = io.StringIO()
    env = types.SimpleNamespace(device="cpu")
    port_cec.do_ec_backend([], env, out)
    lines = out.getvalue().splitlines()
    assert lines[0] == "ec.backend: backend=torch device=cpu source=explicit variant=int8"
    assert lines[1] == "ec.backend: cpu: path=rs_torch (the kernels' plain version)"


@pytest.mark.skipif(__import__("torch").cuda.is_available(), reason="the card is present")
def test_ec_backend_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cec.do_ec_backend([], types.SimpleNamespace(device=None), io.StringIO())


def test_filer_client_and_fsck_walk_raise(tmp_path):
    """The filer is not in the package: the env's filer client raises, and
    so does volume.fsck once its volume scan reaches the filer walk."""
    with shell_cluster(PORT, tmp_path, n=1) as (master, servers, client, env):
        upload_some(PORT, client, n=2, seed=9)
        with pytest.raises(NotImplementedError, match="item 5"):
            env.filer_client()
        run(PORT, env, "lock")
        with pytest.raises(NotImplementedError, match="filer"):
            run(PORT, env, "volume.fsck")
        assert not any(c.startswith(("fs.", "s3.", "mq.")) for c in port_shell.commands())


def test_shell_command_runs_a_script(tmp_path):
    """`python -m seaweedfs_tpu_torch shell -master H:P --device cpu -c`
    against a port cluster in this process."""
    with shell_cluster(PORT, tmp_path, n=2) as (master, servers, client, env):
        upload_some(PORT, client, n=2, seed=10)
        proc = subprocess.run(
            [sys.executable, "-m", "seaweedfs_tpu_torch", "shell", "-master", master.address,
             "--device", "cpu", "-c", "lock; volume.list; cluster.ps; ec.backend; unlock"],
            cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        out = proc.stdout
        assert "cluster locked" in out and "cluster unlocked" in out
        assert "DataCenter" in out and out.count("volume server ") == 2
        assert "ec.backend: backend=torch device=cpu" in out
