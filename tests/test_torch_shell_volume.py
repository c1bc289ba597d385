"""The port's volume.* and collection.* shell commands against the
reference's: twins of `tests/test_shell.py`'s volume cases, each run on a
reference cluster with the reference shell and on a port cluster with the
port shell (the harness of `test_torch_shell.py`: servers registered in
index order on ordered ports, the masters' volume draw seeded, the needle
clock pinned, fixed fids), with the case's own assertions on both and
equal outputs: command output with addresses masked, which server holds
which volume, needle bytes (tolerance 0)."""

import base64
import os

import pytest

from test_torch_cluster import blob, put, twin, vid_of, wait_for
from test_torch_shell import mask, reads, run, sh, shell_cluster, upload_some


def holders_of(env, servers, vid) -> list[int]:
    """Indexes of the servers the master lists as holding volume `vid`."""
    idx = {vs.url: i for i, vs in enumerate(servers)}
    return sorted(idx[n["url"]] for n in env.topology_nodes()
                  if any(int(v["id"]) == vid for v in n.get("volumes", [])))


def store_holders(servers, vid) -> list[int]:
    return [i for i, vs in enumerate(servers) if vs.store.get_volume(vid) is not None]


def _volume_vacuum_and_mark(pkg, root):
    with shell_cluster(pkg, root) as (master, servers, client, env):
        fids = upload_some(pkg, client, n=10, seed=11)
        vid = vid_of(next(iter(fids)))
        for fid in list(fids)[:6]:
            client.delete(fid)
        run(pkg, env, "lock")
        vacuumed = run(pkg, env, f"volume.vacuum -volumeId {vid}")
        assert "->" in vacuumed
        assert reads(client, dict(list(fids.items())[6:]))
        ro = run(pkg, env, f"volume.mark -volumeId {vid} -readonly")
        assert "readonly" in ro
        rw = run(pkg, env, f"volume.mark -volumeId {vid} -writable")
        assert "writable" in rw
        return [mask(t, servers) for t in (vacuumed, ro, rw)]


def test_volume_vacuum_and_mark(tmp_path, monkeypatch):
    twin(_volume_vacuum_and_mark, tmp_path, monkeypatch)


def _fix_replication(pkg, root):
    with shell_cluster(pkg, root) as (master, servers, client, env):
        fids = upload_some(pkg, client, n=1, seed=12, replication="001")
        vid = vid_of(next(iter(fids)))
        wait_for(lambda: len(holders_of(env, servers, vid)) == 2, msg="two replicas")
        before = holders_of(env, servers, vid)
        env.vs_call(servers[before[0]].grpc_address, "VolumeDelete", {"volume_id": vid})
        wait_for(lambda: len(holders_of(env, servers, vid)) == 1, msg="one replica left")
        nofix = run(pkg, env, "volume.fix.replication -noFix")
        assert f"volume {vid}: 1/2 replicas" in nofix
        run(pkg, env, "lock")
        fixed = run(pkg, env, "volume.fix.replication")
        assert "fixed 1" in fixed
        wait_for(lambda: len(holders_of(env, servers, vid)) == 2, msg="two replicas again")
        assert reads(client, fids)
        return {"out": [mask(nofix, servers), mask(fixed, servers)], "before": before,
                "after": holders_of(env, servers, vid)}


def test_fix_replication(tmp_path, monkeypatch):
    twin(_fix_replication, tmp_path, monkeypatch)


def _volume_balance_moves_volumes(pkg, root):
    with shell_cluster(pkg, root) as (master, servers, client, env):
        fids = upload_some(pkg, client, n=30, size=900, seed=13)
        for _ in range(6):
            client.assign()  # each assign may grow a volume
        n_vols = sum(len(vs.store.volume_infos()) for vs in servers)
        wait_for(lambda: sum(len(n.get("volumes", [])) for n in env.topology_nodes()) == n_vols,
                 msg="heartbeats settle")
        before = {i: len(vs.store.volume_infos()) for i, vs in enumerate(servers)}
        run(pkg, env, "lock")
        balanced = run(pkg, env, "volume.balance")
        assert "volume.balance:" in balanced
        after = {i: len(vs.store.volume_infos()) for i, vs in enumerate(servers)}
        assert max(after.values()) - min(after.values()) <= 1, (before, after)
        assert reads(client, fids)
        return {"out": mask(balanced, servers), "before": before, "after": after}


def test_volume_balance_moves_volumes(tmp_path, monkeypatch):
    twin(_volume_balance_moves_volumes, tmp_path, monkeypatch)


def _volume_move_to_named_node(pkg, root):
    S = sh(pkg).shell
    with shell_cluster(pkg, root) as (master, servers, client, env):
        fids = upload_some(pkg, client, n=8, size=800, seed=14)
        vid = vid_of(next(iter(fids)))
        run(pkg, env, "lock")
        (src,) = store_holders(servers, vid)
        dst = next(i for i in range(len(servers)) if i != src)
        moved = run(pkg, env, f"volume.move -volumeId {vid} -target {servers[dst].url}")
        assert f"-> {servers[dst].url}" in moved
        assert store_holders(servers, vid) == [dst]
        assert reads(client, fids)
        more = {put(pkg, client, vid, 100, blob(1400, 500)): blob(1400, 500)}
        assert reads(client, more)  # thawed on the destination
        again = run(pkg, env, f"volume.move -volumeId {vid} -target {servers[dst].url}")
        assert "already on" in again
        with pytest.raises(S.ShellError, match="unknown node") as e:
            run(pkg, env, f"volume.move -volumeId {vid} -target 127.0.0.1:1")
        return {"out": [mask(t, servers) for t in (moved, again)], "error": mask(str(e.value)),
                "src": src, "dst": dst}


def test_volume_move_to_named_node(tmp_path, monkeypatch):
    twin(_volume_move_to_named_node, tmp_path, monkeypatch)


def _collection_delete(pkg, root):
    with shell_cluster(pkg, root) as (master, servers, client, env):
        trash = upload_some(pkg, client, n=1, size=300, seed=15, collection="trash")
        keep = upload_some(pkg, client, n=1, size=300, seed=16)
        run(pkg, env, "lock")
        dry = run(pkg, env, "collection.delete -collection trash")
        assert "would delete" in dry
        assert reads(client, trash)
        forced = run(pkg, env, "collection.delete -collection trash -force")
        assert "removed" in forced
        wait_for(lambda: not any(v.get("collection") == "trash" for n in env.topology_nodes()
                                 for v in n.get("volumes", [])), msg="trash gone")
        assert reads(client, keep)
        with pytest.raises(Exception):
            client.read(next(iter(trash)))
        return [mask(dry, servers), mask(forced, servers)]


def test_collection_delete(tmp_path, monkeypatch):
    twin(_collection_delete, tmp_path, monkeypatch)


def _volume_delete_empty(pkg, root):
    with shell_cluster(pkg, root) as (master, servers, client, env):
        fids = upload_some(pkg, client, n=1, size=200, seed=17)
        fid = next(iter(fids))
        vid = vid_of(fid)

        def live():  # the heartbeat-reported live needles, as deleteEmpty reads them
            return [int(v.get("file_count", 0)) - int(v.get("delete_count", 0))
                    for n in env.topology_nodes() for v in n.get("volumes", [])
                    if int(v["id"]) == vid]

        wait_for(lambda: live() == [1], msg="heartbeat carries the file count")
        run(pkg, env, "lock")
        kept = run(pkg, env, "volume.deleteEmpty -force")
        assert f"removed {vid} from" not in kept
        assert holders_of(env, servers, vid)
        client.delete(fid)
        wait_for(lambda: live() == [0], msg="heartbeat carries the delete")
        dry = run(pkg, env, "volume.deleteEmpty")
        assert f"volume {vid} is empty" in dry
        removed = run(pkg, env, "volume.deleteEmpty -force")
        assert f"removed {vid} from" in removed
        wait_for(lambda: not holders_of(env, servers, vid), msg="the empty volume gone")
        return [mask(t, servers) for t in (kept, dry, removed)]


def test_volume_delete_empty(tmp_path, monkeypatch):
    twin(_volume_delete_empty, tmp_path, monkeypatch)


def _volume_configure_replication(pkg, root):
    S = sh(pkg).shell
    with shell_cluster(pkg, root) as (master, servers, client, env):
        fids = upload_some(pkg, client, n=1, size=100, seed=18)
        vid = vid_of(next(iter(fids)))
        run(pkg, env, "lock")
        out = run(pkg, env, f"volume.configure.replication -volumeId {vid} -replication 001")
        assert "replication -> 001" in out
        (i,) = store_holders(servers, vid)
        assert str(servers[i].store.get_volume(vid).super_block.replica_placement) == "001"
        wait_for(lambda: any(v.get("replica_placement") == "001" for n in env.topology_nodes()
                             for v in n.get("volumes", []) if int(v["id"]) == vid),
                 msg="the heartbeat carries the new placement")
        with pytest.raises(S.ShellError, match="no matching volumes") as e:
            run(pkg, env, "volume.configure.replication -volumeId 9999 -replication 010")
        with open(servers[i].store.get_volume(vid).base_path + ".dat", "rb") as f:
            super_block = f.read(8)
        return {"out": mask(out, servers), "error": str(e.value), "super_block": super_block}


def test_volume_configure_replication(tmp_path, monkeypatch):
    twin(_volume_configure_replication, tmp_path, monkeypatch)


def _replicated(pkg, client, servers, data):
    """A needle with a fixed fid on a fresh 001 (two-copy) volume."""
    vid = vid_of(client.assign(replication="001").fid)
    fid = put(pkg, client, vid, 1, data)
    wait_for(lambda: len(store_holders(servers, vid)) == 2, msg="two replicas")
    return vid, fid, store_holders(servers, vid)


def _check_disk_detects_and_fixes(pkg, root):
    with shell_cluster(pkg, root) as (master, servers, client, env):
        vid, fid, holders = _replicated(pkg, client, servers, b"sync me" * 50)
        lone = f"{vid},deadbeef01020304"
        env.vs_call(servers[holders[0]].grpc_address, "WriteNeedle",
                    {"fid": lone, "data": base64.b64encode(b"lone needle").decode()})
        run(pkg, env, "lock")
        found = run(pkg, env, f"volume.check.disk -volumeId {vid}")
        assert "missing 1 needles" in found and "0 needles synced" in found
        fixed = run(pkg, env, f"volume.check.disk -volumeId {vid} -fix")
        assert "1 needles synced" in fixed
        for h in holders:
            n = servers[h].store.read_needle(vid, 0xDEADBEEF)
            assert n.data == b"lone needle" and n.cookie == 0x01020304
        clean = run(pkg, env, f"volume.check.disk -volumeId {vid}")
        assert "0 divergent" in clean
        return [mask(t, servers) for t in (found, fixed, clean)]


def test_volume_check_disk_detects_and_fixes(tmp_path, monkeypatch):
    twin(_check_disk_detects_and_fixes, tmp_path, monkeypatch)


def _evacuate_and_leave(pkg, root):
    with shell_cluster(pkg, root) as (master, servers, client, env):
        fids = upload_some(pkg, client, n=20, size=600, seed=20)
        vid = vid_of(next(iter(fids)))
        run(pkg, env, "lock")
        run(pkg, env, f"ec.encode -volumeId {vid} -force")
        wait_for(lambda: not holders_of(env, servers, vid), msg="the encode's cut-over")
        victim = next(n for n in env.topology_nodes() if n.get("volumes") or n.get("ec_shards"))
        dry = run(pkg, env, f"volumeServer.evacuate -node {victim['url']} -noApply")
        assert "dry" in dry
        done = run(pkg, env, f"volumeServer.evacuate -node {victim['url']}")
        assert "volumeServer.evacuate:" in done

        def emptied():
            after = next(n for n in env.topology_nodes() if n["url"] == victim["url"])
            return not after.get("volumes") and not after.get("ec_shards")

        wait_for(emptied, msg="the evacuated node empty")
        assert reads(client, fids)
        left = run(pkg, env, f"volumeServer.leave -node {victim['url']}")
        assert "left the cluster" in left
        wait_for(lambda: all(n["url"] != victim["url"] for n in env.topology_nodes()),
                 msg="the node gone from the topology")
        return [mask(t, servers) for t in (dry, done, left)]


def test_volume_server_evacuate_and_leave(tmp_path, monkeypatch):
    twin(_evacuate_and_leave, tmp_path, monkeypatch)


def _check_disk_propagates_deletes(pkg, root):
    with shell_cluster(pkg, root) as (master, servers, client, env):
        vid, fid, holders = _replicated(pkg, client, servers, b"doomed" * 30)
        env.vs_call(servers[holders[0]].grpc_address, "DeleteNeedle", {"fid": fid})
        nid = int(fid.split(",", 1)[1][:-8], 16)
        assert servers[holders[1]].store.get_volume(vid).nm.get(nid) is not None
        run(pkg, env, "lock")
        found = run(pkg, env, f"volume.check.disk -volumeId {vid}")
        assert "outlived its delete" in found
        fixed = run(pkg, env, f"volume.check.disk -volumeId {vid} -fix")
        assert "1 needles synced" in fixed
        for h in holders:
            assert servers[h].store.get_volume(vid).nm.get(nid) is None
        clean = run(pkg, env, f"volume.check.disk -volumeId {vid}")
        assert "0 divergent" in clean
        return [mask(t, servers) for t in (found, fixed, clean)]


def test_volume_check_disk_propagates_deletes(tmp_path, monkeypatch):
    twin(_check_disk_propagates_deletes, tmp_path, monkeypatch)


def _rewrite_after_delete_wins(pkg, root):
    with shell_cluster(pkg, root) as (master, servers, client, env):
        vid, fid, holders = _replicated(pkg, client, servers, b"first life" * 20)
        nid = int(fid.split(",", 1)[1][:-8], 16)
        client.delete(fid)
        env.vs_call(servers[holders[0]].grpc_address, "WriteNeedle",
                    {"fid": fid, "data": base64.b64encode(b"second life").decode()})
        run(pkg, env, "lock")
        fixed = run(pkg, env, f"volume.check.disk -volumeId {vid} -fix")
        assert "1 needles synced" in fixed and "outlived" not in fixed
        for h in holders:
            assert servers[h].store.read_needle(vid, nid).data == b"second life"
        return mask(fixed, servers)


def test_volume_check_disk_rewrite_after_delete_wins(tmp_path, monkeypatch):
    twin(_rewrite_after_delete_wins, tmp_path, monkeypatch)


def _volume_grow(pkg, root):
    with shell_cluster(pkg, root) as (master, servers, client, env):
        run(pkg, env, "lock")
        before = sum(len(n.get("volumes", [])) for n in env.topology_nodes())
        out = run(pkg, env, "volume.grow -count 3 -collection grown")
        assert "3 volumes created" in out

        def grown():
            return sorted((int(v["id"]), n["url"]) for n in env.topology_nodes()
                          for v in n.get("volumes", []) if v.get("collection") == "grown")

        wait_for(lambda: len(grown()) == 3, msg="three grown volumes listed")
        after = sum(len(n.get("volumes", [])) for n in env.topology_nodes())
        assert after >= before + 3
        vid = vid_of(client.assign(collection="grown").fid)
        fid = put(pkg, client, vid, 1, b"to a pre-grown volume")
        assert client.read(fid) == b"to a pre-grown volume"
        return {"out": mask(out, servers), "grown": mask(str(grown()), servers)}


def test_volume_grow(tmp_path, monkeypatch):
    twin(_volume_grow, tmp_path, monkeypatch)


def _unmount_and_mount(pkg, root):
    with shell_cluster(pkg, root) as (master, servers, client, env):
        fids = upload_some(pkg, client, n=1, size=80, seed=23)
        vid = vid_of(next(iter(fids)))
        (h,) = store_holders(servers, vid)
        holder = servers[h]
        run(pkg, env, "lock")
        unmounted = run(pkg, env, f"volume.unmount -volumeId {vid} -node {holder.url}")
        assert "volume.unmount" in unmounted
        assert holder.store.get_volume(vid) is None
        wait_for(lambda: not holders_of(env, servers, vid), msg="dropped from the topology")
        dat = sorted(p for loc in holder.store.locations for p in os.listdir(loc.directory)
                     if p.endswith(".dat"))
        assert dat
        mounted = run(pkg, env, f"volume.mount -volumeId {vid} -node {holder.url}")
        assert "volume.mount" in mounted
        assert reads(client, fids)
        return {"out": [mask(unmounted, servers), mask(mounted, servers)], "dat": dat}


def test_volume_unmount_and_mount(tmp_path, monkeypatch):
    twin(_unmount_and_mount, tmp_path, monkeypatch)


def _orphans_after_cutoff(pkg, root, mp):
    """fsck's orphan dating (its pure part): chunked VolumeNeedleTs calls,
    a post-cutoff copy on any replica spares the needle, undatable ids
    come back apart, a dead holder fails fast."""
    cv = sh(pkg).cv
    mp.setattr(cv, "_NEEDLE_TS_CHUNK", 3)
    cutoff = 1000
    nids = list(range(1, 11))
    calls = []

    class Env:
        def vs_call(self, addr, method, req, timeout=300):
            assert method == "VolumeNeedleTs"
            chunk = req["needle_ids"]
            assert len(chunk) <= 3
            calls.append((addr, tuple(chunk)))
            if addr.startswith("down"):
                raise ConnectionError("holder down")
            if 7 in chunk and addr.startswith("flaky"):
                raise ConnectionError("mid-volume failure")
            return {"ts": {str(n): 2000 if n in (2, 7) else 10 for n in chunk}}

    holders = [{"url": "a:80", "grpc_port": 1}, {"url": "down:80", "grpc_port": 1}]
    fresh, undatable = cv._orphans_after_cutoff(Env(), holders, 5, nids, cutoff)
    assert fresh == {2, 7} and undatable == set()
    assert calls == [("a:1", (1, 2, 3)), ("a:1", (4, 5, 6)), ("a:1", (7, 8, 9)),
                     ("a:1", (10,)), ("down:1", (1, 2, 3))]
    all_down = cv._orphans_after_cutoff(Env(), [{"url": "down:80", "grpc_port": 1}], 5, nids,
                                        cutoff)
    assert all_down == (set(), set(nids))
    calls.clear()
    flaky = cv._orphans_after_cutoff(Env(), [{"url": "flaky:80", "grpc_port": 1}], 5, nids,
                                     cutoff)
    assert flaky == ({2}, {7, 8, 9, 10})
    mp.undo()
    assert cv._NEEDLE_TS_CHUNK == 65536
    return {"first": (fresh, undatable), "down": all_down, "flaky": flaky, "calls": calls}


def test_orphans_after_cutoff_chunks_and_classifies(tmp_path, monkeypatch):
    twin(_orphans_after_cutoff, tmp_path, monkeypatch, mp=pytest.MonkeyPatch())
