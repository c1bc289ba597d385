"""The port's fleet repair scheduler (`seaweedfs_tpu_torch/ec/fleet.py`) and
the master's repair hooks against the reference's: twins of
`tests/test_fleet.py`'s queue, scan, report, lookup, status and scheduler
cases (its placement and batch-RPC cases are twinned in
`test_torch_master.py` and `test_torch_volume_server.py`). Each runs the
reference case's assertions on both packages with the same inputs and
requires the popped orders, the ranked queue, the redundancy histogram,
the dispatched order with its missing counts, each batch's block order
and the rebuilt shard bytes to be equal (tolerance 0). Also the six
scheduler knobs read against the reference's registry."""

import os
import random
import shutil
import threading
import time

import pytest

from seaweedfs_tpu.ec import fleet as ref_fleet
from seaweedfs_tpu.ec.shard_bits import EcVolumeInfo as RefEcVolumeInfo
from seaweedfs_tpu.ec.shard_bits import ShardBits as RefShardBits
from seaweedfs_tpu.pb import Heartbeat as RefHeartbeat
from seaweedfs_tpu.utils import config as ref_config
from seaweedfs_tpu_torch.ec import fleet as port_fleet
from seaweedfs_tpu_torch.ec.shard_bits import EcVolumeInfo as PortEcVolumeInfo
from seaweedfs_tpu_torch.ec.shard_bits import ShardBits as PortShardBits
from seaweedfs_tpu_torch.pb import Heartbeat as PortHeartbeat
from seaweedfs_tpu_torch.utils import config as port_config

from test_torch_cluster import PORT, stop_all, strip, twin, wait_for
from test_torch_master import RAWS, _read
from test_torch_volume_server import build_ec_volume

FLEET = {"ref": ref_fleet, "port": port_fleet}
HB = {"ref": (RefHeartbeat, RefEcVolumeInfo, RefShardBits),
      "port": (PortHeartbeat, PortEcVolumeInfo, PortShardBits)}


# -- RepairQueue (test_fleet.py:47-101) ----------------------------------------------------


def _drain(q) -> list:
    out = []
    while (got := q.pop()) is not None:
        out.append(got)
    return out


def _queue_orders(pkg, root):
    Q = FLEET[pkg.name].RepairQueue
    q = Q()
    q.update(1, Q.priority(1, 500, 1, 1))
    q.update(2, Q.priority(2, 10, 0, 2))
    q.update(3, Q.priority(1, 900, 0, 3))
    q.update(4, Q.priority(1, 500, 3, 4))
    order = _drain(q)
    assert [v for v, _ in order] == [2, 3, 4, 1]
    return order


def test_queue_orders_by_redundancy_then_size_then_exposure(tmp_path, monkeypatch):
    twin(_queue_orders, tmp_path, monkeypatch)


def _queue_concurrent(pkg, root):
    Q = FLEET[pkg.name].RepairQueue
    q = Q()
    rng = random.Random(11)
    items = [(vid, rng.choice([1, 2]), rng.randrange(1, 1000)) for vid in range(400)]

    def push(chunk):
        for vid, missing, size in chunk:
            q.update(vid, Q.priority(missing, size, 0, vid))

    threads = [threading.Thread(target=push, args=(items[i::8],)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    popped = _drain(q)
    assert len(popped) == 400
    missing = [-p[0] for _, p in popped]
    assert missing == sorted(missing, reverse=True)
    return popped


def test_queue_concurrent_enqueue_pops_2_missing_strictly_first(tmp_path, monkeypatch):
    twin(_queue_concurrent, tmp_path, monkeypatch)


def _queue_rerank(pkg, root):
    Q = FLEET[pkg.name].RepairQueue
    q = Q()
    q.update(7, Q.priority(1, 100, 0, 7))
    q.update(8, Q.priority(2, 100, 0, 8))
    q.update(7, Q.priority(2, 100, 0, 7))
    assert q.peek_class() == 2
    first, second = q.pop(), q.pop()
    assert {first[0], second[0]} == {7, 8}
    assert -first[1][0] == 2 and -second[1][0] == 2
    assert q.pop() is None and q.peek_class() is None
    return [first, second]


def test_queue_rerank_on_second_failure_mid_storm(tmp_path, monkeypatch):
    twin(_queue_rerank, tmp_path, monkeypatch)


def _queue_discard(pkg, root):
    Q = FLEET[pkg.name].RepairQueue
    q = Q()
    assert q.update(1, Q.priority(1, 1, 0, 1)) is True
    assert q.update(1, Q.priority(1, 1, 0, 1)) is False  # unchanged: no new entry
    assert q.members() == {1: Q.priority(1, 1, 0, 1)}
    q.discard(1)
    assert q.pop() is None and len(q) == 0
    return q.members()


def test_queue_discard_and_completion(tmp_path, monkeypatch):
    twin(_queue_discard, tmp_path, monkeypatch)


# -- the scheduler without a live cluster (test_fleet.py:381-440) --------------------------


def _hb(pkg, url_port, grpc_port, rack, ec=None):
    Heartbeat = HB[pkg.name][0]
    return Heartbeat(ip="127.0.0.1", port=url_port, grpc_port=grpc_port, rack=rack,
                     data_center="dc", max_volume_count=30, ec_shards=list(ec or []))


def _ec_info(pkg, vid, sids, shard_size=1000):
    _, EcVolumeInfo, ShardBits = HB[pkg.name]
    return EcVolumeInfo(volume_id=vid, shard_bits=ShardBits.from_ids(sids),
                        shard_size=shard_size, data_shards=10, total_shards=14).to_dict()


def quiet_master(pkg):
    """A master with the scheduler attached by hand (the knob is off): its
    loops not started, scan()/status() driven by the case."""
    m = pkg.MasterServer(port=0, reap_interval=3600, http_port=None)
    m.repair = FLEET[pkg.name].RepairScheduler(
        m, max_inflight=1, batch=4, scan_interval=60.0, settle=0.0, dead_after=0.2)
    m.topology.on_ec_shrink = m.repair.kick
    return m


def _status(m) -> dict:
    """RepairStatus without ages (timings)."""
    st = m.repair.status()
    return strip({**st, "events": [{k: v for k, v in e.items() if k != "age_s"}
                                   for e in st["events"]]})


def _scan_ranks(pkg, root):
    m = quiet_master(pkg)
    try:
        m.topology.process_heartbeat(_hb(pkg, 8001, 9001, "r1", ec=[
            _ec_info(pkg, 5, [13]), _ec_info(pkg, 6, [12, 13], 9000)]))
        m.topology.process_heartbeat(_hb(pkg, 8002, 9002, "r2", ec=[
            _ec_info(pkg, 5, list(range(7))), _ec_info(pkg, 6, list(range(7)))]))
        m.topology.process_heartbeat(_hb(pkg, 8003, 9003, "r3", ec=[
            _ec_info(pkg, 5, list(range(7, 13))), _ec_info(pkg, 6, list(range(7, 12)))]))
        assert m.repair.scan() == 0
        m.topology.unregister_node("127.0.0.1:8001")
        assert m.repair.scan() == 2
        members = m.repair.queue.members()
        first, second = m.repair.queue.pop(), m.repair.queue.pop()
        assert first[0] == 6 and -first[1][0] == 2
        assert second[0] == 5 and -second[1][0] == 1
        st = _status(m)
        assert st["redundancy_histogram"] == {"1": 1, "2": 1}
        return {"members": members, "popped": [first, second], "status": st}
    finally:
        m._server.stop()


def test_scan_enumerates_and_ranks_after_holder_death(tmp_path, monkeypatch):
    twin(_scan_ranks, tmp_path, monkeypatch)


def _scan_lost(pkg, root):
    m = quiet_master(pkg)
    try:
        m.topology.process_heartbeat(_hb(pkg, 8001, 9001, "r1", ec=[
            _ec_info(pkg, 9, list(range(9)))]))
        m.repair.scan()
        assert len(m.repair.queue) == 0
        m.repair.scan()  # one LOST event per episode, not one per scan
        st = _status(m)
        lost = [e for e in st["events"] if e["state"] == "lost"]
        assert [e["volume_id"] for e in lost] == [9]
        return st
    finally:
        m._server.stop()


def test_scan_marks_unrecoverable_stripes_lost(tmp_path, monkeypatch):
    twin(_scan_lost, tmp_path, monkeypatch)


def _reports_confirm(pkg, root):
    m = quiet_master(pkg)
    try:
        m.topology.process_heartbeat(_hb(pkg, 8001, 9001, "r1", ec=[_ec_info(pkg, 5, [13])]))
        m.topology.process_heartbeat(_hb(pkg, 8002, 9002, "r2", ec=[
            _ec_info(pkg, 5, list(range(13)))]))
        m.repair.note_reports("127.0.0.1:8002", ["127.0.0.1:9001"])
        m.repair.scan()
        assert len(m.repair.queue) == 0
        with m.topology._lock:
            m.topology.nodes["127.0.0.1:8001"].last_seen -= 1.0
        m.repair.scan()
        assert len(m.repair.queue) == 1
        st = m.repair.status()
        assert st["suspects"] == ["127.0.0.1:9001"]
        # the silent, reported holder was expelled from the topology
        assert "127.0.0.1:8001" not in m.topology.nodes
        return {"members": m.repair.queue.members(), "suspects": st["suspects"],
                "histogram": st["redundancy_histogram"]}
    finally:
        m._server.stop()


def test_reports_plus_heartbeat_silence_confirm_death(tmp_path, monkeypatch):
    twin(_reports_confirm, tmp_path, monkeypatch)


def _lookup_annotates(pkg, root):
    m = quiet_master(pkg)
    try:
        m.topology.process_heartbeat(_hb(pkg, 8001, 9001, "rackA", ec=[_ec_info(pkg, 5, [0])]))
        resp = m._rpc_lookup_ec({"volume_id": 5}, None)
        loc = resp["shard_id_locations"][0]["locations"][0]
        assert loc["rack"] == "rackA" and loc["data_center"] == "dc"
        return resp
    finally:
        m._server.stop()


def test_master_lookup_annotates_rack_and_dc(tmp_path, monkeypatch):
    twin(_lookup_annotates, tmp_path, monkeypatch)


def _status_disabled(pkg, root):
    m = pkg.MasterServer(port=0, reap_interval=3600, http_port=None)
    try:
        assert m.repair is None
        st = m._rpc_repair_status({}, None)
        assert st["enabled"] is False and st["queue_depth"] == 0
        return st
    finally:
        m._server.stop()


def test_repair_status_rpc_disabled_shape(tmp_path, monkeypatch):
    twin(_status_disabled, tmp_path, monkeypatch)


def _status_enabled(pkg, root, mp):
    """WEEDTPU_REPAIR=on: the master builds the scheduler from the knobs,
    hooks the topology's shrink signal, and RepairStatus answers its view."""
    mp.setenv("WEEDTPU_REPAIR", "on")
    mp.setenv("WEEDTPU_REPAIR_BATCH", "3")
    m = pkg.MasterServer(port=0, reap_interval=3600, http_port=None)
    try:
        assert isinstance(m.repair, FLEET[pkg.name].RepairScheduler)
        assert m.topology.on_ec_shrink == m.repair.kick
        assert (m.repair.batch, m.repair.max_inflight, m.repair.settle) == (3, 2, 2.0)
        st = m._rpc_repair_status({}, None)
        assert st["enabled"] is True
        return st
    finally:
        m._server.stop()


def test_master_with_fleet_repair_builds_the_scheduler(tmp_path, monkeypatch):
    twin(_status_enabled, tmp_path, monkeypatch, mp=monkeypatch)


def _follower_holds_its_queue(pkg, root, mp):
    """WEEDTPU_REPAIR=on on a master of a quorum it cannot lead (its two
    peers never answer): the scheduler runs and keeps its queue, as every
    master does, but never takes a batch, since only the leader
    dispatches."""
    mp.setenv("WEEDTPU_REPAIR", "on")
    mp.setenv("WEEDTPU_REPAIR_SETTLE_S", "0")
    out = {}
    for role, peers in (("follower", ["127.0.0.1:1", "127.0.0.1:2"]), ("single", None)):
        m = pkg.MasterServer(port=0, reap_interval=3600, http_port=None, peers=peers,
                             election_timeout=(0.25, 0.5))
        taken = []
        m.repair._next_batch = lambda: taken.append(1)  # records a dispatch, takes nothing
        m.repair.scan = lambda: 0  # the queued stripe is not in the topology: keep it
        m.start()
        try:
            m.repair.queue.update(5, m.repair.queue.priority(2, 1 << 20, 1, 5))
            m.repair.kick("test")
            if role == "follower":
                time.sleep(1.5)  # the dispatch loop re-checks leadership every second
                assert not m.is_leader and m.raft.term >= 1  # it campaigned, and lost
                assert taken == [] and len(m.repair.queue) == 1
            else:
                wait_for(lambda: taken, msg="the single master to dispatch")
            out[role] = {"leader": m.is_leader, "took": bool(taken),
                         "queued": len(m.repair.queue),
                         "enabled": m._rpc_repair_status({}, None)["enabled"]}
        finally:
            m.stop()
    return out


def test_master_with_fleet_repair_and_peers_still_raises(tmp_path, monkeypatch):
    twin(_follower_holds_its_queue, tmp_path, monkeypatch, mp=monkeypatch)


# -- the scheduler end to end (test_fleet.py:479, :679) -----------------------------------


def repair_cluster(pkg, root, mp):
    """A master with the live scheduler and three rack-labelled servers."""
    mp.setenv("WEEDTPU_REPAIR", "on")
    mp.setenv("WEEDTPU_REPAIR_MAX_INFLIGHT", "1")
    mp.setenv("WEEDTPU_REPAIR_SETTLE_S", "0.3")
    mp.setenv("WEEDTPU_REPAIR_SCAN_S", "0.5")
    master = pkg.MasterServer(port=0, reap_interval=3600)
    master.start()
    servers = []
    for i in range(3):
        d = root / f"srv{i}"
        d.mkdir()
        vs = pkg.VolumeServer([str(d)], master.address, heartbeat_interval=0.3, rack=f"r{i}",
                              encoder=pkg.encoder())
        vs.start()
        servers.append(vs)
    return master, servers


def _scheduler_end_to_end(pkg, root, mp):
    master, servers = repair_cluster(pkg, root, mp)
    victim = servers[0]
    try:
        layout = {
            21: {0: [13], 1: list(range(7)), 2: list(range(7, 13))},
            22: {0: [12, 13], 1: list(range(7)), 2: list(range(7, 12))},
        }
        golden = {}
        for vid in layout:
            base, golden[vid] = build_ec_volume(pkg, root / "stage", vid=vid, size=140_000,
                                                seed=vid)
            for i, vs in enumerate(servers):
                dst = os.path.join(vs.store.locations[0].directory, str(vid))
                for s in layout[vid][i]:
                    os.replace(pkg.stripe.shard_file_name(base, s),
                               pkg.stripe.shard_file_name(dst, s))
                for ext in (".ecx", ".eci"):
                    shutil.copy(base + ext, dst + ext)
                vs.store.mount_ec_volume(vid, dst)
                vs.heartbeat_once()
        wait_for(lambda: all(len(master.topology.lookup_ec_shards(v)) == 14 for v in layout),
                 msg="registry complete")
        victim.stop()  # LeaveCluster -> unregister -> on_ec_shrink kick
        wait_for(lambda: all(len(master.topology.lookup_ec_shards(v)) == 14 for v in layout),
                 timeout=60.0, msg="scheduler repaired both volumes")
        # the registry can list a rebuilt shard (its holder's heartbeat)
        # before the scheduler records the batch done: wait for both records
        wait_for(lambda: {e["volume_id"] for e in master.repair.status()["events"]
                          if e["state"] == "done"} >= set(layout),
                 timeout=60.0, msg="scheduler recorded both repairs done")
        st = master.repair.status()
        events = sorted(st["events"], key=lambda e: e["seq"])
        dispatched = [(e["volume_id"], e["missing"]) for e in events
                      if e["state"] == "dispatched"]
        assert dispatched[:2] == [(22, 2), (21, 1)], dispatched
        assert any(e["state"] == "done" for e in events)
        assert st["batches"]
        for b in st["batches"]:
            assert b["dispatch_groups"] == 1
            assert b["volumes"] == len(b["block_order"]) == len(b["block_missing"])
            assert b["block_missing"] == sorted(b["block_missing"], reverse=True)
            assert b["wall_s"] > 0 and b["age_s"] >= 0
        assert st["fused_volumes_total"] == sum(b["volumes"] for b in st["batches"])
        rebuilt = {}
        for vid, lost in ((21, [13]), (22, [12, 13])):
            holders = master.topology.lookup_ec_shards(vid)
            assert sorted(holders) == list(range(14))
            for s in lost:
                (node,) = holders[s]
                vs = next(v for v in servers[1:] if v.url == node.url)
                with open(pkg.stripe.shard_file_name(vs._base_path_for(vid), s), "rb") as f:
                    rebuilt[(vid, s)] = f.read()
                assert rebuilt[(vid, s)] == golden[vid][s]
        # the target each batch landed on, by server index
        index = {vs.grpc_address: i for i, vs in enumerate(servers)}
        batches = [{"target": index[b["target"]], "volumes": b["volumes"],
                    "block_order": b["block_order"], "block_missing": b["block_missing"],
                    "signature_groups": b["signature_groups"]} for b in st["batches"]]
        states = [(e["volume_id"], e["missing"], e["state"]) for e in events]
        return {"dispatched": dispatched, "states": states, "batches": batches,
                "fused": st["fused_volumes_total"], "rebuilt": rebuilt}
    finally:
        stop_all([vs for vs in servers[1:]] + [master])


def test_scheduler_end_to_end_two_missing_first(tmp_path, monkeypatch):
    """Kill the holder of {1 shard of volume 21, 2 of volume 22}: 22's
    repair is dispatched first, both rebuild onto survivors, the registry
    converges to 14; the same events, batches and shard bytes on both."""
    twin(_scheduler_end_to_end, tmp_path, monkeypatch, mp=monkeypatch)


def _unreachable_peer_report(pkg, root, mp):
    master, servers = repair_cluster(pkg, root, mp)
    try:
        vs = servers[0]
        for _ in range(int(os.environ.get("WEEDTPU_REPAIR_REPORT_FAILURES", "3"))):
            vs._note_peer_failure("127.0.0.1:59999")
        assert "127.0.0.1:59999" in vs._unreachable_peers()
        vs.heartbeat_once()
        suspects = master.repair.status()["suspects"]
        assert "127.0.0.1:59999" in suspects
        vs._note_peer_success("127.0.0.1:59999")
        assert "127.0.0.1:59999" not in vs._unreachable_peers()
        return suspects
    finally:
        stop_all([*servers, master])


def test_unreachable_peer_report_rides_heartbeat(tmp_path, monkeypatch):
    twin(_unreachable_peer_report, tmp_path, monkeypatch, mp=monkeypatch)


def test_backoff_requeues_with_exponential_delay():
    """A refused dispatch (RESOURCE_EXHAUSTED) keeps the stripe's rank and
    backs off exponentially, capped at 12x the base: the same sequence of
    delays and events on both packages."""
    out = {}
    for name, fleet in FLEET.items():
        class _M:
            topology = None
        s = fleet.RepairScheduler(_M(), max_inflight=1, batch=1, scan_interval=60.0,
                                  settle=0.0, dead_after=1.0, backoff_base=0.5)
        prio = fleet.RepairQueue.priority(2, 100, 0, 7)
        delays = []
        for _ in range(6):
            t0 = time.monotonic()
            s._requeue([(7, prio, 2)], "RESOURCE_EXHAUSTED: busy", transient=True)
            delays.append(round(s._not_before[7] - t0, 1))
        s._requeue([(8, prio, 2)], "bad geometry", transient=False)
        events = [(e["volume_id"], e["state"], e["detail"]) for e in s._events]
        out[name] = {"delays": delays, "events": events, "members": s.queue.members()}
    assert out["port"] == out["ref"]
    assert out["port"]["delays"] == [0.5, 1.0, 2.0, 4.0, 6.0, 6.0]


# -- the six scheduler knobs ----------------------------------------------------------------

FLEET_KNOBS = ("WEEDTPU_REPAIR_MAX_INFLIGHT", "WEEDTPU_REPAIR_BATCH", "WEEDTPU_REPAIR_SCAN_S",
               "WEEDTPU_REPAIR_SETTLE_S", "WEEDTPU_REPAIR_DEAD_S", "WEEDTPU_REPAIR_BACKOFF")


@pytest.mark.parametrize("name", FLEET_KNOBS)
def test_fleet_knob_reads_as_the_reference(monkeypatch, name):
    for raw in RAWS:
        if raw is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, raw)
        assert _read(port_config, name) == _read(ref_config, name), (name, raw)
    assert port_config.ENV_REGISTRY[name].doc == ref_config.ENV_REGISTRY[name].doc
