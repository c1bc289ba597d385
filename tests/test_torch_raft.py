"""The port's raft quorum against the reference's: twins of all 9 tests in
`tests/test_raft.py`, each running the reference case's own steps and
assertions on three reference masters and on three port masters (volume
servers on the numpy backend and on `Encoder(10, 4, device="cpu")`), with
the reference's election timeout (0.25, 0.5) s and its 10 s wait for a
stable leader, and requiring what comes out to be equal; both packages
resuming each other's persisted `raft.<host_port>.json`, byte for byte;
and `python -m seaweedfs_tpu_torch master -peers a,b,c -raftDir D` forming
a quorum of three processes. All raft twins live in this one file, so
that under `--dist loadfile` they share one worker."""

import contextlib
import json
import os
import random
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

from seaweedfs_tpu.cluster import raft as ref_raft
from seaweedfs_tpu.shell import CommandEnv as RefCommandEnv
from seaweedfs_tpu_torch.cluster import raft as port_raft
from seaweedfs_tpu_torch.shell import CommandEnv as PortCommandEnv

from test_torch_cluster import PORT, REF, stop_all

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST = (0.25, 0.5)  # election timeout range, as the reference's tests use
RAFT = {"ref": ref_raft, "port": port_raft}
ENV = {"ref": RefCommandEnv, "port": PortCommandEnv}


def _wait_for_leader(masters, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        leaders = [m for m in masters if m.raft is not None and m.raft.is_leader]
        if len(leaders) == 1:
            if all(m.raft.leader == leaders[0].address for m in masters if m is not leaders[0]):
                return leaders[0]
        time.sleep(0.05)
    raise AssertionError("no stable leader elected")


@contextlib.contextmanager
def quorum(pkg, root):
    """Three masters of one package forming a raft quorum on loopback (the
    reference fixture: each master's RaftNode built once all addresses are
    known)."""
    masters = [pkg.MasterServer(port=0, reap_interval=3600, election_timeout=FAST)
               for _ in range(3)]
    addresses = [m.address for m in masters]
    for m in masters:
        m.raft = RAFT[pkg.name].RaftNode(
            me=m.address, peers=addresses, server=m._server, state_dir=str(root),
            election_timeout=FAST, payload_fn=m._raft_payload, apply_fn=m._raft_apply,
            on_leader=m._on_become_leader)
    for m in masters:
        m.start()
    try:
        yield masters
    finally:
        stop_all(masters)


def twin(scenario, tmp_path, **kw):
    """`scenario(pkg, root, **kw)` on the reference, then on the port: both
    results must be equal."""
    out = {}
    for pkg in (REF, PORT):
        root = tmp_path / pkg.name
        root.mkdir()
        out[pkg.name] = scenario(pkg, root, **kw)
    assert out["port"] == out["ref"]
    return out["port"]


# -- tests/test_raft.py twins ---------------------------------------------------------------


def _single_leader(pkg, root):
    with quorum(pkg, root) as masters:
        leader = _wait_for_leader(masters)
        states = sorted(m.raft.state for m in masters)
        assert states == ["follower", "follower", "leader"]
        assert leader.is_leader
        return {"states": states, "leader": leader.is_leader,
                "followers_redirect": [m._not_leader_response()["leader"] == leader.address
                                       for m in masters if m is not leader]}


def test_single_leader_elected(tmp_path):
    twin(_single_leader, tmp_path)


def _failover(pkg, root):
    with quorum(pkg, root) as masters:
        leader = _wait_for_leader(masters)
        old_term = leader.raft.term
        leader.stop()
        new_leader = _wait_for_leader([m for m in masters if m is not leader])
        assert new_leader is not leader
        assert new_leader.raft.term > old_term
        return {"new": new_leader is not leader, "term_grew": new_leader.raft.term > old_term}


def test_leader_failover_and_term_increase(tmp_path):
    twin(_failover, tmp_path)


def _assign_redirect(pkg, root):
    with quorum(pkg, root) as masters:
        leader = _wait_for_leader(masters)
        follower = next(m for m in masters if m is not leader)
        d = root / "vol"
        d.mkdir()
        vs = pkg.VolumeServer([str(d)], ",".join(m.address for m in masters),
                              heartbeat_interval=0.3, encoder=pkg.encoder())
        vs.start()
        try:
            # a client pointed only at a follower must find the leader
            client = pkg.MasterClient(follower.address)
            a1 = client.assign()
            assert a1.fid
            client.upload(a1.fid, b"ha payload")
            first = client.read(a1.fid)
            assert first == b"ha payload"
            client.close()
            # kill the leader; a quorum-aware client keeps working
            leader.stop()
            survivors = [m for m in masters if m is not leader]
            _wait_for_leader(survivors)
            client = pkg.MasterClient(",".join(m.address for m in survivors))
            deadline = time.monotonic() + 10
            a2 = None
            while time.monotonic() < deadline:
                try:
                    a2 = client.assign()
                    break
                except Exception:
                    time.sleep(0.2)
            assert a2 is not None and a2.fid
            assert a2.fid != a1.fid  # watermark continuity
            key1 = int(a1.fid.split(",")[1][:-8] or "0", 16)
            key2 = int(a2.fid.split(",")[1][:-8] or "0", 16)
            assert key2 > key1  # floored past the old leader's lease
            client.upload(a2.fid, b"after failover")
            second = client.read(a2.fid)
            assert second == b"after failover"
            client.close()
            return {"reads": [first, second], "key_grew": key2 > key1,
                    "vid_same": a1.fid.split(",")[0] == a2.fid.split(",")[0]}
        finally:
            vs.stop()


def test_assign_redirect_and_failover(tmp_path):
    twin(_assign_redirect, tmp_path)


def _partitioned(pkg, root):
    """A leader that cannot reach a quorum stops claiming leadership."""
    with quorum(pkg, root) as masters:
        leader = _wait_for_leader(masters)
        for c in leader.raft._clients.values():
            c.close()
        leader.raft._clients.clear()
        leader.raft.peers = ["127.0.0.1:1"]  # an unreachable blackhole
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and leader.raft.is_leader:
            time.sleep(0.05)
        assert not leader.raft.is_leader
        assert not leader.is_leader  # Assign would now redirect
        reply = leader._rpc_assign({"count": 1}, None)
        assert "not the raft leader" in reply["error"] and reply["count"] == 0
        return {"raft": leader.raft.is_leader, "master": leader.is_leader,
                "assign": {k: v for k, v in reply.items() if k != "leader"}}


def test_partitioned_leader_steps_down(tmp_path):
    twin(_partitioned, tmp_path)


def _term_persistence(pkg, root):
    rpc = pkg.rpc
    server = rpc.RpcServer(port=0)
    node = RAFT[pkg.name].RaftNode(me="127.0.0.1:1", peers=["127.0.0.1:1"], server=server,
                                   state_dir=str(root), election_timeout=FAST)
    node.term = 42
    node.voted_for = "127.0.0.1:9"
    node._save_state()
    server2 = rpc.RpcServer(port=0)
    node2 = RAFT[pkg.name].RaftNode(me="127.0.0.1:1", peers=["127.0.0.1:1"], server=server2,
                                    state_dir=str(root), election_timeout=FAST)
    assert node2.term == 42 and node2.voted_for == "127.0.0.1:9"
    return {"resumed": [node2.term, node2.voted_for],
            "file": (root / "raft.127.0.0.1_1.json").read_bytes(),
            "files": sorted(os.listdir(root))}


def test_raft_term_persistence(tmp_path):
    twin(_term_persistence, tmp_path)


class FakeRaft:
    is_leader = True
    leader = None
    acks = False
    term = 3

    def replicate_now(self):
        return self.acks


def _lease_quorum(pkg, root):
    """A lease the quorum never acked is rolled back and the RPC fails; a
    quorum outage during a renewal restores the prior lease."""
    rpc = pkg.rpc
    m = pkg.MasterServer(port=0, reap_interval=3600, http_port=None)
    m._rng = random.Random(17)
    events = []
    try:
        m.raft = FakeRaft()
        with pytest.raises(rpc.RpcFault, match="not acknowledged by a master quorum") as ei:
            m._rpc_lease_admin_token(
                {"lock_name": "admin", "previous_token": 0, "client_name": "a"}, None)
        events.append(str(ei.value))
        assert m._admin_locks == {}, "failed lease must be rolled back"
        m.raft.acks = True
        resp = m._rpc_lease_admin_token(
            {"lock_name": "admin", "previous_token": 0, "client_name": "a"}, None)
        tok = int(resp["token"])
        assert tok
        with pytest.raises(rpc.RpcFault, match="held by a") as ei:
            m._rpc_lease_admin_token(
                {"lock_name": "admin", "previous_token": 0, "client_name": "b"}, None)
        events.append(str(ei.value))
        m.raft.acks = False
        with pytest.raises(rpc.RpcFault, match="not acknowledged") as ei:
            m._rpc_lease_admin_token(
                {"lock_name": "admin", "previous_token": tok, "client_name": "a"}, None)
        events.append(str(ei.value))
        assert m._admin_locks["admin"][0] == tok
        return {"token": tok, "events": events, "version": [m._lock_term, m._lock_seq],
                "payload_locks": sorted(m._raft_payload()["admin_locks"])}
    finally:
        m.raft = None
        m._server.stop()


def test_admin_lock_lease_requires_quorum_ack(tmp_path):
    twin(_lease_quorum, tmp_path)


def _seq_gated(pkg, root):
    """A stale or reordered payload never rolls the lock table back; the
    raft term dominates the seq, so a deposed leader's inflated seq never
    out-versions the new leader's table."""
    m = pkg.MasterServer(port=0, reap_interval=3600, http_port=None)
    seen = []
    try:
        fresh = {"max_volume_id": 0, "sequence": 0, "lock_seq": 5,
                 "admin_locks": {"admin": {"token": 42, "ttl_s": 30.0, "client": "holder"}}}
        stale = {"max_volume_id": 0, "sequence": 0, "lock_seq": 3, "admin_locks": {}}
        m._raft_apply(fresh)
        assert m._admin_locks["admin"][0] == 42
        m._raft_apply(stale)
        assert m._admin_locks["admin"][0] == 42, "stale payload rolled back the table"
        seen.append(sorted(m._admin_locks))
        newer = {"max_volume_id": 0, "sequence": 0, "lock_seq": 6, "admin_locks": {}}
        m._raft_apply(newer)
        assert "admin" not in m._admin_locks
        seen.append([m._lock_term, m._lock_seq])
        # the new leader's table, term 2 seq 1, against a deposed leader's
        # term 1 seq 9
        new_term = {"max_volume_id": 7, "sequence": 900, "lock_term": 2, "lock_seq": 1,
                    "admin_locks": {"admin": {"token": 77, "ttl_s": 30.0, "client": "new"}}}
        deposed = {"max_volume_id": 3, "sequence": 100, "lock_term": 1, "lock_seq": 9,
                   "admin_locks": {}}
        m._raft_apply(new_term)
        m._raft_apply(deposed)
        assert m._admin_locks["admin"][0] == 77, "a deposed leader's seq out-versioned the term"
        seen.append([m._lock_term, m._lock_seq, m.topology.max_volume_id,
                     m.sequencer.watermark >= 900])
        return seen
    finally:
        m._server.stop()


def test_admin_lock_apply_is_seq_gated(tmp_path):
    twin(_seq_gated, tmp_path)


def _lock_failover(pkg, root):
    """The shell's lock stays exclusive across a leader crash, and the
    holder's renewal keeps working against the new leader."""
    with quorum(pkg, root) as masters:
        leader = _wait_for_leader(masters)
        addresses = ",".join(m.address for m in masters)
        env = ENV[pkg.name](addresses, client_name="holder")
        env.lock()
        assert env.is_locked
        leader.stop()
        _wait_for_leader([m for m in masters if m is not leader])
        intruder = ENV[pkg.name](addresses, client_name="intruder")
        try:
            with pytest.raises(Exception, match="held by"):
                intruder.lock()
            renewed = env._renew_once()
            assert renewed, "holder lost the lock across failover"
            assert env.is_locked
            with pytest.raises(Exception, match="held by"):
                intruder.lock()
            return {"renewed": renewed, "locked": env.is_locked, "intruder": intruder.is_locked}
        finally:
            intruder.close()
            env._renew_stop and env._renew_stop.set()
            env.close()


def test_admin_lock_survives_leader_failover(tmp_path):
    twin(_lock_failover, tmp_path)


def _follower_http(pkg, root):
    """A follower's HTTP facade answers leader-only calls with
    {"error": ..., "Leader": addr}."""
    with quorum(pkg, root) as masters:
        leader = _wait_for_leader(masters)
        follower = next(m for m in masters if m is not leader)
        base = f"http://{follower.host}:{follower.http_port}"
        out = {}
        for path in ("/vol/grow?count=1", "/dir/assign?count=1"):
            with urllib.request.urlopen(base + path, timeout=10) as r:
                assert r.status == 200
                d = json.loads(r.read())
            assert d["Leader"] == leader.address and "not the raft leader" in d["error"]
            out[path] = sorted(d)
        with urllib.request.urlopen(base + "/cluster/status", timeout=10) as r:
            status = json.loads(r.read())
        out["status"] = {k: v == leader.address if k == "Leader" else v
                         for k, v in status.items() if k not in ("Peers",)}
        return out


def test_follower_http_names_leader_in_json(tmp_path):
    twin(_follower_http, tmp_path)


# -- either package resumes the other's raft state file ------------------------------------


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_raft_state_file_resumes_across_packages(tmp_path, writer, reader):
    """A term and vote one package persisted come back in the other, and the
    reader's next save writes the same bytes the writer's would."""
    pkgs = {"ref": REF, "port": PORT}
    me = "127.0.0.1:19333"
    server = pkgs[writer].rpc.RpcServer(port=0)
    node = RAFT[writer].RaftNode(me=me, peers=[me], server=server, state_dir=str(tmp_path),
                                 election_timeout=FAST)
    node.term, node.voted_for = 7, "127.0.0.1:19334"
    node._save_state()
    path = tmp_path / "raft.127.0.0.1_19333.json"
    written = path.read_bytes()
    server2 = pkgs[reader].rpc.RpcServer(port=0)
    node2 = RAFT[reader].RaftNode(me=me, peers=[me], server=server2, state_dir=str(tmp_path),
                                  election_timeout=FAST)
    assert (node2.term, node2.voted_for) == (7, "127.0.0.1:19334")
    node2._save_state()
    assert path.read_bytes() == written
    # a vote in a later term persists the same way in both packages
    resp = node2._rpc_request_vote({"term": 9, "candidate": "127.0.0.1:19335"}, None)
    assert resp["granted"] and resp["term"] == 9
    again = path.read_bytes()
    node._load_state()
    assert (node.term, node.voted_for) == (9, "127.0.0.1:19335")
    node._save_state()
    assert path.read_bytes() == again == json.dumps(
        {"term": 9, "voted_for": "127.0.0.1:19335"}).encode()


# -- the master command -------------------------------------------------------------------


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def test_master_command_forms_a_three_master_quorum(tmp_path):
    """`python -m seaweedfs_tpu_torch master -peers a,b,c -raftDir D` three
    times: one leader that all three name, each persisting its term under
    its raft directory; SIGTERM stops each with exit code 0."""
    ports = _free_ports(3)
    peers = ",".join(f"127.0.0.1:{p}" for p in ports)
    procs = []
    try:
        for i, p in enumerate(ports):
            d = tmp_path / f"m{i}"
            d.mkdir()
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "seaweedfs_tpu_torch", "master", "-port", str(p),
                 "-peers", peers, "-raftDir", str(d)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=str(tmp_path),
                env=dict(os.environ, PYTHONPATH=ROOT)))
        for proc in procs:
            line = proc.stdout.readline()
            assert "master listening on" in line, line + (proc.stderr.read() if proc.poll() else "")
        deadline = time.monotonic() + 30
        views = []
        while time.monotonic() < deadline:
            views = []
            for p in ports:
                try:
                    with PORT.rpc.RpcClient(f"127.0.0.1:{p}") as c:
                        views.append(c.call(PORT.MASTER_SERVICE, "RaftListClusterServers", {},
                                            timeout=2))
                except Exception:  # noqa: BLE001 — still starting
                    views.append({})
            leaders = {v.get("leader") for v in views}
            if len(leaders) == 1 and "" not in leaders and None not in leaders and \
                    sorted(v.get("state") for v in views) == ["follower", "follower", "leader"]:
                break
            time.sleep(0.1)
        else:
            raise AssertionError(f"no agreed leader: {views}")
        assert all(v["enabled"] and v["servers"] == sorted(peers.split(",")) for v in views)
        term = views[0]["term"]
        assert term >= 1
        for i, p in enumerate(ports):
            state = json.loads((tmp_path / f"m{i}" / f"raft.127.0.0.1_{p}.json").read_text())
            assert state["term"] >= 1
        for proc in procs:
            proc.send_signal(signal.SIGTERM)
        for proc in procs:
            assert proc.wait(timeout=30) == 0, proc.stderr.read()
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
            proc.stdout.close()
            proc.stderr.close()


def test_restarted_master_rejoins_as_a_follower_at_once(tmp_path):
    """A master stopped while volume servers keep dialing it (their
    heartbeats) and restarted on its address and raft directory hears the
    leader before its election timeout: it follows the same leader in the
    same term, deposing nobody, and a client addressed to it alone is
    answered within the port's 1 s reconnect cap (`rpc.RECONNECT_OPTIONS`).
    grpc backs a refused address off for up to two minutes, and every
    channel to that address shares the backoff, so without that cap and
    raft's fresh peer channels after a failed call (`RaftNode._fanout`) the
    restarted master campaigned and deposed the leader, and clients could
    not reach it (the reference keeps both faults)."""
    ports = _free_ports(3)
    addresses = [f"127.0.0.1:{p}" for p in ports]

    def master(i):
        d = tmp_path / f"raft{i}"
        d.mkdir(exist_ok=True)
        return PORT.MasterServer(port=ports[i], peers=addresses, raft_dir=str(d),
                                 reap_interval=3600, http_port=None, election_timeout=FAST)

    masters = [master(i) for i in range(3)]
    for m in masters:
        m.start()
    (tmp_path / "srv").mkdir()
    vs = PORT.VolumeServer([str(tmp_path / "srv")], ",".join(addresses),
                           heartbeat_interval=0.1, encoder=PORT.encoder())
    vs.start()
    stopped = []
    try:
        leader = _wait_for_leader(masters)
        term = leader.raft.term
        i = next(k for k, m in enumerate(masters) if m is not leader)
        masters[i].stop()
        stopped.append(masters[i])
        time.sleep(4.0)  # the heartbeats to it back off meanwhile
        back = master(i)
        assert back.raft.term == term  # resumed from its raft directory
        masters[i] = back
        back.start()
        deadline = time.monotonic() + 2.0
        while back.raft.leader != leader.address and time.monotonic() < deadline:
            time.sleep(0.02)
        assert back.raft.leader == leader.address and leader.raft.is_leader
        assert [m.raft.term for m in masters] == [term] * 3
        client = PORT.MasterClient(back.address)
        try:
            deadline = time.monotonic() + 2.0  # the reconnect cap is 1 s
            while True:
                try:
                    status = client.master_call("RaftListClusterServers", {}, timeout=1)
                    break
                except PORT.ClusterError:
                    assert time.monotonic() < deadline, "the restarted master stays unreachable"
                    time.sleep(0.05)
        finally:
            client.close()
        assert status["leader"] == leader.address and status["state"] == "follower"
    finally:
        vs.stop()
        stop_all([m for m in masters if m not in stopped])
