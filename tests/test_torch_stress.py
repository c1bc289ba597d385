"""The port's twin of `tests/test_stress.py`: hammer an in-process port
cluster (a master and two volume servers on `Encoder(10, 4,
device="cpu")`) from many threads at once and check integrity through the
real gRPC/HTTP stack: writers, readers and deleters; `ec.encode` under
reads; admin-lock contention, also on a three-master raft quorum, where
every grant is acknowledged by a quorum before it is handed out. Each test
is bounded (seconds)."""

import contextlib
import io
import os
import random
import threading

import pytest

from seaweedfs_tpu_torch.cluster.client import ClusterError, MasterClient
from seaweedfs_tpu_torch.cluster.master import MasterServer
from seaweedfs_tpu_torch.cluster.volume_server import VolumeServer
from seaweedfs_tpu_torch.ops.rs_codec import new_encoder
from seaweedfs_tpu_torch.shell import CommandEnv, run_command

from test_torch_cluster import stop_all, wait_for


@contextlib.contextmanager
def raft_quorum(root):
    """Three port masters forming a raft quorum on loopback, at the
    reference tests' election timeout."""
    from seaweedfs_tpu_torch.cluster.raft import RaftNode

    masters = [MasterServer(port=0, reap_interval=3600, election_timeout=(0.25, 0.5))
               for _ in range(3)]
    addresses = [m.address for m in masters]
    for m in masters:
        m.raft = RaftNode(me=m.address, peers=addresses, server=m._server, state_dir=str(root),
                          election_timeout=(0.25, 0.5), payload_fn=m._raft_payload,
                          apply_fn=m._raft_apply, on_leader=m._on_become_leader)
    for m in masters:
        m.start()
    try:
        # the reference tests' wait for one leader that every master names
        wait_for(lambda: sum(m.is_leader for m in masters) == 1 and len(
            {m.raft.leader for m in masters}) == 1, timeout=10.0, msg="a stable leader")
        yield masters
    finally:
        stop_all(masters)


@pytest.fixture
def cluster(tmp_path):
    master = MasterServer(port=0, reap_interval=3600)
    master.start()
    servers = []
    for i in range(2):
        d = tmp_path / f"srv{i}"
        d.mkdir()
        vs = VolumeServer(
            [str(d)], master.address, heartbeat_interval=0.4, max_volume_count=50,
            encoder=new_encoder(device="cpu"),
        )
        vs.start()
        servers.append(vs)
    client = MasterClient(master.address)
    yield master, servers, client
    client.close()
    for vs in servers:
        vs.stop()
    master.stop()


def _run_threads(workers, timeout=60):
    threads = [threading.Thread(target=w, daemon=True) for w in workers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
        assert not t.is_alive(), "stress worker hung"


def test_concurrent_writers_readers_deleters(cluster):
    """8 writer/reader/deleter threads against the same cluster: every
    surviving fid must read back byte-identical; deleted fids must 404;
    no wrong-content reads ever."""
    master, servers, client = cluster
    errors: list[str] = []
    written: dict[str, bytes] = {}
    deleted: set[str] = set()
    lock = threading.Lock()
    rng = random.Random(7)

    def writer(seed):
        r = random.Random(seed)
        c = MasterClient(master.address)
        try:
            for _ in range(25):
                data = os.urandom(r.randint(100, 8000))
                try:
                    res = c.submit(data)
                except ClusterError as e:
                    errors.append(f"submit: {e}")
                    continue
                with lock:
                    written[res.fid] = data
        finally:
            c.close()

    def reader():
        c = MasterClient(master.address)
        try:
            for _ in range(60):
                with lock:
                    if not written:
                        continue
                    fid, want = rng.choice(list(written.items()))
                    if fid in deleted:
                        continue
                try:
                    got = c.read(fid)
                except ClusterError:
                    with lock:
                        if fid not in deleted:
                            errors.append(f"read of live fid {fid} failed")
                    continue
                if got != want:
                    errors.append(f"WRONG CONTENT for {fid}")
        finally:
            c.close()

    def deleter():
        c = MasterClient(master.address)
        try:
            for _ in range(15):
                with lock:
                    candidates = [f for f in written if f not in deleted]
                    if not candidates:
                        continue
                    fid = rng.choice(candidates)
                    deleted.add(fid)  # claim BEFORE deleting: readers tolerate
                c.delete(fid)
        finally:
            c.close()

    _run_threads([lambda s=i: writer(s) for i in range(4)] + [reader] * 3 + [deleter])
    assert not errors, errors[:5]
    # final sweep: all survivors intact, all deleted gone
    for fid, want in written.items():
        if fid in deleted:
            with pytest.raises(ClusterError):
                client.read(fid)
        else:
            assert client.read(fid) == want, f"{fid} corrupted after stress"


def test_concurrent_ec_encode_and_reads(cluster):
    """EC-encode a volume WHILE readers hammer its blobs: reads must never
    return wrong bytes — before, during, or after the cut-over."""
    master, servers, client = cluster
    payloads = {}
    first = client.submit(os.urandom(4000))
    vid = int(first.fid.split(",")[0])
    payloads[first.fid] = client.read(first.fid)
    while len(payloads) < 15:
        a = client.assign()
        if int(a.fid.split(",")[0]) != vid:
            continue
        data = os.urandom(random.randint(500, 5000))
        client.upload(a.fid, data)
        payloads[a.fid] = data

    errors = []
    stop = threading.Event()

    def reader():
        c = MasterClient(master.address)
        try:
            while not stop.is_set():
                fid, want = random.choice(list(payloads.items()))
                try:
                    got = c.read(fid)
                except ClusterError:
                    continue  # transient during cut-over: retried next loop
                if got != want:
                    errors.append(f"WRONG CONTENT {fid} during ec.encode")
                    return
        finally:
            c.close()

    readers = [threading.Thread(target=reader, daemon=True) for _ in range(3)]
    for t in readers:
        t.start()
    env = CommandEnv(master.address, device="cpu")
    try:
        out = io.StringIO()
        run_command(env, "lock", out)
        run_command(env, f"ec.encode -volumeId {vid} -largeBlockSize 4096 -smallBlockSize 512", out)
    finally:
        stop.set()
        for t in readers:
            t.join(30)
        env.close()
    assert not errors, errors
    for fid, want in payloads.items():
        assert client.read(fid) == want, f"{fid} corrupted by concurrent encode"


@pytest.mark.parametrize("masters", ["single", "quorum"])
def test_concurrent_admin_lock_contention(cluster, tmp_path, masters):
    """N threads fight for the exclusive lock: at most one holds it at any
    instant (the invariant every mutating shell command relies on); on a
    three-master quorum the fighters name all three masters and follow the
    leader."""
    master, servers, client = cluster
    address = master.address
    quorum = None
    if masters == "quorum":
        quorum = contextlib.ExitStack()
        address = ",".join(m.address for m in quorum.enter_context(raft_quorum(tmp_path)))
    holders = {"current": 0, "max": 0}
    hlock = threading.Lock()
    acquired = {"n": 0}

    def fighter(i):
        env = CommandEnv(address, client_name=f"fighter-{i}", device="cpu")
        try:
            for _ in range(12):
                try:
                    env.lock()
                except Exception:
                    threading.Event().wait(0.03)  # holder active: back off, retry
                    continue
                with hlock:
                    holders["current"] += 1
                    holders["max"] = max(holders["max"], holders["current"])
                    acquired["n"] += 1
                threading.Event().wait(0.02)  # hold the lock long enough to overlap
                with hlock:
                    holders["current"] -= 1
                env.unlock()
        finally:
            try:
                env.close()
            except Exception:
                pass

    try:
        _run_threads([lambda i=i: fighter(i) for i in range(5)])
    finally:
        if quorum is not None:
            quorum.close()
    assert holders["max"] == 1, "two clients held the exclusive lock at once"
    # the exact count depends on scheduling; what matters is that the lock
    # moved between clients at all while never being held twice
    assert acquired["n"] >= 3, "lock never circulated"
