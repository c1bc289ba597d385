"""The port's log buffer, notification queues, replication and message
queue against the reference's: a twin of each of the 16 cases of
`tests/test_replication_mq.py`, with the reference case's own steps and
assertions run on a port stack (master, one volume server on `Encoder(10,
4, device="cpu")`, filer on loopback); then cross-package cases (at the
end), tolerance 0: a `LogBuffer` under a pinned clock gives equal records
and flush batches, a `LogFileQueue` JSONL file is byte-equal for one filer
event history, a sync checkpointed by one package resumes under the other
with no event applied twice and an equal sink tree, and a topic's
segments and group offsets written by one package's broker are consumed
by the other's, every record once and in the same per-partition order."""

import hashlib
import io
import json
import os
import threading
import time
import types

import grpc
import numpy as np
import pytest

from seaweedfs_tpu_torch.cluster.master import MasterServer
from seaweedfs_tpu_torch.cluster.volume_server import VolumeServer
from seaweedfs_tpu_torch.filer import FilerServer
from seaweedfs_tpu_torch.mq import Broker, BrokerClient
from seaweedfs_tpu_torch.notification import LogFileQueue, MemoryQueue, make_queue
from seaweedfs_tpu_torch.ops.rs_codec import Encoder
from seaweedfs_tpu_torch.replication import FilerSink, LocalSink, Replicator
from seaweedfs_tpu_torch.utils.log_buffer import LogBuffer

import seaweedfs_tpu.mq as ref_mq
import seaweedfs_tpu.notification as ref_notification
import seaweedfs_tpu.replication as ref_replication
import seaweedfs_tpu.utils.log_buffer as ref_log_buffer
import seaweedfs_tpu_torch.mq as port_mq
import seaweedfs_tpu_torch.notification as port_notification
import seaweedfs_tpu_torch.replication as port_replication
import seaweedfs_tpu_torch.utils.log_buffer as port_log_buffer

from test_torch_cluster import stop_all
from test_torch_filer import PORT as PORT_FILER
from test_torch_filer import REF as REF_FILER
from test_torch_filer import pin_clock

REF = types.SimpleNamespace(name="ref", mq=ref_mq, notification=ref_notification,
                            replication=ref_replication, log_buffer=ref_log_buffer, f=REF_FILER)
PORT = types.SimpleNamespace(name="port", mq=port_mq, notification=port_notification,
                             replication=port_replication, log_buffer=port_log_buffer,
                             f=PORT_FILER)
PKGS = {"ref": REF, "port": PORT}


@pytest.fixture
def stack(tmp_path):
    master = MasterServer(port=0, reap_interval=3600)
    master.start()
    (tmp_path / "vol").mkdir()
    vs = VolumeServer([str(tmp_path / "vol")], master.address, heartbeat_interval=0.4,
                      encoder=Encoder(10, 4, device="cpu"))
    vs.start()
    fs = FilerServer(master.address)
    fs.start()
    yield master, vs, fs
    stop_all([fs, vs, master])


def _put(fs, path, data: bytes):
    return fs.write_file(path, io.BytesIO(data))


# -- log buffer (pure) --------------------------------------------------------


def test_log_buffer_flush_and_tail():
    flushed = []
    lb = LogBuffer(
        lambda f, l, recs: flushed.append(recs), max_bytes=200, flush_interval_s=3600
    )
    ts0 = lb.add(b"k1", b"v" * 50)
    assert lb.read_since(0)[0].key == b"k1"
    assert lb.read_since(ts0) == []
    lb.add(b"k2", b"v" * 200)  # crosses max_bytes -> flush
    assert len(flushed) == 1 and [r.key for r in flushed[0]] == [b"k1", b"k2"]
    assert lb.read_since(0) == []
    lb.add(b"k3", b"x")
    lb.close()  # close flushes the tail
    assert [r.key for r in flushed[1]] == [b"k3"]


def test_log_buffer_monotonic_ts():
    lb = LogBuffer(lambda *a: None, flush_interval_s=3600)
    ts = [lb.add(b"", b"x", ts_ns=123) for _ in range(3)]
    assert ts == sorted(ts) and len(set(ts)) == 3
    lb.close()


# -- notification -------------------------------------------------------------


def test_notification_queues(tmp_path):
    mq = MemoryQueue()
    got = []
    mq.subscribe(lambda k, m: got.append(k))
    mq.send_message("/a", {"x": 1})
    assert mq.messages[0][0] == "/a" and got == ["/a"]
    lq = LogFileQueue(str(tmp_path / "events.jsonl"))
    lq.send_message("/b", {"y": 2})
    lq.close()
    lines = open(tmp_path / "events.jsonl", encoding="utf-8").read().splitlines()
    assert json.loads(lines[0])["key"] == "/b"
    assert make_queue("none") is None


def test_filer_notification_wiring(stack):
    _, _, fs = stack
    q = MemoryQueue()
    fs.filer.notification_queue = q
    _put(fs, "/notify/f.txt", b"data")
    deadline = time.monotonic() + 5.0  # dispatch is off-thread
    while time.monotonic() < deadline:
        if "/notify/f.txt" in [k for k, _ in q.messages]:
            break
        time.sleep(0.05)
    assert "/notify/f.txt" in [k for k, _ in q.messages]


# -- replication --------------------------------------------------------------


def test_replicate_to_local_sink(stack, tmp_path):
    _, _, fs = stack
    _put(fs, "/site/a/x.txt", b"xx")
    _put(fs, "/site/y.txt", b"yy")
    sink_dir = tmp_path / "backup"
    rep = Replicator(fs.grpc_address, LocalSink(str(sink_dir)), prefix="/site")
    n = rep.run_once(max_idle_s=0.5)
    assert n >= 3  # dirs + files
    assert (sink_dir / "a" / "x.txt").read_bytes() == b"xx"
    assert (sink_dir / "y.txt").read_bytes() == b"yy"
    # incremental: only new events apply after checkpoint
    _put(fs, "/site/z.txt", b"zz")
    fs.filer.delete_entry("/site/y.txt")
    rep.run_once(max_idle_s=0.5)
    assert (sink_dir / "z.txt").read_bytes() == b"zz"
    assert not (sink_dir / "y.txt").exists()
    # events outside the prefix are ignored
    _put(fs, "/other/o.txt", b"oo")
    rep.run_once(max_idle_s=0.5)
    assert not (sink_dir / "o.txt").exists() and not (sink_dir / "other").exists()
    rep.close()


def test_replicate_filer_to_filer(stack, tmp_path):
    master, vs, fs = stack
    fs2 = FilerServer(master.address)
    fs2.start()
    try:
        _put(fs, "/data/doc.bin", os.urandom(2048))
        rep = Replicator(
            fs.grpc_address, FilerSink(fs2.url, target_root="/mirror"), prefix="/data"
        )
        rep.run_once(max_idle_s=0.5)
        got = fs2.read_file(fs2.filer.find_entry("/mirror/doc.bin"))
        assert got == fs.read_file(fs.filer.find_entry("/data/doc.bin"))
        # rename on source -> delete+create on sink
        fs.filer.rename("/data/doc.bin", "/data/doc2.bin")
        rep.run_once(max_idle_s=0.5)
        assert not fs2.filer.exists("/mirror/doc.bin")
        assert fs2.filer.exists("/mirror/doc2.bin")
        rep.close()
    finally:
        fs2.stop()


def test_replicate_history_with_renamed_source(stack, tmp_path):
    """A create event whose path was later renamed away must not poison
    the replay — the rename's own events reconcile the sink."""
    _, _, fs = stack
    _put(fs, "/hist/orig.bin", b"abc")
    fs.filer.rename("/hist/orig.bin", "/hist/final.bin")
    sink_dir = tmp_path / "hist-sink"
    rep = Replicator(fs.grpc_address, LocalSink(str(sink_dir)), prefix="/hist")
    rep.run_once(max_idle_s=0.5)
    assert (sink_dir / "final.bin").read_bytes() == b"abc"
    assert not (sink_dir / "orig.bin").exists()
    rep.close()


# -- mq broker ----------------------------------------------------------------


def test_mq_publish_subscribe(stack):
    _, _, fs = stack
    with Broker(fs.url, fs.grpc_address) as broker:
        with BrokerClient(broker.address) as c:
            c.configure_topic("events", partition_count=2)
            assert c.list_topics()[0]["topic"] == "events"
            parts = set()
            for i in range(20):
                r = c.publish("events", f"k{i}".encode(), f"v{i}".encode())
                parts.add(r["partition"])
            assert parts == {0, 1}  # key hashing spreads partitions
            got = []
            for p in (0, 1):
                got.extend(
                    (r.key.decode(), r.value.decode())
                    for r in c.subscribe("events", partition=p, max_idle_s=0.5)
                )
            assert sorted(got) == sorted((f"k{i}", f"v{i}") for i in range(20))


def test_mq_durability_across_restart(stack):
    _, _, fs = stack
    broker = Broker(fs.url, fs.grpc_address)
    broker.start()
    with BrokerClient(broker.address) as c:
        c.configure_topic("persist", partition_count=1)
        for i in range(5):
            c.publish("persist", b"", f"m{i}".encode(), partition=0)
    broker.stop()  # flushes segments to the filer
    # the segments are filer files now
    segs = fs.filer.list_entries("/topics/default/persist/0000")
    assert segs and segs[0].name.endswith(".seg")
    broker2 = Broker(fs.url, fs.grpc_address)
    broker2.start()
    try:
        with BrokerClient(broker2.address) as c:
            vals = [
                r.value.decode()
                for r in c.subscribe("persist", partition=0, max_idle_s=0.5)
            ]
            assert vals == [f"m{i}" for i in range(5)]
    finally:
        broker2.stop()


def test_mq_live_subscription(stack):
    _, _, fs = stack
    with Broker(fs.url, fs.grpc_address) as broker:
        with BrokerClient(broker.address) as c:
            c.configure_topic("live", partition_count=1)
            received = []
            done = threading.Event()

            def consume():
                with BrokerClient(broker.address) as sub:
                    for r in sub.subscribe("live", partition=0, max_idle_s=5.0):
                        received.append(r.value)
                        if len(received) >= 3:
                            break
                done.set()

            t = threading.Thread(target=consume, daemon=True)
            t.start()
            time.sleep(0.3)
            for i in range(3):
                c.publish("live", b"", f"msg{i}".encode(), partition=0)
            assert done.wait(10.0)
            assert received == [b"msg0", b"msg1", b"msg2"]


def test_mq_consumer_group_assignment_and_rebalance(stack):
    """Two consumers split the partitions disjointly; when one leaves, the
    survivor is rebalanced onto all of them."""
    _, _, fs = stack
    with Broker(fs.url, fs.grpc_address) as broker:
        with BrokerClient(broker.address) as c:
            c.configure_topic("jobs", partition_count=4)
            a = c.join_group("jobs", "workers", "consumer-a")
            b = c.join_group("jobs", "workers", "consumer-b")
            # b's join bumped the generation: a refreshes its view
            a = c.join_group("jobs", "workers", "consumer-a")
            assert set(a["partitions"]) | set(b["partitions"]) == {0, 1, 2, 3}
            assert set(a["partitions"]) & set(b["partitions"]) == set()
            gen = c.group_heartbeat("jobs", "workers", "consumer-a")
            c.leave_group("jobs", "workers", "consumer-b")
            assert c.group_heartbeat("jobs", "workers", "consumer-a") != gen
            a = c.join_group("jobs", "workers", "consumer-a")
            assert set(a["partitions"]) == {0, 1, 2, 3}


def test_mq_group_offsets_resume_across_consumers(stack):
    """Committed offsets persist in the filer: a replacement consumer
    resumes after the last committed record, not from the beginning."""
    _, _, fs = stack
    with Broker(fs.url, fs.grpc_address) as broker:
        with BrokerClient(broker.address) as c:
            c.configure_topic("ledger", partition_count=1)
            for i in range(6):
                c.publish("ledger", b"", f"m{i}".encode(), partition=0)
            # commit-on-next-poll: the last record (m2) is uncommitted at
            # the break, so it would be redelivered, never lost
            seen = []
            last = None
            for p, rec in c.consume("ledger", "g1", "c1", max_rounds=1):
                seen.append(rec.value.decode())
                last = (p, rec)
                if len(seen) == 3:
                    break
            assert seen == ["m0", "m1", "m2"]
            # a graceful shutdown commits its final record explicitly
            c.commit_offset("ledger", "g1", last[0], last[1].ts_ns)
            c.leave_group("ledger", "g1", "c1")
            # a different consumer in the same group picks up at m3
            rest = [
                rec.value.decode()
                for _, rec in c.consume("ledger", "g1", "c2", max_rounds=1)
            ]
            assert rest == ["m3", "m4", "m5"]
            # a different GROUP starts from scratch
            fresh = [
                rec.value.decode()
                for _, rec in c.consume("ledger", "g2", "c9", max_rounds=1)
            ]
            assert fresh == [f"m{i}" for i in range(6)]


def test_mq_stale_member_is_reaped(stack):
    _, _, fs = stack
    with Broker(fs.url, fs.grpc_address, group_session_timeout=0.3) as broker:
        with BrokerClient(broker.address) as c:
            c.configure_topic("t", partition_count=2)
            c.join_group("t", "g", "dead-consumer")
            live = c.join_group("t", "g", "live-consumer")
            assert len(live["partitions"]) == 1
            # live keeps heartbeating; dead goes silent past the 0.3 s TTL
            for _ in range(3):
                time.sleep(0.2)
                c.group_heartbeat("t", "g", "live-consumer")
            live = c.join_group("t", "g", "live-consumer")
            assert set(live["partitions"]) == {0, 1}
            # and a group whose every member goes silent is swept entirely:
            # the next heartbeat tells the consumer to rejoin
            time.sleep(0.5)
            with pytest.raises(grpc.RpcError, match="unknown group"):
                c.group_heartbeat("t", "g", "live-consumer")
            assert set(c.join_group("t", "g", "live-consumer")["partitions"]) == {0, 1}


def test_mq_consume_crash_never_loses_a_record(stack):
    """At-least-once: a consumer that dies after receiving but before
    committing a record (generator abandoned mid-stream) causes
    redelivery, never loss."""
    _, _, fs = stack
    with Broker(fs.url, fs.grpc_address) as broker:
        with BrokerClient(broker.address) as c:
            c.configure_topic("crashy", partition_count=1)
            for i in range(3):
                c.publish("crashy", b"", f"m{i}".encode(), partition=0)
            gen = c.consume("crashy", "g", "victim", max_rounds=1)
            _, first = next(gen)
            assert first.value == b"m0"
            gen.close()  # caller crashed mid-processing: m0 uncommitted
            got = [r.value.decode() for _, r in c.consume("crashy", "g", "heir", max_rounds=1)]
            assert got == ["m0", "m1", "m2"], got


def test_mq_group_heartbeat_unknown_group_errors(stack):
    _, _, fs = stack
    with Broker(fs.url, fs.grpc_address) as broker:
        with BrokerClient(broker.address) as c:
            c.configure_topic("real", partition_count=1)
            with pytest.raises(grpc.RpcError, match="unknown group"):
                c.group_heartbeat("real", "no-such-group", "x")
            c.leave_group("real", "no-such-group", "x")  # no-op, no state grown
            assert ("default", "real", "no-such-group") not in broker._groups


def test_mq_shell_commands_and_broker_discovery(stack):
    """Brokers announce to the master (node_type=broker) and the shell's
    mq.* commands drive topic admin through the discovered broker."""
    from seaweedfs_tpu_torch import rpc
    from seaweedfs_tpu_torch.shell import CommandEnv, run_command

    master, vs, fs = stack
    with Broker(fs.url, fs.grpc_address) as broker:
        deadline = time.monotonic() + 10
        found = []
        while time.monotonic() < deadline and not found:
            with rpc.RpcClient(master.address) as c:
                found = c.call("weedtpu.Master", "ListClusterNodes", {}).get("brokers", [])
            time.sleep(0.2)
        assert found and found[0]["grpc_address"] == broker.address
        with CommandEnv(master.address, device="cpu") as env:
            def run(line):
                out = io.StringIO()
                run_command(env, line, out)
                return out.getvalue()

            assert broker.address in run("mq.broker.list")
            out = run("mq.topic.configure -topic events -partitions 3")
            assert "3 partitions" in out
            out = run("mq.topic.list")
            assert "default/events: 3 partitions" in out and "total 1 topics" in out


# -- across the packages ------------------------------------------------------


def _log_buffer_script(p, monkeypatch) -> dict:
    """A seeded add script (explicit stamps, repeats and stamps that go
    back) through the package's LogBuffer with its clock pinned."""
    it = iter(range(1 << 30))
    clock = types.SimpleNamespace(time_ns=lambda: 1_700_000_000_000_000_000 + next(it) * 1000)
    monkeypatch.setattr(p.log_buffer, "time", clock)
    batches = []
    lb = p.log_buffer.LogBuffer(
        lambda first, last, recs: batches.append((first, last, [r.to_dict() for r in recs])),
        max_bytes=600, flush_interval_s=3600,
    )
    rng = np.random.default_rng(5)
    stamps, tails = [], []
    for i in range(200):
        choice = rng.integers(0, 4)
        ts = None if choice < 2 else int(rng.integers(1, 1 << 62)) if choice == 2 else 1
        key = rng.bytes(int(rng.integers(0, 9)))
        stamps.append(lb.add(key, rng.bytes(int(rng.integers(0, 120))), ts_ns=ts))
        if i % 37 == 0:
            tails.append([r.to_dict() for r in lb.read_since(stamps[-1] - 5)])
            lb.flush()
    lb.close()
    return {"stamps": stamps, "batches": batches, "tails": tails}


def test_log_buffer_under_a_pinned_clock_gives_equal_records_and_batches(monkeypatch):
    out = {name: _log_buffer_script(p, monkeypatch) for name, p in PKGS.items()}
    assert out["port"] == out["ref"]
    assert len(out["port"]["batches"]) > 10


def _event_history(p, root, monkeypatch) -> bytes:
    """One filer event history (mkdirs, creates, an update, a rename of a
    directory, deletes) on the package's in-process Filer with its clock
    pinned, sent to the package's LogFileQueue -> the JSONL bytes."""
    pin_clock(monkeypatch, p.f)
    path = str(root / "events.jsonl")
    q = p.notification.make_queue("log", path)
    filer = p.f.Filer(p.f.MemoryStore(), notification_queue=q)
    E, A = p.f.Entry, p.f.Attributes
    filer.create_entry(E(path="/a/b", is_directory=True, attributes=A(mode=0o40755)))
    for i in range(5):
        filer.create_entry(E(path=f"/a/b/f{i}.txt", attributes=A(mime="text/plain", mode=0o644)))
    e = filer.find_entry("/a/b/f2.txt")
    e.extended["k"] = "v"
    filer.update_entry(e)
    filer.rename("/a/b", "/a/c")
    filer.delete_entry("/a/c/f1.txt")
    filer.delete_entry("/a", recursive=True)
    filer.close()  # drains the off-thread dispatch
    q.close()
    with open(path, "rb") as f:
        return f.read()


def test_log_file_queue_jsonl_is_byte_equal_for_one_event_history(tmp_path, monkeypatch):
    out = {}
    for name, p in PKGS.items():
        (tmp_path / name).mkdir()
        out[name] = _event_history(p, tmp_path / name, monkeypatch)
    assert out["port"] == out["ref"]
    assert out["port"].count(b"\n") > 12


class _CountingSink:
    """A package's LocalSink that records every mutation it applies."""

    def __init__(self, p, root):
        self.inner = p.replication.LocalSink(root)
        self.name = self.inner.name
        self.applied = []

    def create(self, key, data, mime="", is_dir=False):
        self.applied.append(("create", key, hashlib.sha256(data).hexdigest(), is_dir))
        self.inner.create(key, data, mime=mime, is_dir=is_dir)

    def delete(self, key, is_dir=False):
        self.applied.append(("delete", key, is_dir))
        self.inner.delete(key, is_dir=is_dir)

    def close(self):
        self.inner.close()


def _tree(root) -> dict:
    out = {}
    for d, dirs, files in os.walk(root):
        rel = os.path.relpath(d, root)
        for name in dirs:
            out[os.path.normpath(os.path.join(rel, name))] = "dir"
        for name in files:
            with open(os.path.join(d, name), "rb") as f:
                out[os.path.normpath(os.path.join(rel, name))] = hashlib.sha256(f.read()).hexdigest()
    return out


def _seeded_files(fs, rng, prefix, n):
    for i in range(n):
        _put(fs, f"{prefix}/d{i % 3}/f{i}.bin", rng.bytes(int(rng.integers(1, 5000))))


@pytest.mark.parametrize("first", ["ref", "port"])
def test_sync_checkpointed_by_one_package_resumes_under_the_other(stack, tmp_path, first):
    """The first package's Replicator drains the history and checkpoints in
    the source filer's KV; seeded mutations follow; the other package's
    Replicator, same sink id, applies exactly the events after the
    checkpoint. Together they apply every event once, and the sink tree
    equals a one-pass sync of the whole history."""
    _, _, fs = stack
    second = "port" if first == "ref" else "ref"
    rng = np.random.default_rng(9)
    _seeded_files(fs, rng, "/sync", 12)
    sink_dir = str(tmp_path / "sink")
    sink1 = _CountingSink(PKGS[first], sink_dir)
    rep1 = PKGS[first].replication.Replicator(fs.grpc_address, sink1, prefix="/sync")
    n1 = rep1.run_once(max_idle_s=0.5)
    checkpoint = rep1.load_offset()
    rep1.close()
    # overwrites, a rename, deletes and new files after the checkpoint
    _put(fs, "/sync/d0/f0.bin", rng.bytes(777))
    fs.filer.rename("/sync/d1/f1.bin", "/sync/d2/moved.bin")
    fs.filer.delete_entry("/sync/d0/f3.bin")
    _seeded_files(fs, rng, "/sync/new", 4)
    sink2 = _CountingSink(PKGS[second], sink_dir)
    rep2 = PKGS[second].replication.Replicator(fs.grpc_address, sink2, prefix="/sync")
    assert rep2.load_offset() == checkpoint
    n2 = rep2.run_once(max_idle_s=0.5)
    rep2.close()
    with PORT.f.FilerClient(fs.grpc_address) as fc:
        history = list(fc.subscribe(since_ns=0, path_prefix="/sync", max_idle_s=0.5))
    assert n1 == sum(ev.ts_ns <= checkpoint for ev in history)
    assert n2 == sum(ev.ts_ns > checkpoint for ev in history) > 0
    # a one-pass sync of the whole history under a fresh id
    whole_dir = str(tmp_path / "whole")
    whole = PORT.replication.Replicator(fs.grpc_address, LocalSink(whole_dir), prefix="/sync",
                                        sink_id="whole")
    assert whole.run_once(max_idle_s=0.5) == n1 + n2
    whole.close()
    assert _tree(sink_dir) == _tree(whole_dir)
    assert "d2/moved.bin" in _tree(sink_dir) and "d0/f3.bin" not in _tree(sink_dir)


@pytest.mark.parametrize("first", ["ref", "port"])
def test_topic_written_by_one_package_broker_is_consumed_by_the_other(stack, first):
    """Publish 64 keyed records through the first package's broker; its
    group consumes 20 and commits; it stops (its segments flush to the
    filer). The other package's broker and client consume the same group:
    every record arrives once overall, in each partition in publish
    order, on the partition the key routed it to."""
    _, _, fs = stack
    second = "port" if first == "ref" else "ref"
    rng = np.random.default_rng(13)
    records = [(rng.bytes(8), rng.bytes(int(rng.integers(1, 200)))) for _ in range(64)]
    a = PKGS[first].mq.Broker(fs.url, fs.grpc_address)
    a.start()
    published = {}
    with PKGS[first].mq.BrokerClient(a.address) as c:
        c.configure_topic("cross", partition_count=4)
        for key, value in records:
            r = c.publish("cross", key, value)
            published.setdefault(r["partition"], []).append((key, value))
        got = []
        last = None
        for part, rec in c.consume("cross", "g", "c1", max_rounds=1):
            got.append((part, rec.key, rec.value))
            last = (part, rec.ts_ns)
            if len(got) == 20:
                break
        c.commit_offset("cross", "g", last[0], last[1])
        c.leave_group("cross", "g", "c1")
    a.stop()
    b = PKGS[second].mq.Broker(fs.url, fs.grpc_address)
    b.start()
    try:
        with PKGS[second].mq.BrokerClient(b.address) as c:
            assert c.list_topics() == [{"topic": "cross", "partition_count": 4}]
            for part, rec in c.consume("cross", "g", "c2", max_rounds=1):
                got.append((part, rec.key, rec.value))
            # the routing is the same in both packages
            for part, pairs in published.items():
                assert {c.publish("cross", k, b"again")["partition"] for k, _ in pairs} == {part}
    finally:
        b.stop()
    assert len(got) == len(records)
    by_part = {}
    for part, key, value in got:
        by_part.setdefault(part, []).append((key, value))
    assert by_part == published


# -- the CLI commands across the packages -------------------------------------


def test_both_packages_register_the_same_commands():
    """The port's CLI and shell registries hold every command of the
    reference's: 26 CLI commands and 54 shell commands."""
    from seaweedfs_tpu.command import commands as ref_cli
    from seaweedfs_tpu.shell import commands as ref_sh
    from seaweedfs_tpu_torch.command import commands as port_cli
    from seaweedfs_tpu_torch.shell import commands as port_sh

    assert sorted(port_cli()) == sorted(ref_cli()) and len(port_cli()) == 26
    assert sorted(port_sh()) == sorted(ref_sh()) and len(port_sh()) == 54
