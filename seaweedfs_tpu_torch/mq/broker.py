"""MQ broker, after upstream's weed/mq/broker/ (publish/subscribe RPC
over log-structured topics persisted via the filer). The broker runs no
kernel and takes no device: segment reads go through the filer, and so
through the volume servers' EC reads.

RPC surface (weedtpu.MessageQueue):
  ConfigureTopic  {namespace, topic, partition_count}
  ListTopics      {namespace}
  Publish         {namespace, topic, key b64, value b64 [, partition]}
                  -> {partition, ts_ns}
  Subscribe       {namespace, topic, partition, since_ns, max_idle_s}
                  -> stream of LogRecord dicts (flushed segments first,
                     then the live tail)

Consumer groups (weed/mq sub_coordinator analog):
  JoinGroup       {namespace, topic, group, consumer_id}
                  -> {generation, partitions, partition_count}
  GroupHeartbeat  {namespace, topic, group, consumer_id} -> {generation}
  LeaveGroup      {namespace, topic, group, consumer_id}
  CommitOffset    {namespace, topic, group, partition, ts_ns}
  FetchOffset     {namespace, topic, group, partition} -> {ts_ns}

Membership is broker-resident with a session TTL (a consumer that stops
heartbeating is reaped and its partitions rebalance); the generation
bumps on every membership change so consumers detect rebalances.
Committed offsets persist through the filer KV facet, so a group
resumes where it left off across broker AND consumer restarts.

Partition assignment: explicit, else hash(key) % partitions — the
reference's key-hash routing; within a group, partitions are split
round-robin over the sorted member ids.
"""

from __future__ import annotations

import hashlib
import json
import threading
import urllib.parse
import urllib.request
from typing import Optional

from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.filer.client import FilerClient
from seaweedfs_tpu_torch.pb import MQ_SERVICE
from seaweedfs_tpu_torch.utils.log_buffer import LogBuffer, LogRecord
from seaweedfs_tpu_torch.security import tls

TOPICS_ROOT = "/topics"


class _Partition:
    def __init__(self, broker: "Broker", ns: str, topic: str, index: int):
        self.broker = broker
        self.dir = f"{TOPICS_ROOT}/{ns}/{topic}/{index:04d}"
        self.buffer = LogBuffer(self._flush_segment)
        self.lock = threading.Lock()
        # bumped on every persisted segment; subscribers re-scan flushed
        # data when it moves (otherwise a flush racing the live tail
        # would hide the drained records in a segment they already read)
        self.flush_seq = 0

    def _flush_segment(self, first_ts: int, last_ts: int, records: list[LogRecord]) -> None:
        body = "\n".join(json.dumps(r.to_dict()) for r in records).encode()
        url = f"{tls.scheme()}://{self.broker.filer_http}{urllib.parse.quote(self.dir)}/{first_ts:020d}.seg"
        req = urllib.request.Request(
            url, data=body, method="PUT",
            headers={"Content-Type": "application/x-weedtpu-segment"},
        )
        with tls.urlopen(req, timeout=60) as r:
            r.read()
        self.flush_seq += 1

    def read_flushed(self, since_ns: int) -> list[LogRecord]:
        segs = sorted(
            (
                e
                for e in self.broker.filer.list(self.dir, limit=1 << 20)
                if e.name.endswith(".seg")
            ),
            key=lambda e: e.name,
        )
        firsts = [int(e.name[: -len(".seg")]) for e in segs]
        out: list[LogRecord] = []
        for i, e in enumerate(segs):
            # segment i covers [firsts[i], firsts[i+1]): skip wholly-old
            # segments by name instead of downloading + parsing them
            if i + 1 < len(firsts) and firsts[i + 1] <= since_ns + 1:
                continue
            raw = self.broker.filer.read_file(e.path)
            for line in raw.decode().splitlines():
                try:
                    rec = LogRecord.from_dict(json.loads(line))
                except (ValueError, KeyError):
                    continue
                if rec.ts_ns > since_ns:
                    out.append(rec)
        return out


class _Group:
    """Resident state of one consumer group on one topic."""

    def __init__(self):
        self.members: dict[str, float] = {}  # consumer_id -> last heartbeat
        self.generation = 0


class Broker:
    GROUP_SESSION_TIMEOUT = 10.0

    def __init__(
        self,
        filer_http_address: str,
        filer_grpc_address: str,
        port: int = 0,
        host: str = "127.0.0.1",
        group_session_timeout: float = GROUP_SESSION_TIMEOUT,
    ):
        self.filer_http = filer_http_address
        self.filer = FilerClient(filer_grpc_address)
        self.host = host
        self.group_session_timeout = group_session_timeout
        self._partitions: dict[tuple[str, str, int], _Partition] = {}
        self._groups: dict[tuple[str, str, str], _Group] = {}
        self._lock = threading.Lock()
        self._grpc = rpc.RpcServer(port=port, host=host)
        self._grpc.add_service(self._build_service())
        self.port = self._grpc.port
        self._stop = threading.Event()
        self._announce_thread = threading.Thread(
            target=self._announce_loop, daemon=True
        )

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> None:
        self._grpc.start()
        self._announce_thread.start()

    def _announce_loop(self) -> None:
        """Register with the master cluster-node list (node_type=broker) so
        shells discover brokers like they discover filers. The masters are
        learned through the filer's configuration — the broker only ever
        needs a filer address to join a cluster."""
        masters: list[str] = []
        while True:
            try:
                if not masters:
                    masters = self.filer.configuration().get("masters", [])
                for m in masters:
                    with rpc.RpcClient(m) as c:
                        c.call(
                            "weedtpu.Master",
                            "FilerHeartbeat",
                            {
                                "http_address": self.address,
                                "grpc_address": self.address,
                                "node_type": "broker",
                            },
                            timeout=5,
                        )
            except Exception:  # noqa: BLE001 — filer/master down; retry
                masters = []
            if self._stop.wait(5.0):
                return

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            parts = list(self._partitions.values())
        for p in parts:
            p.buffer.close()  # final flush -> filer
        self._grpc.stop()
        self.filer.close()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- topic bookkeeping ----------------------------------------------------

    def _topic_conf(self, ns: str, topic: str) -> Optional[dict]:
        e = self.filer.lookup(f"{TOPICS_ROOT}/{ns}/{topic}")
        if e is None:
            return None
        try:
            return json.loads(e.extended.get("mq", "{}"))
        except ValueError:
            return {}

    def _partition(self, ns: str, topic: str, index: int) -> _Partition:
        key = (ns, topic, index)
        with self._lock:
            p = self._partitions.get(key)
            if p is None:
                p = _Partition(self, ns, topic, index)
                self._partitions[key] = p
            return p

    # -- RPC ------------------------------------------------------------------

    def _build_service(self) -> rpc.Service:
        svc = rpc.Service(MQ_SERVICE)
        svc.add("ConfigureTopic", self._rpc_configure)
        svc.add("ListTopics", self._rpc_list)
        svc.add("Publish", self._rpc_publish)
        svc.add("Subscribe", self._rpc_subscribe, kind="unary_stream", resp_format="json")
        svc.add("JoinGroup", self._rpc_join_group)
        svc.add("GroupHeartbeat", self._rpc_group_heartbeat)
        svc.add("LeaveGroup", self._rpc_leave_group)
        svc.add("CommitOffset", self._rpc_commit_offset)
        svc.add("FetchOffset", self._rpc_fetch_offset)
        return svc

    # -- consumer groups ------------------------------------------------------

    def _reap_stale(self, g: _Group, now: float) -> bool:
        """Caller holds self._lock. Returns True when membership changed."""
        stale = [
            cid
            for cid, seen in g.members.items()
            if now - seen > self.group_session_timeout
        ]
        for cid in stale:
            del g.members[cid]
        if stale:
            g.generation += 1
        return bool(stale)

    def _sweep_dead_groups(self, now: float) -> None:
        """Caller holds self._lock: drop group entries whose every member
        is gone (crashed consumers never call LeaveGroup) — broker-resident
        state must not grow with the history of group names."""
        for key in list(self._groups):
            g = self._groups[key]
            self._reap_stale(g, now)
            if not g.members:
                del self._groups[key]

    def _assigned(self, g: _Group, consumer_id: str, count: int) -> list[int]:
        """Partitions for consumer_id: round-robin over sorted members —
        deterministic, so every member computes the same split."""
        members = sorted(g.members)
        if consumer_id not in members:
            return []
        rank = members.index(consumer_id)
        return [p for p in range(count) if p % len(members) == rank]

    def _rpc_join_group(self, req: dict, ctx) -> dict:
        import time as _time

        ns = req.get("namespace") or "default"
        topic = req["topic"]
        conf = self._topic_conf(ns, topic)
        if conf is None:
            raise rpc.NotFoundFault(f"topic {ns}/{topic} not configured")
        count = int(conf.get("partition_count") or 4)
        cid = req["consumer_id"]
        key = (ns, topic, req.get("group") or "default")
        now = _time.monotonic()
        with self._lock:
            # lookup-or-create and mutate under ONE lock hold: a racing
            # LeaveGroup deleting the entry between two acquisitions would
            # otherwise leave this joiner registered in an orphaned object
            self._sweep_dead_groups(now)
            g = self._groups.get(key)
            if g is None:
                g = self._groups[key] = _Group()
            if cid not in g.members:
                g.generation += 1
            g.members[cid] = now
            return {
                "generation": g.generation,
                "partitions": self._assigned(g, cid, count),
                "partition_count": count,
                "session_timeout_s": self.group_session_timeout,
            }

    def _rpc_group_heartbeat(self, req: dict, ctx) -> dict:
        import time as _time

        ns = req.get("namespace") or "default"
        key = (ns, req["topic"], req.get("group") or "default")
        now = _time.monotonic()
        with self._lock:
            # look up WITHOUT creating: a typo'd topic/group must error,
            # not grow broker-resident state forever
            g = self._groups.get(key)
            if g is not None:
                self._reap_stale(g, now)
                if not g.members:
                    del self._groups[key]  # fully reaped: drop the entry
                    g = None
            if g is None:
                # the consumer treats this as "rejoin" (it may itself have
                # been the reaped member)
                raise rpc.NotFoundFault(f"unknown group {key[2]} on {ns}/{req['topic']}")
            if req["consumer_id"] in g.members:
                g.members[req["consumer_id"]] = now
            return {"generation": g.generation}

    def _rpc_leave_group(self, req: dict, ctx) -> dict:
        ns = req.get("namespace") or "default"
        key = (ns, req["topic"], req.get("group") or "default")
        with self._lock:
            g = self._groups.get(key)
            if g is None:
                return {}
            if g.members.pop(req["consumer_id"], None) is not None:
                g.generation += 1
            if not g.members:  # last one out: drop the resident entry
                del self._groups[key]
        return {}

    @staticmethod
    def _offset_key(ns: str, topic: str, group: str, partition: int) -> str:
        return f"mq.offset/{ns}/{topic}/{group}/{partition:04d}"

    def _rpc_commit_offset(self, req: dict, ctx) -> dict:
        ns = req.get("namespace") or "default"
        key = self._offset_key(
            ns, req["topic"], req.get("group") or "default", int(req["partition"])
        )
        self.filer.kv_put(key, str(int(req["ts_ns"])).encode())
        return {}

    def _rpc_fetch_offset(self, req: dict, ctx) -> dict:
        ns = req.get("namespace") or "default"
        raw = self.filer.kv_get(
            self._offset_key(
                ns, req["topic"], req.get("group") or "default", int(req["partition"])
            )
        )
        return {"ts_ns": int(raw.decode()) if raw else 0}

    def _rpc_configure(self, req: dict, ctx) -> dict:
        from seaweedfs_tpu_torch.filer.entry import Entry

        ns = req.get("namespace") or "default"
        topic = req["topic"]
        count = int(req.get("partition_count") or 4)
        path = f"{TOPICS_ROOT}/{ns}/{topic}"
        e = self.filer.lookup(path)
        if e is None:
            e = Entry(path=path, is_directory=True)
        e.extended["mq"] = json.dumps({"partition_count": count})
        self.filer.create(e)
        return {"partition_count": count}

    def _rpc_list(self, req: dict, ctx) -> dict:
        ns = req.get("namespace") or "default"
        out = []
        for e in self.filer.list(f"{TOPICS_ROOT}/{ns}", limit=10000):
            if e.is_directory:
                conf = {}
                try:
                    conf = json.loads(e.extended.get("mq", "{}"))
                except ValueError:
                    pass
                out.append({"topic": e.name, **conf})
        return {"topics": out}

    def _rpc_publish(self, req: dict, ctx) -> dict:
        import base64

        ns = req.get("namespace") or "default"
        topic = req["topic"]
        conf = self._topic_conf(ns, topic)
        if conf is None:
            raise rpc.NotFoundFault(f"topic {ns}/{topic} not configured")
        count = int(conf.get("partition_count") or 4)
        key = base64.b64decode(req.get("key", ""))
        value = base64.b64decode(req.get("value", ""))
        if "partition" in req:
            index = int(req["partition"]) % count
        else:
            index = int.from_bytes(
                hashlib.md5(key).digest()[:4], "big"
            ) % count if key else 0
        ts = self._partition(ns, topic, index).buffer.add(key, value)
        return {"partition": index, "ts_ns": ts}

    def _rpc_subscribe(self, req: dict, ctx):
        ns = req.get("namespace") or "default"
        topic = req["topic"]
        index = int(req.get("partition", 0))
        since = int(req.get("since_ns", 0))
        max_idle = float(req.get("max_idle_s", 5.0))
        if self._topic_conf(ns, topic) is None:
            raise rpc.NotFoundFault(f"topic {ns}/{topic} not configured")
        part = self._partition(ns, topic, index)
        stop = threading.Event()
        ctx.add_callback(stop.set)
        last = since
        idle = 0.0
        seen_seq = -1  # forces a flushed-segment scan on the first pass
        while not stop.is_set() and idle < max_idle:
            recs: list[LogRecord] = []
            if part.flush_seq != seen_seq:
                # flushed data moved since we last looked (or first pass):
                # re-scan segments so records drained out of the live
                # buffer by a racing flush are never skipped
                seen_seq = part.flush_seq
                recs = part.read_flushed(last)
            recs += part.buffer.read_since(last)
            if recs:
                for rec in sorted(recs, key=lambda r: r.ts_ns):
                    yield rec.to_dict()
                    last = max(last, rec.ts_ns)
                idle = 0.0
            else:
                part.buffer.wait_for_data(last, 0.2)
                idle += 0.2


class BrokerClient:
    """Publish/subscribe client (weed/mq/client analog)."""

    def __init__(self, broker_address: str):
        self._rpc = rpc.RpcClient(broker_address)

    def close(self) -> None:
        self._rpc.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def configure_topic(self, topic: str, partition_count: int = 4, namespace: str = "default") -> None:
        self._rpc.call(
            MQ_SERVICE,
            "ConfigureTopic",
            {"namespace": namespace, "topic": topic, "partition_count": partition_count},
        )

    def list_topics(self, namespace: str = "default") -> list[dict]:
        return self._rpc.call(MQ_SERVICE, "ListTopics", {"namespace": namespace})["topics"]

    def publish(
        self, topic: str, key: bytes, value: bytes,
        namespace: str = "default", partition: Optional[int] = None,
    ) -> dict:
        import base64

        req = {
            "namespace": namespace,
            "topic": topic,
            "key": base64.b64encode(key).decode(),
            "value": base64.b64encode(value).decode(),
        }
        if partition is not None:
            req["partition"] = partition
        return self._rpc.call(MQ_SERVICE, "Publish", req)

    def subscribe(
        self, topic: str, partition: int = 0, since_ns: int = 0,
        namespace: str = "default", max_idle_s: float = 5.0,
    ):
        for d in self._rpc.stream(
            MQ_SERVICE,
            "Subscribe",
            {
                "namespace": namespace,
                "topic": topic,
                "partition": partition,
                "since_ns": since_ns,
                "max_idle_s": max_idle_s,
            },
            resp_format="json",
        ):
            yield LogRecord.from_dict(d)

    # -- consumer groups ------------------------------------------------------

    def join_group(self, topic: str, group: str, consumer_id: str, namespace: str = "default") -> dict:
        return self._rpc.call(
            MQ_SERVICE,
            "JoinGroup",
            {"namespace": namespace, "topic": topic, "group": group, "consumer_id": consumer_id},
        )

    def group_heartbeat(self, topic: str, group: str, consumer_id: str, namespace: str = "default") -> int:
        return int(
            self._rpc.call(
                MQ_SERVICE,
                "GroupHeartbeat",
                {"namespace": namespace, "topic": topic, "group": group, "consumer_id": consumer_id},
            )["generation"]
        )

    def leave_group(self, topic: str, group: str, consumer_id: str, namespace: str = "default") -> None:
        self._rpc.call(
            MQ_SERVICE,
            "LeaveGroup",
            {"namespace": namespace, "topic": topic, "group": group, "consumer_id": consumer_id},
        )

    def commit_offset(self, topic: str, group: str, partition: int, ts_ns: int, namespace: str = "default") -> None:
        self._rpc.call(
            MQ_SERVICE,
            "CommitOffset",
            {"namespace": namespace, "topic": topic, "group": group,
             "partition": partition, "ts_ns": ts_ns},
        )

    def fetch_offset(self, topic: str, group: str, partition: int, namespace: str = "default") -> int:
        return int(
            self._rpc.call(
                MQ_SERVICE,
                "FetchOffset",
                {"namespace": namespace, "topic": topic, "group": group, "partition": partition},
            )["ts_ns"]
        )

    def consume(
        self,
        topic: str,
        group: str,
        consumer_id: str,
        namespace: str = "default",
        poll_idle_s: float = 0.5,
        auto_commit: bool = True,
        commit_every: int = 1,
        max_rounds: Optional[int] = None,
    ):
        """Group consumer loop: join, drain each assigned partition from
        its committed offset, and rebalance whenever the broker's
        generation moves. Yields (partition, LogRecord).

        Commit discipline is commit-on-next-poll (at-least-once): a
        record's offset commits only after the caller comes back for the
        next one — proof it processed the last. A caller that crashes or
        breaks mid-stream therefore sees its last <= `commit_every`
        records redelivered; call `commit_offset(topic, group, p,
        rec.ts_ns)` before a graceful stop to avoid the duplicates.
        Committing any earlier (e.g. on generator close) would silently
        LOSE a record whose processing raised. Raising `commit_every`
        batches the offset RPCs (1 filer kv_put per N records instead of
        per record) at the price of a longer redelivery window.

        Heartbeats pace themselves from the broker's advertised session
        timeout, and every blocking wait is capped below it — a live
        consumer is never reaped for being busy OR idle.

        `max_rounds` bounds the poll loop (None = run until closed)."""
        import time as _time

        state = self.join_group(topic, group, consumer_id, namespace)

        def hb_interval():
            return max(0.05, float(state.get("session_timeout_s", 10.0)) / 3)

        last_hb = _time.monotonic()
        rounds = 0
        while max_rounds is None or rounds < max_rounds:
            rounds += 1
            rebalance = False
            for p in state["partitions"]:
                # heartbeat between partitions too: several idle partitions
                # in sequence must not add up past the session timeout
                if _time.monotonic() - last_hb >= hb_interval():
                    last_hb = _time.monotonic()
                    if self._heartbeat_or_rejoin(
                        topic, group, consumer_id, namespace, state
                    ):
                        rebalance = True
                        break
                since = self.fetch_offset(topic, group, p, namespace)
                pending = 0  # records delivered but not yet committed
                last_ts = since
                for rec in self.subscribe(
                    topic, partition=p, since_ns=since,
                    # cap each blocking wait well below the session timeout:
                    # combined with the pre-partition heartbeat above, the
                    # longest un-heartbeated stretch is ~1.5/3 of the TTL
                    namespace=namespace, max_idle_s=min(poll_idle_s, hb_interval() / 2),
                ):
                    yield p, rec
                    # the caller came back: the record was processed
                    last_ts, pending = rec.ts_ns, pending + 1
                    if auto_commit and pending >= commit_every:
                        self.commit_offset(topic, group, p, last_ts, namespace)
                        pending = 0
                    # a busy partition must not starve the heartbeat —
                    # the broker would reap us as stale mid-stream
                    if _time.monotonic() - last_hb >= hb_interval():
                        last_hb = _time.monotonic()
                        if self._heartbeat_or_rejoin(
                            topic, group, consumer_id, namespace, state
                        ):
                            rebalance = True
                            break
                if auto_commit and pending:
                    self.commit_offset(topic, group, p, last_ts, namespace)
                if rebalance:
                    break
            if not rebalance:
                if not state["partitions"]:
                    # idle member (more consumers than partitions): wait for
                    # a rebalance instead of hammering the broker
                    _time.sleep(min(poll_idle_s, hb_interval()))
                last_hb = _time.monotonic()
                rebalance = self._heartbeat_or_rejoin(
                    topic, group, consumer_id, namespace, state
                )
            if rebalance:  # pick up the new split
                state = self.join_group(topic, group, consumer_id, namespace)

    def _heartbeat_or_rejoin(self, topic, group, consumer_id, namespace, state) -> bool:
        """True when the consumer must rejoin: the generation moved, or the
        broker forgot the group (we were reaped / the entry was swept)."""
        import grpc as _grpc

        try:
            return (
                self.group_heartbeat(topic, group, consumer_id, namespace)
                != state["generation"]
            )
        except _grpc.RpcError as e:
            if e.code() == _grpc.StatusCode.NOT_FOUND:
                return True
            raise
