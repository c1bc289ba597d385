"""Raft leader election for master HA, after upstream's master quorum
(weed/server/raft_server.go + raft_hashicorp.go). The topology stays soft
state that heartbeats rebuild on any master, so the replicated hard state
is small.

What is replicated and why:

  - term / voted_for      — persisted per node in `raft.<host_port>.json`
                            under `state_dir` (the same file, byte for
                            byte, as the JAX package's: either resumes
                            the other's)
  - leader heartbeats     — carry a small `payload` dict (max volume id,
                            needle-sequence watermark, the admin lock
                            table) that followers apply, so a new leader
                            never reissues ids

This is election + watermark replication, not a general replicated log:
upstream keeps its cluster metadata the same way (soft topology, a
raft-elected leader, tiny hard state), so a log machine would add latency
without adding safety here. No card is involved.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from typing import Callable, Optional

from seaweedfs_tpu_torch import rpc

RAFT_SERVICE = "weedtpu.Raft"

FOLLOWER, CANDIDATE, LEADER = "follower", "candidate", "leader"


class RaftNode:
    def __init__(
        self,
        me: str,
        peers: list[str],
        server: rpc.RpcServer,
        state_dir: str = "",
        election_timeout: tuple[float, float] = (1.0, 2.0),
        payload_fn: Optional[Callable[[], dict]] = None,
        apply_fn: Optional[Callable[[dict], None]] = None,
        on_leader: Optional[Callable[[], None]] = None,
    ):
        self.me = me
        self.peers = [p for p in peers if p != me]
        self.state = FOLLOWER
        self.term = 0
        self.voted_for: Optional[str] = None
        self.leader: Optional[str] = None
        self._timeout_range = election_timeout
        self._payload_fn = payload_fn or (lambda: {})
        self._apply_fn = apply_fn or (lambda p: None)
        self._on_leader = on_leader
        self._lock = threading.RLock()
        self._last_heard = time.monotonic()
        self._last_quorum_ack = time.monotonic()
        self._stop = threading.Event()
        self._state_path = (
            os.path.join(state_dir, f"raft.{me.replace(':', '_')}.json")
            if state_dir
            else ""
        )
        self._load_state()
        svc = rpc.Service(RAFT_SERVICE)
        svc.add("RequestVote", self._rpc_request_vote)
        svc.add("AppendEntries", self._rpc_append_entries)
        server.add_service(svc)
        self._clients: dict[str, rpc.RpcClient] = {}
        self._clients_mu = threading.Lock()
        self._ticker = threading.Thread(target=self._run, daemon=True)

    # -- persistence ----------------------------------------------------------

    def _load_state(self) -> None:
        if self._state_path and os.path.exists(self._state_path):
            try:
                with open(self._state_path, encoding="utf-8") as f:
                    d = json.load(f)
                self.term = int(d.get("term", 0))
                self.voted_for = d.get("voted_for")
            except (ValueError, OSError):
                pass

    def _save_state(self) -> None:
        if not self._state_path:
            return
        tmp = self._state_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"term": self.term, "voted_for": self.voted_for}, f)
            f.flush()
            os.fsync(f.fileno())  # term/vote must survive a crash (election safety)
        os.replace(tmp, self._state_path)

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        if not self.peers:
            # single-node cluster: immediate leadership
            with self._lock:
                self.state = LEADER
                self.leader = self.me
            if self._on_leader:
                self._on_leader()
        self._ticker.start()

    def stop(self) -> None:
        self._stop.set()
        with self._clients_mu:
            clients, self._clients = list(self._clients.values()), {}
        for c in clients:
            c.close()

    @property
    def is_leader(self) -> bool:
        return self.state == LEADER

    def _client(self, peer: str) -> rpc.RpcClient:
        with self._clients_mu:
            c = self._clients.get(peer)
            if c is None:
                # a subchannel of its own, not grpc's process-wide one, which
                # other clients of a stopped master (volume servers' heartbeats)
                # keep in backoff
                c = rpc.RpcClient(peer, options=(("grpc.use_local_subchannel_pool", 1),))
                self._clients[peer] = c
            return c

    # -- RPC handlers ---------------------------------------------------------

    def _rpc_request_vote(self, req: dict, ctx) -> dict:
        term, candidate = int(req["term"]), req["candidate"]
        with self._lock:
            if term > self.term:
                self.term = term
                self.voted_for = None
                self.state = FOLLOWER
                self._save_state()
            granted = term >= self.term and self.voted_for in (None, candidate)
            if granted:
                self.voted_for = candidate
                self._last_heard = time.monotonic()
                self._save_state()
        resp = {"term": self.term, "granted": granted}
        if granted:
            # piggyback this voter's applied payload: the winning candidate
            # adopts the freshest table from its vote quorum, which must
            # intersect any quorum that acked a replicated lease — so a
            # quorum-acked admin lock survives leader failover even though
            # this raft has no log up-to-dateness restriction
            resp["payload"] = self._payload_fn()
        return resp

    def _rpc_append_entries(self, req: dict, ctx) -> dict:
        term, leader = int(req["term"]), req["leader"]
        with self._lock:
            if term < self.term:
                return {"term": self.term, "ok": False}
            if term > self.term:
                self.term = term
                self.voted_for = None
                self.state = FOLLOWER
                self._save_state()
            elif self.state != FOLLOWER:
                # equal-term step-down (candidate lost the race): keep
                # voted_for — clearing it would allow a second vote in the
                # same term, breaking Raft's one-vote-per-term invariant
                self.state = FOLLOWER
                self._save_state()
            self.leader = leader
            self._last_heard = time.monotonic()
        payload = req.get("payload") or {}
        if payload:
            self._apply_fn(payload)
        return {"term": self.term, "ok": True}

    # -- main loop ------------------------------------------------------------

    def _election_deadline(self) -> float:
        lo, hi = self._timeout_range
        return random.uniform(lo, hi)

    def _run(self) -> None:
        deadline = self._election_deadline()
        while not self._stop.is_set():
            if self.state == LEADER:
                self._broadcast_heartbeat()
                # a leader partitioned from the quorum must step down, or
                # it keeps allocating ids that the majority-side leader
                # also allocates (split brain)
                if self.peers:
                    with self._lock:
                        silent = time.monotonic() - self._last_quorum_ack
                        if silent > self._timeout_range[1]:
                            self.state = FOLLOWER
                            self.leader = None
                self._stop.wait(self._timeout_range[0] / 3)
                continue
            self._stop.wait(0.05)
            with self._lock:
                waited = time.monotonic() - self._last_heard
            if waited >= deadline:
                self._campaign()
                deadline = self._election_deadline()

    def _campaign(self) -> None:
        with self._lock:
            self.state = CANDIDATE
            self.term += 1
            self.voted_for = self.me
            self._save_state()
            term = self.term
            self._last_heard = time.monotonic()
        resps = self._fanout("RequestVote", {"term": term, "candidate": self.me})
        votes = 1 + sum(1 for r in resps if r.get("granted"))
        # adopt voter payloads BEFORE taking leadership: apply_fn is
        # seq-aware, so the freshest lock table in the vote quorum wins
        # regardless of arrival order
        for r in resps:
            if r.get("granted") and r.get("payload"):
                try:
                    self._apply_fn(r["payload"])
                except Exception:  # noqa: BLE001 — a bad payload must not block election
                    pass
        higher = max((r["term"] for r in resps if r["term"] > term), default=0)
        quorum = (len(self.peers) + 1) // 2 + 1
        with self._lock:
            if higher > self.term:
                self.term = higher
                self.state = FOLLOWER
                self.voted_for = None
                self._save_state()
                return
            if self.state != CANDIDATE or self.term != term:
                return
            if votes >= quorum:
                self.state = LEADER
                self.leader = self.me
                self._last_quorum_ack = time.monotonic()
            else:
                self.state = FOLLOWER
                return
        self._broadcast_heartbeat()
        if self._on_leader:
            self._on_leader()

    def _peer_timeout(self) -> float:
        # well below the election floor: one dead peer must not stall the
        # round past a follower's deadline (leadership flapping)
        return max(0.2, self._timeout_range[0] / 4)

    def _fanout(self, method: str, req: dict) -> list[dict]:
        """Call all peers in PARALLEL; returns the responses received
        within the per-peer timeout."""
        results: list[dict] = []
        lock = threading.Lock()

        def one(peer: str) -> None:
            client = self._client(peer)
            try:
                resp = client.call(RAFT_SERVICE, method, req, timeout=self._peer_timeout())
            except Exception:  # noqa: BLE001 — unreachable peer
                # the next round dials a fresh channel: grpc backs a refused
                # channel off, so a peer restarted on its address would hear
                # no heartbeat, time out and depose the leader
                with self._clients_mu:
                    if self._clients.get(peer) is client:
                        del self._clients[peer]
                client.close()
                return
            with lock:
                results.append(resp)

        threads = [threading.Thread(target=one, args=(p,)) for p in self.peers]
        for t in threads:
            t.start()
        for t in threads:
            t.join(self._peer_timeout() + 0.5)
        return results

    def _broadcast_heartbeat(self) -> bool:
        """One replication round. Returns True when a quorum acked."""
        with self._lock:
            term = self.term
        payload = self._payload_fn()
        resps = self._fanout(
            "AppendEntries", {"term": term, "leader": self.me, "payload": payload}
        )
        acks = sum(1 for r in resps if r.get("ok"))
        higher = max((r["term"] for r in resps if r["term"] > term), default=0)
        with self._lock:
            quorum = (len(self.peers) + 1) // 2 + 1
            quorum_ok = acks + 1 >= quorum
            if quorum_ok:
                self._last_quorum_ack = time.monotonic()
            if higher > self.term:
                self.term = higher
                self.state = FOLLOWER
                self.voted_for = None
                self._save_state()
                return False
        return quorum_ok

    def replicate_now(self) -> bool:
        """Synchronously push the current payload to a quorum (used by the
        master to make an admin-lock lease durable BEFORE handing the token
        to the client). Returns False when no quorum acked — the caller
        must treat the mutation as not committed."""
        if not self.peers:
            return self.is_leader  # single-node: local state is the quorum
        if not self.is_leader:
            return False
        return self._broadcast_heartbeat()
