"""Fleet-scale repair scheduler — the master-side brain that turns
per-shard healing (remote rebuild, scrub) into a cluster
that survives a node, then a rack.

A dead volume server leaves HUNDREDS of stripes each short a shard, and
the ORDER they are repaired in decides data-loss risk ("Practical
Considerations in Repairing Reed-Solomon Codes"): a stripe
missing 2 shards is one failure from data loss while a 1-missing stripe
still has slack, so 2-missing repairs strictly first. This module owns:

  - `RepairQueue` — a redundancy-ranked priority queue: stripes order by
    (missing shards DESC, stripe bytes DESC, single-domain exposure
    DESC, vid). Re-ranking mid-storm (a second holder of a queued stripe
    dies) is a lazy-invalidation push: the stale heap entry is skipped
    on pop.
  - `RepairScheduler` — death detection (reaped nodes, heartbeat-silent
    holders, peer-unreachable reports from volume servers), full-registry
    scans that enumerate every under-replicated stripe, a correlation
    settle window so a rack's second node dying 200 ms after its first
    is ranked as ONE event, and a paced dispatch loop that batches many
    volumes' rebuilds into `VolumeEcShardsRebuildBatch` RPCs (one fused
    decode dispatch per missing-signature group on the target) under a
    cluster-wide `WEEDTPU_REPAIR_MAX_INFLIGHT`
    budget, backing off exponentially on 503/RESOURCE_EXHAUSTED so the
    existing rebuild admission lane keeps foreground SLOs intact while
    a repair storm runs.

Repair traffic is still the holders' rebuild admission lane: every slab or
projection stream the batch rebuild opens takes a rebuild token on the
holder serving it; the scheduler's budget bounds how many such rebuild
RPCs are in flight cluster-wide on top.
"""

from __future__ import annotations

import heapq
import threading
import time
from collections import deque
from typing import Optional

import grpc

from seaweedfs_tpu_torch import rpc, stats
from seaweedfs_tpu_torch.ec import placement
from seaweedfs_tpu_torch.ec.constants import DATA_SHARDS_COUNT, TOTAL_SHARDS_COUNT
from seaweedfs_tpu_torch.pb import VOLUME_SERVICE
from seaweedfs_tpu_torch.utils import config


class RepairQueue:
    """Thread-safe redundancy-ranked priority queue of stripes.

    Priority tuple: (-missing, -stripe_bytes, -exposure, vid) — Python's
    min-heap then pops the most-missing (least-redundant) stripe first,
    big stripes before small at equal redundancy, higher single-domain
    exposure before lower. `update` re-ranks by pushing a fresh entry;
    stale entries are skipped on pop (lazy invalidation — the classic
    decrease-key-free heap)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._heap: list[tuple] = []
        self._prio: dict[int, tuple] = {}
        self._order = 0

    @staticmethod
    def priority(missing: int, stripe_bytes: int, exposure: int, vid: int) -> tuple:
        return (-int(missing), -int(stripe_bytes), -int(exposure), int(vid))

    def update(self, vid: int, prio: tuple) -> bool:
        """Insert or re-rank; True when the entry changed (new or moved)."""
        with self._lock:
            if self._prio.get(vid) == prio:
                return False
            self._prio[vid] = prio
            self._order += 1
            heapq.heappush(self._heap, (prio, self._order, vid))
            return True

    def discard(self, vid: int) -> None:
        with self._lock:
            self._prio.pop(vid, None)

    def pop(self) -> Optional[tuple[int, tuple]]:
        """(vid, priority) of the most urgent live entry, or None."""
        with self._lock:
            while self._heap:
                prio, _, vid = heapq.heappop(self._heap)
                if self._prio.get(vid) == prio:
                    del self._prio[vid]
                    return vid, prio
            return None

    def peek_class(self) -> Optional[int]:
        """Missing-count of the head entry (None when empty)."""
        with self._lock:
            while self._heap:
                prio, _, vid = self._heap[0]
                if self._prio.get(vid) == prio:
                    return -prio[0]
                heapq.heappop(self._heap)
            return None

    def members(self) -> dict[int, tuple]:
        with self._lock:
            return dict(self._prio)

    def __len__(self) -> int:
        with self._lock:
            return len(self._prio)


class RepairScheduler:
    """Master-side mass-rebuild scheduler (see module docstring).

    Lifecycle: `start()` spawns the scan + dispatch threads; `stop()`
    joins them. Only the raft leader dispatches (followers keep their
    queue warm from their own soft-state topology, so a failover resumes
    mid-storm). All knobs are registered repair env entries (see
    utils/config.py), overridable per-instance for tests."""

    EVENT_LOG = 1024  # bounded dispatch/outcome history for RepairStatus
    REPORT_TTL = 30.0  # seconds an un-renewed peer-unreachable report stands

    def __init__(
        self,
        master,
        *,
        max_inflight: Optional[int] = None,
        batch: Optional[int] = None,
        scan_interval: Optional[float] = None,
        settle: Optional[float] = None,
        dead_after: Optional[float] = None,
        backoff_base: Optional[float] = None,
        cap_override: Optional[int] = None,
    ) -> None:
        self.master = master
        self.max_inflight = (
            config.env("WEEDTPU_REPAIR_MAX_INFLIGHT")
            if max_inflight is None
            else max(1, int(max_inflight))
        )
        self.batch = (
            config.env("WEEDTPU_REPAIR_BATCH") if batch is None else max(1, int(batch))
        )
        self.scan_interval = (
            config.env("WEEDTPU_REPAIR_SCAN_S")
            if scan_interval is None
            else float(scan_interval)
        )
        self.settle = (
            config.env("WEEDTPU_REPAIR_SETTLE_S") if settle is None else float(settle)
        )
        self.dead_after = (
            config.env("WEEDTPU_REPAIR_DEAD_S")
            if dead_after is None
            else float(dead_after)
        )
        self.backoff_base = (
            config.env("WEEDTPU_REPAIR_BACKOFF")
            if backoff_base is None
            else float(backoff_base)
        )
        self.cap_override = (
            config.env("WEEDTPU_PLACEMENT_MAX_PER_DOMAIN")
            if cap_override is None
            else int(cap_override)
        )
        self.queue = RepairQueue()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._gate = threading.BoundedSemaphore(self.max_inflight)
        self._inflight: set[int] = set()
        self._mu = threading.Lock()
        self._events: deque = deque(maxlen=self.EVENT_LOG)
        self._seq = 0
        self._settle_until = 0.0
        #: peer-unreachable reports: suspect grpc addr -> {reporter url:
        #: monotonic ts}. Entries age out after REPORT_TTL unless renewed
        #: by a fresh heartbeat report — a reporter that recovered simply
        #: stops naming the peer and the suspicion evaporates.
        self._reports: dict[str, dict[str, float]] = {}
        #: suspects already confirmed dead — repeated reports about them
        #: must NOT keep extending the settle window (that would starve
        #: dispatch for as long as heartbeats keep naming the corpse)
        self._confirmed: set[str] = set()
        #: stripes already logged as unrecoverable (missing > m) — one
        #: LOST event per episode, not one per scan
        self._lost: set[int] = set()
        self._not_before: dict[int, float] = {}
        self._backoff: dict[int, float] = {}
        self._hist: dict[str, int] = {}
        #: per-dispatch occupancy records (bounded, newest last): how many
        #: volumes and signature groups each batch carried, the fused
        #: dispatch count the target reported, the in-batch block order,
        #: and the dispatch->response wall — the storm post-mortem data
        #: RepairStatus serves
        self._batches: deque = deque(maxlen=256)
        self._fused_volumes_total = 0
        self._threads: list[threading.Thread] = []

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._threads = [
            threading.Thread(target=self._scan_loop, daemon=True, name="repair-scan"),
            threading.Thread(
                target=self._dispatch_loop, daemon=True, name="repair-dispatch"
            ),
        ]
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        for t in self._threads:
            t.join(timeout=5.0)

    # -- event log -----------------------------------------------------------

    def _event(self, state: str, vid: int, missing: int, target: str = "", detail: str = "") -> int:
        with self._mu:
            self._seq += 1
            seq = self._seq
            self._events.append(
                {
                    "seq": seq,
                    "volume_id": int(vid),
                    "missing": int(missing),
                    "state": state,
                    "target": target,
                    "t": time.monotonic(),
                    "detail": detail[:200],
                }
            )
        return seq

    # -- death signals -------------------------------------------------------

    def kick(self, reason: str = "") -> None:
        """A death/coverage signal landed: open (or extend) the settle
        window so correlated failures rank together, then wake the
        loops. Cheap and lock-light — callable from heartbeat ingest."""
        with self._mu:
            self._settle_until = time.monotonic() + self.settle
        self._wake.set()

    def note_reports(self, reporter_url: str, peers) -> None:
        """Fold one heartbeat's peer-unreachable report in. A peer is
        treated as dead-for-repair only when it ALSO stopped
        heartbeating (`dead_after`) — one slow reporter must not declare
        a healthy node dead — but confirmed reports skip the topology
        reaper's much longer DEAD_NODE window."""
        if not peers:
            return
        newly_confirmed = False
        now = time.monotonic()
        with self._mu:
            for addr in peers:
                self._reports.setdefault(str(addr), {})[reporter_url] = now
            self._prune_reports(now)
        topo = self.master.topology
        with topo._lock:
            by_grpc = {n.grpc_address: n for n in topo.nodes.values()}
            dead_now = {
                str(addr)
                for addr in peers
                if (node := by_grpc.get(str(addr))) is None
                or (now - node.last_seen) >= self.dead_after
            }
        with self._mu:
            fresh = dead_now - self._confirmed
            self._confirmed |= fresh
            for addr in map(str, peers):
                # a suspect that is heartbeating again un-confirms, so a
                # LATER real death of the same addr kicks afresh
                if addr not in dead_now:
                    self._confirmed.discard(addr)
            newly_confirmed = bool(fresh)
        if newly_confirmed:
            self.kick("peer-unreachable report confirmed")

    def _prune_reports(self, now: float) -> None:
        """Drop aged-out report entries (caller holds _mu)."""
        for addr in list(self._reports):
            live = {
                r: t
                for r, t in self._reports[addr].items()
                if now - t < self.REPORT_TTL
            }
            if live:
                self._reports[addr] = live
            else:
                del self._reports[addr]
                self._confirmed.discard(addr)

    def _holder_live(self, node, now: float) -> bool:
        """Is this topology node a live holder for repair purposes?
        Reported-unreachable peers die at `dead_after` of heartbeat
        silence; unreported ones at 4x (a long GC pause alone must not
        trigger a mass rebuild)."""
        age = now - node.last_seen
        if age < self.dead_after:
            return True
        with self._mu:
            self._prune_reports(now)
            reported = bool(self._reports.get(node.grpc_address))
        return not reported and age < max(60.0, 4.0 * self.dead_after)

    # -- enumeration ---------------------------------------------------------

    def scan(self) -> int:
        """Enumerate every under-replicated stripe from the master's EC
        registry and (re-)rank it. Returns how many entries changed —
        the storm signal the settle window dampens.

        Confirmed-dead holders (peer-reported AND heartbeat-silent, or
        silent past the unreported bound) are EXPELLED from the topology
        first — the read-path-evidence-driven fast reaper. Without it
        the corpse's shards keep answering "present" to every consumer
        (lookup routing, rebuild survivor choice, this very scan) until
        the slow DEAD_NODE reaper lands. A resurrected node re-registers
        wholesale on its next heartbeat."""
        topo = self.master.topology
        now = time.monotonic()
        with topo._lock:
            expelled = [
                u for u, n in topo.nodes.items()
                if not self._holder_live(n, now)
            ]
        for u in expelled:
            topo.unregister_node(u)
        with topo._lock:
            live = {
                u: n for u, n in topo.nodes.items() if self._holder_live(n, now)
            }
            registry = {
                vid: {sid: set(urls) for sid, urls in m.items()}
                for vid, m in topo.ec_locations.items()
            }
            geometry = dict(getattr(topo, "ec_geometry", {}))
            domains = {
                u: (n.data_center, n.rack) for u, n in topo.nodes.items()
            }
        changed = 0
        hist: dict[str, int] = {}
        seen = set()
        for vid, shard_map in registry.items():
            holders = {
                sid: [u for u in urls if u in live]
                for sid, urls in shard_map.items()
            }
            present = {sid for sid, urls in holders.items() if urls}
            geo = geometry.get(vid) or {}
            data = int(geo.get("data_shards") or 0) or DATA_SHARDS_COUNT
            total = int(geo.get("total_shards") or 0) or TOTAL_SHARDS_COUNT
            shard_size = int(geo.get("shard_size") or 0)
            parity = max(1, total - data)
            missing = [s for s in range(total) if s not in present]
            hist[str(min(len(missing), parity + 1))] = (
                hist.get(str(min(len(missing), parity + 1)), 0) + 1
            )
            seen.add(vid)
            if not missing:
                self.queue.discard(vid)
                self._lost.discard(vid)
                continue
            if len(missing) > parity:
                if vid not in self._lost:
                    self._lost.add(vid)
                    self._event(
                        "lost", vid, len(missing),
                        detail=f"only {len(present)} shards survive, need {data}",
                    )
                self.queue.discard(vid)
                continue
            self._lost.discard(vid)
            with self._mu:
                if vid in self._inflight:
                    continue  # already being repaired; re-ranked on completion
            exposure = placement.domain_exposure(holders, domains)
            prio = RepairQueue.priority(
                len(missing), shard_size * data, exposure, vid
            )
            if self.queue.update(vid, prio):
                changed += 1
        # entries for vids that left the registry entirely (deleted)
        for vid in list(self.queue.members()):
            if vid not in seen:
                self.queue.discard(vid)
        with self._mu:
            self._hist = hist
        stats.RepairQueueDepth.set(len(self.queue))
        return changed

    # -- loops ---------------------------------------------------------------

    def _scan_loop(self) -> None:
        while not self._stop.is_set():
            woke = self._wake.wait(timeout=self.scan_interval)
            if self._stop.is_set():
                return
            if woke:
                self._wake.clear()
            try:
                if self.scan():
                    self._wake.set()  # new work: dispatch promptly
            except Exception:  # noqa: BLE001 — the scheduler must never die
                pass

    def _maintenance_idle(self) -> bool:
        """Defer the storm while an operator holds the cluster admin lock
        — exactly the auto-vacuum's discipline: a mass rebuild racing an
        ec.convert/balance would interleave on the same volumes."""
        locks = getattr(self.master, "_admin_locks", None)
        mu = getattr(self.master, "_admin_lock_mu", None)
        if locks is None or mu is None:
            return True
        now = time.monotonic()
        with mu:
            return not any(exp > now for _, exp, _ in locks.values())

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            if not len(self.queue):
                self._wake.wait(timeout=self.scan_interval)
                self._wake.clear()
                continue
            now = time.monotonic()
            with self._mu:
                settle_left = self._settle_until - now
            if settle_left > 0:
                # correlation window: a rack's nodes die milliseconds
                # apart but their heartbeats silence staggers — ranking
                # before the dust settles would start 1-missing repairs
                # that a moment later should have been 2-missing
                self._stop.wait(min(settle_left, 0.25))
                continue
            if not self.master.is_leader or not self._maintenance_idle():
                self._stop.wait(1.0)
                continue
            # acquire the inflight slot BEFORE popping: while all slots
            # are busy nothing is popped or inflight-marked, so work that
            # arrives (or re-ranks) during the wait is seen at its fresh
            # priority — popping first would dispatch a stale batch the
            # moment a slot frees, ahead of newer 2-missing stripes
            self._gate.acquire()
            if self._stop.is_set():
                self._gate.release()
                return
            with self._mu:
                settle_open = self._settle_until > time.monotonic()
            if settle_open:
                self._gate.release()
                continue  # loop re-enters the settle wait
            job = self._next_batch()
            if job is None:
                self._gate.release()
                self._stop.wait(0.25)
                continue
            threading.Thread(
                target=self._run_batch, args=job, daemon=True,
                name="repair-batch",
            ).start()

    # -- batch assembly ------------------------------------------------------

    def _topology_view(self):
        topo = self.master.topology
        now = time.monotonic()
        with topo._lock:
            nodes = [
                {
                    "url": u,
                    "grpc": n.grpc_address,
                    "data_center": n.data_center,
                    "rack": n.rack,
                    "ec_load": sum(
                        b.shard_id_count() for b in n.ec_shards.values()
                    ),
                }
                for u, n in topo.nodes.items()
                if self._holder_live(n, now)
            ]
            registry = {
                vid: {sid: sorted(urls) for sid, urls in m.items()}
                for vid, m in topo.ec_locations.items()
            }
            domains = {u: (n.data_center, n.rack) for u, n in topo.nodes.items()}
            geometry = dict(getattr(topo, "ec_geometry", {}))
            collections = dict(topo.ec_collections)
        return nodes, registry, domains, geometry, collections

    def _next_batch(self):
        """Pop the head stripe, choose its domain-compliant rebuild
        target, and greedily add queued stripes — ACROSS priority
        classes — that the same target can legally host.  One RPC then
        carries the whole settle-window cohort, and the target fuses
        every signature group into one block-diagonal decode dispatch.
        Members are added in priority order, so 2-before-1 survives as
        the batch's BLOCK order rather than as separate rounds."""
        head = self.queue.pop()
        if head is None:
            return None
        vid, prio = head
        now = time.monotonic()
        nb = self._not_before.get(vid, 0.0)
        if nb > now:
            self.queue.update(vid, prio)  # still backing off: rotate
            if len(self.queue) == 1:
                self._stop.wait(min(nb - now, 0.5))
            return None
        nodes, registry, domains, geometry, collections = self._topology_view()
        if not nodes:
            self.queue.update(vid, prio)
            self._stop.wait(1.0)
            return None

        def target_for(v: int, candidates=None):
            holders = registry.get(v) or {}
            geo = geometry.get(v) or {}
            data = int(geo.get("data_shards") or 0) or DATA_SHARDS_COUNT
            total = int(geo.get("total_shards") or 0) or TOTAL_SHARDS_COUNT
            present = {s for s, urls in holders.items() if urls}
            missing = [s for s in range(total) if s not in present]
            return placement.pick_rebuild_target(
                nodes if candidates is None else candidates,
                holders, domains, missing, max(1, total - data),
                cap_override=self.cap_override,
                strict=candidates is not None,
            ), len(missing)

        target, n_missing = target_for(vid)
        if n_missing == 0:
            # healed between rank and dispatch (a holder came back, a
            # peer's rebuild landed): nothing to send — and dispatching
            # a no-op batch would churn the event log forever
            return None
        if target is None:
            self.queue.update(vid, prio)
            self._stop.wait(1.0)
            return None
        batch = [(vid, prio, n_missing)]
        if self.batch > 1:
            for v2, p2 in sorted(
                self.queue.members().items(), key=lambda kv: kv[1]
            ):
                if len(batch) >= self.batch:
                    break
                if self._not_before.get(v2, 0.0) > now:
                    continue
                # the head's target joins the batch whenever it can
                # LEGALLY host this stripe's missing shards — requiring
                # each stripe's independently-ranked best target to
                # coincide would split the cohort by load-balance noise
                t2, m2 = target_for(v2, candidates=[target])
                if m2 == 0:
                    self.queue.discard(v2)  # healed: nothing to batch
                    continue
                if t2 is not None:
                    self.queue.discard(v2)
                    batch.append((v2, p2, m2))
        with self._mu:
            for v, _, _ in batch:
                self._inflight.add(v)
        stats.RepairInflight.set(len(self._inflight))
        vols = [
            {"volume_id": v, "collection": collections.get(v, "")}
            for v, _, _ in batch
        ]
        return (target, batch, vols)

    # -- dispatch ------------------------------------------------------------

    def _run_batch(self, target: dict, batch: list, vols: list) -> None:
        addr = target["grpc"]
        seqs = {}
        n_missing_of = {v: n for v, _, n in batch}
        for v, prio, n_missing in batch:
            seqs[v] = self._event("dispatched", v, n_missing, target=addr)
            stats.RepairDispatch.labels(str(n_missing)).inc()
        t_dispatch = time.monotonic()
        try:
            try:
                with rpc.RpcClient(addr) as c:
                    resp = c.call(
                        VOLUME_SERVICE,
                        "VolumeEcShardsRebuildBatch",
                        {"volumes": vols},
                        timeout=600,
                    )
            except grpc.RpcError as e:
                transient = e.code() in (
                    grpc.StatusCode.RESOURCE_EXHAUSTED,
                    grpc.StatusCode.UNAVAILABLE,
                )
                self._requeue(batch, str(e), transient=transient)
                return
            except Exception as e:  # noqa: BLE001 — transport-level failure
                self._requeue(batch, str(e), transient=True)
                return
            wall_s = time.monotonic() - t_dispatch
            # the RPC mounts rebuilt shards before returning, so this wall
            # IS dispatch->mount for every volume the batch carried
            block_order = [int(v) for v in resp.get("block_order", [])]
            record = {
                "target": addr,
                "volumes": len(batch),
                "signature_groups": int(resp.get("signature_groups", 0)),
                "dispatch_groups": int(resp.get("dispatch_groups", 0)),
                "block_order": block_order,
                "block_missing": [n_missing_of.get(v, 0) for v in block_order],
                "wall_s": round(wall_s, 6),
                "t": time.monotonic(),
            }
            with self._mu:
                self._batches.append(record)
                self._fused_volumes_total += int(resp.get("volumes_fused", 0))
            stats.RepairFusedVolumes.inc(int(resp.get("volumes_fused", 0)))
            stats.RepairDispatchGroups.set(int(resp.get("dispatch_groups", 0)))
            results = {
                int(r.get("volume_id", -1)): r for r in resp.get("results", [])
            }
            ok, failed = [], []
            for v, prio, n_missing in batch:
                r = results.get(v) or {}
                if r.get("error"):
                    failed.append((v, prio, n_missing, r["error"]))
                else:
                    ok.append((v, n_missing, r))
            for v, n_missing, r in ok:
                self._event(
                    "done", v, n_missing, target=addr,
                    detail=f"rebuilt {r.get('rebuilt_shard_ids')}",
                )
                with self._mu:
                    self._backoff.pop(v, None)
                    self._not_before.pop(v, None)
            for v, prio, n_missing, err in failed:
                lowered = err.lower()
                transient = (
                    "resource_exhausted" in lowered
                    or "unavailable" in lowered
                    or "503" in lowered
                )
                self._requeue(
                    [(v, prio, n_missing)], err, transient=transient
                )
        finally:
            with self._mu:
                for v, _, _ in batch:
                    self._inflight.discard(v)
            stats.RepairInflight.set(len(self._inflight))
            self._gate.release()
            self._wake.set()  # completions may unblock the next class

    def _requeue(self, batch: list, err: str, transient: bool) -> None:
        """Exponential per-stripe backoff: 503/RESOURCE_EXHAUSTED (the
        admission lane pushing back) and transport failures retry
        calmly; the stripe keeps its rank so it still beats less-urgent
        work once the backoff expires."""
        now = time.monotonic()
        for v, prio, n_missing in batch:
            with self._mu:
                cur = self._backoff.get(v, self.backoff_base)
                self._backoff[v] = min(cur * 2.0, 12.0 * self.backoff_base)
                self._not_before[v] = now + cur
            state = "backoff" if transient else "failed"
            self._event(state, v, n_missing, detail=err)
            stats.RepairBackoff.inc()
            self.queue.update(v, prio)

    # -- status --------------------------------------------------------------

    def status(self) -> dict:
        """The RepairStatus RPC payload: queue depth, inflight, the
        redundancy histogram from the last scan, current placement
        violations, suspects, and the recent event log."""
        _, registry, domains, geometry, _ = self._topology_view()
        violations: list[str] = []
        for vid, holders in sorted(registry.items()):
            geo = geometry.get(vid) or {}
            data = int(geo.get("data_shards") or 0) or DATA_SHARDS_COUNT
            total = int(geo.get("total_shards") or 0) or TOTAL_SHARDS_COUNT
            for dom, sids in placement.stripe_violations(
                holders, domains, max(1, total - data),
                cap_override=self.cap_override,
            ):
                violations.append(
                    f"vid={vid} domain={dom[0]}/{dom[1]} holds "
                    f"{len(sids)}>{placement.max_per_domain(max(1, total - data), self.cap_override)} "
                    f"shards {sids}"
                )
        stats.PlacementViolations.set(len(violations))
        now = time.monotonic()
        with self._mu:
            events = [
                {
                    "seq": e["seq"],
                    "volume_id": e["volume_id"],
                    "missing": e["missing"],
                    "state": e["state"],
                    "target": e["target"],
                    "age_s": round(now - e["t"], 3),
                    "detail": e["detail"],
                }
                for e in self._events
            ]
            hist = dict(self._hist)
            suspects = sorted(
                a for a, reporters in self._reports.items() if reporters
            )
            inflight = len(self._inflight)
            batches = [
                {
                    "target": b["target"],
                    "volumes": b["volumes"],
                    "signature_groups": b["signature_groups"],
                    "dispatch_groups": b["dispatch_groups"],
                    "block_order": list(b["block_order"]),
                    "block_missing": list(b["block_missing"]),
                    "wall_s": b["wall_s"],
                    "age_s": round(now - b["t"], 3),
                }
                for b in self._batches
            ]
            fused_total = self._fused_volumes_total
        return {
            "enabled": True,
            "queue_depth": len(self.queue),
            "inflight": inflight,
            "redundancy_histogram": hist,
            "violations": violations,
            "events": events,
            "suspects": suspects,
            "batches": batches,
            "fused_volumes_total": fused_total,
        }
