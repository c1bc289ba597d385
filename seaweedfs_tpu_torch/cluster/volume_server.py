"""Volume server — mirror of weed/server/volume_server.go, the HTTP needle
handlers (volume_server_handlers_read.go/_write.go), the heartbeat loop
(volume_grpc_client_to_master.go), and the full EC RPC surface
(volume_grpc_erasure_coding.go). Every EC RPC (generate, rebuild, convert,
verify, the slab and projection reads, to-volume) runs on the Store's
encoder: the factory's kernel on the card unless the caller passes one.
VolumeTierMove/VolumeTierFetch move a sealed volume's .dat to remote
storage (remote_storage.tier) and back; a tiered volume serves reads
from the remote copy.

Data path: HTTP GET/POST/DELETE /<vid>,<fid> against the local Store, with
EC degraded reads falling back master-lookup -> remote VolumeEcShardRead ->
reconstruction (the p50 north-star path). Control path: weedtpu.VolumeServer
RPC service. Membership: a periodic full-state Heartbeat unary to the
master (the reference's bidi stream collapsed; deltas ride the next tick).
"""

from __future__ import annotations

import base64
import http.server
import json
import os
import queue
import random
import socketserver
import threading
import urllib.error
import urllib.parse
import urllib.request
from concurrent import futures
from contextlib import ExitStack
from typing import Optional

import time

import grpc

from seaweedfs_tpu_torch import rpc, stats
from seaweedfs_tpu_torch.obs import trace as trace_mod
from seaweedfs_tpu_torch.ec import convert as convert_mod
from seaweedfs_tpu_torch.ec import scrub as scrub_mod
from seaweedfs_tpu_torch.ec import stripe
from seaweedfs_tpu_torch.security import Guard
from seaweedfs_tpu_torch.ec.ec_volume import (
    EcDegradedReadError,
    EcVolume,
    NeedleDeleted,
    NeedleNotFound,
)
from seaweedfs_tpu_torch.pb import MASTER_SERVICE, VOLUME_SERVICE, Heartbeat
from seaweedfs_tpu_torch.storage.file_id import FileId
from seaweedfs_tpu_torch.storage.needle import CrcError, Needle
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.volume import VolumeReadOnly
from seaweedfs_tpu_torch.security import tls
from seaweedfs_tpu_torch.utils import config

_COPY_CHUNK = 1024 * 1024
_EC_EXTS = [".ecx", ".ecj", ".eci"]
EC_SHARD_READ_TIMEOUT = 10.0  # s; per-holder cap on one interval read
# bulk slab streams (rebuild input): larger windows, so a longer per-call
# deadline — but still bounded, so a hung holder fails over instead of
# pinning a rebuild forever
EC_SLAB_READ_TIMEOUT = 120.0
_SLAB_CHUNK = 4 * 1024 * 1024  # bound on one CRC-framed slab-stream chunk
#: parallel survivor-fetch threads for a distributed rebuild (RTT-bound)
EC_REBUILD_FETCH_WORKERS = 16
#: longest a slab stream may WAIT for a rebuild-lane token before being
#: refused outright — an unbounded blocking acquire would pin this gRPC
#: worker and re-create the very starvation the gate exists to prevent
EC_SLAB_ADMISSION_WAIT = 15.0


def _first_multipart_file(body: bytes, ctype: str):
    """(bytes, filename, mime) of the first file part of a form upload,
    or None. email.parser handles the RFC 2046 framing (boundaries,
    part headers, trailing CRLF) so the needle stores exactly the file
    bytes the client attached."""
    import email.parser

    msg = email.parser.BytesParser().parsebytes(
        b"Content-Type: "
        + ctype.encode("latin-1", "replace")  # header charset; never raises
        + b"\r\n\r\n"
        + body
    )
    if not msg.is_multipart():
        return None
    parts = msg.get_payload()
    chosen = next(
        (p for p in parts if p.get_filename()), parts[0] if parts else None
    )
    if chosen is None:
        return None
    payload = chosen.get_payload(decode=True)
    if payload is None:
        return None
    fname = (chosen.get_filename() or "").encode("utf-8", "surrogateescape")
    return payload, fname, chosen.get_content_type()


class VolumeServer:
    def __init__(
        self,
        directories: list[str],
        master_address: str,
        port: int = 0,
        grpc_port: int = 0,
        host: str = "127.0.0.1",
        public_url: str = "",
        data_center: str = "DefaultDataCenter",
        rack: str = "DefaultRack",
        max_volume_count: int = 8,
        heartbeat_interval: float = 5.0,
        encoder=None,
        guard: Optional[Guard] = None,
        needle_map_kind: str = "memory",
        ec_lookup_ttl: float = 30.0,
        replicate_timeout: float = 5.0,
    ):
        self.guard = guard or Guard()
        # Short per-replica timeout: the fan-out is parallel, so a dead
        # replica costs one `replicate_timeout`, never a serial sum.
        self.replicate_timeout = replicate_timeout
        self.store = Store(directories, encoder=encoder, needle_map_kind=needle_map_kind)
        self.store.load()
        self.master_address = master_address
        self.host = host
        self.data_center = data_center
        self.rack = rack
        self.max_volume_count = max_volume_count
        self._hb_interval = heartbeat_interval
        self._stop = threading.Event()
        # heartbeats in flight, by sequence number: VolumeCreate answers only
        # once those that began before it have reached the masters
        self._hb_cv = threading.Condition()
        self._hb_seq = 0
        self._hb_in_flight: set[int] = set()

        self._grpc = rpc.RpcServer(port=grpc_port, host=host)
        self._grpc.add_service(self._build_service())
        self.grpc_port = self._grpc.port

        self._http = _ThreadingHTTPServer((host, port), _Handler)
        tls.maybe_wrap_https(self._http)  # data-path HTTPS when configured
        self._http.volume_server = self
        self.port = self._http.server_address[1]
        self.public_url = public_url or f"{host}:{self.port}"
        self._http_thread = threading.Thread(target=self._http.serve_forever, daemon=True)
        self._hb_thread = threading.Thread(target=self._heartbeat_loop, daemon=True)
        # HA quorum: heartbeat every master (topology is soft state on
        # each; a raft-promoted follower already has a live view)
        self._master_addresses = [
            a.strip() for a in master_address.split(",") if a.strip()
        ]
        self._masters = {a: rpc.RpcClient(a) for a in self._master_addresses}
        self._master = self._masters[self._master_addresses[0]]
        # Per-volume maintenance mutex: compact, EC-shard generation, and
        # the .dat/.idx copy streams all read/rewrite the volume FILES
        # outside the Volume's needle lock — two of them interleaving on
        # one volume (auto-vacuum racing ec.encode, balance racing compact)
        # would stream/encode a half-swapped .dat. Serializing them here
        # closes the race no matter which actor (timer or operator) fires.
        self._maint_locks: dict[int, threading.Lock] = {}
        self._maint_mu = threading.Lock()
        # degraded-read plumbing: LookupEcVolume answers are cached per vid
        # with expiry (the reference caches ShardLocations on the EcVolume)
        # and peer channels are pooled — an uncached lookup + fresh dial per
        # interval read would dominate remote-reconstruct p50
        self._peer_pool = rpc.ClientPool()
        self._shard_locs: dict[int, tuple[float, dict[int, list[str]]]] = {}
        self._shard_locs_lock = threading.Lock()
        # single-flight dedup: vid -> Event set when an in-flight master
        # lookup lands (or fails); concurrent misses wait on it instead of
        # each paying their own LookupEcVolume round-trip
        self._shard_locs_inflight: dict[int, threading.Event] = {}
        # per-vid invalidation generation: a leader whose lookup was in
        # flight when an invalidation landed must not write its (possibly
        # pre-invalidation) result into the cache
        self._shard_locs_gen: dict[int, int] = {}
        self.ec_lookup_ttl = ec_lookup_ttl
        # admission control for the rebuild lane: a storm of bulk
        # VolumeEcShardSlabRead streams (several concurrent rebuilds
        # targeting this holder) would otherwise occupy every RPC worker
        # and starve foreground interval reads. Tokens are taken for the
        # LIFE of a slab stream; waiters queue and are counted.
        self._rebuild_gate = threading.BoundedSemaphore(
            config.env("WEEDTPU_REBUILD_MAX_INFLIGHT")
        )
        # trace-repair stance, latched per server instance so tests can
        # model mixed-version clusters (an "off" peer neither advertises
        # nor serves the projection read — the capability-negotiation
        # fallback path): on | off | auto
        self._trace_repair = config.env("WEEDTPU_TRACE_REPAIR")
        # peer-unreachable accounting for the heartbeat report: the repair
        # scheduler cross-checks these against heartbeat silence, so a
        # dead holder is discovered in read-path time instead of waiting
        # for the topology reaper (initialized before scrub — its repair
        # threads exercise the peer paths from __init__ onward)
        self._peer_fail_mu = threading.Lock()
        self._peer_failures: dict[str, int] = {}
        # scrub & self-heal: the background integrity scanner (when the
        # policy is on) plus the quarantine/repair machinery it feeds.
        # Repair workers start LAZILY on the first quarantine — ec.verify
        # with quarantine:true must heal even on servers running with the
        # continuous scrubber off.
        self._scrub: Optional[scrub_mod.Scrubber] = None
        self._repair_q: "queue.Queue[tuple[int, int]]" = queue.Queue()
        self._repair_threads: list[threading.Thread] = []
        self._repair_mu = threading.Lock()
        backoff = float(config.env("WEEDTPU_SCRUB_REPAIR_BACKOFF"))
        self._repair_policy = scrub_mod.RepairPolicy(
            base=backoff, max_backoff=12.0 * backoff
        )
        # ONE quarantine ledger per server, owned here — NOT by the scan
        # thread — so pending repairs survive restarts even on servers
        # running with the continuous scrubber off (ec.verify -quarantine
        # and verify-on-read quarantine too)
        self._scrub_cursor = scrub_mod.ScrubCursor(self._scrub_cursor_path())
        for ent in list(self._scrub_cursor.quarantine):
            ev = self.store.get_ec_volume(ent["vid"])
            if ev is not None:
                ev.quarantine_shard(ent["shard"], ent["reason"])
            self._enqueue_repair(ent["vid"], ent["shard"])
        # single-flight guard for verify-on-read healing: concurrent
        # corrupt-needle reads of one volume must not each launch their
        # own cluster-wide verify fan-out
        self._heal_mu = threading.Lock()
        self._heal_locks: dict[int, threading.Lock] = {}
        if config.env("WEEDTPU_SCRUB") == "on":
            self._start_scrub()
        # inline-EC ingest (encode-on-write): when the policy is on, every
        # acked append polls the volume's stripe builder through the
        # Store.on_write seam, so a sealing volume is born EC'd instead of
        # paying a warm batch conversion; crossing the auto-seal threshold
        # finalizes in a background thread. Policy off = no hook, no cost.
        self._ingest = None
        if config.env("WEEDTPU_INLINE_EC") == "on":
            from seaweedfs_tpu_torch.ec.ingest import IngestManager

            self._ingest = IngestManager(
                self.store,
                seal_trigger=self._auto_inline_seal,
                spread_factory=(
                    self._spread_factory
                    if config.env("WEEDTPU_INLINE_EC_SPREAD") == "on"
                    else None
                ),
            )
            self.store.on_write = self._ingest.on_write

    # -- lifecycle -----------------------------------------------------------

    @property
    def url(self) -> str:
        return f"{self.host}:{self.port}"

    @property
    def grpc_address(self) -> str:
        return f"{self.host}:{self.grpc_port}"

    def start(self) -> None:
        self._grpc.start()
        self._http_thread.start()
        self.heartbeat_once()
        self._hb_thread.start()

    def _leave_cluster(self) -> None:
        """Stop heartbeating and depart the master topology (shared by
        stop() and the VolumeServerLeave RPC). Setting _stop first also
        gates heartbeat_once(): an admin RPC landing after leave must not
        re-register the drained node."""
        self._stop.set()
        try:
            self._masters_fanout("LeaveCluster", {"url": self.url}, timeout=2)
        except Exception:  # noqa: BLE001 — masters may already be gone
            pass

    def stop(self) -> None:
        self._leave_cluster()
        if self._scrub is not None:
            self._scrub.stop()  # persists the cursor; quarantine entries
            # survive on disk for the next generation's repair queue
        self._http.shutdown()
        self._http.server_close()
        self._grpc.stop()
        for c in self._masters.values():
            c.close()
        self._peer_pool.close_all()
        if self._ingest is not None:
            self._ingest.close()  # journaled state stays on disk for resume
        self.store.close()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- heartbeat -----------------------------------------------------------

    def _note_peer_failure(self, addr: str) -> None:
        """One unreachable-peer observation (degraded fetch, slab stream,
        shard pull failed at the transport). Crossing the report
        threshold puts the addr in the next heartbeat's
        unreachable_peers — the repair scheduler's fast death signal."""
        with self._peer_fail_mu:
            self._peer_failures[addr] = self._peer_failures.get(addr, 0) + 1

    def _note_peer_success(self, addr: str) -> None:
        if not self._peer_failures:
            return
        with self._peer_fail_mu:
            self._peer_failures.pop(addr, None)

    def _unreachable_peers(self) -> list[str]:
        threshold = int(config.env("WEEDTPU_REPAIR_REPORT_FAILURES"))
        with self._peer_fail_mu:
            return sorted(
                a for a, n in self._peer_failures.items() if n >= threshold
            )

    def _make_heartbeat(self) -> Heartbeat:
        stats.VolumeServerVolumeGauge.labels("normal").set(
            sum(len(loc.volumes) for loc in self.store.locations)
        )
        stats.VolumeServerVolumeGauge.labels("ec").set(
            sum(len(loc.ec_volumes) for loc in self.store.locations)
        )
        return Heartbeat(
            ip=self.host,
            port=self.port,
            grpc_port=self.grpc_port,
            public_url=self.public_url,
            data_center=self.data_center,
            rack=self.rack,
            max_volume_count=self.max_volume_count,
            volumes=self.store.volume_infos(),
            ec_shards=[i.to_dict() for i in self.store.ec_volume_infos()],
            unreachable_peers=self._unreachable_peers(),
        )

    def _masters_fanout(self, method: str, req: dict, timeout: float) -> int:
        """Call every master in PARALLEL (a firewalled master must not
        stall the round by its full RPC deadline); returns success count,
        raising the last error when none succeeded."""
        ok = [0]
        errs: list[Exception] = []
        lock = threading.Lock()

        def one(c: rpc.RpcClient) -> None:
            try:
                c.call(MASTER_SERVICE, method, req, timeout=timeout)
                with lock:
                    ok[0] += 1
            except Exception as e:  # noqa: BLE001 — that master may be down
                with lock:
                    errs.append(e)

        threads = [
            threading.Thread(target=one, args=(c,)) for c in self._masters.values()
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout + 1.0)
        if not ok[0] and errs:
            raise errs[-1]
        return ok[0]

    def heartbeat_once(self) -> None:
        if self._stop.is_set():  # left the cluster: never re-register
            return
        with self._hb_cv:  # numbered before its snapshot is taken
            self._hb_seq += 1
            seq = self._hb_seq
            self._hb_in_flight.add(seq)
        try:
            self._masters_fanout("Heartbeat", self._make_heartbeat().to_dict(), timeout=10)
        finally:
            with self._hb_cv:
                self._hb_in_flight.discard(seq)
                self._hb_cv.notify_all()

    def _await_earlier_heartbeats(self, timeout: float = 15.0) -> None:
        """Return once every heartbeat that began before this call has
        reached the masters (or `timeout` passed). A heartbeat is a full
        snapshot of the volumes: one taken before a VolumeCreate and
        ingested after the master registered the new volume would drop it
        again, and the assign that grew it would hand out a volume with no
        location (the reference's master then answers lookups empty)."""
        with self._hb_cv:
            mark = self._hb_seq
            self._hb_cv.wait_for(lambda: not any(s <= mark for s in self._hb_in_flight),
                                 timeout=timeout)

    def _master_query(self, method: str, req: dict, timeout: float = 5.0) -> dict:
        """Read query against any reachable master (soft state is on all)."""
        last_err: Exception | None = None
        for c in self._masters.values():
            try:
                return c.call(MASTER_SERVICE, method, req, timeout=timeout)
            except Exception as e:  # noqa: BLE001
                last_err = e
        raise last_err  # type: ignore[misc]

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self._hb_interval):
            try:
                # prune whole TTL volumes whose newest write aged out; the
                # heartbeat that follows drops them from the topology
                self._reap_expired_volumes()
                self.heartbeat_once()
            except Exception:  # noqa: BLE001 — keep beating; master reappears
                continue

    # -- helpers -------------------------------------------------------------

    def _base_path_for(self, vid: int, collection: str = "") -> str:
        """Existing base path for vid, else a fresh one on the emptiest disk."""
        for loc in self.store.locations:
            for candidate in (f"{collection}_{vid}" if collection else None, str(vid)):
                if candidate and (
                    os.path.exists(os.path.join(loc.directory, candidate + ".dat"))
                    or stripe.find_local_shards(os.path.join(loc.directory, candidate))
                    or os.path.exists(os.path.join(loc.directory, candidate + ".ecx"))
                ):
                    return os.path.join(loc.directory, candidate)
        loc = min(
            self.store.locations,
            key=lambda l: len(l.volumes) + len(l.ec_volumes),
        )
        base = f"{collection}_{vid}" if collection else str(vid)
        return os.path.join(loc.directory, base)

    def _lookup_shard_locations(self, vid: int) -> dict[int, list[str]]:
        """shard_id -> [grpc addresses], via the per-vid cache with expiry.
        The reference caches ShardLocations on the EcVolume and refreshes on
        an interval; an expired or missing entry pays one master round-trip,
        every other interval read within the TTL is lookup-free.

        Misses are SINGLE-FLIGHT: a burst of degraded reads against an
        uncached vid (cold start, post-invalidation) elects one leader to
        do the master round-trip; the rest wait on its Event and read the
        fresh cache. A failed leader wakes the waiters with the cache still
        cold — each retries the loop and the next one through becomes
        leader, so failures propagate per caller without a thundering herd
        on the healthy path."""
        while True:
            now = time.monotonic()
            with self._shard_locs_lock:
                hit = self._shard_locs.get(vid)
                if hit is not None and hit[0] > now:
                    return hit[1]
                ev = self._shard_locs_inflight.get(vid)
                if ev is None:
                    ev = self._shard_locs_inflight[vid] = threading.Event()
                    leader = True
                    gen0 = self._shard_locs_gen.get(vid, 0)
                else:
                    leader = False
            if not leader:
                with trace_mod.span("ec.lookup", volume=vid, role="waiter"):
                    ev.wait(timeout=30.0)
                continue  # re-check the cache; become leader if still cold
            with trace_mod.span(
                "ec.lookup", volume=vid, role="leader"
            ):
                try:
                    # bounded retry with decorrelated jitter: ONE transient
                    # master hiccup must not fail the leader AND every waiter
                    # of the burst (each would retry the loop, elect a new
                    # leader, and hammer the recovering master in lockstep).
                    # Only TRANSIENT failures retry — an application-level
                    # fault from a healthy master is final on first answer,
                    # and re-asking would just hold the single-flight
                    # leadership while every waiter queues behind a sleep.
                    retries = int(config.env("WEEDTPU_LOOKUP_RETRIES"))
                    delay = 0.05
                    for attempt in range(retries + 1):
                        try:
                            resp = self._master_query(
                                "LookupEcVolume", {"volume_id": vid}
                            )
                            break
                        except grpc.RpcError as e:
                            if attempt >= retries or e.code() not in (
                                grpc.StatusCode.UNAVAILABLE,
                                grpc.StatusCode.DEADLINE_EXCEEDED,
                            ):
                                raise
                            delay = min(1.0, random.uniform(0.05, delay * 3.0))
                            time.sleep(delay)
                        except Exception:  # noqa: BLE001 — transport-level
                            # (ConnectionError & co. from a dying channel)
                            if attempt >= retries:
                                raise
                            delay = min(1.0, random.uniform(0.05, delay * 3.0))
                            time.sleep(delay)
                    locs: dict[int, list[str]] = {}
                    for entry in resp.get("shard_id_locations", []):
                        # domain-locality ladder: the master annotates each
                        # holder with its rack/DC, so ties in the failover
                        # ladder (and the hedge's alternate pick) prefer
                        # same-rack, then same-DC holders — the cheap fetch
                        # — without any lookup at read time. Stable within
                        # a tier: the master's ordering is preserved.
                        def _locality(locd: dict) -> int:
                            if not locd.get("rack") and not locd.get("data_center"):
                                return 1  # unlabeled reply: neutral
                            if (
                                locd.get("data_center") == self.data_center
                                and locd.get("rack") == self.rack
                            ):
                                return 0
                            if locd.get("data_center") == self.data_center:
                                return 1
                            return 2
                        addrs = [
                            f"{locd['url'].rsplit(':', 1)[0]}:{locd['grpc_port']}"
                            for locd in sorted(
                                entry["locations"], key=_locality
                            )
                            if locd["url"] != self.url  # not a remote for ourselves
                        ]
                        if addrs:
                            locs[int(entry["shard_id"])] = addrs
                    with self._shard_locs_lock:
                        # an invalidation that landed mid-lookup means this
                        # answer may predate it: serve it to OUR callers (they
                        # asked before the invalidation) but leave the cache
                        # cold so the invalidator's own lookup goes to the
                        # master fresh
                        if self._shard_locs_gen.get(vid, 0) == gen0:
                            self._shard_locs[vid] = (now + self.ec_lookup_ttl, locs)
                    return locs
                finally:
                    with self._shard_locs_lock:
                        self._shard_locs_inflight.pop(vid, None)
                    ev.set()

    def _invalidate_shard_locations(self, vid: int) -> None:
        with self._shard_locs_lock:
            self._shard_locs.pop(vid, None)
            self._shard_locs_gen[vid] = self._shard_locs_gen.get(vid, 0) + 1

    def _remote_reader_for(self, vid: int):
        """RemoteReader closure for EC degraded reads: cached master
        LookupEcVolume -> pooled VolumeEcShardRead on a holder."""
        # Peer-identity state for the process-wide suspicion registry.
        # THREE layers, most-accurate first:
        #   `attempts` — one PER-CALL token per live read, naming the addr
        #     that call is inside right now + when it entered. A capped
        #     timeout fires while the pool thread still sits in the wedged
        #     holder, so the LONGEST-RUNNING live attempt for the shard is
        #     exact blame — per-call tokens mean a concurrent fast-failing
        #     read can neither clobber nor erase a blocked read's entry.
        #   `slowest` — per shard, the addr that consumed the most wall
        #     time in the most recent COMPLETED read. The slow-miss signal
        #     (recover_suspect_after) fires after the read returned; the
        #     attempt that ate the time is the wedge suspect, NOT whichever
        #     holder happened to be tried last before the miss.
        #   `last_locs` — the most recent successful lookup; deliberately
        #     survives _invalidate_shard_locations (failed reads invalidate
        #     the SERVING cache, but identity keying must not collapse to
        #     per-volume scope exactly when a peer goes bad).
        attempts: dict[object, tuple[int, str, float]] = {}
        slowest: dict[int, str] = {}
        last_locs: dict[int, list[str]] = {}

        def read(shard_id: int, offset: int, size: int) -> Optional[bytes]:
            try:
                locs = self._lookup_shard_locations(vid)
            except Exception:  # noqa: BLE001
                return None
            last_locs.update(locs)
            token = object()
            slow_addr, slow_dur = None, -1.0
            failed = False
            try:
                for addr in locs.get(shard_id, ()):
                    t0 = time.monotonic()
                    attempts[token] = (shard_id, addr, t0)
                    with trace_mod.span(
                        "ec.fetch.holder", addr=addr, shard=shard_id
                    ):
                        try:
                            chunks = self._peer_pool.get(addr).stream(
                                VOLUME_SERVICE,
                                "VolumeEcShardRead",
                                {
                                    "volume_id": vid,
                                    "shard_id": shard_id,
                                    "offset": offset,
                                    "size": size,
                                },
                                # one interval, not a bulk copy: a hung holder
                                # must not pin a degraded read for the 600s
                                # bulk-stream default — the recover fan-out
                                # treats a timeout as a miss and uses another
                                # survivor
                                timeout=EC_SHARD_READ_TIMEOUT,
                            )
                            buf = b"".join(chunks)
                            if len(buf) == size:
                                self._note_peer_success(addr)
                                return buf
                            failed = True  # holder answered short: stale layout
                            trace_mod.annotate(short=len(buf))
                        except Exception:  # noqa: BLE001 — try next holder
                            self._peer_pool.invalidate(addr)
                            self._note_peer_failure(addr)
                            failed = True
                            trace_mod.annotate(failed=True)
                        finally:
                            dur = time.monotonic() - t0
                            if dur > slow_dur:
                                slow_addr, slow_dur = addr, dur
                return None
            finally:
                attempts.pop(token, None)
                if slow_addr is not None:
                    slowest[shard_id] = slow_addr
                if failed:
                    # shards may have moved; next read re-asks the master
                    self._invalidate_shard_locations(vid)

        def peer_for(shard_id: int) -> Optional[str]:
            """Peer identity behind `shard_id` for suspicion keying —
            LOCAL-STATE-ONLY (checks run per candidate on the read ladder
            and must never add a master round-trip). Precedence: the addr
            the LONGEST-RUNNING live attempt is blocked on, then the addr
            that consumed the most time in the last completed read, then
            the primary holder from the last successful lookup. None until
            this reader has looked up at least once (EcVolume then keys
            suspicion per-volume, the narrower fallback)."""
            live = [
                (started, addr)
                for (s, addr, started) in list(attempts.values())
                if s == shard_id
            ]
            if live:
                return min(live)[1]
            addrs = last_locs.get(shard_id) or ()
            slow = slowest.get(shard_id)
            if slow and (not addrs or slow in addrs):
                # still a listed holder (or no fresher list exists): the
                # addr that ate the last read's wall time is best blame
                return slow
            if addrs:
                return addrs[0]
            # this reader never completed a read, but the SERVER may have
            # the locations cached (serving cache, possibly TTL-stale —
            # identity doesn't care): without this, a volume's FIRST
            # degraded read can't see a peer another volume already marked
            # wedged and pays its own capped attempt anyway
            with self._shard_locs_lock:
                hit = self._shard_locs.get(vid)
            if hit is not None:
                cached = hit[1].get(shard_id)
                if cached:
                    return cached[0]
            return None

        def holders_for(shard_id: int) -> list[str]:
            """Known holder addrs behind `shard_id`, LOCAL-STATE-ONLY like
            peer_for (the hedge decision runs mid-read and must never add
            a master round-trip): serving cache first (fresher after an
            invalidation), then this reader's last successful lookup."""
            with self._shard_locs_lock:
                hit = self._shard_locs.get(vid)
            if hit is not None and hit[1].get(shard_id):
                return list(hit[1][shard_id])
            return list(last_locs.get(shard_id, ()))

        def via(addr: str, shard_id: int, offset: int, size: int) -> Optional[bytes]:
            """One single-holder interval read — the hedge backup path:
            same transport, timeout, and live-attempt bookkeeping as the
            ladder, but pinned at `addr` so the backup provably lands on a
            DIFFERENT holder than the primary it is racing."""
            token = object()
            attempts[token] = (shard_id, addr, time.monotonic())
            try:
                with trace_mod.span("ec.fetch.holder", addr=addr, shard=shard_id):
                    chunks = self._peer_pool.get(addr).stream(
                        VOLUME_SERVICE,
                        "VolumeEcShardRead",
                        {
                            "volume_id": vid,
                            "shard_id": shard_id,
                            "offset": offset,
                            "size": size,
                        },
                        timeout=EC_SHARD_READ_TIMEOUT,
                    )
                    buf = b"".join(chunks)
                if len(buf) == size:
                    self._note_peer_success(addr)
                    return buf
                return None
            except Exception:  # noqa: BLE001 — a failed backup is a miss
                self._peer_pool.invalidate(addr)
                self._note_peer_failure(addr)
                return None
            finally:
                attempts.pop(token, None)

        read.peer_for = peer_for
        read.holders_for = holders_for
        read.via = via
        return read

    def _open_ec_volume(self, vid: int) -> Optional[EcVolume]:
        ev = self.store.get_ec_volume(vid)
        if ev is not None and ev.remote_reader is None:
            ev.remote_reader = self._remote_reader_for(vid)
        return ev

    # -- scrub & self-heal ----------------------------------------------------

    def _ec_volumes_snapshot(self) -> dict[int, EcVolume]:
        return {
            vid: ev
            for loc in self.store.locations
            for vid, ev in list(loc.ec_volumes.items())
        }

    def _scrub_cursor_path(self) -> str:
        path = config.env("WEEDTPU_SCRUB_CURSOR")
        if path:
            return path
        return os.path.join(
            self.store.locations[0].directory, ".scrub_cursor.json"
        )

    def _scrub_admit(self) -> bool:
        """Admission hook for scrub chunk reads: the scan yields whenever
        the rebuild lane (WEEDTPU_REBUILD_MAX_INFLIGHT) is saturated —
        integrity scanning is repair traffic and queues behind both
        foreground reads (via the rate cap) and actual rebuild streams
        (via this gate check). The token is probed, not held: a local
        chunk read is milliseconds, and pinning a slab-stream slot for a
        whole shard scan would do the starving this hook prevents."""
        if self._rebuild_gate.acquire(blocking=False):
            self._rebuild_gate.release()
            return True
        return False

    def _start_scrub(self) -> None:
        # (quarantine entries persisted by a previous generation were
        # already re-marked and re-queued at __init__ — that recovery must
        # not depend on the scan thread being enabled)
        self._scrub = scrub_mod.Scrubber(
            volumes=self._ec_volumes_snapshot,
            on_finding=self._scrub_finding,
            cursor_path=self._scrub_cursor_path(),
            rate_mb=float(config.env("WEEDTPU_SCRUB_RATE_MB")),
            chunk_bytes=int(config.env("WEEDTPU_SCRUB_CHUNK")),
            interval=float(config.env("WEEDTPU_SCRUB_INTERVAL")),
            admit=self._scrub_admit,
            cursor=self._scrub_cursor,
        )
        self._scrub.start()

    def _scrub_finding(self, vid: int, shard: int, verdict: str) -> None:
        """Quarantine one failed shard and schedule its automatic repair
        (called from the scrub thread and the verify RPC). The damaged
        file moves aside to `.bad` so shard discovery — and the rebuild
        that is about to run — treats it as missing rather than as a
        survivor; the bytes stay on disk for forensics until the repair
        verifies its replacement."""
        ev = self.store.get_ec_volume(vid)
        if ev is None:
            return
        with self.maintenance_lock(vid):
            ev.quarantine_shard(shard, verdict)
            p = stripe.shard_file_name(ev.base, shard)
            if os.path.exists(p):
                try:
                    os.replace(p, p + ".bad")
                except OSError:
                    pass  # missing-class findings have nothing to move
        self._scrub_cursor.add_quarantine(vid, shard, verdict)
        try:
            # push the shard delta to the master NOW: peers' degraded
            # reads re-route to clean holders on their next lookup
            # instead of burning an attempt on our quarantined copy
            self.heartbeat_once()
        except Exception:  # noqa: BLE001 — masters may be down mid-chaos
            pass
        self._enqueue_repair(vid, shard)

    def _enqueue_repair(self, vid: int, shard: int) -> None:
        with self._repair_mu:
            want = int(config.env("WEEDTPU_SCRUB_MAX_REPAIRS"))
            while len(self._repair_threads) < want:
                t = threading.Thread(
                    target=self._repair_loop,
                    daemon=True,
                    name=f"ec-scrub-repair-{len(self._repair_threads)}",
                )
                t.start()
                self._repair_threads.append(t)
        self._repair_q.put((vid, shard))

    def _repair_loop(self) -> None:
        """One repair worker: drain quarantined shards, honoring the
        per-shard backoff clock. Failures re-queue; the worker count
        (WEEDTPU_SCRUB_MAX_REPAIRS) is the concurrency cap."""
        while not self._stop.is_set():
            try:
                vid, shard = self._repair_q.get(timeout=0.5)
            except queue.Empty:
                continue
            key = (vid, shard)
            delay = self._repair_policy.delay(key)
            if delay > 0:
                # not due yet: wait a beat, then put it back (bounded at
                # ~2 requeues/s per pending shard, not a spin)
                self._stop.wait(min(delay, 0.5))
                self._repair_q.put(key)
                continue
            ok = False
            try:
                ok = self._repair_shard(vid, shard)
            except Exception:  # noqa: BLE001 — any failure re-queues
                ok = False
            if ok:
                self._repair_policy.succeeded(key)
                # ledger first: the ok counter is the observable "repair
                # finished" signal (tests and operators poll it), so the
                # persisted quarantine entry must already be gone when it
                # ticks
                self._scrub_cursor.remove_quarantine(vid, shard)
                stats.ScrubRepairs.labels("ok").inc()
            else:
                stats.ScrubRepairs.labels("failed").inc()
                self._repair_policy.failed(key)
                self._repair_q.put(key)

    def _repair_shard(self, vid: int, shard: int) -> bool:
        """One automatic repair attempt for a quarantined shard: pull a
        clean replica from another holder when one exists (cheapest),
        else trace-mode rebuild from survivors (slab fallback inside
        `_ec_rebuild_remote`); either way the bytes ON DISK are
        re-verified against the `.eci` CRC before the shard re-enters
        serving. True = repaired (or nothing left to repair)."""
        with trace_mod.ensure("scrub.repair", klass="scrub"):
            trace_mod.annotate(volume=vid, shard=shard)
            return self._repair_shard_inner(vid, shard)

    def _repair_shard_inner(self, vid: int, shard: int) -> bool:
        ev = self.store.get_ec_volume(vid)
        if ev is None:
            return True  # volume unmounted/deleted since: nothing to heal
        base = ev.base
        from seaweedfs_tpu_torch.storage.store import parse_base_name

        parsed = parse_base_name(os.path.basename(base))
        collection = parsed[0] if parsed else ""
        info = stripe.read_ec_info(base)
        recorded = (info or {}).get("shard_crc32")
        want_len = stripe.geometry_from_info(info).total_shards
        if not isinstance(recorded, list) or len(recorded) != want_len:
            return False  # nothing to verify a repair against
        want_size = scrub_mod.expected_shard_size(info)
        path = stripe.shard_file_name(base, shard)
        produced = os.path.exists(path)  # an earlier repair's rebuild may
        # already have regenerated this shard (one rebuild call fills
        # EVERY missing shard of the volume)
        if not produced:
            try:
                self._invalidate_shard_locations(vid)
                locs = self._lookup_shard_locations(vid)
            except Exception:  # noqa: BLE001 — master down: try a rebuild
                locs = {}
            for addr in locs.get(shard, ()):
                if self._pull_clean_shard(
                    addr, vid, collection, base, shard, recorded[shard]
                ):
                    produced = True
                    break
        if not produced:
            resp = self._ec_rebuild_remote(
                vid, collection, base, {"trace_mode": self._trace_repair}
            )
            if shard not in resp.get("rebuilt_shard_ids", []):
                return False
        # belt + braces: the rebuild CRC-verified its STREAM; this pass
        # verifies the BYTES ON DISK (a torn local write must not remount)
        verdict = scrub_mod.scan_shard_file(path, recorded[shard], want_size)
        if verdict != scrub_mod.OK:
            try:
                os.unlink(path)
            except OSError:
                pass
            return False
        with self.maintenance_lock(vid):
            if not ev.mount_local_shard(shard):
                return False
            try:
                os.unlink(path + ".bad")
            except OSError:
                pass
        try:
            self.heartbeat_once()  # the shard is a holder again
        except Exception:  # noqa: BLE001
            pass
        return True

    def _heal_needle_read(self, vid: int, needle_id: int, cookie=None):
        """A needle read failed its body crc32c (Needle.from_bytes) — some
        interval of it was served from a corrupt copy BEFORE the
        background scrubber reached it. Verify-on-read is the second
        detection layer: identify the damaged shard (scan the needle's
        local shards against .eci; failing that, ask every remote holder
        of the touched shards to verify-and-quarantine via the
        VolumeEcShardsVerify RPC), quarantine it, and retry the read —
        with the bad copy out of serving, the ladder reconstructs from
        clean survivors and the CLIENT NEVER SEES THE CORRUPT BYTES.
        Raises when no culprit can be identified (nothing left to heal
        with) — a 500, not silently-served garbage.

        Healing is SINGLE-FLIGHT per volume: concurrent corrupt-needle
        reads serialize on a per-vid lock and re-try the read first —
        whoever got there before us likely already quarantined the
        culprit, so one flipped bit costs one verify fan-out, never a
        scan storm across every holder per concurrent reader."""
        with self._heal_mu:
            lk = self._heal_locks.setdefault(vid, threading.Lock())
        with lk:
            try:
                return self.store.read_ec_needle(vid, needle_id, cookie)
            except CrcError:
                pass  # still corrupt: we are the healer
            return self._heal_needle_read_locked(vid, needle_id, cookie)

    def _heal_needle_read_locked(self, vid: int, needle_id: int, cookie=None):
        with trace_mod.ensure("heal.verify", klass="scrub"):
            trace_mod.annotate(volume=vid, needle=needle_id)
            return self._heal_needle_read_hunt(vid, needle_id, cookie)

    def _heal_needle_read_hunt(self, vid: int, needle_id: int, cookie=None):
        ev = self._open_ec_volume(vid)
        if ev is None:
            raise IOError(f"needle {needle_id:x}: body crc mismatch")
        _, _, intervals = ev.locate_needle(needle_id)
        touched = sorted(
            {iv.to_shard_id_and_offset(ev.large, ev.small)[0] for iv in intervals}
        )
        info = stripe.read_ec_info(ev.base)
        recorded = (info or {}).get("shard_crc32")
        found = False
        if isinstance(recorded, list) and len(recorded) == stripe.geometry_from_info(info).total_shards:
            want_size = scrub_mod.expected_shard_size(info)
            for s in touched:
                if s not in ev._shard_files:
                    continue
                verdict = scrub_mod.scan_shard_file(
                    stripe.shard_file_name(ev.base, s), recorded[s], want_size
                )
                if verdict != scrub_mod.OK:
                    stats.ScrubCorruptionsFound.labels(verdict).inc()
                    self._scrub_finding(vid, s, verdict)
                    found = True
        if not found:
            # the corrupt interval may have been FETCHED from a peer
            # holder whose scrubber has not reached it: ask every holder
            # of the touched shards to verify-and-quarantine its copies,
            # then re-route — the retry lands on a clean replica (or
            # reconstructs around the quarantined one)
            try:
                locs = self._lookup_shard_locations(vid)
            except Exception:  # noqa: BLE001 — master down: nothing to ask
                locs = {}
            for addr in sorted({a for s in touched for a in locs.get(s, ())}):
                try:
                    r = self._peer_pool.get(addr).call(
                        VOLUME_SERVICE,
                        "VolumeEcShardsVerify",
                        {"volume_id": vid, "quarantine": True},
                        timeout=30,
                    )
                    if r.get("quarantined"):
                        found = True
                except Exception:  # noqa: BLE001 — holder down: next
                    continue
            if found:
                self._invalidate_shard_locations(vid)
        if not found:
            raise IOError(
                f"needle {needle_id:x}: body crc mismatch and no corrupt "
                "shard could be identified on any holder"
            )
        try:
            return self.store.read_ec_needle(vid, needle_id, cookie)
        except CrcError as e:
            # a second corrupt copy survived the quarantine round (e.g.
            # damage outside the touched shards, or a peer's verify raced
            # its own repair): surface a typed IOError — the HTTP handler
            # answers 500 JSON, never a dropped connection
            raise IOError(
                f"needle {needle_id:x}: still failing body crc after "
                "quarantining a corrupt shard — repair in progress"
            ) from e

    def _pull_clean_shard(
        self,
        addr: str,
        vid: int,
        collection: str,
        base: str,
        shard: int,
        want_crc: int,
    ) -> bool:
        """Re-pull one shard file from a peer holder, CRC-verifying the
        stream against the `.eci` record BEFORE it replaces anything —
        the peer's copy may be silently corrupt too (its own scrubber
        just hasn't reached it), and a repair must never launder bad
        bytes back into serving."""
        import zlib

        tmp = base + stripe.to_ext(shard) + ".cpy"
        try:
            chunks = self._peer_pool.get(addr).stream(
                VOLUME_SERVICE,
                "VolumeEcShardFileCopy",
                {"volume_id": vid, "collection": collection,
                 "ext": stripe.to_ext(shard)},
                timeout=EC_SLAB_READ_TIMEOUT,
            )
            crc = 0
            with open(tmp, "wb") as f:
                for chunk in chunks:
                    crc = zlib.crc32(chunk, crc)
                    f.write(chunk)
                f.flush()
                os.fsync(f.fileno())
            if crc != (want_crc & 0xFFFFFFFF):
                return False  # replica is damaged too: rebuild instead
            os.replace(tmp, base + stripe.to_ext(shard))
            return True
        except Exception:  # noqa: BLE001 — holder down/short: next option
            return False
        finally:
            if os.path.exists(tmp):
                try:
                    os.remove(tmp)
                except OSError:
                    pass

    # -- RPC service ---------------------------------------------------------

    def _build_service(self) -> rpc.Service:
        svc = rpc.Service(VOLUME_SERVICE)
        add = svc.add
        add("VolumeCreate", self._rpc_volume_create)
        add("VolumeDelete", self._rpc_volume_delete)
        add("VolumeMarkReadonly", self._rpc_mark_readonly)
        add("VolumeMarkWritable", self._rpc_mark_writable)
        add("VolumeCompact", self._rpc_compact)
        add("VolumeCopy", self._rpc_volume_copy)
        add("VolumeStatus", self._rpc_volume_status)
        add("WriteNeedle", self._rpc_write_needle)
        add("DeleteNeedle", self._rpc_delete_needle)
        add("VolumeEcShardsGenerate", self._rpc_ec_generate)
        add("VolumeEcShardsCopy", self._rpc_ec_copy)
        add("VolumeEcShardsRebuild", self._rpc_ec_rebuild)
        add("VolumeEcShardsRebuildBatch", self._rpc_ec_rebuild_batch)
        add("VolumeEcShardPartialWrite", self._rpc_ec_partial_write)
        add("VolumeEcShardSpreadCommit", self._rpc_ec_spread_commit)
        add("VolumeEcShardsConvert", self._rpc_ec_convert)
        add("VolumeEcShardsVerify", self._rpc_ec_verify)
        add("VolumeEcShardsMount", self._rpc_ec_mount)
        add("VolumeEcShardsUnmount", self._rpc_ec_unmount)
        add("VolumeEcShardRead", self._rpc_ec_shard_read, kind="unary_stream", resp_format="bytes")
        add("VolumeEcShardSlabRead", self._rpc_ec_slab_read, kind="unary_stream", resp_format="bytes")
        add("VolumeEcShardFileCopy", self._rpc_ec_file_copy, kind="unary_stream", resp_format="bytes")
        add("VolumeEcBlobDelete", self._rpc_ec_blob_delete)
        add("VolumeEcShardsToVolume", self._rpc_ec_to_volume)
        add("VolumeEcShardsDelete", self._rpc_ec_delete)
        add("VolumeTierMove", self._rpc_tier_move)
        add("VolumeTierFetch", self._rpc_tier_fetch)
        add("VolumeMount", self._rpc_volume_mount)
        add("VolumeUnmount", self._rpc_volume_unmount)
        add("VolumeConfigure", self._rpc_volume_configure)
        add("VolumeNeedleIds", self._rpc_needle_ids)
        add("VolumeNeedleTs", self._rpc_needle_ts)
        add("ReadNeedle", self._rpc_read_needle)
        add("VolumeServerLeave", self._rpc_server_leave)
        return svc

    # volume admin

    def _rpc_volume_create(self, req: dict, ctx) -> dict:
        self.store.create_volume(
            int(req["volume_id"]),
            collection=req.get("collection", ""),
            replication=req.get("replication") or "000",
            ttl=req.get("ttl", ""),
        )
        # the master registers the volume when this returns
        self._await_earlier_heartbeats()
        return {}

    def _rpc_volume_delete(self, req: dict, ctx) -> dict:
        if self._ingest is not None:  # partial stripe state dies with the .dat
            v = self.store.get_volume(int(req["volume_id"]))
            self._ingest.discard(
                int(req["volume_id"]), v.base_path if v is not None else None
            )
        self.store.remove_volume(int(req["volume_id"]))
        self.heartbeat_once()  # push the deletion to the master now
        return {}

    def _rpc_mark_readonly(self, req: dict, ctx) -> dict:
        v = self.store.get_volume(int(req["volume_id"]))
        if v is None:
            raise rpc.NotFoundFault(f"volume {req['volume_id']} not found")
        v.read_only = True
        return {}

    def _rpc_mark_writable(self, req: dict, ctx) -> dict:
        v = self.store.get_volume(int(req["volume_id"]))
        if v is None:
            raise rpc.NotFoundFault(f"volume {req['volume_id']} not found")
        v.read_only = False
        return {}

    def _reap_expired_volumes(self) -> None:
        """TTL reap under the per-volume maintenance mutex: a volume that
        is frozen (balance/ec.encode in flight) or mid-copy must not have
        its files unlinked underneath the operation — it stays for the
        next sweep. The expiry re-check happens under the VOLUME lock and
        flips read_only before any unlink, so a write acked after the
        sweep's scan either refreshed the mtime (volume survives) or is
        refused — an acknowledged write is never deleted."""
        for vid in self.store.expired_volume_ids():
            with self.maintenance_lock(vid):
                vol = self.store.get_volume(vid)
                if vol is None or vol.read_only:
                    continue  # frozen: an operator operation owns it
                with vol._lock:
                    if not vol.is_expired():
                        continue  # a write landed since the scan
                    vol.read_only = True  # fence out further writes
                self.store.remove_volume(vid)

    def maintenance_lock(self, vid: int) -> threading.Lock:
        with self._maint_mu:
            lk = self._maint_locks.get(vid)
            if lk is None:
                lk = self._maint_locks[vid] = threading.Lock()
            return lk

    def _rpc_compact(self, req: dict, ctx) -> dict:
        vid = int(req["volume_id"])
        v = self.store.get_volume(vid)
        if v is None:
            raise rpc.NotFoundFault(f"volume {req['volume_id']} not found")
        with self.maintenance_lock(vid):
            v = self.store.get_volume(vid)
            if v is None:
                raise rpc.NotFoundFault(f"volume {vid} not found")
            if v.read_only:
                # frozen volumes are frozen for a reason (ec.encode, copy in
                # flight): compacting one would shift every needle offset
                raise rpc.RpcFault(f"volume {vid} is read-only; not compacting")
            if self._ingest is not None:
                # compaction rewrites the whole .dat: every encoded inline
                # row is stale — drop the state (journal + partials too),
                # a fresh builder restarts from the compacted file on the
                # next write
                self._ingest.discard(vid, v.base_path)
            before, after = v.compact()
            if self._ingest is not None:
                # again AFTER the rewrite: a write that acked just before
                # the compact may have raced a builder back into existence
                # from the PRE-compact .dat between the first discard and
                # the offset-shifting rewrite
                self._ingest.discard(vid, v.base_path)
        return {"bytes_before": before, "bytes_after": after}

    def _rpc_volume_copy(self, req: dict, ctx) -> dict:
        """VolumeCopy: pull a volume's .dat/.idx from source_data_node and
        load it locally (volume_grpc_copy.go analog; serves
        volume.fix.replication)."""
        vid = int(req["volume_id"])
        collection = req.get("collection", "")
        if self.store.get_volume(vid) is not None:
            raise rpc.RpcFault(f"volume {vid} already exists locally")
        base = self._base_path_for(vid, collection)
        # pull BOTH files to temp names, rename only once both are complete:
        # a half-copied volume must never be discoverable by Store.load()
        tmps = {ext: base + ext + ".cpy" for ext in (".dat", ".idx")}
        try:
            with rpc.RpcClient(req["source_data_node"]) as c:
                for ext, tmp in tmps.items():
                    chunks = c.stream(
                        VOLUME_SERVICE,
                        "VolumeEcShardFileCopy",
                        {"volume_id": vid, "collection": collection, "ext": ext},
                    )
                    with open(tmp, "wb") as f:
                        for chunk in chunks:
                            f.write(chunk)
                        f.flush()
                        os.fsync(f.fileno())
            for ext, tmp in tmps.items():
                os.replace(tmp, base + ext)
        finally:
            for tmp in tmps.values():
                if os.path.exists(tmp):
                    os.remove(tmp)
        from seaweedfs_tpu_torch.storage.volume import Volume

        loc = next(
            l for l in self.store.locations if os.path.dirname(base) == l.directory
        )
        v = Volume(loc.directory, vid, collection)
        v.read_only = bool(req.get("read_only", False))
        loc.volumes[vid] = v
        self.heartbeat_once()
        return {"size": os.path.getsize(base + ".dat")}

    def _rpc_tier_move(self, req: dict, ctx) -> dict:
        """VolumeTierMove: upload the .dat to remote storage and reopen
        the volume through the remote backend."""
        from seaweedfs_tpu_torch.remote_storage import make_remote_client
        from seaweedfs_tpu_torch.remote_storage.tier import tier_move
        from seaweedfs_tpu_torch.storage.volume import Volume

        vid = int(req["volume_id"])
        v = self.store.get_volume(vid)
        if v is None:
            raise rpc.NotFoundFault(f"volume {vid} not found")
        if v.tiered:
            raise rpc.RpcFault(f"volume {vid} is already tiered")
        client = make_remote_client(req["destination"])
        if self._ingest is not None:  # the local .dat is leaving this disk
            self._ingest.discard(vid, v.base_path)
        was_read_only = v.read_only
        v.read_only = True  # freeze writes; READS keep serving during upload
        try:
            info = tier_move(
                v.base_path,
                client,
                key_prefix=req.get("key_prefix") or "volumes/",
                keep_local=True,
            )
        except Exception:
            v.read_only = was_read_only
            raise
        # upload verified: swap to the remote backend (the only offline
        # window is this close/remove/reopen, not the upload itself)
        v.close()
        os.remove(v.base_path + ".dat")
        for loc in self.store.locations:
            if loc.volumes.get(vid) is v:
                loc.volumes[vid] = Volume(loc.directory, vid, v.collection)
        self.heartbeat_once()
        return {"size": info["size"], "key": info["key"]}

    def _rpc_tier_fetch(self, req: dict, ctx) -> dict:
        """VolumeTierFetch: bring a tiered .dat back to local disk."""
        from seaweedfs_tpu_torch.remote_storage.tier import tier_fetch
        from seaweedfs_tpu_torch.storage.volume import Volume

        vid = int(req["volume_id"])
        v = self.store.get_volume(vid)
        if v is None:
            raise rpc.NotFoundFault(f"volume {vid} not found")
        if not v.tiered:
            raise rpc.RpcFault(f"volume {vid} is not tiered")
        v.close()
        tier_fetch(v.base_path)
        for loc in self.store.locations:
            if loc.volumes.get(vid) is v:
                loc.volumes[vid] = Volume(loc.directory, vid, v.collection)
        self.heartbeat_once()
        return {"size": os.path.getsize(v.base_path + ".dat")}

    def _rpc_volume_status(self, req: dict, ctx) -> dict:
        vid = int(req["volume_id"])
        v = self.store.get_volume(vid)
        if v is not None:
            return {
                "volume_id": vid,
                "kind": "normal",
                "size": v.content_size(),
                "file_count": v.needle_count(),
                "read_only": v.read_only,
                "rack": self.rack,
                "data_center": self.data_center,
            }
        ev = self.store.get_ec_volume(vid)
        if ev is not None:
            per_shard: dict[str, int] = {}
            for s in ev.shard_ids:
                try:
                    per_shard[str(s)] = os.path.getsize(
                        stripe.shard_file_name(ev.base, s)
                    )
                except OSError:  # racing unmount/delete: omit, don't fault
                    continue
            return {
                "volume_id": vid,
                "kind": "ec",
                "shard_ids": ev.shard_ids,
                "shard_size": ev.shard_size,
                # per-shard, not the max: a remote rebuilder's geometry
                # preflight must see a truncated shard hiding behind a
                # healthy sibling on the same holder
                "shard_file_sizes": per_shard,
                # trace-repair planners only group shards onto holders
                # that advertise the projection read
                "capabilities": (
                    ["slab_projection"] if self._trace_repair != "off" else []
                ),
                # shards pulled from serving by failed integrity
                # verification (scrub/ec.verify), with WHY — operators and
                # rebuilding peers must be able to tell "quarantined,
                # repair pending" from "never held here"
                "quarantined": {
                    str(s): r for s, r in sorted(ev.quarantined.items())
                },
                # recorded geometry: ec.convert's pre-copy pulls only the
                # <= k shards the conversion reads, and shell maintenance
                # (ec.rebuild) scans missing shards over THIS volume's
                # total, not the legacy 14
                "data_shards": ev.data_shards,
                "total_shards": ev.total_shards,
                # failure-domain labels: placement planners and operator
                # audits read the holder's rack/zone straight off status
                "rack": self.rack,
                "data_center": self.data_center,
            }
        raise rpc.NotFoundFault(f"volume {vid} not found")

    # needle ops over RPC (HTTP is the primary data path; these serve
    # replication fan-out and tests)

    def _rpc_write_needle(self, req: dict, ctx) -> dict:
        import base64

        fid = FileId.parse(req["fid"])
        n = Needle(cookie=fid.cookie, id=fid.key, data=base64.b64decode(req["data"]))
        # *_b64 carry raw bytes losslessly (the check.disk repair path);
        # the plain fields remain for human callers with UTF-8 names
        if req.get("name_b64"):
            n.name = base64.b64decode(req["name_b64"])
        elif req.get("name"):
            n.name = req["name"].encode()
        if req.get("mime_b64"):
            n.mime = base64.b64decode(req["mime_b64"])
        elif req.get("mime"):
            n.mime = req["mime"].encode()
        offset, size = self.store.write_needle(fid.volume_id, n)
        return {"size": size}

    def _rpc_delete_needle(self, req: dict, ctx) -> dict:
        fid = FileId.parse(req["fid"])
        found = self.store.delete_needle(fid.volume_id, fid.key)
        return {"found": bool(found)}

    def _rpc_read_needle(self, req: dict, ctx) -> dict:
        """Read one needle by id (no cookie check) — serves volume.check.disk's
        replica sync, where the repairer must copy the needle verbatim
        (cookie included) from the replica that has it."""
        import base64

        try:
            # wire the remote reader first: an EC volume whose stripe is
            # partly remote (spread parity, lost local shards) must serve
            # this read through the same degraded ladder as the HTTP path
            self._open_ec_volume(int(req["volume_id"]))
            n = self.store.read_needle(int(req["volume_id"]), int(req["needle_id"]))
        except CrcError:
            # same verify-on-read healing as the HTTP path: a repairer
            # must get clean reconstructed bytes, never corrupt ones
            n = self._heal_needle_read(int(req["volume_id"]), int(req["needle_id"]))
        except KeyError as e:  # volume or needle gone (racing delete): typed fault
            raise rpc.NotFoundFault(str(e)) from e
        return {
            "cookie": n.cookie,
            "data": base64.b64encode(n.data).decode(),
            # b64, not a lossy text decode: names/mimes are raw bytes, and a
            # repair must round-trip them verbatim
            "name_b64": base64.b64encode(n.name or b"").decode(),
            "mime_b64": base64.b64encode(n.mime or b"").decode(),
            # volume.fsck's -cutoffTimeAgo filter reads this to spare
            # needles written while the check was running
            "append_at_ns": n.append_at_ns,
        }

    def _rpc_volume_mount(self, req: dict, ctx) -> dict:
        """Re-open an unmounted volume from disk (VolumeMount analog)."""
        if not self.store.mount_volume(int(req["volume_id"])):
            raise rpc.NotFoundFault(f"no files for volume {req['volume_id']}")
        self.heartbeat_once()
        return {}

    def _rpc_volume_unmount(self, req: dict, ctx) -> dict:
        """Stop serving a volume but keep its files (VolumeUnmount analog)
        — operators use it to fence a volume for offline inspection."""
        if not self.store.unmount_volume(int(req["volume_id"])):
            raise rpc.NotFoundFault(f"volume {req['volume_id']} not mounted")
        self.heartbeat_once()
        return {}

    def _rpc_volume_configure(self, req: dict, ctx) -> dict:
        """Change a volume's replica placement in its superblock
        (volume.configure.replication analog)."""
        v = self.store.get_volume(int(req["volume_id"]))
        if v is None:
            raise rpc.NotFoundFault(f"volume {req['volume_id']} not found")
        if getattr(v, "tiered", False):
            raise rpc.RpcFault(
                f"volume {v.id} is tiered — fetch it local first (volume.tier.fetch)",
                code=grpc.StatusCode.FAILED_PRECONDITION,
            )
        if self._ingest is not None:
            # the superblock rewrite is an IN-PLACE .dat overwrite inside
            # stripe row 0 — route it through the journaled delta-parity
            # path so the inline stripe stays exact instead of silently
            # stale (the end-to-end consumer of Encoder.parity_delta).
            # Under the maintenance lock: a seal (generate/auto-seal) holds
            # it while finalizing, so the rewrite can never land BETWEEN
            # the builder being popped and the shards being renamed — the
            # window where it would bypass the delta path silently.
            import dataclasses

            from seaweedfs_tpu_torch.storage.super_block import ReplicaPlacement

            with self.maintenance_lock(int(req["volume_id"])):
                old = v.super_block.to_bytes()
                new = dataclasses.replace(
                    v.super_block,
                    replica_placement=ReplicaPlacement.parse(req["replication"]),
                ).to_bytes()
                self._ingest.overwrite(
                    int(req["volume_id"]), 0, old, new,
                    mutate=lambda: v.configure_replication(req["replication"]),
                )
        else:
            v.configure_replication(req["replication"])
        self.heartbeat_once()  # the topology keys layouts by (coll, rp, ttl)
        return {"replication": str(v.super_block.replica_placement)}

    def _rpc_needle_ids(self, req: dict, ctx) -> dict:
        """Page through a volume's LIVE needle ids (id, size ascending by id)
        — volume.check.disk diffs these across replicas. The first page also
        carries the volume's tombstoned ids (from the .idx history) so the
        repairer can tell "replica missed the write" from "replica processed
        the delete" and propagate the delete instead of resurrecting."""
        v = self.store.get_volume(int(req["volume_id"]))
        if v is None:
            raise rpc.NotFoundFault(f"volume {req['volume_id']} not found")
        limit = min(int(req.get("limit") or 65536), 65536)
        if req.get("tombstones"):  # tombstone-history page, same resume protocol
            rows, truncated = v.tombstone_history(
                int(req.get("deleted_start_from", 0)), limit
            )
            return {
                "deleted": [{"id": k, "final_dead": d} for k, d in rows],
                "deleted_truncated": truncated,
            }
        entries, truncated = v.needle_entries_page(int(req.get("start_from", 0)), limit)
        return {
            "entries": [{"id": k, "size": s} for k, s in entries],
            "truncated": truncated,
        }

    def _rpc_needle_ts(self, req: dict, ctx) -> dict:
        """Batch append_at_ns lookup (8-byte read per needle, no payload)
        — volume.fsck's -cutoffTimeAgo filter dates orphan candidates with
        one RPC per volume instead of a full ReadNeedle per orphan."""
        v = self.store.get_volume(int(req["volume_id"]))
        if v is None:
            raise rpc.NotFoundFault(f"volume {req['volume_id']} not found")
        ts = v.needle_append_ts([int(n) for n in req.get("needle_ids", [])])
        return {"ts": {str(k): v_ for k, v_ in ts.items()}}

    def _rpc_server_leave(self, req: dict, ctx) -> dict:
        """Stop heartbeating and depart the master's topology
        (volumeServer.leave analog). The process keeps serving reads so an
        operator can drain it; a later stop() is a no-op for the heartbeat."""
        self._leave_cluster()
        return {"left": True}

    # EC surface

    def _rpc_ec_generate(self, req: dict, ctx) -> dict:
        """VolumeEcShardsGenerate: local .dat+.idx -> 14 shards + .ecx.

        With `inline: true` the shards are finalized from the encode-on-
        write stripe state (resumed from the journaled sidecar after a
        crash) instead of re-encoding the whole sealed .dat — byte-
        identical output, but the bulk of the encode already happened at
        ingest time. Any unusable inline state (policy off, geometry
        mismatch, broken/un-vouchable journal) falls back to the warm
        conversion inside the same call; the response's `mode` says which
        path actually produced the shards."""
        vid = int(req["volume_id"])
        v = self.store.get_volume(vid)
        if v is None:
            raise rpc.NotFoundFault(f"volume {vid} not found")
        kwargs = {}
        if req.get("large_block_size"):
            kwargs["large_block_size"] = int(req["large_block_size"])
        if req.get("small_block_size"):
            kwargs["small_block_size"] = int(req["small_block_size"])
        t0 = time.monotonic()
        info: dict = {"mode": "warm"}
        with self.maintenance_lock(vid):  # never interleave with compact/copy
            if req.get("inline") and self._inline_usable(kwargs):
                info = self._ingest.seal_volume(vid, v.base_path)
                # the SHELL owns this seal's cut-over (ec.encode copies +
                # spreads from here): discard any pre-spread partials so
                # its allocation starts from the full local set
                self._finalize_spread(vid, v.base_path, "shell")
            else:
                if self._ingest is not None:
                    # a warm generate supersedes any inline partial state:
                    # leftovers must not shadow the fresh shard set — base
                    # included, so journaled state from before a restart
                    # (no live builder) is scrubbed from disk too
                    self._ingest.discard(vid, v.base_path)
                stripe.write_ec_files(
                    v.base_path, encoder=self.store.encoder, **kwargs
                )
            stripe.write_sorted_file_from_idx(v.base_path)
        stats.EcEncodeSeconds.observe(time.monotonic() - t0)
        stats.EcEncodeBytes.inc(os.path.getsize(v.base_path + ".dat"))
        total = stripe.geometry_from_info(
            stripe.read_ec_info(v.base_path)
        ).total_shards
        return {
            "shard_ids": list(range(total)),
            "mode": info.get("mode", "warm"),
            "inline_rows": int(info.get("rows_inline", 0)),
            "delta_updates": int(info.get("delta_updates", 0)),
        }

    def _inline_usable(self, kwargs: dict) -> bool:
        """Inline finalize serves the request only when the policy is on
        and any explicitly-requested geometry matches what the builders
        encoded with — a mismatched request warm-encodes with ITS sizes."""
        if self._ingest is None:
            return False
        if kwargs.get("large_block_size", self._ingest.large) != self._ingest.large:
            return False
        if kwargs.get("small_block_size", self._ingest.small) != self._ingest.small:
            return False
        return True

    def _auto_inline_seal(self, vid: int) -> None:
        """Threshold auto-seal (WEEDTPU_INLINE_EC_SEAL_BYTES): freeze the
        volume, finalize its inline stripe (warm fallback inside
        seal_volume), write the sorted index, and mount the EC volume —
        the volume is born EC'd with no operator in the loop. Reads keep
        serving from the now read-only volume; spreading shards across
        the cluster stays the shell's (ec.encode) cut-over decision."""
        sealed = False
        froze = False  # only roll back a freeze THIS seal applied — the
        # early-return guard must never un-freeze a volume an operator
        # (or the shell's ec.encode) made read-only
        v = None
        try:
            with self.maintenance_lock(vid):
                v = self.store.get_volume(vid)
                if v is None or v.read_only or getattr(v, "tiered", False):
                    return
                with v._lock:
                    v.read_only = True
                    froze = True
                t0 = time.monotonic()
                seal_info = self._ingest.seal_volume(vid, v.base_path)
                stripe.write_sorted_file_from_idx(v.base_path)
                # spread cut-over BEFORE the local mount: committed parity
                # shards mount on their planned holders and vanish from
                # this node's discovery set — the volume is born spread,
                # the owner never hosts all k+m (broken/unplanned spreads
                # leave everything local exactly as before)
                spread_done = self._finalize_spread(
                    vid, v.base_path, seal_info.get("mode", "warm")
                )
                self.store.mount_ec_volume(vid, v.base_path)
                stats.EcEncodeSeconds.observe(time.monotonic() - t0)
                stats.EcEncodeBytes.inc(os.path.getsize(v.base_path + ".dat"))
                if spread_done:
                    trace_mod.annotate(spread=spread_done)
                sealed = True
            self.heartbeat_once()
        except Exception:  # noqa: BLE001 — auto-seal is opportunistic: the
            # volume must come back writable and the trigger re-arms, so a
            # transient failure costs a retry at the next threshold write
            pass
        finally:
            if not sealed and self._ingest is not None:
                if froze:
                    v.read_only = False
                self._ingest.seal_failed(vid)

    def _rpc_ec_copy(self, req: dict, ctx) -> dict:
        """VolumeEcShardsCopy: PULL the named shards (+index files) from the
        source node into local storage (streaming file copy)."""
        vid = int(req["volume_id"])
        collection = req.get("collection", "")
        shard_ids = [int(s) for s in req.get("shard_ids", [])]
        src = req["source_data_node"]  # grpc address host:port
        base = self._base_path_for(vid, collection)
        with rpc.RpcClient(src) as c:
            names = [stripe.to_ext(s) for s in shard_ids]
            if req.get("copy_ecx_file", True):
                names += _EC_EXTS
            for name in names:
                try:
                    chunks = c.stream(
                        VOLUME_SERVICE,
                        "VolumeEcShardFileCopy",
                        {"volume_id": vid, "collection": collection, "ext": name},
                    )
                    tmp = base + name + ".cpy"
                    try:
                        with open(tmp, "wb") as f:
                            for chunk in chunks:
                                f.write(chunk)
                            f.flush()
                            os.fsync(f.fileno())
                        os.replace(tmp, base + name)
                    finally:
                        if os.path.exists(tmp):
                            os.remove(tmp)
                except Exception:
                    if name in (".ecj", ".eci"):  # optional files
                        continue
                    raise
        return {}

    # -- inline-ingest parity spreading (WEEDTPU_INLINE_EC_SPREAD) -----------

    def _spread_factory(self, vid: int, base: str):
        """Build a SpreadSession for one ingesting volume: ask the master
        for the live topology, run the failure-domain planner over it,
        and tee each parity shard at its planned eventual holder. None
        (no spreading, seal stays fully local) when the cluster has no
        viable targets or the master is unreachable."""
        from seaweedfs_tpu_torch.ec import placement
        from seaweedfs_tpu_torch.ec import spread as spread_mod
        from seaweedfs_tpu_torch.ec.shard_bits import ShardBits
        from seaweedfs_tpu_torch.storage.store import parse_base_name

        topo = self._master_query("VolumeList", {})
        nodes: list[dict] = []
        for dc, racks in (topo.get("data_centers") or {}).items():
            for rack, nds in racks.items():
                for nd in nds:
                    nodes.append(
                        {
                            "url": nd["url"],
                            "grpc": f"{nd['url'].rsplit(':', 1)[0]}:{nd['grpc_port']}",
                            "data_center": dc,
                            "rack": rack,
                            "ec_load": sum(
                                ShardBits(e.get("shard_bits", 0)).shard_id_count()
                                for e in nd.get("ec_shards", [])
                            ),
                        }
                    )
        enc = self.store.encoder
        targets = placement.plan_parity_targets(
            nodes,
            self.url,
            enc.data_shards,
            enc.total_shards,
            cap_override=int(config.env("WEEDTPU_PLACEMENT_MAX_PER_DOMAIN")),
            load_of=lambda n: n["ec_load"],
        )
        if not targets:
            return None
        parsed = parse_base_name(os.path.basename(base))
        return spread_mod.SpreadSession(
            vid,
            parsed[0] if parsed else "",
            base,
            {sid: n["grpc"] for sid, n in targets.items()},
            self._peer_pool,
            enc.data_shards,
            self._ingest.large,
        )

    def _finalize_spread(self, vid: int, base: str, mode: str) -> list[int]:
        """Seal cut-over for a pre-spread volume: commit each target's
        parity partial (tail ship + CRC verify + rename + mount there)
        and unlink the owner's local copy of every committed shard, so
        the subsequent local mount hosts only the remaining shards.
        Inline/resumed seals only — a warm fallback re-encoded from
        scratch, so its spread partials are aborted instead."""
        if self._ingest is None:
            return []
        session = self._ingest.take_spread(vid)
        if session is None:
            return []
        if mode not in ("inline", "resumed"):
            session.abort()
            return []
        info = stripe.read_ec_info(base)
        recorded = (info or {}).get("shard_crc32")
        total = stripe.geometry_from_info(info).total_shards
        if not isinstance(recorded, list) or len(recorded) != total:
            session.abort()  # nothing to CRC-verify commits against
            return []
        shard_size = scrub_mod.expected_shard_size(info)
        done = session.finalize(self.grpc_address, recorded, shard_size)
        for s in done:
            try:
                os.unlink(stripe.shard_file_name(base, s))
            except OSError:
                pass  # already absent: the target still hosts it
        return done

    def _rpc_ec_partial_write(self, req: dict, ctx) -> dict:
        """VolumeEcShardPartialWrite: land one absolute-offset window of
        a parity shard being spread to this node into `<base>.ecNN.inp`
        (invisible to shard discovery until the commit renames it)."""
        from seaweedfs_tpu_torch.ec.ingest import part_path

        vid = int(req["volume_id"])
        shard = int(req["shard_id"])
        offset = int(req.get("offset", 0))
        raw = req.get("data") or ""
        data = (
            base64.b64decode(raw) if isinstance(raw, str) else bytes(raw)
        )
        base = self._base_path_for(vid, req.get("collection", ""))
        p = part_path(base, shard)
        mode = "r+b" if os.path.exists(p) else "w+b"
        with open(p, mode) as f:
            f.seek(offset)
            f.write(data)
        return {}

    def _rpc_ec_spread_commit(self, req: dict, ctx) -> dict:
        """VolumeEcShardSpreadCommit: finalize (or, with size=0, discard)
        a spread parity partial. The bytes on disk must CRC32-match the
        owner's .eci record BEFORE the rename — a torn ship sequence
        must never mount as a real shard."""
        from seaweedfs_tpu_torch.ec import spread as spread_mod
        from seaweedfs_tpu_torch.ec.ingest import part_path

        vid = int(req["volume_id"])
        shard = int(req["shard_id"])
        size = int(req.get("size", 0))
        collection = req.get("collection", "")
        base = self._base_path_for(vid, collection)
        p = part_path(base, shard)
        if size <= 0:
            try:
                os.unlink(p)
            except OSError:
                pass
            return {"mounted": False}
        if not os.path.exists(p):
            raise rpc.NotFoundFault(f"no spread partial for {vid}.{shard:02d}")
        with self.maintenance_lock(vid):
            with open(p, "r+b") as f:
                f.truncate(size)
                f.flush()
                os.fsync(f.fileno())
            crc = spread_mod.local_crc(p)
            if crc != (int(req.get("crc32", 0)) & 0xFFFFFFFF):
                os.unlink(p)  # torn spread: the owner keeps its local copy
                raise rpc.RpcFault(
                    f"spread partial {vid}.{shard:02d} CRC mismatch",
                    code=grpc.StatusCode.FAILED_PRECONDITION,
                )
            src = req.get("source_data_node") or ""
            if src:
                self._ensure_ec_index_files(vid, collection, base, [src])
            os.replace(p, stripe.shard_file_name(base, shard))
            mounted = False
            if req.get("mount"):
                ev = self.store.get_ec_volume(vid)
                if ev is not None:
                    mounted = ev.mount_local_shard(shard)
                else:
                    self.store.mount_ec_volume(vid, base)
                    mounted = True
        if mounted:
            try:
                self.heartbeat_once()  # this node is a holder NOW
            except Exception:  # noqa: BLE001 — next beat carries it
                pass
        return {"mounted": mounted}

    def _rpc_ec_file_copy(self, req: dict, ctx):
        """Stream one local EC-related file (server side of ShardsCopy and
        of VolumeCopy's .dat/.idx pull). Streaming .dat/.idx holds the
        volume's maintenance mutex so a concurrent compact can never swap
        the file mid-stream (the destination would get a torn copy)."""
        vid = int(req["volume_id"])
        base = self._base_path_for(vid, req.get("collection", ""))
        path = base + req["ext"]
        lock = self.maintenance_lock(vid) if req["ext"] in (".dat", ".idx") else None
        if lock is not None:
            lock.acquire()
        try:
            if not os.path.exists(path):
                raise rpc.NotFoundFault(f"{path} not found")
            with open(path, "rb") as f:
                while True:
                    chunk = f.read(_COPY_CHUNK)
                    if not chunk:
                        break
                    yield chunk
        finally:
            if lock is not None:
                lock.release()

    def _rpc_ec_rebuild(self, req: dict, ctx) -> dict:
        """VolumeEcShardsRebuild: reconstruct missing shards.

        Default mode reads >=10 LOCAL survivors (the pre-distributed shape:
        the shell first copies every survivor here). With `remote: true`
        this node becomes the rebuild target without any bulk pre-copy:
        survivors it lacks stream in over VolumeEcShardSlabRead while the
        decode runs — the network-overlapped distributed path."""
        vid = int(req["volume_id"])
        collection = req.get("collection", "")
        base = self._base_path_for(vid, collection)
        t0 = time.monotonic()
        with trace_mod.ensure("rebuild.run", klass="maint"):
            trace_mod.annotate(volume=vid, remote=bool(req.get("remote")))
            if not req.get("remote"):
                rebuilt = stripe.rebuild_ec_files(
                    base, encoder=stripe.encoder_for_base(base, self.store.encoder)
                )
                stats.EcRebuildSeconds.observe(time.monotonic() - t0)
                return {"rebuilt_shard_ids": rebuilt}
            resp = self._ec_rebuild_remote(vid, collection, base, req)
            trace_mod.annotate(
                mode=resp.get("mode"), wire_bytes=resp.get("wire_bytes")
            )
        stats.EcRebuildSeconds.observe(time.monotonic() - t0)
        return resp

    def _ec_rebuild_remote(
        self, vid: int, collection: str, base: str, req: dict
    ) -> dict:
        """Distributed rebuild: fetch survivors from peer holders through
        the triple-overlap pipeline (network prefetch / staging fill /
        device decode) and regenerate the missing `.ecNN` files locally,
        CRC-verified against the .eci record. Holder failover happens
        inside each RemoteSlabSource mid-rebuild; this method only decides
        WHO is a survivor and wires the transports."""
        with self.maintenance_lock(vid):
            # a rebuild wants the freshest holder map, not a TTL-stale one:
            # routing a GB-scale fetch at a node that dropped its shards
            # costs a failover round per batch window
            self._invalidate_shard_locations(vid)
            locs = self._lookup_shard_locations(vid)
            local = set(stripe.find_local_shards(base))
            present = sorted(local | set(locs))
            enc = stripe.encoder_for_base(base, self.store.encoder)
            missing = [s for s in range(enc.total_shards) if s not in present]
            if not missing:
                return {"rebuilt_shard_ids": []}
            if len(present) < enc.data_shards:
                raise rpc.RpcFault(
                    f"cannot rebuild volume {vid}: only {len(present)} survivors "
                    f"reachable, need {enc.data_shards}",
                    code=grpc.StatusCode.FAILED_PRECONDITION,
                )
            holders = sorted({a for addrs in locs.values() for a in addrs})
            self._ensure_ec_index_files(vid, collection, base, holders)
            shard_size, holder_caps = self._resolve_shard_size(
                vid, base, local, holders
            )
            tuning = {}
            if int(req.get("buffer_size") or 0) > 0:
                tuning["buffer_size"] = int(req["buffer_size"])
            if int(req.get("max_batch_bytes") or 0) > 0:
                tuning["max_batch_bytes"] = int(req["max_batch_bytes"])
            if int(req.get("prefetch_batches") or 0) > 0:
                tuning["prefetch_batches"] = int(req["prefetch_batches"])
            chosen = present[: enc.data_shards]
            remote_needed = [s for s in chosen if s not in local]
            resp = {
                "local_survivors": sorted(local & set(chosen)),
                "remote_survivors": remote_needed,
            }
            mode_req = str(req.get("trace_mode") or "").strip().lower()
            trace_mode = (
                mode_req if mode_req in ("on", "off", "auto") else self._trace_repair
            )
            trace_fallback = ""
            trace_wasted = 0  # bytes an aborted trace attempt already moved
            if trace_mode != "off" and remote_needed:
                # trace-repair first: every holder ships |missing| projected
                # rows for its whole survivor group instead of full slabs.
                # ANY failure (incapable peer, stale holder map, mid-rebuild
                # kill, torn stream) lands on the full-slab path below —
                # trace is a bandwidth optimization, never an availability
                # trade. `on` attempts projections wherever holders are
                # capable; `auto` additionally declines when the plan would
                # not actually move fewer bytes than the slabs it replaces
                # (fully-spread placements with several missing shards).
                groups, labels, plan_reason = self._plan_trace_groups(
                    vid, base, chosen, missing, locs, holder_caps, local, enc
                )
                if groups is not None and trace_mode == "auto":
                    remote_groups = sum(1 for g in groups if g.holder != "local")
                    if remote_groups * len(missing) >= len(remote_needed):
                        for g in groups:
                            g.close()
                        groups, labels = None, []
                        plan_reason = (
                            f"no bandwidth win: {remote_groups} holder "
                            f"groups x {len(missing)} missing rows >= "
                            f"{len(remote_needed)} survivor slabs"
                        )
                if groups is None:
                    trace_fallback = plan_reason
                else:
                    try:
                        try:
                            rebuilt = stripe.rebuild_ec_files_from_projections(
                                base,
                                groups,
                                shard_size,
                                missing,
                                encoder=enc,
                                **tuning,
                            )
                            wire = sum(g.bytes_fetched for g in groups)
                        finally:
                            for g in groups:
                                g.close()
                        stats.EcRepairNetworkBytes.labels("trace").inc(wire)
                        stats.EcRebuildRemoteBytes.inc(wire)
                        resp.update(
                            rebuilt_shard_ids=rebuilt,
                            wire_bytes=wire,
                            mode="trace",
                            trace_groups=labels,
                            failed_over=[],
                            trace_fallback="",
                        )
                        return resp
                    except Exception as e:  # noqa: BLE001 — fall back to slabs
                        trace_fallback = f"{type(e).__name__}: {e}"[:200]
                        # the aborted attempt's bytes DID cross the network:
                        # count them, or scraped trace-vs-slab comparisons
                        # would flatter trace exactly when fallbacks happen
                        trace_wasted = sum(g.bytes_fetched for g in groups)
                        if trace_wasted:
                            stats.EcRepairNetworkBytes.labels("trace").inc(
                                trace_wasted
                            )
                            stats.EcRebuildRemoteBytes.inc(trace_wasted)
            # full-slab path: the capability/chaos fallback and the
            # trace_mode=off shape — striped RemoteSlabSource per survivor.
            # fetch workers are RTT/IO-bound (they sleep on peer streams),
            # so size the pool above the survivor count: with prefetch
            # running `prefetch_batches` windows ahead, a tight pool would
            # serialize the very round-trips the pipeline exists to hide
            executor = futures.ThreadPoolExecutor(
                max_workers=EC_REBUILD_FETCH_WORKERS,
                thread_name_prefix=f"ec-rebuild-{vid}",
            )
            sources: dict[int, stripe.SlabSource] = {}
            try:
                for s in present:
                    if s in local:
                        sources[s] = stripe.LocalSlabSource(
                            stripe.shard_file_name(base, s)
                        )
                sources.update(
                    self._remote_slab_sources(
                        vid, [s for s in present if s not in local], executor
                    )
                )
                rebuilt = stripe.rebuild_ec_files_from_sources(
                    base,
                    sources,
                    shard_size,
                    encoder=enc,
                    missing=missing,
                    **tuning,
                )
                wire = sum(
                    src.bytes_fetched
                    for src in sources.values()
                    if isinstance(src, stripe.RemoteSlabSource)
                )
            finally:
                for src in sources.values():
                    src.close()
                executor.shutdown(wait=False, cancel_futures=True)
            if wire:
                stats.EcRepairNetworkBytes.labels("slab").inc(wire)
                stats.EcRebuildRemoteBytes.inc(wire)
            failed_over = [
                f"{src.shard_id}:{addr}"
                for src in sources.values()
                if isinstance(src, stripe.RemoteSlabSource)
                for addr in src.failovers
            ]
            resp.update(
                rebuilt_shard_ids=rebuilt,
                failed_over=failed_over,
                # total bytes THIS rebuild moved, aborted trace attempt
                # included — wire_bytes is a network-cost number, not a
                # successful-path number
                wire_bytes=wire + trace_wasted,
                mode="slab" if remote_needed else "local",
                trace_groups=[],
                trace_fallback=trace_fallback,
            )
            return resp

    def _rpc_ec_rebuild_batch(self, req: dict, ctx) -> dict:
        """VolumeEcShardsRebuildBatch: this node rebuilds MANY volumes'
        missing shards in one call — the fleet scheduler's dispatch unit.
        Each volume is planned like a single remote rebuild (fresh holder
        map, survivor choice, shard-size preflight, slab sources through
        the admission-gated bulk read), then same-signature volumes fuse
        into shared width-packed decode pipelines
        (`stripe.rebuild_ec_files_batch`). Rebuilt shards mount here and
        the delta heartbeats immediately. Per-volume failures are soft
        (reported in `results[].error`); the call only faults wholesale
        on malformed requests."""
        vols = list(req.get("volumes") or [])
        if not vols:
            raise rpc.RpcFault(
                "volumes required", code=grpc.StatusCode.INVALID_ARGUMENT
            )
        tuning = {}
        if int(req.get("buffer_size") or 0) > 0:
            tuning["buffer_size"] = int(req["buffer_size"])
        if int(req.get("max_batch_bytes") or 0) > 0:
            tuning["max_batch_bytes"] = int(req["max_batch_bytes"])
        t0 = time.monotonic()
        jobs: list[dict] = []
        meta: dict[str, dict] = {}  # base -> {vid, collection}
        errors: dict[int, str] = {}
        executor = futures.ThreadPoolExecutor(
            max_workers=EC_REBUILD_FETCH_WORKERS,
            thread_name_prefix="ec-rebuild-batch",
        )
        with ExitStack() as locks, trace_mod.ensure("rebuild.run", klass="maint"):
            trace_mod.annotate(batch=len(vols))
            # per-volume maintenance locks, vid-sorted so concurrent
            # batches can never deadlock on each other — but PLANNING runs
            # in request order below: the scheduler sent the batch in
            # priority order, and job order becomes the block order of the
            # fused dispatch (2-missing blocks before 1-missing)
            for v in sorted(vols, key=lambda d: int(d["volume_id"])):
                locks.enter_context(self.maintenance_lock(int(v["volume_id"])))
            for v in vols:
                vid = int(v["volume_id"])
                collection = v.get("collection", "")
                sources: dict[int, stripe.SlabSource] = {}
                try:
                    base = self._base_path_for(vid, collection)
                    self._invalidate_shard_locations(vid)
                    locs = self._lookup_shard_locations(vid)
                    local = set(stripe.find_local_shards(base))
                    present = sorted(local | set(locs))
                    enc = stripe.encoder_for_base(base, self.store.encoder)
                    missing = [
                        s for s in range(enc.total_shards) if s not in present
                    ]
                    if not missing:
                        meta.setdefault(base, {"vid": vid, "collection": collection})
                        jobs.append(
                            {"base": base, "sources": {}, "shard_size": 0,
                             "missing": [], "encoder": enc}
                        )
                        continue
                    if len(present) < enc.data_shards:
                        errors[vid] = (
                            f"only {len(present)} survivors reachable, "
                            f"need {enc.data_shards}"
                        )
                        continue
                    holders = sorted({a for aa in locs.values() for a in aa})
                    self._ensure_ec_index_files(vid, collection, base, holders)
                    shard_size, _caps = self._resolve_shard_size(
                        vid, base, local, holders
                    )
                    chosen = present[: enc.data_shards]
                    for s in chosen:
                        if s in local:
                            sources[s] = stripe.LocalSlabSource(
                                stripe.shard_file_name(base, s)
                            )
                    sources.update(
                        self._remote_slab_sources(
                            vid, [s for s in chosen if s not in local], executor
                        )
                    )
                    meta[base] = {"vid": vid, "collection": collection}
                    jobs.append(
                        {
                            "base": base,
                            "sources": sources,
                            "shard_size": shard_size,
                            "missing": missing,
                            "encoder": enc,
                        }
                    )
                except Exception as e:  # noqa: BLE001 — soft per-volume
                    # sources opened before the failure (local survivor
                    # handles) must not leak fds: the post-run cleanup
                    # only reaches jobs that were actually appended
                    for src in sources.values():
                        src.close()
                    errors[vid] = f"{type(e).__name__}: {e}"[:300]
            try:
                res = stripe.rebuild_ec_files_batch(jobs, **tuning)
            finally:
                for job in jobs:
                    for src in job["sources"].values():
                        src.close()
                executor.shutdown(wait=False, cancel_futures=True)
        results: list[dict] = []
        total_wire = 0
        for job in jobs:
            base = job["base"]
            m = meta[base]
            wire = sum(
                src.bytes_fetched
                for src in job["sources"].values()
                if isinstance(src, stripe.RemoteSlabSource)
            )
            total_wire += wire
            rebuilt = res["rebuilt"].get(base)
            err = res["errors"].get(base, "")
            if rebuilt and not err:
                try:
                    ev = self.store.get_ec_volume(m["vid"])
                    if ev is not None:
                        for s in rebuilt:
                            ev.mount_local_shard(s)
                    else:
                        self.store.mount_ec_volume(m["vid"], base)
                except Exception as e:  # noqa: BLE001 — rebuilt but dark
                    err = f"mount failed: {e}"[:300]
            results.append(
                {
                    "volume_id": m["vid"],
                    "rebuilt_shard_ids": rebuilt or [],
                    "error": err,
                    "wire_bytes": wire,
                }
            )
        for vid, err in errors.items():
            results.append(
                {"volume_id": vid, "rebuilt_shard_ids": [], "error": err,
                 "wire_bytes": 0}
            )
        if total_wire:
            stats.EcRepairNetworkBytes.labels("slab").inc(total_wire)
            stats.EcRebuildRemoteBytes.inc(total_wire)
        stats.EcRebuildSeconds.observe(time.monotonic() - t0)
        try:
            self.heartbeat_once()  # rebuilt shards are holders NOW
        except Exception:  # noqa: BLE001 — masters may be mid-chaos
            pass
        vid_of_base = {b: m["vid"] for b, m in meta.items()}
        return {
            "results": sorted(results, key=lambda r: r["volume_id"]),
            "wire_bytes": total_wire,
            "dispatch_groups": res["dispatch_groups"],
            "signature_groups": res.get("signature_groups", 0),
            "volumes_fused": res.get("volumes_fused", 0),
            "block_order": [
                vid_of_base[b] for b in res.get("block_order", [])
                if b in vid_of_base
            ],
        }

    def _plan_trace_groups(
        self,
        vid: int,
        base: str,
        chosen: list[int],
        missing: list[int],
        locs: dict[int, list[str]],
        holder_caps: dict[str, set],
        local: set[int],
        enc=None,
    ):
        """Group the chosen survivors onto projection-capable holders:
        -> (groups, labels, "") on success, (None, [], reason) when trace
        repair cannot be planned (capability negotiation's fallback).

        Greedy minimum-holder cover: each round assigns the holder that
        covers the most still-unassigned remote survivors (ties broken by
        address for determinism) — fewer groups = fewer projected-row
        streams = fewer moved bytes, since the wire cost is
        groups x |missing| x shard bytes. The target's own survivors form
        a zero-wire local group running the SAME projection math."""
        remote_needed = [s for s in chosen if s not in local]
        coverable: dict[str, set[int]] = {}
        for s in remote_needed:
            for addr in locs.get(s, ()):
                if "slab_projection" in holder_caps.get(addr, ()):
                    coverable.setdefault(addr, set()).add(s)
        uncovered = set(remote_needed) - {
            s for sids in coverable.values() for s in sids
        }
        if uncovered:
            return None, [], (
                f"survivors {sorted(uncovered)} have no projection-capable "
                "holder"
            )
        plan = (enc or self.store.encoder).repair_projection_plan(chosen, missing)
        rows = len(missing)
        assign: dict[str, list[int]] = {}
        remaining = set(remote_needed)
        while remaining:
            addr = max(
                coverable,
                key=lambda a: (len(coverable[a] & remaining), a),
            )
            got = sorted(coverable[addr] & remaining)
            if not got:  # unreachable given the cover check above
                return None, [], "trace planner could not cover survivors"
            assign[addr] = got
            remaining -= set(got)
        groups: list[stripe.SlabSource] = []
        labels: list[str] = []
        try:
            local_chosen = sorted(local & set(chosen))
            if local_chosen:
                import numpy as np

                groups.append(
                    stripe.LocalProjectionSource(
                        [stripe.shard_file_name(base, s) for s in local_chosen],
                        np.stack([plan[s] for s in local_chosen], axis=1),
                        enc or self.store.encoder,
                    )
                )
                labels.append("local=" + "+".join(str(s) for s in local_chosen))
            for addr in sorted(assign):
                sids = assign[addr]
                terms = [
                    {
                        "shard_id": s,
                        "coeffs": base64.b64encode(plan[s].tobytes()).decode(),
                    }
                    for s in sids
                ]
                groups.append(
                    stripe.TraceSlabSource(
                        addr,
                        sids,
                        rows,
                        self._projection_fetcher(addr, vid, terms, rows),
                    )
                )
                labels.append(f"{addr}=" + "+".join(str(s) for s in sids))
        except Exception as e:  # noqa: BLE001 — a bad group must not leak the rest
            for g in groups:
                g.close()
            return None, [], f"trace group setup failed: {e}"
        return groups, labels, ""

    def _projection_fetcher(self, addr: str, vid: int, terms: list, rows: int):
        """Transport closure for one holder group: the projection mode of
        the CRC-checked slab RPC. Short return on EOF (the source
        zero-fills); any fault propagates so the rebuild falls back to
        full slabs rather than failing over inside the group (the group's
        shards live on exactly this holder)."""

        def fetch(offset: int, size: int) -> bytes:
            import numpy as np

            frames = self._peer_pool.get(addr).stream(
                VOLUME_SERVICE,
                "VolumeEcShardSlabRead",
                {
                    "volume_id": vid,
                    "offset": offset,
                    "size": size,
                    "projection": terms,
                    "projection_rows": rows,
                },
                timeout=EC_SLAB_READ_TIMEOUT,
            )
            # each frame is its own row-major (rows, cols_i) block —
            # restitch column-wise so the caller sees one row-major
            # (rows, sum cols_i) window
            blocks = []
            got = 0
            for frame in frames:
                chunk = rpc.crc_unframe(frame)
                got += len(chunk)
                if got > size * rows:
                    raise IOError(
                        f"projection group@{addr}: stream over-answered "
                        f"({got} > {size * rows})"
                    )
                if len(chunk) % rows:
                    raise IOError(
                        f"projection group@{addr}: frame of {len(chunk)} "
                        f"bytes is not {rows} rows"
                    )
                blocks.append(
                    np.frombuffer(chunk, dtype=np.uint8).reshape(rows, -1)
                )
            if not blocks:
                return b""
            if len(blocks) == 1:
                return blocks[0].tobytes()
            return np.concatenate(blocks, axis=1).tobytes()

        return fetch

    def _ensure_ec_index_files(
        self, vid: int, collection: str, base: str, holders: list[str]
    ) -> None:
        """A rebuild target that never held this volume lacks .ecx/.ecj/.eci;
        pull them from any holder so the regenerated shards are mountable
        and CRC-verifiable. .ecj/.eci are optional upstream, so only a
        missing .ecx is fatal."""
        needed = [ext for ext in _EC_EXTS if not os.path.exists(base + ext)]
        if not needed:
            return
        errs: list[str] = []
        for ext in needed:
            done = False
            for addr in holders:
                try:
                    chunks = self._peer_pool.get(addr).stream(
                        VOLUME_SERVICE,
                        "VolumeEcShardFileCopy",
                        {"volume_id": vid, "collection": collection, "ext": ext},
                    )
                    tmp = base + ext + ".cpy"
                    try:
                        with open(tmp, "wb") as f:
                            for chunk in chunks:
                                f.write(chunk)
                            f.flush()
                            os.fsync(f.fileno())
                        os.replace(tmp, base + ext)
                    finally:
                        if os.path.exists(tmp):
                            os.remove(tmp)
                    done = True
                    break
                except Exception as e:  # noqa: BLE001 — try the next holder
                    errs.append(f"{addr}{ext}: {e}")
            if not done and ext == ".ecx":
                raise rpc.RpcFault(
                    f"volume {vid}: no holder could supply .ecx: {'; '.join(errs)[:400]}"
                )

    def _resolve_shard_size(
        self, vid: int, base: str, local: set[int], holders: list[str]
    ) -> int:
        """Uniform shard length from local survivors and holder
        VolumeStatus reports — and the remote mirror of the local path's
        survivors-agree-on-length preflight: a truncated survivor would
        otherwise zero-fill past its EOF exactly like a legitimate tail
        and decode into silently-wrong shards (the .eci CRC gate only
        fires after the whole volume has streamed, and only when CRCs
        were recorded). Returns (shard_size, capabilities-by-holder) —
        the same status round-trip feeds the trace-repair planner, so
        capability negotiation costs zero extra RPCs."""
        sizes: dict[str, int] = {}
        caps: dict[str, set[str]] = {}
        for s in local:
            sizes[f"local:.ec{s:02d}"] = os.path.getsize(
                stripe.shard_file_name(base, s)
            )
        last: Exception | None = None
        for addr in holders:
            try:
                st = self._peer_pool.get(addr).call(
                    VOLUME_SERVICE, "VolumeStatus", {"volume_id": vid}, timeout=10
                )
                if st.get("kind") != "ec":
                    continue
                caps[addr] = set(st.get("capabilities") or ())
                per_shard = st.get("shard_file_sizes") or {}
                if per_shard:
                    for k, v in per_shard.items():
                        sizes[f"{addr}:.ec{int(k):02d}"] = int(v)
                elif int(st.get("shard_size", 0)) > 0:
                    # pre-per-shard peers: their max is the best we get
                    sizes[addr] = int(st["shard_size"])
            except Exception as e:  # noqa: BLE001 — a dead holder reports nothing
                last = e
        if not sizes:
            raise rpc.RpcFault(
                f"volume {vid}: could not learn shard size from any holder"
                + (f" (last error: {last})" if last else "")
            )
        if len(set(sizes.values())) != 1:
            raise rpc.RpcFault(
                f"volume {vid}: survivors disagree on shard length: {sizes} "
                "— truncated shard?",
                code=grpc.StatusCode.FAILED_PRECONDITION,
            )
        return next(iter(sizes.values())), caps

    def _remote_slab_sources(
        self, vid: int, shard_ids: list[int], executor
    ) -> dict[int, stripe.RemoteSlabSource]:
        """RemoteSlabSource per shard, wired to the CRC-checked bulk slab
        RPC over pooled peer channels, with holder refresh re-asking the
        master after an invalidation."""
        locs = self._lookup_shard_locations(vid)

        def fetch_for(sid: int):
            def fetch(addr: str, offset: int, size: int) -> bytes:
                # NOTE: no _peer_pool.invalidate here — the pooled channel
                # is shared by every shard's concurrent slab streams to
                # this holder, and closing it over ONE stripe failure
                # (timeout, CRC mismatch) would cancel the other nine
                # mid-flight and cascade one transient error into a
                # whole-holder failover for all sources. The source marks
                # the holder dead for ITSELF; genuinely-broken channels
                # are redialed by the degraded-read path's invalidation.
                try:
                    data = self._fetch_slab(addr, vid, sid, offset, size)
                except Exception:
                    self._note_peer_failure(addr)
                    raise
                self._note_peer_success(addr)
                return data

            return fetch

        def refresh_for(sid: int):
            def refresh():
                self._invalidate_shard_locations(vid)
                return self._lookup_shard_locations(vid).get(sid, ())

            return refresh

        return {
            sid: stripe.RemoteSlabSource(
                sid,
                locs.get(sid, ()),
                fetch_for(sid),
                executor=executor,
                refresh_holders=refresh_for(sid),
                fetch_deadline=EC_SLAB_READ_TIMEOUT,
            )
            for sid in shard_ids
            if locs.get(sid)
        }

    def _fetch_slab(
        self, addr: str, vid: int, shard_id: int, offset: int, size: int
    ) -> bytes:
        """One bulk range via VolumeEcShardSlabRead: CRC-verified chunks,
        short return on EOF (the caller zero-fills, like a local read)."""
        frames = self._peer_pool.get(addr).stream(
            VOLUME_SERVICE,
            "VolumeEcShardSlabRead",
            {
                "volume_id": vid,
                "shard_id": shard_id,
                "offset": offset,
                "size": size,
            },
            timeout=EC_SLAB_READ_TIMEOUT,
        )
        parts: list[bytes] = []
        got = 0
        for frame in frames:
            chunk = rpc.crc_unframe(frame)
            got += len(chunk)
            if got > size:
                raise IOError(
                    f"shard {shard_id}@{addr}: slab stream over-answered "
                    f"({got} > {size})"
                )
            parts.append(chunk)
        return b"".join(parts)

    def _rpc_ec_convert(self, req: dict, ctx) -> dict:
        """VolumeEcShardsConvert: re-encode this node's shard set of one
        EC volume into a different registered code family WITHOUT a
        decode->re-encode round trip — data blocks regroup, new parity is
        a GF projection of surviving shards, and the staged target
        (<base>.cv.*) is built while the OLD geometry keeps serving.
        Rides the per-volume maintenance lock (never interleaves with
        compact/copy/generate), journals crash-resumable progress to the
        .ecc sidecar, and — with `cutover: true` — re-verifies the staged
        bytes on disk against the new .eci before atomically retiring the
        old geometry and remounting."""
        vid = int(req["volume_id"])
        collection = req.get("collection", "")
        base = self._base_path_for(vid, collection)
        family = str(req.get("target_family") or "")
        t0 = time.monotonic()
        kwargs: dict = {}
        if int(req.get("max_batch_bytes") or 0) > 0:
            kwargs["max_batch_bytes"] = int(req["max_batch_bytes"])
        if int(req.get("journal_bytes") or 0) > 0:
            kwargs["journal_bytes"] = int(req["journal_bytes"])
        with self.maintenance_lock(vid), trace_mod.ensure(
            "convert.run", klass="maint"
        ):
            trace_mod.annotate(volume=vid, family=family)
            if not stripe.find_local_shards(base):
                raise rpc.NotFoundFault(f"no local shards for volume {vid}")
            try:
                res = convert_mod.convert_ec_files(
                    base, family, encoder=self.store.encoder, **kwargs
                )
                if req.get("cutover") and res["mode"] != "noop":
                    # retire the old geometry under the same lock: the
                    # serving handles close, the staged set swaps in
                    # (.eci first — a crash window refuses to mount
                    # rather than misreads), and the volume remounts as
                    # its new geometry. Reads block only for the swap.
                    self.store.unmount_ec_volume(vid)
                    try:
                        if res["mode"] != "cutover":
                            convert_mod.cutover(base)
                    except BaseException:
                        # the swap did not happen (staged state torn/gone
                        # between stage and cut-over): the intact OLD
                        # geometry must come back into serving rather
                        # than leave a healthy volume dark until restart
                        try:
                            self.store.mount_ec_volume(vid, base)
                        except Exception:  # noqa: BLE001 — a half-swapped
                            pass  # set refuses to mount; resume heals it
                        raise
                    self.store.mount_ec_volume(vid, base)
            except (convert_mod.ConversionError, ValueError) as e:
                raise rpc.RpcFault(
                    f"convert volume {vid} -> {family!r}: {e}",
                    code=grpc.StatusCode.FAILED_PRECONDITION,
                )
        stats.EcConvertSeconds.observe(time.monotonic() - t0)
        try:
            self.heartbeat_once()  # shard-id delta (e.g. 14 -> 24 shards)
        except Exception:  # noqa: BLE001 — master down: next beat carries it
            pass
        return {
            "shard_ids": res["shard_ids"],
            "src_family": res["src_family"],
            "target_family": res["target_family"],
            "bytes_read": int(res["bytes_read"]),
            "bytes_written": int(res["bytes_written"]),
            "reconstructed_bytes": int(res["reconstructed_bytes"]),
            "mode": res["mode"],
        }

    def _rpc_ec_verify(self, req: dict, ctx) -> dict:
        """VolumeEcShardsVerify: CRC-verify this node's local shards of one
        EC volume against the `.eci` record — the orphaned
        `verify_local_shards` fsck math, wired into the control plane.
        With `quarantine: true`, any failing shard is pulled from serving
        and handed to the automatic-repair queue exactly as a background
        scrub finding would be; report-only otherwise."""
        vid = int(req["volume_id"])
        ev = self.store.get_ec_volume(vid)
        if ev is None:
            raise rpc.NotFoundFault(f"ec volume {vid} not mounted")
        verdicts, has_crcs = scrub_mod.verify_ec_volume(
            ev, chunk_bytes=int(config.env("WEEDTPU_SCRUB_CHUNK"))
        )
        quarantined_now: list[int] = []
        if req.get("quarantine") and has_crcs:
            for s, v in sorted(verdicts.items()):
                if v in scrub_mod.FINDING_CLASSES and s not in ev.quarantined:
                    stats.ScrubCorruptionsFound.labels(v).inc()
                    self._scrub_finding(vid, s, v)
                    quarantined_now.append(s)
        return {
            "verdicts": {str(s): v for s, v in sorted(verdicts.items())},
            "has_crcs": has_crcs,
            "quarantined": quarantined_now,
        }

    def _rpc_ec_mount(self, req: dict, ctx) -> dict:
        vid = int(req["volume_id"])
        base = self._base_path_for(vid, req.get("collection", ""))
        if not stripe.find_local_shards(base):
            raise rpc.NotFoundFault(f"no local shards for volume {vid}")
        self.store.mount_ec_volume(vid, base)
        self.heartbeat_once()  # push the shard delta to the master now
        return {}

    def _rpc_ec_unmount(self, req: dict, ctx) -> dict:
        self.store.unmount_ec_volume(int(req["volume_id"]))
        self.heartbeat_once()
        return {}

    def _rpc_ec_shard_read(self, req: dict, ctx):
        """Stream bytes from one local shard (remote interval reads)."""
        delay_ms = config.env("WEEDTPU_BENCH_RPC_DELAY_MS")
        if delay_ms:
            # bench-only network simulation: on a 1-core loopback host the
            # real cost of a remote fetch is CPU, so parallelism cannot
            # show; a server-side sleep models the RTT that dominates real
            # clusters (and releases the GIL, so overlap is measurable)
            time.sleep(delay_ms / 1e3)
        vid = int(req["volume_id"])
        shard_id = int(req["shard_id"])
        offset = int(req["offset"])
        size = int(req["size"])
        ev = self.store.get_ec_volume(vid)
        if ev is None:
            raise rpc.NotFoundFault(f"ec volume {vid} not mounted")
        f = ev._shard_files.get(shard_id)
        if f is None:
            raise rpc.NotFoundFault(f"shard {shard_id} of volume {vid} not local")
        remaining = size
        pos = offset
        while remaining > 0:
            n = min(_COPY_CHUNK, remaining)
            buf = ev._read_local(shard_id, pos, n)
            if buf is None:
                raise rpc.RpcFault(f"short read shard {shard_id} @{pos}")
            yield buf.tobytes()
            pos += n
            remaining -= n

    def _rpc_ec_slab_read(self, req: dict, ctx):
        """Bulk slab stream for the distributed rebuild pipeline — the big
        sibling of VolumeEcShardRead: large windows, bounded chunk size,
        a CRC32 on every chunk (rebuild input must not trust bare TCP),
        and a PRIVATE file handle so a long stream never seek-races the
        serving handles interval reads use. EOF ends the stream short;
        the client zero-fills, mirroring local read_padded_into."""
        # admission control: slab streams ride a token-gated lane
        # (WEEDTPU_REBUILD_MAX_INFLIGHT) so a rebuild storm queues here
        # instead of saturating the RPC worker pool foreground interval
        # reads (VolumeEcShardRead) share. Tokens are held for the life
        # of the stream; a non-immediate grant is a counted wait, and the
        # wait itself is BOUNDED — past it the stream is refused
        # (RESOURCE_EXHAUSTED, retryable: the rebuilder's slab source
        # fails over) rather than pinning this worker thread too.
        if not self._rebuild_gate.acquire(blocking=False):
            stats.RebuildAdmissionWaits.inc()
            if not self._rebuild_gate.acquire(timeout=EC_SLAB_ADMISSION_WAIT):
                raise rpc.RpcFault(
                    "rebuild slab-read lane saturated "
                    f"(WEEDTPU_REBUILD_MAX_INFLIGHT="
                    f"{config.env('WEEDTPU_REBUILD_MAX_INFLIGHT')}); retry",
                    code=grpc.StatusCode.RESOURCE_EXHAUSTED,
                )
        try:
            delay_ms = config.env("WEEDTPU_BENCH_RPC_DELAY_MS")
            if delay_ms:
                # bench-only RTT model, same rationale as VolumeEcShardRead:
                # one sleep per bulk window (the per-request latency a real
                # network charges), GIL-released so client-side overlap shows
                time.sleep(delay_ms / 1e3)
            vid = int(req["volume_id"])
            # projection requests carry terms instead of a shard_id; a
            # PLAIN slab read with no shard_id must still fault loudly
            # (silently serving shard 0 would decode wrong survivor data)
            shard_id = 0 if req.get("projection") else int(req["shard_id"])
            offset = int(req["offset"])
            size = int(req["size"])
            chunk_size = min(max(64 * 1024, int(req.get("chunk_size") or _SLAB_CHUNK)), 8 << 20)
            yield_s = config.env("WEEDTPU_REBUILD_YIELD_MS") / 1e3
            ev = self.store.get_ec_volume(vid)
            if ev is None:
                raise rpc.NotFoundFault(f"ec volume {vid} not mounted")
            if req.get("projection"):
                yield from self._slab_projection_stream(
                    ev, req, offset, size, chunk_size, yield_s
                )
                return
            if shard_id not in ev._shard_files:
                raise rpc.NotFoundFault(f"shard {shard_id} of volume {vid} not local")
            path = stripe.shard_file_name(ev.base, shard_id)
            with open(path, "rb") as f:
                f.seek(offset)
                remaining = size
                while remaining > 0:
                    buf = f.read(min(chunk_size, remaining))
                    if not buf:
                        break  # EOF: short stream, client zero-fills
                    yield rpc.crc_frame(buf)
                    remaining -= len(buf)
                    if yield_s > 0 and remaining > 0:
                        # cooperative yield between chunks: cede the GIL/
                        # disk to foreground reads under contention
                        time.sleep(yield_s)
        finally:
            self._rebuild_gate.release()

    def _slab_projection_stream(
        self, ev, req: dict, offset: int, size: int, chunk_size: int, yield_s: float
    ):
        """Trace-repair half of VolumeEcShardSlabRead: stream the GF(2^8)
        partial sum of the requested LOCAL shards through the supplied
        decode coefficients — `rows` projected rows per byte column,
        row-major per chunk, CRC-framed like a plain slab. Moves
        rows x window bytes for the whole holder group instead of one
        full slab per survivor; EOF ends the stream short (all shards of
        a volume share one length) and the client zero-fills.

        The projection itself is the codec's bit-plane GF(2)/GF(2^8)
        matmul (Encoder.project), so the survivor side reuses exactly the
        verified decode math rather than a second GF implementation."""
        import numpy as np

        if self._trace_repair == "off":
            raise rpc.RpcFault(
                "slab projection reads disabled (WEEDTPU_TRACE_REPAIR=off)",
                code=grpc.StatusCode.UNIMPLEMENTED,
            )
        rows = int(req.get("projection_rows") or 0)
        terms = req["projection"]
        if rows <= 0 or rows > ev.total_shards:
            raise rpc.RpcFault(f"bad projection_rows {rows}")
        sids: list[int] = []
        coeff_cols: list[bytes] = []
        for term in terms:
            sid = int(term["shard_id"])
            raw = term["coeffs"]
            coeffs = raw if isinstance(raw, (bytes, bytearray)) else base64.b64decode(raw)
            if len(coeffs) != rows:
                raise rpc.RpcFault(
                    f"projection term for shard {sid} carries {len(coeffs)} "
                    f"coefficients, want {rows}"
                )
            if sid in sids:
                raise rpc.RpcFault(f"duplicate projection term for shard {sid}")
            sids.append(sid)
            coeff_cols.append(bytes(coeffs))
        missing_local = [s for s in sids if s not in ev._shard_files]
        if missing_local:
            # the planner grouped against a stale holder map: refuse the
            # whole group so the rebuilder re-plans (or falls back) rather
            # than silently projecting a partial sum
            raise rpc.NotFoundFault(
                f"projection shards {missing_local} of volume "
                f"{int(req['volume_id'])} not local"
            )
        coeffs = np.frombuffer(b"".join(coeff_cols), dtype=np.uint8).reshape(
            len(sids), rows
        ).T.copy()  # (rows, n_terms)
        paths = [stripe.shard_file_name(ev.base, s) for s in sids]
        actual = max(0, min(size, min(os.path.getsize(p) for p in paths) - offset))
        if actual == 0:
            return  # whole window past EOF: empty stream, client zero-fills
        cols_per_chunk = max(64 * 1024 // rows, chunk_size // rows)
        enc = self.store.encoder
        with ExitStack() as stack:
            files = [stack.enter_context(open(p, "rb")) for p in paths]
            sent = 0
            while sent < actual:
                cols = min(cols_per_chunk, actual - sent)
                block = np.empty((len(sids), cols), dtype=np.uint8)
                for i, f in enumerate(files):
                    stripe.read_padded_into(f, offset + sent, block[i])
                projected = enc.project(coeffs, block)
                yield rpc.crc_frame(projected.tobytes())
                sent += cols
                if yield_s > 0 and sent < actual:
                    time.sleep(yield_s)

    def _rpc_ec_blob_delete(self, req: dict, ctx) -> dict:
        vid = int(req["volume_id"])
        fid = FileId.parse(req["fid"]) if "fid" in req else None
        needle_id = fid.key if fid else int(req["needle_id"])
        ev = self.store.get_ec_volume(vid)
        if ev is None:
            raise rpc.NotFoundFault(f"ec volume {vid} not mounted")
        return {"found": ev.delete_needle(needle_id)}

    def _rpc_ec_to_volume(self, req: dict, ctx) -> dict:
        """VolumeEcShardsToVolume: local shards -> normal .dat/.idx."""
        vid = int(req["volume_id"])
        collection = req.get("collection", "")
        base = self._base_path_for(vid, collection)
        present = stripe.find_local_shards(base)
        if any(s not in present for s in range(10)):
            stripe.rebuild_ec_files(base, encoder=self.store.encoder)
        stripe.write_dat_file(base)
        stripe.write_idx_file_from_ec_index(base)
        self.store.unmount_ec_volume(vid)
        # load as normal volume
        for loc in self.store.locations:
            if os.path.dirname(base) == loc.directory:
                from seaweedfs_tpu_torch.storage.volume import Volume

                loc.volumes[vid] = Volume(loc.directory, vid, collection)
        self.heartbeat_once()
        return {}

    def _rpc_ec_delete(self, req: dict, ctx) -> dict:
        vid = int(req["volume_id"])
        shard_ids = [int(s) for s in req.get("shard_ids", [])]
        base = self._base_path_for(vid, req.get("collection", ""))
        self.store.unmount_ec_volume(vid)
        for s in shard_ids or stripe.find_local_shards(base):
            p = stripe.shard_file_name(base, s)
            if os.path.exists(p):
                os.remove(p)
            if os.path.exists(p + ".bad"):  # quarantined original, kept
                os.remove(p + ".bad")       # for forensics until deletion
        if not stripe.find_local_shards(base):
            for ext in _EC_EXTS:
                if os.path.exists(base + ext):
                    os.remove(base + ext)
        elif stripe.find_local_shards(base):
            self.store.mount_ec_volume(vid, base)
        self.heartbeat_once()
        return {}


# -- HTTP data path ----------------------------------------------------------


class _ThreadingHTTPServer(socketserver.ThreadingMixIn, http.server.HTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    volume_server: "VolumeServer"


class _Handler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # Keep-alive clients send one small request per round trip; with Nagle
    # on, each response stalls ~40 ms behind the peer's delayed ACK.
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):  # quiet
        pass

    @property
    def vs(self) -> VolumeServer:
        return self.server.volume_server

    def _parse_fid(self) -> Optional[FileId]:
        path = urllib.parse.urlparse(self.path).path.lstrip("/")
        try:
            return FileId.parse(path)
        except ValueError:
            return None

    def _reply(
        self,
        code: int,
        body: bytes,
        content_type: str = "application/octet-stream",
        head: bool = False,
        headers: Optional[dict] = None,
    ) -> None:
        self.send_response(code)
        # the trace id rides back on EVERY reply of a traced request, so
        # a client can correlate its latency with the server-side span
        # tree (/debug/traces, glog grep) without guessing
        tid = trace_mod.current_trace_id()
        if tid:
            self.send_header(trace_mod.HTTP_HEADER, tid)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        if not head:  # HEAD: headers only, or keep-alive streams desync
            self.wfile.write(body)

    def _reply_json(
        self,
        code: int,
        obj: dict,
        head: bool = False,
        headers: Optional[dict] = None,
    ) -> None:
        self._reply(
            code, json.dumps(obj).encode(), "application/json", head=head,
            headers=headers,
        )

    def _serve_get(self, head: bool) -> None:
        path = urllib.parse.urlparse(self.path).path
        if path == "/debug/traces":
            self._reply(
                200,
                json.dumps(trace_mod.debug_payload(self.path)).encode(),
                "application/json",
                head=head,
            )
            return
        if path not in ("/metrics", "/status", "/ui", "/ui/index.html"):
            # needle reads are the traced serving path; debug/status
            # surfaces must not churn the ring
            t0 = time.monotonic()
            with trace_mod.start(
                "http.read",
                klass="healthy",
                trace_id=self.headers.get(trace_mod.HTTP_HEADER),
            ):
                self._serve_get_inner(head)
            stats.VolumeServerRequestHistogram.labels("get").observe(
                time.monotonic() - t0
            )
            return
        self._serve_get_inner(head)

    def _serve_get_inner(self, head: bool) -> None:
        if urllib.parse.urlparse(self.path).path == "/metrics":
            self._reply(
                200,
                stats.REGISTRY.expose().encode(),
                "text/plain; version=0.0.4",
                head=head,
            )
            return
        if urllib.parse.urlparse(self.path).path == "/status":
            self._reply_json(
                200,
                {
                    "volumes": self.vs.store.volume_infos(),
                    "ec_volumes": [i.to_dict() for i in self.vs.store.ec_volume_infos()],
                },
                head=head,
            )
            return
        if urllib.parse.urlparse(self.path).path in ("/ui", "/ui/index.html"):
            # operator status page (volume_server_handlers_ui.go analog).
            # Every interpolated string is escaped: collection/rack/dc names
            # arrive from unauthenticated callers and render in a browser.
            from html import escape as _esc

            vols = self.vs.store.volume_infos()
            ecs = [i.to_dict() for i in self.vs.store.ec_volume_infos()]
            rows = "".join(
                f"<tr><td>{int(v['id'])}</td><td>{_esc(str(v.get('collection','')))}</td>"
                f"<td>{int(v.get('size',0))}</td><td>{int(v.get('file_count',0))}</td>"
                f"<td>{float(v.get('garbage_ratio',0)):.2f}</td>"
                f"<td>{bool(v.get('read_only',False))}</td>"
                f"<td>{_esc(str(v.get('replica_placement','')))}</td></tr>"
                for v in sorted(vols, key=lambda v: int(v["id"]))
            )
            ec_rows = "".join(
                f"<tr><td>{int(e['volume_id'])}</td>"
                f"<td>{_esc(str(e.get('collection','')))}</td>"
                f"<td>{bin(e.get('shard_bits',0)).count('1')}</td></tr>"
                for e in sorted(ecs, key=lambda e: int(e["volume_id"]))
            )
            html = (
                "<!DOCTYPE html><html><head><title>weedtpu volume server</title>"
                "<style>body{font-family:monospace}table{border-collapse:collapse}"
                "td,th{border:1px solid #999;padding:2px 8px}</style></head><body>"
                f"<h1>Volume Server {_esc(self.vs.url)}</h1>"
                f"<p>grpc :{int(self.vs.grpc_port)} &middot; "
                f"rack {_esc(str(self.vs.rack))} &middot; "
                f"dc {_esc(str(self.vs.data_center))} &middot; "
                f"{len(vols)}/{self.vs.max_volume_count} volume slots</p>"
                "<h2>Volumes</h2><table><tr><th>id</th><th>collection</th>"
                "<th>size</th><th>files</th><th>garbage</th><th>read-only</th>"
                f"<th>rp</th></tr>{rows}</table>"
                "<h2>EC volumes</h2><table><tr><th>id</th><th>collection</th>"
                f"<th>shards held</th></tr>{ec_rows}</table>"
                '<p><a href="/status">/status</a> &middot; '
                '<a href="/metrics">/metrics</a></p></body></html>'
            )
            self._reply(200, html.encode(), "text/html; charset=utf-8", head=head)
            return
        stats.VolumeServerRequestCounter.labels("get").inc()
        fid = self._parse_fid()
        if fid is None:
            self._reply_json(400, {"error": "bad file id"}, head=head)
            return
        if not self.vs.guard.check_read(
            str(fid), self.headers.get("Authorization", ""), self.client_address[0]
        ):
            self._reply_json(401, {"error": "unauthorized read"}, head=head)
            return
        try:
            self.vs._open_ec_volume(fid.volume_id)  # wire the remote reader
            try:
                n = self.vs.store.read_needle(
                    fid.volume_id, fid.key, cookie=fid.cookie
                )
            except CrcError:
                # verify-on-read caught a corrupt copy BEFORE it reached
                # the client: identify + quarantine the damaged shard
                # (here or on a peer holder) and serve the clean
                # reconstruction; raises when nothing can be healed
                n = self.vs._heal_needle_read(
                    fid.volume_id, fid.key, cookie=fid.cookie
                )
        except (KeyError, NeedleNotFound):
            self._reply_json(404, {"error": "not found"}, head=head)
            return
        except NeedleDeleted:
            self._reply_json(404, {"error": "deleted"}, head=head)
            return
        except PermissionError:
            self._reply_json(403, {"error": "cookie mismatch"}, head=head)
            return
        except EcDegradedReadError as e:
            # a degraded read that could not be served NOW is overload/
            # partial-failure, not a server bug: 503 + Retry-After (typed
            # per failure class — suspicion-window length for no-viable-
            # holders, prompt for a deadline cut) so clients back off
            # instead of hammering a stripe mid-repair
            self._reply_json(
                503,
                {
                    "error": str(e),
                    "class": type(e).__name__,
                    "attempted": [str(a) for a in e.attempted],
                    "suspected": [str(s) for s in e.suspected],
                },
                head=head,
                headers={"Retry-After": str(max(1, round(e.retry_after)))},
            )
            return
        except IOError as e:
            self._reply_json(500, {"error": str(e)}, head=head)
            return
        ctype = n.mime.decode() if n.mime else "application/octet-stream"
        # the serving class the read resolved to (healthy / ec_intact /
        # cached / degraded) rides back per-request so load harnesses can
        # classify latencies without scraping traces
        klass = trace_mod.current_class()
        self._reply(
            200, n.data, ctype, head=head,
            headers={trace_mod.READ_CLASS_HEADER: klass} if klass else None,
        )

    def do_GET(self) -> None:
        self._serve_get(head=False)

    def do_HEAD(self) -> None:
        self._serve_get(head=True)

    def _replicate(
        self,
        fid: FileId,
        method: str,
        data: Optional[bytes],
        ctype: str,
        name: bytes = b"",
    ) -> Optional[str]:
        """Fan a write/delete out to the volume's sibling replicas
        (store_replicate.go analog). Returns an error string, or None.
        The X-Weed-Replicate header stops forwarding loops; the filename
        of a form upload rides X-Weed-Filename (b64) so replica needles
        stay byte-identical to the primary's (check.disk compares per-id
        sizes, and the name is part of the needle body)."""
        try:
            resp = self.vs._master_query(
                "Lookup", {"volume_or_file_ids": [str(fid.volume_id)]}
            )
            entries = resp.get("volume_id_locations", [])
            locations = entries[0].get("locations", []) if entries else []
        except Exception as e:  # noqa: BLE001
            return f"replica lookup failed: {e}"
        # replica hop needs its own token: volume servers share the signing
        # key, so mint one here rather than forwarding the client's
        auth = {}
        if self.vs.guard.signing_key:
            from seaweedfs_tpu_torch.security.jwt import mint_file_token

            auth = {
                "Authorization": "Bearer "
                + mint_file_token(self.vs.guard.signing_key, str(fid))
            }

        def _push(url: str) -> Optional[str]:
            try:
                req = urllib.request.Request(
                    f"{tls.scheme()}://{url}/{fid}",
                    data=data,
                    method=method,
                    headers={
                        "X-Weed-Replicate": "1",
                        **auth,
                        **({"Content-Type": ctype} if ctype else {}),
                        **(
                            {"X-Weed-Filename": base64.b64encode(name).decode()}
                            if name
                            else {}
                        ),
                    },
                )
                with tls.urlopen(req, timeout=self.vs.replicate_timeout) as r:
                    r.read()
                return None
            except urllib.error.HTTPError as e:
                if method == "DELETE" and e.code == 404:
                    return None  # already absent on the replica
                return f"{url}: HTTP {e.code}"
            except Exception as e:  # noqa: BLE001
                return f"{url}: {e}"

        # Parallel fan-out (store_replicate.go's DistributedOperation analog):
        # one dead replica costs one timeout, not a serial sum of them.
        targets = [d["url"] for d in locations if d["url"] != self.vs.url]
        if not targets:
            return None
        with futures.ThreadPoolExecutor(max_workers=min(8, len(targets))) as pool:
            errs = [e for e in pool.map(_push, targets) if e]
        return "; ".join(errs) or None

    def do_POST(self) -> None:
        t0 = time.monotonic()
        with trace_mod.start(
            "http.write",
            klass="put",
            trace_id=self.headers.get(trace_mod.HTTP_HEADER),
        ):
            self._do_post_inner()
        stats.VolumeServerRequestHistogram.labels("post").observe(
            time.monotonic() - t0
        )

    def _do_post_inner(self) -> None:
        stats.VolumeServerRequestCounter.labels("post").inc()
        fid = self._parse_fid()
        if fid is None:
            self._reply_json(400, {"error": "bad file id"})
            return
        if not self.vs.guard.check_write(
            str(fid), self.headers.get("Authorization", ""), self.client_address[0]
        ):
            self._reply_json(401, {"error": "unauthorized write"})
            return
        length = int(self.headers.get("Content-Length", 0))
        data = self.rfile.read(length)
        ctype = self.headers.get("Content-Type", "")
        name = b""
        if ctype.startswith("multipart/form-data"):
            # the reference's canonical workflow is `curl -F file=@x URL`
            # ([ref: weed/server/volume_server_handlers_write.go +
            # needle parsing of form uploads — mount empty]); storing the
            # raw form would hand the framing back as file bytes on read
            try:
                part = _first_multipart_file(data, ctype)
            except Exception:  # noqa: BLE001 — malformed framing is a 400
                part = None
            if part is None:
                self._reply_json(400, {"error": "no file part in form data"})
                return
            data, name, part_mime = part
            ctype = part_mime
        elif self.headers.get("X-Weed-Filename"):
            # replica hop: the primary forwards the parsed form filename
            # so sibling needles stay byte-identical
            try:
                name = base64.b64decode(self.headers["X-Weed-Filename"])
            except Exception:  # noqa: BLE001 — bad header: store unnamed
                name = b""
        n = Needle(cookie=fid.cookie, id=fid.key, data=data)
        if name:
            n.name = name
        if ctype and ctype != "application/octet-stream":
            n.mime = ctype.encode("utf-8", "surrogateescape")
        try:
            _, size = self.vs.store.write_needle(fid.volume_id, n)
        except KeyError:
            self._reply_json(404, {"error": f"volume {fid.volume_id} not found"})
            return
        except VolumeReadOnly as e:
            self._reply_json(422, {"error": str(e)})
            return
        except ValueError as e:
            # client-controlled inputs (255-byte name/mime caps, framing)
            # must answer 400, not abort the connection
            self._reply_json(400, {"error": str(e)})
            return
        if "X-Weed-Replicate" not in self.headers:
            err = self._replicate(fid, "POST", data, ctype, name=name)
            if err:
                # strict replication (the reference fails the write when the
                # fan-out fails): surface the partial state to the client
                self._reply_json(500, {"error": f"replication failed: {err}", "size": size})
                return
        self._reply_json(201, {"size": size})

    do_PUT = do_POST

    def do_DELETE(self) -> None:
        stats.VolumeServerRequestCounter.labels("delete").inc()
        fid = self._parse_fid()
        if fid is None:
            self._reply_json(400, {"error": "bad file id"})
            return
        if not self.vs.guard.check_write(
            str(fid), self.headers.get("Authorization", ""), self.client_address[0]
        ):
            self._reply_json(401, {"error": "unauthorized delete"})
            return
        try:
            found = self.vs.store.delete_needle(fid.volume_id, fid.key)
        except KeyError:
            self._reply_json(404, {"error": "volume not found"})
            return
        except VolumeReadOnly as e:
            self._reply_json(422, {"error": str(e)})
            return
        if "X-Weed-Replicate" not in self.headers:
            err = self._replicate(fid, "DELETE", None, "")
            if err:
                self._reply_json(500, {"error": f"replicated delete failed: {err}"})
                return
        self._reply_json(200 if found else 404, {"found": bool(found)})
