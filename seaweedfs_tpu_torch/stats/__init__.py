"""Metrics: Prometheus-model counters, gauges and histograms on a
process-global registry, exposed in the text exposition format (the
reference's `stats`, family for family: the same names, help texts,
labels and buckets, so a scraper reads either package the same way).
Stdlib only; the format is wire-compatible with Prometheus scrapers.

The north-star EC metrics are pre-registered:
  weedtpu_ec_encode_bytes_total, weedtpu_ec_encode_seconds,
  weedtpu_ec_reconstruct_seconds (p50 shard-reconstruct latency source).
"""

from __future__ import annotations

import bisect
import threading
from typing import Optional


class _Labeled:
    """One metric family; children keyed by label values."""

    kind = "untyped"

    def __init__(self, name: str, help_: str, label_names: tuple[str, ...] = ()):
        self.name = name
        self.help = help_
        self.label_names = label_names
        self._children: dict[tuple, "_Child"] = {}
        self._lock = threading.Lock()

    def labels(self, *values: str) -> "_Child":
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected {len(self.label_names)} label values, got {len(values)}"
            )
        key = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child()
                self._children[key] = child
            return child

    def _make_child(self) -> "_Child":
        raise NotImplementedError

    def _label_str(self, key: tuple) -> str:
        if not self.label_names:
            return ""
        pairs = ",".join(
            f'{n}="{v}"' for n, v in zip(self.label_names, key)
        )
        return "{" + pairs + "}"

    def collect(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            items = list(self._children.items())
        for key, child in items:
            lines.extend(child.render(self.name, self._label_str(key)))
        return lines


class _Child:
    def render(self, name: str, labels: str) -> list[str]:
        raise NotImplementedError


class _CounterChild(_Child):
    def __init__(self):
        self._v = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._v += amount

    @property
    def value(self) -> float:
        return self._v

    def render(self, name, labels):
        return [f"{name}{labels} {self._v}"]


class Counter(_Labeled):
    kind = "counter"

    def _make_child(self):
        return _CounterChild()

    # label-less sugar
    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    @property
    def value(self) -> float:
        return self.labels().value


class _GaugeChild(_CounterChild):
    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)


class Gauge(_Labeled):
    kind = "gauge"

    def _make_child(self):
        return _GaugeChild()

    def set(self, v: float) -> None:
        self.labels().set(v)

    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    @property
    def value(self) -> float:
        return self.labels().value


_DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


class _HistogramChild(_Child):
    def __init__(self, buckets):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)
        self.sum = 0.0
        self.total = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.total += 1

    def quantile(self, q: float) -> float:
        """Approximate quantile from bucket upper bounds (ops dashboards;
        the p50 reconstruct-latency metric reads this)."""
        with self._lock:
            if self.total == 0:
                return 0.0
            rank = q * self.total
            seen = 0
            for i, c in enumerate(self.counts):
                seen += c
                if seen >= rank:
                    return self.buckets[i] if i < len(self.buckets) else float("inf")
            return float("inf")

    def render(self, name, labels):
        out = []
        cum = 0
        inner = labels[1:-1] if labels else ""
        for ub, c in zip(self.buckets, self.counts):
            cum += c
            le = f'le="{ub}"'
            lab = "{" + (inner + "," if inner else "") + le + "}"
            out.append(f"{name}_bucket{lab} {cum}")
        lab = "{" + (inner + "," if inner else "") + 'le="+Inf"' + "}"
        out.append(f"{name}_bucket{lab} {cum + self.counts[-1]}")
        out.append(f"{name}_sum{labels} {self.sum}")
        out.append(f"{name}_count{labels} {self.total}")
        return out


class Histogram(_Labeled):
    kind = "histogram"

    def __init__(self, name, help_, label_names=(), buckets=_DEFAULT_BUCKETS):
        super().__init__(name, help_, label_names)
        self.buckets = tuple(sorted(buckets))

    def _make_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, v: float) -> None:
        self.labels().observe(v)

    def quantile(self, q: float) -> float:
        return self.labels().quantile(q)


class Registry:
    def __init__(self):
        self._metrics: dict[str, _Labeled] = {}
        self._lock = threading.Lock()

    def register(self, metric: _Labeled) -> _Labeled:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                return existing
            self._metrics[metric.name] = metric
        if not metric.label_names:
            metric.labels()  # label-less metrics expose a zero sample eagerly
        return metric

    def counter(self, name: str, help_: str = "", labels: tuple[str, ...] = ()) -> Counter:
        return self.register(Counter(name, help_, labels))  # type: ignore[return-value]

    def gauge(self, name: str, help_: str = "", labels: tuple[str, ...] = ()) -> Gauge:
        return self.register(Gauge(name, help_, labels))  # type: ignore[return-value]

    def histogram(
        self, name: str, help_: str = "", labels: tuple[str, ...] = (),
        buckets=_DEFAULT_BUCKETS,
    ) -> Histogram:
        return self.register(Histogram(name, help_, labels, buckets))  # type: ignore[return-value]

    def expose(self) -> str:
        """Prometheus text exposition format."""
        with self._lock:
            metrics = list(self._metrics.values())
        lines = []
        for m in metrics:
            lines.extend(m.collect())
        return "\n".join(lines) + "\n"


REGISTRY = Registry()

# -- the framework's standard metric set (metrics.go analog) -----------------

VolumeServerRequestCounter = REGISTRY.counter(
    "weedtpu_volume_request_total", "volume server http/grpc requests", ("type",)
)
VolumeServerRequestHistogram = REGISTRY.histogram(
    "weedtpu_volume_request_seconds", "volume server request latency", ("type",)
)
MasterReceivedHeartbeatCounter = REGISTRY.counter(
    "weedtpu_master_received_heartbeats_total", "heartbeats ingested by the master"
)
MasterAssignCounter = REGISTRY.counter(
    "weedtpu_master_assign_total", "fid assignments served"
)
EcEncodeBytes = REGISTRY.counter(
    "weedtpu_ec_encode_bytes_total", "data bytes erasure-encoded"
)
EcEncodeSeconds = REGISTRY.histogram(
    "weedtpu_ec_encode_seconds", "wall time of volume EC encodes"
)
EcReconstructSeconds = REGISTRY.histogram(
    "weedtpu_ec_reconstruct_seconds",
    "latency of shard-interval reconstructions (p50 is the north-star)",
)
EcRebuildSeconds = REGISTRY.histogram(
    "weedtpu_ec_rebuild_seconds",
    "wall time of whole-shard ec.rebuild runs (local or remote survivors)",
)
EcRebuildRemoteBytes = REGISTRY.counter(
    "weedtpu_ec_rebuild_remote_bytes_total",
    "survivor bytes fetched from peer holders by distributed rebuilds",
)
EcRepairNetworkBytes = REGISTRY.counter(
    "weedtpu_ec_repair_network_bytes_total",
    "survivor payload bytes a rebuild target pulled over the network, by "
    "source mode: `trace` = GF projection rows (|missing| rows per holder "
    "group), `slab` = full survivor slabs — the repair-bandwidth headline "
    "(trace must run strictly below slab for the same rebuild)",
    ("mode",),
)
DegradedReadSeconds = REGISTRY.histogram(
    "weedtpu_degraded_read_seconds",
    "end-to-end latency of degraded (reconstructing) interval reads — the "
    "availability face of repair; weedload's SLO artifact tracks its p99",
)
HedgeFired = REGISTRY.counter(
    "weedtpu_hedge_fired_total",
    "backup shard fetches launched after the per-peer hedge delay",
)
HedgeWon = REGISTRY.counter(
    "weedtpu_hedge_won_total",
    "hedged fetches whose BACKUP answered first (the primary was slow or "
    "wedged; the hedge converted a tail-latency read into a normal one)",
)
CoalescedReads = REGISTRY.counter(
    "weedtpu_coalesced_reads_total",
    "degraded decodes absorbed by single-flight coalescing (waiters served "
    "from the leader's reconstruction instead of decoding again)",
)
ReadCacheHits = REGISTRY.counter(
    "weedtpu_read_cache_hits_total",
    "interval reads served from the decoded-interval cache — no fetch "
    "fan-out, no hedge, no reconstruct histogram observation",
)
ReadCacheMisses = REGISTRY.counter(
    "weedtpu_read_cache_misses_total",
    "decoded-interval cache lookups that found nothing (including "
    "TTL-expired entries) and fell through to the remote/reconstruct rungs",
)
ReadCacheEvictions = REGISTRY.counter(
    "weedtpu_read_cache_evictions_total",
    "decoded intervals dropped by the WEEDTPU_READ_CACHE_MB LRU budget or "
    "the WEEDTPU_READ_CACHE_TTL_S age bound",
)
ReadCacheInvalidations = REGISTRY.counter(
    "weedtpu_read_cache_invalidations_total",
    "decoded intervals flushed by correctness events — quarantine, shard "
    "remount, inline-ingest delta update, unmount/convert cut-over",
)
ReadCacheBytes = REGISTRY.gauge(
    "weedtpu_read_cache_bytes",
    "bytes currently held by the decoded-interval cache",
)
RebuildAdmissionWaits = REGISTRY.counter(
    "weedtpu_rebuild_admission_waits_total",
    "rebuild slab-read streams that had to WAIT for an admission token "
    "(the gate held a rebuild storm off the foreground read lane)",
)
DegradedReadErrors = REGISTRY.counter(
    "weedtpu_degraded_read_errors_total",
    "degraded reads failed, by typed error class (EcNoViableHolders, "
    "EcDegradedReadTimeout, EcShardCorrupt, HedgeMismatch)",
    ("class",),
)
ScrubBytesScanned = REGISTRY.counter(
    "weedtpu_scrub_bytes_scanned_total",
    "EC shard bytes CRC-verified by the background scrubber (rate-capped, "
    "admission-gated — repair traffic, never foreground)",
)
ScrubCorruptionsFound = REGISTRY.counter(
    "weedtpu_scrub_corruptions_found_total",
    "shard integrity failures detected by scrub/verify, by class: corrupt "
    "= CRC32 disagrees with the .eci record, truncated = file shorter "
    "than the stripe geometry demands, missing = mounted shard whose "
    "file vanished",
    ("class",),
)
ScrubRepairs = REGISTRY.counter(
    "weedtpu_scrub_repairs_total",
    "automatic repairs of quarantined shards, by result (ok = rebuilt or "
    "re-pulled, re-verified against .eci, and remounted; failed = attempt "
    "errored and was re-queued with backoff)",
    ("result",),
)
ScrubCycles = REGISTRY.counter(
    "weedtpu_scrub_cycles_total",
    "completed full passes of the background shard-integrity scrubber",
)
InlineEcRows = REGISTRY.counter(
    "weedtpu_inline_ec_rows_total",
    "large stripe rows encoded by the inline-EC ingest path (encode "
    "amortized into writes instead of a seal-time batch conversion)",
)
InlineEcBytes = REGISTRY.counter(
    "weedtpu_inline_ec_bytes_total",
    "volume data bytes whose parity was computed inline at ingest time",
)
InlineEcDeltaUpdates = REGISTRY.counter(
    "weedtpu_inline_ec_delta_updates_total",
    "delta parity updates applied to already-encoded inline stripe rows "
    "(overwrites folded in as GF rank-1 updates, not re-encodes)",
)
InlineEcDeltaBytes = REGISTRY.counter(
    "weedtpu_inline_ec_delta_bytes_total",
    "bytes computed+moved by inline delta parity updates (changed bytes x "
    "(2 data + 2x parity-shard read-modify-write) — compare against "
    "full-stripe re-encode bytes for the <0.5x small-write gate)",
)
InlineEcSeals = REGISTRY.counter(
    "weedtpu_inline_ec_seals_total",
    "volume seals by how the shard files were produced: inline = live "
    "stripe state finalized, resumed = journaled state recovered after a "
    "restart then finalized, warm = full .dat re-encode fallback",
    ("mode",),
)
InlineEcSpreadBytes = REGISTRY.counter(
    "weedtpu_inline_ec_spread_bytes_total",
    "parity bytes streamed to their placement-planned eventual holders "
    "DURING inline encode (WEEDTPU_INLINE_EC_SPREAD) — seal cut-over "
    "then ships only the tail",
)
InlineEcSpreadCommits = REGISTRY.counter(
    "weedtpu_inline_ec_spread_commits_total",
    "seal-time spread commits by result (ok = the target CRC-verified, "
    "mounted, and now hosts the parity shard; failed = the shard stayed "
    "local — spreading is an optimization, never an availability trade)",
    ("result",),
)
EcConvertBytes = REGISTRY.counter(
    "weedtpu_ec_convert_bytes_total",
    "bytes the geometry converter moved, by direction: read = source "
    "shard bytes consumed (pass-through data + survivor reads when a "
    "source data shard needed reconstructing), written = target shard "
    "bytes materialized — compare written against the decode->re-encode "
    "round trip's total I/O for the <=0.5x conversion gate",
    ("direction",),
)
EcConvertSeconds = REGISTRY.histogram(
    "weedtpu_ec_convert_seconds",
    "wall time of whole-volume geometry conversions (ec.convert)",
)
EcMeshDevices = REGISTRY.gauge(
    "weedtpu_ec_mesh_devices",
    "devices in the mesh backend's dp x sp device mesh (0 = every dispatch "
    "is single-device; set when a mesh encoder builds its mesh)",
)
EcDispatchTotal = REGISTRY.counter(
    "weedtpu_ec_dispatch_total",
    "codec matrix dispatches by backend (one batched device/host apply per "
    "increment — the per-backend traffic split behind the selection gauge)",
    ("backend",),
)
EcBackendSelected = REGISTRY.gauge(
    "weedtpu_ec_backend_selected",
    "codec backend chosen by new_encoder (1 = currently selected; source "
    "says why: on-chip-evidence, cpu-bench-evidence, platform, "
    "env:WEEDTPU_BACKEND, explicit)",
    ("backend", "source"),
)
XorschedCache = REGISTRY.gauge(
    "weedtpu_xorsched_schedule_cache",
    "compiled XOR-schedule LRU counters by event (hits/misses/evictions/"
    "size/cap), mirrored from ops.xorsched at each xorsched dispatch — "
    "steady-state serving should be all hits; churning misses mean the "
    "matrix working set exceeds WEEDTPU_XORSCHED_CACHE",
    ("event",),
)
RepairQueueDepth = REGISTRY.gauge(
    "weedtpu_repair_queue_depth",
    "under-replicated stripes currently queued by the master's fleet "
    "repair scheduler (ranked 2-missing strictly before 1-missing)",
)
RepairInflight = REGISTRY.gauge(
    "weedtpu_repair_inflight",
    "stripes whose batched rebuild dispatch is currently running, "
    "bounded by WEEDTPU_REPAIR_MAX_INFLIGHT",
)
RepairDispatch = REGISTRY.counter(
    "weedtpu_repair_dispatch_total",
    "stripe repairs the fleet scheduler dispatched, by missing-shard "
    "count at dispatch time (the priority class: '2' rows must start "
    "before '1' rows during a storm)",
    ("missing",),
)
RepairBackoff = REGISTRY.counter(
    "weedtpu_repair_backoff_total",
    "repair dispatches deferred by exponential backoff after a 503/"
    "RESOURCE_EXHAUSTED (the rebuild admission lane pushing back) or a "
    "transport failure",
)
RepairFusedVolumes = REGISTRY.counter(
    "weedtpu_repair_fused_volumes_total",
    "volumes whose rebuilds rode a fused batch dispatch (heterogeneous "
    "block-diagonal decode) — divided by dispatch count this is the "
    "batch occupancy a storm achieved",
)
RepairDispatchGroups = REGISTRY.gauge(
    "weedtpu_repair_dispatch_groups",
    "decode dispatch groups the most recent repair batch ran: 1 means "
    "the whole cohort fused into one block-diagonal dispatch, higher "
    "values mean per-signature-group dispatches (fusion off or absent)",
)
PlacementViolations = REGISTRY.gauge(
    "weedtpu_placement_violations",
    "stripes x domains currently violating the failure-domain invariant "
    "(a rack holding more than m shards of one stripe), from the repair "
    "scheduler's last status audit",
)
RpcServerSeconds = REGISTRY.histogram(
    "weedtpu_rpc_server_seconds",
    "server-side wall time of one gRPC method execution, by method — "
    "recorded at the generic dispatch seam, so every registered RPC is "
    "covered without per-handler wiring",
    ("method",),
)
RpcInflight = REGISTRY.gauge(
    "weedtpu_rpc_inflight",
    "gRPC method executions currently on a server worker thread, by "
    "method (a saturated worker pool shows up here before it shows up "
    "as tail latency)",
    ("method",),
)
VolumeServerVolumeGauge = REGISTRY.gauge(
    "weedtpu_volume_server_volumes", "volumes hosted", ("type",)
)
FilerRequestCounter = REGISTRY.counter(
    "weedtpu_filer_request_total", "filer http requests", ("type",)
)
S3RequestCounter = REGISTRY.counter(
    "weedtpu_s3_request_total", "s3 gateway requests", ("action",)
)


def start_metrics_server(port: int, host: str = "127.0.0.1"):
    """Standalone pull endpoint (the reference's -metricsPort). Returns the
    http.server instance (caller owns shutdown)."""
    import http.server
    import threading as _threading

    class H(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            body = REGISTRY.expose().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = http.server.HTTPServer((host, port), H)
    _threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv
