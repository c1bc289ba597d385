"""The metrics the degraded read, inline ingest, conversion and scrub tick, with the reference's names
and methods (`inc`, `observe`, `set`, `labels(...)`), kept in process for
the tests and scripts to read. There is no exposition format: that belongs
to the serving stack."""

from __future__ import annotations

import bisect
import threading


class _Labeled:
    """One metric family; children keyed by label values."""

    def __init__(self, name: str, help_: str, label_names: tuple[str, ...] = ()):
        self.name = name
        self.help = help_
        self.label_names = label_names
        self._children: dict[tuple, object] = {}
        self._lock = threading.Lock()

    def labels(self, *values: str):
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected {len(self.label_names)} label values, got {len(values)}"
            )
        key = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make_child()
            return child

    def _make_child(self):
        raise NotImplementedError


class _CounterChild:
    def __init__(self) -> None:
        self._v = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._v += amount

    @property
    def value(self) -> float:
        return self._v


class _GaugeChild(_CounterChild):
    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)


class Counter(_Labeled):
    def _make_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    @property
    def value(self) -> float:
        return self.labels().value


class Gauge(Counter):
    def _make_child(self):
        return _GaugeChild()

    def set(self, v: float) -> None:
        self.labels().set(v)


_DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


class _HistogramChild:
    def __init__(self, buckets: tuple) -> None:
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


class Histogram(_Labeled):
    def __init__(self, name: str, help_: str, label_names: tuple[str, ...] = (),
                 buckets: tuple = _DEFAULT_BUCKETS):
        super().__init__(name, help_, label_names)
        self.buckets = tuple(sorted(buckets))

    def _make_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, v: float) -> None:
        self.labels().observe(v)


EcReconstructSeconds = Histogram(
    "weedtpu_ec_reconstruct_seconds",
    "latency of shard-interval reconstructions (actual decodes only)",
)
DegradedReadSeconds = Histogram(
    "weedtpu_degraded_read_seconds",
    "client-facing latency of degraded (reconstructing) interval reads",
)
HedgeFired = Counter(
    "weedtpu_hedge_fired_total",
    "backup shard fetches launched after the per-peer hedge delay",
)
HedgeWon = Counter(
    "weedtpu_hedge_won_total", "hedged fetches whose backup answered first",
)
CoalescedReads = Counter(
    "weedtpu_coalesced_reads_total",
    "degraded decodes absorbed by single-flight coalescing",
)
ReadCacheHits = Counter(
    "weedtpu_read_cache_hits_total", "interval reads served from the decoded-interval cache",
)
ReadCacheMisses = Counter(
    "weedtpu_read_cache_misses_total",
    "decoded-interval cache lookups that found nothing (TTL-expired included)",
)
ReadCacheEvictions = Counter(
    "weedtpu_read_cache_evictions_total",
    "decoded intervals dropped by the byte budget or the age bound",
)
ReadCacheInvalidations = Counter(
    "weedtpu_read_cache_invalidations_total",
    "decoded intervals flushed by quarantine, shard remount or unmount",
)
ReadCacheBytes = Gauge(
    "weedtpu_read_cache_bytes", "bytes currently held by the decoded-interval cache",
)
DegradedReadErrors = Counter(
    "weedtpu_degraded_read_errors_total",
    "degraded reads failed, by typed error class (EcNoViableHolders, "
    "EcDegradedReadTimeout, EcShardCorrupt, HedgeMismatch)",
    ("class",),
)
ScrubBytesScanned = Counter(
    "weedtpu_scrub_bytes_scanned_total", "EC shard bytes CRC-verified by the scrubber",
)
ScrubCorruptionsFound = Counter(
    "weedtpu_scrub_corruptions_found_total",
    "shard integrity failures found by scrub/verify, by class (corrupt, truncated, missing)",
    ("class",),
)
ScrubCycles = Counter(
    "weedtpu_scrub_cycles_total", "completed full passes of the scrubber",
)
InlineEcRows = Counter(
    "weedtpu_inline_ec_rows_total", "large stripe rows encoded by inline-EC ingest",
)
InlineEcBytes = Counter(
    "weedtpu_inline_ec_bytes_total", "volume data bytes whose parity was computed at ingest",
)
InlineEcDeltaUpdates = Counter(
    "weedtpu_inline_ec_delta_updates_total",
    "delta parity updates applied to already-encoded inline rows",
)
InlineEcDeltaBytes = Counter(
    "weedtpu_inline_ec_delta_bytes_total",
    "bytes computed and moved by inline delta parity updates "
    "(changed bytes x (2 + 2 x parity shards))",
)
InlineEcSeals = Counter(
    "weedtpu_inline_ec_seals_total",
    "volume seals by how the shard files were produced (inline, resumed, warm)",
    ("mode",),
)
EcConvertBytes = Counter(
    "weedtpu_ec_convert_bytes_total",
    "bytes the geometry converter moved, by direction (read, written)",
    ("direction",),
)
