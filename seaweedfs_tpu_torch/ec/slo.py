"""SLO instrumentation for the serving path: an HDR-style latency
recorder and the committed-artifact report format weedload and chaos_soak
write (`artifacts/SLO_r*.json`, the latency sibling of `BENCH_r*.json`).

The recorder is open-loop-friendly: observations are bucketed into
geometrically-spaced cells (~5% relative precision from 0.1 ms to 2 min,
one int per cell) so recording costs O(1) with no per-sample allocation
and quantiles stay exact to the bucket width no matter how skewed the
distribution — the property HdrHistogram popularized and a p99-under-
chaos measurement needs (a reservoir would subsample exactly the tail
the SLO is about). Samples are keyed by (phase, klass): phase is WHEN
(steady, chaos), klass is WHAT (healthy vs degraded traffic), so one run
yields the healthy-vs-degraded comparison the stated SLO is defined
over: degraded p99 < FACTOR x healthy p99.
"""

from __future__ import annotations

import bisect
import json
import os
import threading
import time
from typing import Optional

_MIN = 1e-4  # 0.1 ms: below this, bucket 0 (scheduler noise, not signal)
_MAX = 120.0  # 2 min: beyond any deadline in the system
_GROWTH = 1.05  # ~5% relative quantile error


def _bounds() -> list[float]:
    out = [_MIN]
    while out[-1] < _MAX:
        out.append(out[-1] * _GROWTH)
    return out


BUCKET_BOUNDS: tuple[float, ...] = tuple(_bounds())


class _Cell:
    # every mutation is a read-modify-write (counts[i]+=1, sum+=s): a
    # per-cell lock keeps 64 recording threads from dropping samples —
    # the artifact's counts must be exact even if the quantiles are
    # bucket-precision
    __slots__ = ("counts", "total", "sum", "errors", "max", "lock")

    def __init__(self) -> None:
        self.counts = [0] * (len(BUCKET_BOUNDS) + 1)
        self.total = 0
        self.sum = 0.0
        self.errors = 0
        self.max = 0.0
        self.lock = threading.Lock()

    def observe(self, seconds: float) -> None:
        i = bisect.bisect_left(BUCKET_BOUNDS, seconds)
        with self.lock:
            self.counts[i] += 1
            self.total += 1
            self.sum += seconds
            self.max = max(self.max, seconds)

    def inc_error(self) -> None:
        with self.lock:
            self.errors += 1

    def merge(self, other: "_Cell") -> None:
        with other.lock:
            counts, total, sum_ = list(other.counts), other.total, other.sum
            errors, max_ = other.errors, other.max
        for i, c in enumerate(counts):
            self.counts[i] += c
        self.total += total
        self.sum += sum_
        self.errors += errors
        self.max = max(self.max, max_)

    def to_dict(self) -> dict:
        """Wire form for cross-process merging (weedload --procs workers
        ship their recorders back as JSON). Bucket bounds are code-level
        constants, so counts alone round-trip exactly."""
        with self.lock:
            return {
                "counts": list(self.counts),
                "total": self.total,
                "sum": self.sum,
                "errors": self.errors,
                "max": self.max,
            }

    @classmethod
    def from_dict(cls, d: dict) -> "_Cell":
        cell = cls()
        counts = list(d["counts"])
        if len(counts) != len(cell.counts):
            raise ValueError(
                f"bucket count mismatch: {len(counts)} != {len(cell.counts)} "
                "(recorder serialized by a different code version?)"
            )
        cell.counts = counts
        cell.total = int(d["total"])
        cell.sum = float(d["sum"])
        cell.errors = int(d["errors"])
        cell.max = float(d["max"])
        return cell

    def _quantile(self, q: float) -> float:
        """Value at quantile `q` (caller holds the lock or owns the cell),
        reported as the matching bucket's upper bound (conservative:
        never under-reports a tail)."""
        if self.total == 0:
            return 0.0
        rank = q * self.total
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank and c:
                return BUCKET_BOUNDS[i] if i < len(BUCKET_BOUNDS) else self.max
        return self.max

    def quantile(self, q: float) -> float:
        with self.lock:
            return self._quantile(q)

    def summary(self) -> dict:
        with self.lock:
            return {
                "count": self.total,
                "errors": self.errors,
                "mean": round(self.sum / self.total, 6) if self.total else 0.0,
                "p50": round(self._quantile(0.50), 6),
                "p95": round(self._quantile(0.95), 6),
                "p99": round(self._quantile(0.99), 6),
                "max": round(self.max, 6),
            }


class LatencyRecorder:
    """Thread-safe (phase, klass)-keyed latency histogram set."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._cells: dict[tuple[str, str], _Cell] = {}

    def _cell(self, phase: str, klass: str) -> _Cell:
        key = (phase, klass)
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                cell = self._cells[key] = _Cell()
            return cell

    def observe(self, phase: str, klass: str, seconds: float) -> None:
        self._cell(phase, klass).observe(seconds)

    def error(self, phase: str, klass: str) -> None:
        self._cell(phase, klass).inc_error()

    def merged(self, klass: str) -> _Cell:
        """One cell folding every phase's samples for `klass` — the
        whole-run healthy/degraded distributions the SLO compares."""
        out = _Cell()
        with self._lock:
            items = list(self._cells.items())
        for (_, k), cell in items:
            if k == klass:
                out.merge(cell)
        return out

    def to_dict(self) -> dict:
        """{"phase\\tklass": cell-dict} — what a weedload generator worker
        writes to its result file; the driver folds every worker's dict
        into one recorder with merge_dict."""
        with self._lock:
            items = list(self._cells.items())
        return {f"{phase}\t{klass}": cell.to_dict() for (phase, klass), cell in items}

    def merge_dict(self, d: dict) -> None:
        for key, cell_dict in d.items():
            phase, klass = key.split("\t", 1)
            self._cell(phase, klass).merge(_Cell.from_dict(cell_dict))

    def phases(self) -> dict:
        """{phase: {klass: summary}} — the per-phase artifact section."""
        out: dict[str, dict] = {}
        with self._lock:
            items = list(self._cells.items())
        for (phase, klass), cell in sorted(items):
            out.setdefault(phase, {})[klass] = cell.summary()
        return out


def slo_verdict(
    recorder: LatencyRecorder,
    factor: float = 5.0,
    healthy: str = "healthy",
    degraded: str = "degraded",
    min_samples: int = 20,
    max_error_rate: float = 0.10,
) -> dict:
    """The stated SLO: degraded p99 < `factor` x healthy p99, judged over
    the whole run (all phases merged). Below `min_samples` on either side
    the verdict is not evidence and says so instead of vacuously passing.
    Errors gate the verdict too: a quantile computed over the few reads
    that SUCCEEDED certifies nothing when most degraded reads failed, so
    either class exceeding `max_error_rate` fails the SLO outright."""
    h = recorder.merged(healthy).summary()
    d = recorder.merged(degraded).summary()
    enough = h["count"] >= min_samples and d["count"] >= min_samples
    # None, not inf: the artifact must stay strict JSON
    ratio = round(d["p99"] / h["p99"], 3) if h["p99"] > 0 else None

    def _err_rate(s: dict) -> float:
        attempts = s["count"] + s["errors"]
        return (s["errors"] / attempts) if attempts else 0.0

    h_err, d_err = _err_rate(h), _err_rate(d)
    return {
        "target": f"degraded_p99 < {factor} x healthy_p99",
        "factor": factor,
        "healthy_p99": h["p99"],
        "degraded_p99": d["p99"],
        "ratio": ratio,
        "healthy_error_rate": round(h_err, 4),
        "degraded_error_rate": round(d_err, 4),
        "max_error_rate": max_error_rate,
        "enough_samples": enough,
        "ok": bool(
            enough
            and ratio is not None
            and ratio < factor
            and h_err <= max_error_rate
            and d_err <= max_error_rate
        ),
    }


def assemble_report(
    recorder: LatencyRecorder,
    workload: dict,
    chaos: Optional[dict] = None,
    knobs: Optional[dict] = None,
    counters: Optional[dict] = None,
    lost: Optional[list] = None,
    slo_factor: float = 5.0,
    classes: tuple = ("healthy", "degraded"),
    corruption: Optional[dict] = None,
) -> dict:
    """The SLO_r*.json schema (committed-artifact format, BENCH_r* sibling):
    workload parameters, per-phase per-class quantiles, whole-run
    aggregates, the SLO verdict, the chaos ledger, and zero-loss evidence.
    `classes` lists the traffic classes folded into the `overall` section
    — healthy/degraded always (the SLO comparison), plus e.g. `put` when
    the run offered write traffic (weedload --put-fraction). `corruption`
    (weedload --corrupt) is the fault-injection ledger: every injected
    bit-flip/truncation/deletion with its healed verdict — `ok` then also
    demands all_healed (an unhealed injection is as disqualifying as a
    lost byte)."""
    merged_classes = tuple(dict.fromkeys(("healthy", "degraded") + tuple(classes)))
    report = {
        "when": time.strftime("%FT%TZ", time.gmtime()),
        "kind": "slo",
        "workload": workload,
        "chaos": chaos or {},
        "phases": recorder.phases(),
        "overall": {
            klass: recorder.merged(klass).summary() for klass in merged_classes
        },
        "slo": slo_verdict(recorder, factor=slo_factor),
        "knobs": knobs or {},
        "counters": counters or {},
        "lost": lost or [],
    }
    if corruption is not None:
        report["corruption"] = corruption
    report["ok"] = not report["lost"] and (
        corruption is None or bool(corruption.get("all_healed"))
    )
    return report


#: keys every SLO_r*.json must carry — weedload's smoke gate and the
#: harness tests both assert against this one list
REPORT_SCHEMA_KEYS = (
    "when", "kind", "workload", "chaos", "phases", "overall", "slo",
    "knobs", "counters", "lost", "ok",
)


# -- per-stage tail attribution (weedtrace aggregation) -----------------------

#: keys every TRACE_ATTRIB_r*.json must carry
TRACE_ATTRIB_SCHEMA_KEYS = (
    "when", "kind", "trace_count", "classes", "slowest",
)


def assemble_trace_attribution(
    traces: list,
    classes: tuple = ("healthy", "ec_intact", "degraded", "put"),
    kinds: tuple = ("http.read", "http.write"),
    slowest_n: int = 5,
) -> dict:
    """Fold scraped `/debug/traces` span trees into per-stage tail
    attribution: for each traffic class, the p50/p99 of the seconds each
    STAGE (span name) contributed to its requests' end-to-end latency.

    Stage seconds come from `obs.trace.attribute_stages`, which assigns
    every span its self-time and scales parallel children down to the
    wall time that actually passed — so per trace the stage seconds sum
    EXACTLY to the end-to-end duration, and per class
    `sum(stages[*].total_s) == e2e_total_s` (reported as
    `stage_coverage`, 1.0 by construction; the consistency gate the
    artifact is committed under). The `slowest` section carries the
    `slowest_n` slowest full traces (span trees included) across the
    selected classes — the exemplars behind the quantiles."""
    from seaweedfs_tpu_torch.obs import trace as trace_mod

    picked = [
        t for t in traces
        if t.get("kind") in kinds and t.get("class") in classes
    ]
    e2e: dict[str, _Cell] = {}
    stage_cells: dict[str, dict[str, _Cell]] = {}
    stage_totals: dict[str, dict[str, float]] = {}
    e2e_totals: dict[str, float] = {}
    for t in picked:
        klass = t["class"]
        e2e.setdefault(klass, _Cell()).observe(t["duration_s"])
        e2e_totals[klass] = e2e_totals.get(klass, 0.0) + t["duration_s"]
        for stage, secs in trace_mod.attribute_stages(t).items():
            stage_cells.setdefault(klass, {}).setdefault(
                stage, _Cell()
            ).observe(secs)
            tot = stage_totals.setdefault(klass, {})
            tot[stage] = tot.get(stage, 0.0) + secs
    out_classes: dict[str, dict] = {}
    for klass, cell in sorted(e2e.items()):
        e2e_total = e2e_totals.get(klass, 0.0)
        stages = {}
        for stage, scell in sorted((stage_cells.get(klass) or {}).items()):
            s = scell.summary()
            total = stage_totals[klass][stage]
            stages[stage] = {
                "count": s["count"],
                "p50": s["p50"],
                "p99": s["p99"],
                "mean": s["mean"],
                "total_s": round(total, 6),
                # which stage OWNS the class's latency, in one number
                "share": round(total / e2e_total, 4) if e2e_total else 0.0,
            }
        stage_sum = sum(v["total_s"] for v in stages.values())
        out_classes[klass] = {
            "count": cell.summary()["count"],
            "e2e": cell.summary(),
            "stages": stages,
            "e2e_total_s": round(e2e_total, 6),
            "stage_total_s": round(stage_sum, 6),
            "stage_coverage": (
                round(stage_sum / e2e_total, 4) if e2e_total else 1.0
            ),
        }
    slowest = sorted(picked, key=lambda t: t["duration_s"], reverse=True)
    return {
        "when": time.strftime("%FT%TZ", time.gmtime()),
        "kind": "trace_attrib",
        "trace_count": len(picked),
        "classes": out_classes,
        "slowest": slowest[: max(0, int(slowest_n))],
    }


def write_trace_attribution(path: str, attrib: dict) -> None:
    for key in TRACE_ATTRIB_SCHEMA_KEYS:
        if key not in attrib:
            raise ValueError(f"trace attribution missing required key {key!r}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(attrib, f, indent=1)


def write_report(path: str, report: dict) -> None:
    for key in REPORT_SCHEMA_KEYS:
        if key not in report:
            raise ValueError(f"SLO report missing required key {key!r}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=1)
