"""weedtrace core: context-local spans, trace ids, and the bounded
per-process trace ring with tail-biased retention.

Design constraints, in order:

1. **Safe to leave ON.** The read path takes thousands of spans/second
   under load, so recording must be allocation-light and lock-free on
   the span path: a span is one `__slots__` object appended to its
   parent's list; serialization to dicts happens lazily at snapshot
   time (`/debug/traces`, weedload's scrape), never per request. With
   `WEEDTPU_TRACE=off` the root constructors return a no-op and every
   `span()` call collapses to one ContextVar read. No fsync, no I/O,
   ever — the ring lives and dies with the process.

2. **Tail-biased retention.** A uniform sample would retain exactly the
   traces the p99 is NOT about. The ring always keeps error traces and
   the N slowest per (kind, class); everything else is probabilistically
   sampled (`WEEDTPU_TRACE_SAMPLE`) into a bounded FIFO. Total memory is
   bounded by `WEEDTPU_TRACE_RING` + N x live (kind, class) keys +
   the error buffer.

3. **One id end to end.** Trace ids are minted at the HTTP fronts and
   the shell, ride gRPC invocation metadata (`weedtpu-trace` — request
   METADATA, so the pinned proto contracts are untouched) and the
   `X-Weedtpu-Trace` HTTP header, and come back on the response so a
   client can grep every process's glog lines / trace rings for one
   slow request.

Span names are a closed catalog (`SPAN_NAMES`): a test scans every
`span`/`start`/`ensure` call site in the package and requires each
name to be registered and each registered stage to be used — dashboards
and the tail-attribution artifact key on these strings, so they must
not drift. Recording never checks the name: a typo'd stage on a serving
path is a test failure, never a failed read.

`collect()` is the tests' and scripts' helper: a root whose finished
spans come back as a flat list instead of landing in the ring.
"""

from __future__ import annotations

import bisect
import contextlib
import contextvars
import os
import random
import re
import threading
import time
from typing import Iterator, Optional

from seaweedfs_tpu_torch.utils import config

#: the registered stage catalog — every span()/start()/ensure() name in
#: the package MUST appear here, and every entry must have a call site
#: (both pinned by tests/test_torch_obs.py's call-site scan; the
#: reference's catalog, entry for entry). The tail-attribution artifact
#: and `ec.trace` render these strings verbatim.
SPAN_NAMES: dict[str, str] = {
    "http.read": "volume-server HTTP GET of one needle (the serving path)",
    "http.write": "volume-server HTTP POST/PUT of one needle",
    "master.http": "master HTTP facade route (/dir/assign, /dir/lookup, ...)",
    "shell.command": "one weed-shell command execution",
    "rpc.server": "server side of one gRPC method (method name in attrs)",
    "ec.lookup": "master LookupEcVolume round-trip (shard-location cache miss)",
    "ec.recover": "degraded interval reconstruction, client-facing wall time",
    "ec.gather": "survivor fan-out for one interval (local + remote fetches)",
    "ec.fetch": "one remote shard-interval fetch attempt (primary)",
    "ec.fetch.holder": "one holder attempt inside a fetch's failover ladder",
    "ec.hedge": "backup fetch raced against a slow primary",
    "ec.coalesce.wait": "waiter parked on another read's in-flight decode",
    "ec.decode": "GF decode dispatch (backend + batch width in attrs)",
    "cache.hit": "interval served from the decoded-interval cache (no fan-out)",
    "cache.miss": "decoded-interval cache consulted and empty for this interval",
    "rebuild.run": "one whole-volume rebuild (local or distributed)",
    "rebuild.stage": "staging-ring fill for one rebuild batch (disk/wire)",
    "rebuild.drain": "device sync + shard write-out for one rebuild batch",
    "encode.stage": "staging-ring fill for one encode batch",
    "encode.drain": "device sync + shard write-out for one encode batch",
    "ingest.encode": "inline-EC encode of newly-final large rows (one poll)",
    "ingest.seal": "inline-EC seal finalization of one volume",
    "ingest.spread.commit": "seal-time commit of one pre-spread parity shard",
    "scrub.cycle": "one full background integrity pass over mounted shards",
    "scrub.repair": "one automatic repair attempt of a quarantined shard",
    "convert.run": "one whole-volume geometry conversion",
    "convert.chunk": "one journaled chunk of a geometry conversion",
    "heal.verify": "verify-on-read culprit hunt after a body-CRC failure",
}

_ID_RE = re.compile(r"^[0-9a-fA-F][0-9a-fA-F-]{0,63}$")

#: gRPC invocation-metadata key / HTTP header the id rides on
MD_KEY = "weedtpu-trace"
HTTP_HEADER = "X-Weedtpu-Trace"
#: HTTP response header carrying the serving class a read resolved to
#: (healthy / ec_intact / cached / degraded) — weedload classifies
#: per-request latencies from it instead of guessing from topology
READ_CLASS_HEADER = "X-Weedtpu-Read-Class"

_cv: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "weedtpu_torch_trace_span", default=None
)

#: guards only the first-child list publication in Span.add_child
_first_child_lock = threading.Lock()


def enabled() -> bool:
    return config.env("WEEDTPU_TRACE") == "on"


def new_trace_id() -> str:
    return os.urandom(8).hex()


def valid_id(tid) -> Optional[str]:
    """Sanitized inbound trace id, or None (never trust wire input)."""
    if isinstance(tid, str) and _ID_RE.match(tid):
        return tid.lower()
    return None


class _TraceState:
    """Shared per-trace state every span of the tree points at."""

    __slots__ = ("trace_id", "kind", "klass", "wall0", "t0")

    def __init__(self, trace_id: str, kind: str, klass: str):
        self.trace_id = trace_id
        self.kind = kind
        self.klass = klass
        self.wall0 = time.time()
        self.t0 = time.monotonic()


class Span:
    __slots__ = ("name", "attrs", "t0", "dur", "children", "error", "trace")

    def __init__(self, name: str, attrs: Optional[dict], trace: _TraceState):
        self.name = name
        self.attrs = attrs
        self.t0 = time.monotonic()
        self.dur = 0.0
        self.children: Optional[list] = None
        self.error: Optional[str] = None
        self.trace = trace

    def annotate(self, **kv) -> None:
        if self.attrs is None:
            self.attrs = kv
        else:
            self.attrs.update(kv)

    def add_child(self, child: "Span") -> None:
        # list.append is atomic under the GIL, so the steady state is
        # lock-free — but the FIRST-child check-then-assign is not: two
        # pool workers attaching the first two children concurrently
        # could each publish their own list and lose a span. One shared
        # lock guards only that publication (double-checked).
        if self.children is None:
            with _first_child_lock:
                if self.children is None:
                    self.children = []
        self.children.append(child)

    def to_dict(self) -> dict:
        d = {
            "name": self.name,
            "t_ms": round((self.t0 - self.trace.t0) * 1e3, 3),
            "dur_ms": round(self.dur * 1e3, 3),
        }
        if self.attrs:
            d["attrs"] = {k: v for k, v in self.attrs.items()}
        if self.error:
            d["error"] = self.error
        if self.children:
            d["spans"] = [c.to_dict() for c in self.children]
        return d


class _Completed:
    """One finished trace held in the ring — serialized lazily."""

    __slots__ = ("root", "state", "dur", "error")

    def __init__(self, root: Span, state: _TraceState, error: Optional[str]):
        self.root = root
        self.state = state
        self.dur = root.dur
        self.error = error

    def to_dict(self) -> dict:
        return {
            "trace_id": self.state.trace_id,
            "kind": self.state.kind,
            "class": self.state.klass,
            "start": round(self.state.wall0, 3),
            "duration_s": round(self.dur, 6),
            "error": self.error,
            "root": self.root.to_dict(),
        }


class TraceRing:
    """Bounded retention of completed traces, tail-biased:

    - every ERROR trace lands in a bounded error buffer (newest win),
    - the `slowest_n` slowest per (kind, class) are always kept,
    - the rest pass a probabilistic sample gate into a bounded FIFO.

    `seed` pins the sampler for deterministic tests; 0 = entropy."""

    def __init__(
        self,
        capacity: Optional[int] = None,
        slowest_n: Optional[int] = None,
        sample: Optional[float] = None,
        seed: Optional[int] = None,
        errors_cap: int = 64,
    ):
        self._lock = threading.Lock()
        self.capacity = int(capacity if capacity is not None else config.env("WEEDTPU_TRACE_RING"))
        self.slowest_n = int(
            slowest_n if slowest_n is not None else config.env("WEEDTPU_TRACE_SLOWEST")
        )
        self._sample = sample
        self.errors_cap = errors_cap
        s = seed if seed is not None else config.env("WEEDTPU_TRACE_SEED")
        self._rng = random.Random(s or None)
        self._sampled: list[_Completed] = []
        self._errors: list[_Completed] = []
        #: (kind, class) -> ascending-by-duration list of _Completed
        self._slowest: dict[tuple[str, str], list[_Completed]] = {}
        self.offered = 0
        self.kept = 0

    def _sample_rate(self) -> float:
        if self._sample is not None:
            return self._sample
        return float(config.env("WEEDTPU_TRACE_SAMPLE"))

    def offer(self, done: _Completed) -> bool:
        kept = False
        with self._lock:
            self.offered += 1
            if done.error is not None:
                self._errors.append(done)
                if len(self._errors) > self.errors_cap:
                    del self._errors[0]
                kept = True
            key = (done.state.kind, done.state.klass)
            row = self._slowest.setdefault(key, [])
            if len(row) < self.slowest_n or done.dur > row[0].dur:
                # insert sorted ascending; evict the least-slow
                bisect.insort(row, done, key=lambda c: c.dur)
                if len(row) > self.slowest_n:
                    del row[0]
                kept = True
            if not kept:
                rate = self._sample_rate()
                if rate >= 1.0 or self._rng.random() < rate:
                    self._sampled.append(done)
                    if len(self._sampled) > self.capacity:
                        del self._sampled[0]
                    kept = True
            if kept:
                self.kept += 1
        return kept

    def snapshot(
        self,
        kind: Optional[str] = None,
        klass: Optional[str] = None,
        min_duration: float = 0.0,
        limit: int = 100,
    ) -> list[dict]:
        """Serialized retained traces, slowest first, deduped by identity
        (a trace can sit in both the slowest row and the sampled FIFO)."""
        with self._lock:
            all_: list[_Completed] = list(self._sampled) + list(self._errors)
            for row in self._slowest.values():
                all_.extend(row)
        seen: set[int] = set()
        out: list[_Completed] = []
        for c in all_:
            if id(c) in seen:
                continue
            seen.add(id(c))
            if kind and c.state.kind != kind:
                continue
            if klass and c.state.klass != klass:
                continue
            if c.dur < min_duration:
                continue
            out.append(c)
        out.sort(key=lambda c: c.dur, reverse=True)
        return [c.to_dict() for c in out[: max(0, int(limit))]]

    def stats(self) -> dict:
        with self._lock:
            return {
                "offered": self.offered,
                "kept": self.kept,
                "sampled": len(self._sampled),
                "errors": len(self._errors),
                "slowest_keys": len(self._slowest),
            }

    def clear(self) -> None:
        with self._lock:
            self._sampled.clear()
            self._errors.clear()
            self._slowest.clear()
            self.offered = self.kept = 0


#: the per-process ring every finished root lands in
RING = TraceRing()


# -- recording primitives ------------------------------------------------------


class _NullCtx:
    """Shared no-op for disabled tracing / span-outside-trace — one
    allocation for the whole process, not one per call."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullCtx()


class span:  # noqa: N801 — reads as a statement: `with span("ec.gather"):`
    """Record one child span under the ambient trace; a no-op (and
    allocation-free beyond this tiny object) when no trace is active."""

    __slots__ = ("_name", "_attrs", "_sp", "_tok")

    def __init__(self, _name: str, **attrs):
        self._name = _name
        self._attrs = attrs or None
        self._sp = None
        self._tok = None

    def __enter__(self) -> Optional[Span]:
        parent = _cv.get()
        if parent is None:
            return None
        sp = Span(self._name, self._attrs, parent.trace)
        parent.add_child(sp)
        self._sp = sp
        self._tok = _cv.set(sp)
        return sp

    def __exit__(self, et, ev, tb):
        sp = self._sp
        if sp is None:
            return False
        sp.dur = time.monotonic() - sp.t0
        if et is not None and sp.error is None:
            sp.error = et.__name__
        _cv.reset(self._tok)
        return False


class _RootCtx:
    __slots__ = ("_state", "_root", "_tok", "_ring")

    def __init__(self, state: _TraceState, ring: TraceRing):
        self._state = state
        self._ring = ring
        self._root = None
        self._tok = None

    def __enter__(self) -> Span:
        root = Span(self._state.kind, None, self._state)
        self._root = root
        self._tok = _cv.set(root)
        return root

    def __exit__(self, et, ev, tb):
        root = self._root
        root.dur = time.monotonic() - root.t0
        error = None
        if et is not None:
            error = f"{et.__name__}: {ev}"[:200]
            root.error = et.__name__
        _cv.reset(self._tok)
        self._ring.offer(_Completed(root, self._state, error))
        return False


def start(kind: str, klass: str = "healthy", trace_id=None, ring: Optional[TraceRing] = None):
    """Begin a root trace (the HTTP fronts, the shell, background
    maintenance). `trace_id` adopts a propagated id (sanitized); absent
    or invalid ids mint a fresh one. Returns a context manager yielding
    the root Span — or a no-op when tracing is off."""
    if not enabled():
        return _NULL
    tid = valid_id(trace_id) or new_trace_id()
    return _RootCtx(_TraceState(tid, kind, klass), ring or RING)


def continue_trace(kind: str, trace_id, klass: str = "rpc", ring: Optional[TraceRing] = None):
    """Root trace ONLY when a propagated id arrived — the RPC server
    seam: un-traced callers (heartbeats, bare clients) cost nothing,
    traced callers get their id continued in this process's ring."""
    tid = valid_id(trace_id)
    if tid is None or not enabled():
        return _NULL
    return _RootCtx(_TraceState(tid, kind, klass), ring or RING)


def ensure(kind: str, klass: str = "maint"):
    """A span under the ambient trace when one is active, else a fresh
    root trace — maintenance paths (rebuild, convert, scrub repair,
    seal) are always visible in the ring, and nest correctly when an
    operator's shell trace reached them over RPC."""
    if _cv.get() is not None:
        return span(kind)
    return start(kind, klass=klass)


def current() -> Optional[Span]:
    return _cv.get()


def current_trace_id() -> Optional[str]:
    sp = _cv.get()
    return sp.trace.trace_id if sp is not None else None


def current_class() -> Optional[str]:
    sp = _cv.get()
    return sp.trace.klass if sp is not None else None


def annotate(**kv) -> None:
    sp = _cv.get()
    if sp is not None:
        sp.annotate(**kv)


def set_class(klass: str) -> None:
    """Reclassify the AMBIENT trace (e.g. a read that turned degraded
    mid-flight) — retention and attribution key on the final class."""
    sp = _cv.get()
    if sp is not None:
        sp.trace.klass = klass


class attach:  # noqa: N801 — `with attach(parent):` in worker threads
    """Adopt a span captured in another thread as this thread's ambient
    span — the fetch-pool workers' bridge (ContextVars don't cross
    thread-pool submission)."""

    __slots__ = ("_sp", "_tok")

    def __init__(self, sp: Optional[Span]):
        self._sp = sp
        self._tok = None

    def __enter__(self):
        if self._sp is not None:
            self._tok = _cv.set(self._sp)
        return self._sp

    def __exit__(self, *exc):
        if self._tok is not None:
            _cv.reset(self._tok)
        return False


def traced(name: str, **attrs):
    """Decorator form of `span` for whole-function stages."""

    def deco(fn):
        import functools

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with span(name, **attrs):
                return fn(*a, **kw)

        return wrapper

    return deco


# -- the /debug/traces surface -------------------------------------------------


def debug_payload(request_path: str, ring: Optional[TraceRing] = None) -> dict:
    """The `/debug/traces` JSON body for one HTTP request path (query
    string included): filter by `kind`, `class`, `min_ms`, cap with
    `limit`. Shared by the volume-server and master HTTP fronts."""
    import urllib.parse

    q = {
        k: v[0]
        for k, v in urllib.parse.parse_qs(
            urllib.parse.urlparse(request_path).query
        ).items()
    }

    def _f(name: str, default: float) -> float:
        try:
            return float(q.get(name, default))
        except (TypeError, ValueError):
            return default

    ring = ring or RING
    return {
        "enabled": enabled(),
        "stats": ring.stats(),
        "traces": ring.snapshot(
            kind=q.get("kind") or None,
            klass=q.get("class") or None,
            min_duration=_f("min_ms", 0.0) / 1e3,
            limit=int(_f("limit", 100)),
        ),
    }


# -- rendering (ec.trace / tests) ---------------------------------------------


def render_trace(trace: dict) -> str:
    """Human span tree with wall times — the `ec.trace` output format.

    trace=4f1d... http.read class=degraded 812.4ms
      +-   0.1ms   810.9ms ec.recover
      |  +-   0.2ms   540.0ms ec.gather shard=3
      ...
    """
    lines = [
        f"trace={trace['trace_id']} {trace['kind']} "
        f"class={trace['class']} {trace['duration_s'] * 1e3:.1f}ms"
        + (f" ERROR={trace['error']}" if trace.get("error") else "")
    ]

    def walk(sp: dict, depth: int) -> None:
        attrs = " ".join(f"{k}={v}" for k, v in (sp.get("attrs") or {}).items())
        err = f" ERROR={sp['error']}" if sp.get("error") else ""
        lines.append(
            f"{'|  ' * depth}+- {sp['t_ms']:8.1f}ms {sp['dur_ms']:9.1f}ms "
            f"{sp['name']}" + (f" {attrs}" if attrs else "") + err
        )
        for c in sp.get("spans", ()):
            walk(c, depth + 1)

    for c in trace["root"].get("spans", ()):
        walk(c, 0)
    return "\n".join(lines)


# -- per-stage attribution (slo.py's aggregation input) ------------------------


def attribute_stages(trace: dict) -> dict[str, float]:
    """Per-stage attributed seconds for ONE trace, summing EXACTLY to
    its end-to-end duration.

    Each span's self-time (duration minus its children's) goes to its
    own name; the root's self-time goes to "other". Children that
    overlap in parallel (hedged/fan-out fetches, whose summed durations
    exceed the parent's wall time) are scaled down proportionally so a
    stage can never be attributed more wall time than actually passed —
    the property that makes per-class stage sums comparable against the
    observed e2e latencies."""
    stages: dict[str, float] = {}

    def walk(sp: dict, budget: float, is_root: bool) -> None:
        children = sp.get("spans") or []
        child_sum = sum(c["dur_ms"] for c in children) / 1e3
        scale = 1.0
        if child_sum > budget > 0:
            scale = budget / child_sum
        self_t = max(0.0, budget - child_sum * scale)
        key = "other" if is_root else sp["name"]
        stages[key] = stages.get(key, 0.0) + self_t
        for c in children:
            walk(c, (c["dur_ms"] / 1e3) * scale, False)

    walk(trace["root"], trace["duration_s"], True)
    return stages


def iter_spans(trace: dict) -> Iterator[dict]:
    stack = [trace["root"]]
    while stack:
        sp = stack.pop()
        yield sp
        stack.extend(sp.get("spans", ()))


# -- the tests' and scripts' collector ------------------------------------------


def _flatten(sp: Span, out: list) -> None:
    """Children before their parent, siblings in start order: the order
    sequential spans finish in."""
    for c in sp.children or ():
        _flatten(c, out)
    out.append({"name": sp.name, "seconds": sp.dur, **(sp.attrs or {})})


@contextlib.contextmanager
def collect(klass: str = "healthy") -> Iterator[list]:
    """Root a trace of its own (the same `_TraceState` and `Span` objects
    a ring root records into) whose spans come back, when the block ends,
    as the yielded list of flat records {"name", "seconds", **attrs}
    instead of landing in a ring. Records whatever WEEDTPU_TRACE says, as
    `span` does under any ambient root; `start` inside the block opens a
    root of its own, whose spans go to the ring, not here."""
    spans: list = []
    root = Span("collect", None, _TraceState(new_trace_id(), "collect", klass))
    tok = _cv.set(root)
    try:
        yield spans
    finally:
        _cv.reset(tok)
        root.dur = time.monotonic() - root.t0
        for c in root.children or ():
            _flatten(c, spans)
