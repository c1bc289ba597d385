"""Minimal spans for the stripe engine and the degraded read.

`span(name, **attrs)` times a block under one of the registered stage names.
It records only while a `collect()` block is active in the same context (or
in a thread that `attach`ed a span of it), and is a no-op otherwise. The
collect block also carries the read's class ("healthy", "ec_intact",
"cached", "degraded"), which the read path reads and sets."""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Iterator, Optional

#: the stage catalog; names match the reference's spans
SPAN_NAMES: dict[str, str] = {
    "encode.stage": "staging-ring fill for one encode batch",
    "encode.drain": "device sync + shard write-out for one encode batch",
    "rebuild.stage": "staging-ring fill for one rebuild batch",
    "rebuild.drain": "device sync + shard write-out for one rebuild batch",
    "ec.recover": "degraded interval reconstruction, client-facing wall time",
    "ec.gather": "survivor fan-out for one interval (local + remote fetches)",
    "ec.fetch": "one remote shard-interval fetch attempt (primary)",
    "ec.hedge": "backup fetch raced against a slow primary",
    "ec.coalesce.wait": "waiter parked on another read's in-flight decode",
    "ec.decode": "GF decode dispatch (backend + batch width in attrs)",
    "cache.hit": "interval served from the decoded-interval cache (no fan-out)",
    "cache.miss": "decoded-interval cache consulted and empty for this interval",
    "ingest.encode": "inline-EC encode of newly final large rows (one poll)",
    "ingest.seal": "inline-EC seal of one volume",
    "scrub.cycle": "one full integrity pass over the mounted shards",
    "convert.chunk": "one journaled chunk of a geometry conversion",
}


class _Collector:
    """What one `collect()` block shares with every span under it."""

    __slots__ = ("spans", "klass")

    def __init__(self, klass: str):
        self.spans: list = []
        self.klass = klass


class Span:
    """One open span; `annotate` adds attributes to its record."""

    __slots__ = ("name", "attrs", "collector")

    def __init__(self, name: str, attrs: dict, collector: _Collector):
        self.name = name
        self.attrs = attrs
        self.collector = collector

    def annotate(self, **kv) -> None:
        self.attrs.update(kv)


class _NullSpan:
    """What `span` yields when nothing records."""

    __slots__ = ()

    def annotate(self, **kv) -> None:
        pass


_NULL = _NullSpan()

_cv: contextvars.ContextVar[Optional[Span]] = contextvars.ContextVar(
    "weedtpu_torch_span", default=None
)


@contextlib.contextmanager
def span(name: str, **attrs) -> Iterator[Span | _NullSpan]:
    if name not in SPAN_NAMES:
        raise ValueError(f"unregistered span name {name!r}")
    parent = _cv.get()
    if parent is None:
        yield _NULL
        return
    sp = Span(name, attrs, parent.collector)
    tok = _cv.set(sp)
    t0 = time.perf_counter()
    try:
        yield sp
    finally:
        _cv.reset(tok)
        # list.append is atomic: spans of pool threads land safely
        sp.collector.spans.append({"name": name, "seconds": time.perf_counter() - t0, **sp.attrs})


@contextlib.contextmanager
def collect(klass: str = "healthy") -> Iterator[list]:
    """Record every span finished inside the block into the yielded list."""
    root = Span("", {}, _Collector(klass))
    tok = _cv.set(root)
    try:
        yield root.collector.spans
    finally:
        _cv.reset(tok)


@contextlib.contextmanager
def start(kind: str, klass: str = "healthy") -> Iterator[_NullSpan]:
    """A root span for background work (an ingest poll, a scrub cycle). A
    root begins a trace of its own, and the trace ring that would keep it
    belongs to the serving stack: until that exists, the root takes
    attributes and records nothing, and the spans under it are no-ops."""
    if kind not in SPAN_NAMES:
        raise ValueError(f"unregistered span name {kind!r}")
    tok = _cv.set(None)
    try:
        yield _NULL
    finally:
        _cv.reset(tok)


def ensure(kind: str, klass: str = "maint"):
    """A span under the ambient one when there is one, else a fresh root
    (`start`): maintenance paths nest when a caller collects."""
    if _cv.get() is not None:
        return span(kind)
    return start(kind, klass=klass)


def current() -> Optional[Span]:
    """The ambient span, to hand to a pool thread's `attach`."""
    return _cv.get()


@contextlib.contextmanager
def attach(parent: Optional[Span]) -> Iterator[Optional[Span]]:
    """Adopt a span captured in another thread as this thread's ambient one
    (context variables do not cross a thread-pool submission)."""
    if parent is None:
        yield None
        return
    tok = _cv.set(parent)
    try:
        yield parent
    finally:
        _cv.reset(tok)


def annotate(**kv) -> None:
    """Add attributes to the ambient span's record."""
    sp = _cv.get()
    if sp is not None:
        sp.annotate(**kv)


def current_class() -> Optional[str]:
    sp = _cv.get()
    return sp.collector.klass if sp is not None else None


def set_class(klass: str) -> None:
    """Reclassify the ambient read (one that turned degraded mid-flight)."""
    sp = _cv.get()
    if sp is not None:
        sp.collector.klass = klass
