"""LogBuffer, after upstream's weed/util/log_buffer/: an in-memory append buffer of
timestamped records that flushes to a durable segment (via callback)
when full or on an interval, while still serving reads that span both
flushed segments (caller-provided) and the live tail.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterator, Optional


@dataclass
class LogRecord:
    ts_ns: int
    key: bytes
    value: bytes

    def to_dict(self) -> dict:
        import base64

        return {
            "ts_ns": self.ts_ns,
            "key": base64.b64encode(self.key).decode(),
            "value": base64.b64encode(self.value).decode(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "LogRecord":
        import base64

        return cls(
            ts_ns=int(d["ts_ns"]),
            key=base64.b64decode(d.get("key", "")),
            value=base64.b64decode(d.get("value", "")),
        )


class LogBuffer:
    """`flush_fn(first_ts_ns, last_ts_ns, records)` persists a batch; it
    runs on the caller's thread (add) or the flush timer thread."""

    def __init__(
        self,
        flush_fn: Callable[[int, int, list[LogRecord]], None],
        max_bytes: int = 4 * 1024 * 1024,
        flush_interval_s: float = 2.0,
    ):
        self._flush_fn = flush_fn
        self._max = max_bytes
        self._records: list[LogRecord] = []
        self._last_ts = 0  # survives drains: monotonicity across flushes
        self._bytes = 0
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._stop = threading.Event()
        self._interval = flush_interval_s
        self._timer = threading.Thread(target=self._flush_loop, daemon=True)
        self._timer.start()

    def add(self, key: bytes, value: bytes, ts_ns: Optional[int] = None) -> int:
        rec = LogRecord(ts_ns or time.time_ns(), key, value)
        to_flush = None
        with self._lock:
            # monotonic across the whole buffer LIFETIME, not just the
            # current batch — a record stamped <= the last flushed ts
            # would be invisible to subscribers seeking past the flush
            if rec.ts_ns <= self._last_ts:
                rec.ts_ns = self._last_ts + 1
            self._last_ts = rec.ts_ns
            self._records.append(rec)
            self._bytes += len(key) + len(value) + 16
            if self._bytes >= self._max:
                to_flush = self._drain_locked()
            self._cv.notify_all()
        if to_flush:
            self._persist(to_flush)
        return rec.ts_ns

    def _persist(self, recs: list[LogRecord]) -> bool:
        try:
            self._flush_fn(recs[0].ts_ns, recs[-1].ts_ns, recs)
            return True
        except Exception:  # noqa: BLE001 — requeue, retry on next flush
            with self._lock:
                self._records = recs + self._records
                self._bytes += sum(len(r.key) + len(r.value) + 16 for r in recs)
            return False

    def _drain_locked(self) -> list[LogRecord]:
        recs, self._records = self._records, []
        self._bytes = 0
        return recs

    def flush(self) -> bool:
        """Persist the live tail. On flush_fn failure the batch is
        REQUEUED at the front (records stay readable and are retried on
        the next flush) and False is returned — a transient sink outage
        must never drop acked records or kill the flush timer."""
        with self._lock:
            recs = self._drain_locked()
        if not recs:
            return True
        return self._persist(recs)

    def _flush_loop(self) -> None:
        while not self._stop.wait(self._interval):
            self.flush()

    def close(self) -> None:
        self._stop.set()
        if not self.flush():
            self.flush()  # one retry on shutdown

    def read_since(self, ts_ns: int) -> list[LogRecord]:
        """Live-tail records newer than ts_ns (flushed data is the
        caller's job to merge in)."""
        with self._lock:
            return [r for r in self._records if r.ts_ns > ts_ns]

    def wait_for_data(self, ts_ns: int, timeout: float) -> bool:
        with self._lock:
            if any(r.ts_ns > ts_ns for r in self._records):
                return True
            self._cv.wait(timeout)
            return any(r.ts_ns > ts_ns for r in self._records)
