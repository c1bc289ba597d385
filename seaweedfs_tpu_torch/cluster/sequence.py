"""Needle-id sequencers — mirror of weed/sequence: a memory sequencer with
optional durable checkpointing (the reference persists via master metadata/raft; here a tiny
state file fsynced on batch boundaries), plus a snowflake sequencer for
coordination-free multi-master id allocation."""

from __future__ import annotations

import os
import threading
import time


class MemorySequencer:
    """Monotonic id allocator. With a state_path, the next-id watermark is
    persisted ahead of use in BATCH-sized leases so a crash never re-issues
    an id (the reference's raft-backed sequencer gives the same guarantee)."""

    BATCH = 10_000

    def __init__(self, start: int = 1, state_path: str | None = None):
        self._lock = threading.Lock()
        self._state_path = state_path
        self._next = start
        self._leased_until = start
        if state_path and os.path.exists(state_path):
            with open(state_path) as f:
                self._next = self._leased_until = int(f.read().strip() or start)

    def _lease(self, upto: int) -> None:
        if self._state_path:
            tmp = self._state_path + ".tmp"
            with open(tmp, "w") as f:
                f.write(str(upto))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._state_path)
        self._leased_until = upto

    def next_ids(self, count: int = 1) -> int:
        """Returns the first id of a contiguous run of `count`."""
        with self._lock:
            first = self._next
            end = first + count
            if end > self._leased_until:
                self._lease(end + self.BATCH)
            self._next = end
            return first

    @property
    def watermark(self) -> int:
        """Next id to be handed out (replicated to raft followers)."""
        with self._lock:
            return self._next

    def floor(self, value: int) -> None:
        """Never allocate below `value` again (applied from the raft
        leader's watermark; a new leader floors past it plus a margin)."""
        with self._lock:
            if value > self._next:
                self._next = value
                if value > self._leased_until:
                    self._lease(value + self.BATCH)


class SnowflakeSequencer:
    """41-bit ms timestamp | 10-bit node id | 12-bit sequence."""

    EPOCH_MS = 1_600_000_000_000

    def __init__(self, node_id: int):
        if not 0 <= node_id < 1024:
            raise ValueError("node_id must fit in 10 bits")
        self._node = node_id
        self._lock = threading.Lock()
        self._last_ms = 0
        self._seq = 0

    def next_ids(self, count: int = 1) -> int:
        """Snowflake ids are not contiguous, so batch assignment (count > 1,
        where the client derives fids by incrementing the key) only works
        with MemorySequencer; reject it here rather than hand out a run that
        collides with future allocations."""
        if count != 1:
            raise ValueError("SnowflakeSequencer cannot lease contiguous id runs")
        with self._lock:
            ms = time.time_ns() // 1_000_000
            if ms < self._last_ms:
                # clock stepped backwards (NTP): never reuse an old
                # timestamp — keep allocating in the last-seen millisecond
                ms = self._last_ms
            if ms == self._last_ms:
                self._seq += 1
                if self._seq >= 4096:
                    while ms <= self._last_ms:
                        ms = time.time_ns() // 1_000_000
                    self._seq = 0
            else:
                self._seq = 0
            self._last_ms = ms
            return ((ms - self.EPOCH_MS) << 22) | (self._node << 12) | self._seq
