"""ChunkCache — tiered read cache for immutable chunks, the
weed/util/chunk_cache analog: the filer/mount read path hits the same hot chunks over and over
(directory pages, small files, manifest heads); a fid is written once and
never mutated, so caching by fid is safe and deletes just evict.

Two tiers, like the reference's memory + on-disk volume caches:

  memory   byte-budgeted LRU (OrderedDict), items above `max_item_bytes`
           bypass it — one huge blob must not wipe the working set
  disk     optional directory of fid-named files with a byte budget,
           evicted oldest-mtime-first; survives restarts (the reference's
           persisted disk cache role)

Reads promote disk hits back into memory. All operations are lock-guarded
and O(1)-ish; eviction is amortized.
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict
from typing import Optional


class ChunkCache:
    def __init__(
        self,
        memory_bytes: int = 64 << 20,
        max_item_bytes: int = 4 << 20,
        disk_dir: str = "",
        disk_bytes: int = 0,
    ):
        self.memory_budget = memory_bytes
        self.max_item_bytes = max_item_bytes
        self.disk_dir = disk_dir
        self.disk_budget = disk_bytes
        self._mem: OrderedDict[str, bytes] = OrderedDict()
        self._mem_bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self._disk_bytes = 0  # running total: eviction scans only when over budget
        if disk_dir and disk_bytes > 0:
            os.makedirs(disk_dir, exist_ok=True)
            try:
                self._disk_bytes = sum(
                    e.stat().st_size
                    for e in os.scandir(disk_dir)
                    if e.name.endswith(".chunk")
                )
            except OSError:
                pass

    # -- keys -----------------------------------------------------------------

    @staticmethod
    def _disk_name(fid: str) -> str:
        return hashlib.sha1(fid.encode()).hexdigest() + ".chunk"

    def _disk_path(self, fid: str) -> str:
        return os.path.join(self.disk_dir, self._disk_name(fid))

    # -- api ------------------------------------------------------------------

    def get(self, fid: str) -> Optional[bytes]:
        with self._lock:
            data = self._mem.get(fid)
            if data is not None:
                self._mem.move_to_end(fid)
                self.hits += 1
                return data
        if self.disk_dir and self.disk_budget > 0:
            try:
                with open(self._disk_path(fid), "rb") as f:
                    data = f.read()
                # same guard as put(): a persisted oversized blob (e.g.
                # after a restart with a smaller max_item_bytes) must not
                # wipe the memory working set on promotion
                if len(data) <= self.max_item_bytes:
                    self._put_mem(fid, data)
                with self._lock:
                    self.hits += 1
                return data
            except OSError:
                pass
        with self._lock:
            self.misses += 1
        return None

    def put(self, fid: str, data: bytes) -> None:
        if len(data) > self.max_item_bytes:
            return
        self._put_mem(fid, data)
        if self.disk_dir and self.disk_budget > 0:
            try:
                path = self._disk_path(fid)
                try:
                    prev = os.path.getsize(path)
                except OSError:
                    prev = 0
                tmp = path + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(data)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
                with self._lock:
                    self._disk_bytes += len(data) - prev
                    over = self._disk_bytes > self.disk_budget
                if over:
                    self._evict_disk()
            except OSError:
                pass  # a full/broken disk tier must never fail a read

    def _put_mem(self, fid: str, data: bytes) -> None:
        with self._lock:
            old = self._mem.pop(fid, None)
            if old is not None:
                self._mem_bytes -= len(old)
            self._mem[fid] = data
            self._mem_bytes += len(data)
            while self._mem_bytes > self.memory_budget and self._mem:
                _, evicted = self._mem.popitem(last=False)
                self._mem_bytes -= len(evicted)

    def delete(self, fid: str) -> None:
        with self._lock:
            old = self._mem.pop(fid, None)
            if old is not None:
                self._mem_bytes -= len(old)
        if self.disk_dir and self.disk_budget > 0:
            path = self._disk_path(fid)
            try:
                size = os.path.getsize(path)
                os.remove(path)
                with self._lock:
                    self._disk_bytes = max(0, self._disk_bytes - size)
            except OSError:
                pass

    def _evict_disk(self) -> None:
        """Called only when the running total crossed the budget — the
        directory scan is paid once per overflow, not per put."""
        try:
            entries = [
                (e.stat().st_mtime, e.path, e.stat().st_size)
                for e in os.scandir(self.disk_dir)
                if e.name.endswith(".chunk")
            ]
        except OSError:
            return
        total = sum(s for _, _, s in entries)
        removed = 0
        for _, path, size in sorted(entries):  # oldest first
            if total - removed <= self.disk_budget:
                break
            try:
                os.remove(path)
                removed += size
            except OSError:
                pass
        # adjust by the delta rather than overwriting: puts/deletes racing
        # this scan already updated the counter for files we didn't see
        with self._lock:
            self._disk_bytes = max(0, self._disk_bytes - removed)

    @property
    def memory_bytes_used(self) -> int:
        with self._lock:
            return self._mem_bytes

    def clear(self) -> None:
        """Full invalidation of BOTH tiers (a memory-only clear would keep
        serving old bytes from disk on the next get)."""
        with self._lock:
            self._mem.clear()
            self._mem_bytes = 0
        if self.disk_dir and self.disk_budget > 0:
            try:
                for e in os.scandir(self.disk_dir):
                    if e.name.endswith(".chunk"):
                        os.remove(e.path)
            except OSError:
                pass
            with self._lock:
                self._disk_bytes = 0
