"""Needle maps: id -> (offset, size) per volume, as upstream SeaweedFS keeps
them (weed/storage/needle_map). `MemDb` is the sorted in-memory map that
turns a volume's .idx log into its .ecx index; `CompactMap` is the serving
map fed by .idx replay; `SortedFileNeedleMap` is the persistent map for
volumes whose needle population should not be rebuilt in RAM on every
mount (the role of upstream's leveldb and sorted-file maps, the `-index`
flag)."""

from __future__ import annotations

import bisect
import json
import os
from typing import Iterator, Optional

import numpy as np

from seaweedfs_tpu_torch.storage import idx as idx_mod
from seaweedfs_tpu_torch.storage import types


class MemDb:
    """Sorted id -> (offset, size) map with .idx replay and ascending visit."""

    def __init__(self) -> None:
        self._m: dict[int, tuple[int, int]] = {}
        self._sorted: Optional[list[int]] = None  # cache, dropped when the key set changes

    def set(self, key: int, stored_offset: int, size: int) -> None:
        if key not in self._m:
            self._sorted = None
        self._m[key] = (stored_offset, size)

    def delete(self, key: int) -> None:
        if self._m.pop(key, None) is not None:
            self._sorted = None

    def get(self, key: int) -> Optional[tuple[int, int]]:
        return self._m.get(key)

    def __len__(self) -> int:
        return len(self._m)

    def ascending_visit(self, start: int = 0) -> Iterator[tuple[int, int, int]]:
        """Visit (key, offset, size) ascending by key, from `start` on. The
        sorted key list is cached until the key set changes, so a paged
        scan sorts once and each page costs O(log n + page)."""
        if self._sorted is None:
            self._sorted = sorted(self._m)
        keys = self._sorted
        for key in keys[bisect.bisect_left(keys, start):]:
            entry = self._m.get(key)
            if entry is not None:  # the key went since the cache was cut
                yield key, *entry

    def load_from_idx(self, idx_path: str) -> None:
        """Replay an .idx log: last write wins; a tombstone or a zero offset
        deletes (readNeedleMap semantics of upstream's ec_encoder.go)."""
        with open(idx_path, "rb") as f:
            buf = f.read()
        for key, off, size in idx_mod.walk_index_buffer(buf):
            if off != 0 and not types.is_deleted(size):
                self.set(key, off, size)
            else:
                self.delete(key)

    def save_to_idx(self, path: str) -> None:
        idx_mod.write_entries(self.ascending_visit(), path)


class CompactMap(MemDb):
    """The serving map: MemDb's semantics, with the interface
    `SortedFileNeedleMap` shares."""

    def close(self) -> None:
        pass


class SortedFileNeedleMap:
    """Persistent needle map: the sorted live entries in a `.sdx` sidecar,
    binary-searched through a memory map, plus an in-RAM overlay of the
    changes since it was built.

    Mount cost is O(tail), not O(needles): `.sdx.meta` records the `.idx`
    byte offset the `.sdx` covers, so a clean reopen maps the sorted file
    and replays only the `.idx` entries appended after that watermark. A
    crash between an `.idx` append and the next flush loses nothing: the
    tail replay recovers it. Entries are the 16-byte big-endian record of
    `.idx`/`.ecx`."""

    OVERLAY_FLUSH_ENTRIES = 128 * 1024  # merge threshold, ~3 MB of dict
    VISIT_CHUNK = 4096  # sidecar rows converted per step of a visit

    def __init__(self, base_path: str):
        self.idx_path = base_path + ".idx"
        self.sdx_path = base_path + ".sdx"
        self.meta_path = base_path + ".sdx.meta"
        # key -> (offset, size) live, or None: deleted since the build
        self._overlay: dict[int, Optional[tuple[int, int]]] = {}
        self._mm: Optional[np.ndarray] = None
        self._keys: Optional[np.ndarray] = None
        self._count = 0
        self.rebuilt_full = False  # did the mount pay a full replay?
        self.replayed_tail = 0
        # While the .idx tail replays, the overlay covers entries only up to
        # this byte offset: a flush then must not stamp the watermark past
        # it, or a crash mid-replay would skip the rest of the tail on the
        # next mount (lost entries, resurrected deletes).
        self._replay_pos: Optional[int] = None
        self._open()

    def _idx_size(self) -> int:
        try:
            return os.path.getsize(self.idx_path)
        except OSError:
            return 0

    def _map_sdx(self) -> None:
        n = os.path.getsize(self.sdx_path) // types.NEEDLE_MAP_ENTRY_SIZE
        if n:
            self._mm = np.memmap(self.sdx_path, dtype=idx_mod._BE_ENTRY_DTYPE, mode="r",
                                 shape=(n,))
            self._keys = self._mm["key"]
        else:
            self._mm = None
            self._keys = None

    def _open(self) -> None:
        idx_size = self._idx_size()
        watermark = -1
        if os.path.exists(self.sdx_path) and os.path.exists(self.meta_path):
            try:
                with open(self.meta_path, encoding="utf-8") as f:
                    watermark = int(json.load(f)["idx_size"])
            except (ValueError, KeyError, OSError):
                watermark = -1
        if 0 <= watermark <= idx_size:
            self._map_sdx()
            self._count = 0 if self._mm is None else len(self._mm)
            self._replay_tail(watermark, idx_size)
        else:
            self._rebuild(idx_size)

    def _rebuild(self, idx_size: int) -> None:
        """Full .idx replay into a fresh sorted .sdx (first mount, lost meta)."""
        mem = MemDb()
        if os.path.exists(self.idx_path):
            mem.load_from_idx(self.idx_path)
        tmp = self.sdx_path + ".tmp"
        idx_mod.write_entries(mem.ascending_visit(), tmp)
        os.replace(tmp, self.sdx_path)
        self._write_meta(idx_size)
        self._map_sdx()
        self._count = len(mem)
        self._overlay.clear()
        self.rebuilt_full = True

    def _replay_tail(self, watermark: int, idx_size: int) -> None:
        """Apply the .idx entries appended after the .sdx's watermark."""
        if idx_size <= watermark:
            return
        with open(self.idx_path, "rb") as f:
            f.seek(watermark)
            buf = f.read(idx_size - watermark)
        self._replay_pos = watermark
        try:
            for key, off, size in idx_mod.walk_index_buffer(buf):
                if off != 0 and not types.is_deleted(size):
                    self.set(key, off, size)
                else:
                    self.delete(key)
                self.replayed_tail += 1
                self._replay_pos = watermark + self.replayed_tail * types.NEEDLE_MAP_ENTRY_SIZE
        finally:
            self._replay_pos = None

    def _write_meta(self, idx_size: int) -> None:
        tmp = self.meta_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"idx_size": idx_size}, f)
            f.flush()
            os.fsync(f.fileno())  # the watermark vouches for what the .sdx covers
        os.replace(tmp, self.meta_path)

    def _search_sdx(self, key: int) -> Optional[tuple[int, int]]:
        if self._keys is None:
            return None
        pos = int(np.searchsorted(self._keys, np.uint64(key)))
        if pos >= len(self._keys) or int(self._keys[pos]) != key:
            return None
        row = self._mm[pos]
        return int(row["offset"]), int(row["size"])

    def get(self, key: int) -> Optional[tuple[int, int]]:
        if key in self._overlay:
            return self._overlay[key]
        return self._search_sdx(key)

    def set(self, key: int, stored_offset: int, size: int) -> None:
        if self.get(key) is None:
            self._count += 1
        self._overlay[key] = (stored_offset, size)
        if len(self._overlay) >= self.OVERLAY_FLUSH_ENTRIES:
            self.flush()

    def delete(self, key: int) -> None:
        if self.get(key) is not None:
            self._count -= 1
            self._overlay[key] = None

    def __len__(self) -> int:
        return self._count

    def _sdx_rows(self, start: int) -> Iterator[tuple[int, int, int]]:
        """The sidecar's (key, offset, size) rows from `start` on, converted
        to Python ints a chunk at a time."""
        mm, keys = self._mm, self._keys  # a flush mid-visit maps a new file
        if keys is None:
            return
        for lo in range(int(np.searchsorted(keys, np.uint64(start))), len(keys),
                        self.VISIT_CHUNK):
            yield from mm[lo : lo + self.VISIT_CHUNK].tolist()

    def ascending_visit(self, start: int = 0) -> Iterator[tuple[int, int, int]]:
        """Merge the sorted file with the sorted overlay, from `start` on
        (a binary search into each side, no linear skip)."""
        overlay_keys = sorted(k for k in self._overlay if k >= start)
        oi = 0
        for key, offset, size in self._sdx_rows(start):
            while oi < len(overlay_keys) and overlay_keys[oi] < key:
                ok = overlay_keys[oi]
                if self._overlay[ok] is not None:
                    yield ok, *self._overlay[ok]
                oi += 1
            if oi < len(overlay_keys) and overlay_keys[oi] == key:
                ov = self._overlay[key]
                if ov is not None:
                    yield key, *ov
                oi += 1
                continue
            yield key, offset, size
        for ok in overlay_keys[oi:]:
            if self._overlay[ok] is not None:
                yield ok, *self._overlay[ok]

    def flush(self) -> None:
        """Merge the overlay into a fresh sorted .sdx and advance the
        watermark to the .idx position it covers (the whole file, or the
        replay cursor when flushed mid-replay)."""
        covered = self._replay_pos if self._replay_pos is not None else self._idx_size()
        if not self._overlay and os.path.exists(self.sdx_path):
            self._write_meta(covered)
            return
        tmp = self.sdx_path + ".tmp"
        idx_mod.write_entries(self.ascending_visit(), tmp)
        self._mm = None  # drop the old map before the file is replaced under it
        self._keys = None
        os.replace(tmp, self.sdx_path)
        self._write_meta(covered)
        self._overlay.clear()
        self._map_sdx()

    def close(self) -> None:
        self.flush()
        self._mm = None
        self._keys = None

    def load_from_idx(self, idx_path: str) -> None:
        """MemDb's interface: rebuild the sidecar from the given .idx."""
        self.idx_path = idx_path
        self._rebuild(self._idx_size())


def new_needle_map(kind: str, base_path: str):
    """The map of the `-index` kind: memory | sorted_file."""
    if kind == "memory":
        return CompactMap()
    if kind == "sorted_file":
        return SortedFileNeedleMap(base_path)
    raise ValueError(f"unknown needle map kind {kind!r}")
