""".idx / .ecx walking: a log (or, sorted by key, an index) of 16-byte
(key, offset, size) entries."""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np

from seaweedfs_tpu_torch.storage import types

_BE_ENTRY_DTYPE = np.dtype([("key", ">u8"), ("offset", ">u4"), ("size", ">i4")])
_NATIVE_ENTRY_DTYPE = np.dtype([("key", np.uint64), ("offset", np.uint32), ("size", np.int32)])


def walk_index_buffer(buf: bytes) -> Iterator[tuple[int, int, int]]:
    """Yield (key, stored_offset, size) for each complete 16-byte entry."""
    for i in range(len(buf) // types.NEEDLE_MAP_ENTRY_SIZE):
        yield types.unpack_index_entry(buf, i * types.NEEDLE_MAP_ENTRY_SIZE)


def index_entries_array(buf: bytes) -> np.ndarray:
    """Every complete entry as a structured array with native key, offset
    and size columns."""
    n = len(buf) // types.NEEDLE_MAP_ENTRY_SIZE
    be = np.frombuffer(buf[: n * types.NEEDLE_MAP_ENTRY_SIZE], dtype=_BE_ENTRY_DTYPE)
    return be.astype(_NATIVE_ENTRY_DTYPE)


def write_entries(entries: Iterable[tuple[int, int, int]], path: str) -> None:
    with open(path, "wb") as sink:
        for key, off, size in entries:
            sink.write(types.pack_index_entry(key, off, size))
