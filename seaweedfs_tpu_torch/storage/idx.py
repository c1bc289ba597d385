""".idx / .ecx walking: a log (or, sorted by key, an index) of 16-byte
(key, offset, size) entries."""

from __future__ import annotations

from typing import BinaryIO, Callable, Iterable, Iterator

import numpy as np

from seaweedfs_tpu_torch.storage import types

_BE_ENTRY_DTYPE = np.dtype([("key", ">u8"), ("offset", ">u4"), ("size", ">i4")])
_NATIVE_ENTRY_DTYPE = np.dtype([("key", np.uint64), ("offset", np.uint32), ("size", np.int32)])


def walk_index_buffer(buf: bytes) -> Iterator[tuple[int, int, int]]:
    """Yield (key, stored_offset, size) for each complete 16-byte entry."""
    for i in range(len(buf) // types.NEEDLE_MAP_ENTRY_SIZE):
        yield types.unpack_index_entry(buf, i * types.NEEDLE_MAP_ENTRY_SIZE)


def walk_index_file(f: BinaryIO | str, fn: Callable[[int, int, int], None]) -> None:
    """Call fn(key, offset, size) for each entry of a file or open handle."""
    if isinstance(f, str):
        with open(f, "rb") as fh:
            data = fh.read()
    else:
        data = f.read()
    for key, off, size in walk_index_buffer(data):
        fn(key, off, size)


def index_entries_array(buf: bytes) -> np.ndarray:
    """Every complete entry as a structured array with native key, offset
    and size columns."""
    n = len(buf) // types.NEEDLE_MAP_ENTRY_SIZE
    be = np.frombuffer(buf[: n * types.NEEDLE_MAP_ENTRY_SIZE], dtype=_BE_ENTRY_DTYPE)
    return be.astype(_NATIVE_ENTRY_DTYPE)


def write_entries(entries: Iterable[tuple[int, int, int]], out: BinaryIO | str) -> None:
    """Write (key, stored_offset, size) triples as 16-byte records to a
    path (created or truncated) or an open handle (left open)."""
    if isinstance(out, str):
        with open(out, "wb") as sink:
            write_entries(entries, sink)
        return
    for key, off, size in entries:
        out.write(types.pack_index_entry(key, off, size))
