"""On-disk index types of upstream SeaweedFS (weed/storage/types).

NeedleId: uint64, big-endian. Offset: uint32 in units of 8 bytes.
Size: int32 big-endian two's complement; negative = deleted.
Index entry (.idx / .ecx): key(8) | offset(4) | size(4) = 16 bytes.
A needle record on disk: header (cookie + id + size), body, checksum,
a timestamp in version 3, padded to 8 bytes.
"""

from __future__ import annotations

import struct

NEEDLE_ID_SIZE = 8
OFFSET_SIZE = 4
SIZE_SIZE = 4
NEEDLE_MAP_ENTRY_SIZE = NEEDLE_ID_SIZE + OFFSET_SIZE + SIZE_SIZE  # 16
NEEDLE_PADDING_SIZE = 8
NEEDLE_HEADER_SIZE = 4 + NEEDLE_ID_SIZE + SIZE_SIZE  # cookie + id + size
NEEDLE_CHECKSUM_SIZE = 4
TIMESTAMP_SIZE = 8

TOMBSTONE_FILE_SIZE = -1

_ENTRY = struct.Struct(">QIi")  # key, offset (x8 units), size


def is_deleted(size: int) -> bool:
    return size < 0


def pack_index_entry(key: int, stored_offset: int, size: int) -> bytes:
    return _ENTRY.pack(key, stored_offset, size)


def unpack_index_entry(buf: bytes, pos: int = 0) -> tuple[int, int, int]:
    """-> (key, stored_offset, size)."""
    return _ENTRY.unpack_from(buf, pos)


def offset_to_bytes(actual_offset: int) -> int:
    """Byte offset -> stored uint32 (units of 8). Must be 8-aligned."""
    if actual_offset % NEEDLE_PADDING_SIZE:
        raise ValueError(f"offset {actual_offset} not {NEEDLE_PADDING_SIZE}-aligned")
    return actual_offset // NEEDLE_PADDING_SIZE


def offset_to_actual(stored: int) -> int:
    return stored * NEEDLE_PADDING_SIZE


def _unpadded_size(size: int, version: int) -> int:
    base = NEEDLE_HEADER_SIZE + max(size, 0) + NEEDLE_CHECKSUM_SIZE
    return base + TIMESTAMP_SIZE if version == 3 else base


def actual_size(size: int, version: int = 3) -> int:
    """On-disk bytes of a needle record whose body is `size` bytes."""
    return _unpadded_size(size, version) + padding_length(size, version)


def padding_length(size: int, version: int = 3) -> int:
    return (-_unpadded_size(size, version)) % NEEDLE_PADDING_SIZE
