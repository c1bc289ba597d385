"""Sequential .dat walker: the engine behind `fix` (rebuild the .idx from
the data) and `export` (dump needles), as upstream's ScanVolumeFile.

A scan can stop before EOF for two reasons that look the same locally (a
record whose claimed size overruns the file): a crash mid-append truncated
the final record (recoverable: drop the partial tail), or a corrupted size
field mid-file (everything after it is intact but unreachable, and acting
on a partial scan would destroy it). They are told apart by probing past
the stop point for any parseable, CRC-valid record: corruption leaves
valid needles behind it, a true tail does not.
"""

from __future__ import annotations

import mmap
import os
from typing import BinaryIO, Iterator

from seaweedfs_tpu_torch.storage import types
from seaweedfs_tpu_torch.storage.needle import CrcError, Needle
from seaweedfs_tpu_torch.storage.super_block import SUPER_BLOCK_SIZE, SuperBlock


class CorruptVolume(IOError):
    """A record mid-file is structurally corrupt but valid data follows it."""


def _valid_record_after(f: BinaryIO, start: int, file_size: int, version: int) -> int:
    """Probe the 8-aligned offsets in (start, EOF) for a fully parseable,
    CRC-valid needle record. Returns its offset, or -1.

    Scans to EOF (not a fixed window), so a corrupted size field on a huge
    record cannot hide intact data beyond an arbitrary horizon; most
    offsets fail a 16-byte plausibility check, and the probe runs only on
    the corruption/truncation path."""
    probe = (start + types.NEEDLE_PADDING_SIZE - 1) // types.NEEDLE_PADDING_SIZE
    probe *= types.NEEDLE_PADDING_SIZE
    if probe + types.NEEDLE_HEADER_SIZE > file_size:
        return -1
    with mmap.mmap(f.fileno(), length=file_size, access=mmap.ACCESS_READ) as mm:
        while probe + types.NEEDLE_HEADER_SIZE <= file_size:
            size = int.from_bytes(mm[probe + 12 : probe + 16], "big", signed=True)
            if 0 < size <= file_size - probe:
                whole = types.actual_size(size, version)
                if probe + whole <= file_size:
                    try:
                        Needle.from_bytes(mm[probe : probe + whole], version, verify=True)
                        return probe
                    except (ValueError, CrcError):
                        pass
            elif size == 0:
                # a delete marker is a legitimate survivor (deletes are often
                # the last records): cookie 0, a nonzero id, checksum
                # crc32c(b"") == 0, enough constrained bytes that needle
                # data rarely passes for one
                whole = types.actual_size(0, version)
                cookie = int.from_bytes(mm[probe : probe + 4], "big")
                nid = int.from_bytes(mm[probe + 4 : probe + 12], "big")
                checksum = int.from_bytes(mm[probe + 16 : probe + 20], "big")
                if probe + whole <= file_size and cookie == 0 and nid != 0 and checksum == 0:
                    return probe
            probe += types.NEEDLE_PADDING_SIZE
    return -1


def scan_volume_file(dat_path: str, verify_crc: bool = True) -> Iterator[tuple[int, Needle]]:
    """Yield (byte_offset, needle) for every record of a volume .dat, in
    append order. Delete markers (the size-0 records `delete_needle`
    appends) come as needles of size 0.

    A crash-truncated final record is dropped (`weed fix`'s behaviour);
    corruption mid-file raises CorruptVolume instead of losing the intact
    records after it."""
    file_size = os.path.getsize(dat_path)
    with open(dat_path, "rb") as f:
        version = SuperBlock.from_bytes(f.read(SUPER_BLOCK_SIZE)).version
        offset = SUPER_BLOCK_SIZE
        while offset + types.NEEDLE_HEADER_SIZE <= file_size:
            f.seek(offset)
            header = f.read(types.NEEDLE_HEADER_SIZE)
            size = int.from_bytes(header[12:16], "big", signed=True)
            if size < 0:
                # the volume writes size >= 0 only (deletes are size 0), so a
                # negative size in a .dat is corruption, never a record: a
                # flipped sign bit would otherwise tombstone a live needle
                survivor = _valid_record_after(f, offset + 1, file_size, version)
                if survivor >= 0:
                    raise CorruptVolume(
                        f"{dat_path}: negative size {size} at {offset} with a "
                        f"valid record at {survivor} — corrupt size field"
                    )
                break
            whole = types.actual_size(size, version)
            rec = header + f.read(whole - types.NEEDLE_HEADER_SIZE)
            if len(rec) < whole - types.padding_length(size, version):
                survivor = _valid_record_after(f, offset + 1, file_size, version)
                if survivor >= 0:
                    raise CorruptVolume(
                        f"{dat_path}: record at {offset} claims {whole} bytes "
                        f"past EOF but a valid record exists at {survivor} — "
                        f"corrupt size field, refusing partial scan"
                    )
                break  # a truncated tail (crash mid-append)
            try:
                n = Needle.from_bytes(rec, version, verify=verify_crc and size > 0)
            except (ValueError, CrcError) as e:
                survivor = _valid_record_after(f, offset + 1, file_size, version)
                if survivor >= 0:
                    raise CorruptVolume(
                        f"{dat_path}: corrupt record at {offset} ({e}) with a "
                        f"valid record at {survivor} — refusing partial scan"
                    ) from e
                break  # garbage at the tail only: treated as truncation
            yield offset, n
            offset += whole


def rebuild_idx(base_path: str, verify_crc: bool = True) -> int:
    """<base>.dat -> <base>.idx by a full scan (`weed fix`): a record with a
    body gets its (offset, size) entry, a size-0 delete marker a tombstone
    entry, so a replay keeps delete-after-write order. Returns the record
    count. On failure the partial .idx.tmp is removed and the existing
    .idx is left as it was."""
    tmp = base_path + ".idx.tmp"
    count = 0
    try:
        with open(tmp, "wb") as out:
            for offset, n in scan_volume_file(base_path + ".dat", verify_crc=verify_crc):
                if n.size > 0:
                    out.write(types.pack_index_entry(n.id, types.offset_to_bytes(offset), n.size))
                else:
                    out.write(types.pack_index_entry(n.id, 0, types.TOMBSTONE_FILE_SIZE))
                count += 1
            out.flush()
            os.fsync(out.fileno())
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    os.replace(tmp, base_path + ".idx")
    return count
