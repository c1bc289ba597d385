"""Write-back page cache, after upstream's weed/mount/page_writer/ (the
UploadPipeline / ChunkedDirtyPages machinery, simplified to its
semantics).

DirtyPages holds the not-yet-uploaded byte intervals of one open file.
Overlapping/adjacent writes merge; `read` overlays dirty bytes on top of
what the store has; `drain` emits the merged intervals for upload.
"""

from __future__ import annotations

from typing import Optional


class DirtyPages:
    def __init__(self):
        # sorted, non-overlapping, non-adjacent [(offset, bytearray)]
        self._runs: list[tuple[int, bytearray]] = []

    @property
    def dirty(self) -> bool:
        return bool(self._runs)

    @property
    def byte_count(self) -> int:
        return sum(len(b) for _, b in self._runs)

    def write(self, offset: int, data: bytes) -> None:
        if not data:
            return
        new_lo, new_hi = offset, offset + len(data)
        merged = bytearray(data)
        keep: list[tuple[int, bytearray]] = []
        lo = new_lo
        for run_off, run_buf in self._runs:
            run_hi = run_off + len(run_buf)
            if run_hi < new_lo or run_off > new_hi:
                keep.append((run_off, run_buf))
                continue
            # overlap or adjacency: fold the old run around the new data
            # (new bytes win where they overlap)
            if run_off < lo:
                merged[0:0] = run_buf[: lo - run_off]
                lo = run_off
            if run_hi > new_hi:
                merged.extend(run_buf[len(run_buf) - (run_hi - new_hi) :])
                new_hi = run_hi
        keep.append((lo, merged))
        keep.sort(key=lambda r: r[0])
        self._runs = keep

    def read_overlay(self, offset: int, buf: bytearray) -> None:
        """Patch `buf` (file bytes starting at `offset`) with dirty data."""
        end = offset + len(buf)
        for run_off, run_buf in self._runs:
            lo = max(offset, run_off)
            hi = min(end, run_off + len(run_buf))
            if lo < hi:
                buf[lo - offset : hi - offset] = run_buf[lo - run_off : hi - run_off]

    def max_extent(self) -> int:
        """Highest dirty byte offset + 1 (0 when clean)."""
        if not self._runs:
            return 0
        off, buf = self._runs[-1]
        return off + len(buf)

    def drain(self) -> list[tuple[int, bytes]]:
        runs = [(off, bytes(buf)) for off, buf in self._runs]
        self._runs = []
        return runs

    def truncate(self, size: int) -> None:
        """Drop dirty bytes at or past `size`."""
        out = []
        for off, buf in self._runs:
            if off >= size:
                continue
            if off + len(buf) > size:
                buf = buf[: size - off]
            out.append((off, buf))
        self._runs = out
