"""The needle record of upstream SeaweedFS (weed/storage/needle), versions
2 and 3.

  header : Cookie(4 BE) | NeedleId(8 BE) | Size(4 BE)
  body   : when data present —
           DataSize(4 BE) | Data | Flags(1)
           [NameSize(1) | Name]           if FLAG_HAS_NAME
           [MimeSize(1) | Mime]           if FLAG_HAS_MIME
           [LastModified(5 BE)]           if FLAG_HAS_LAST_MODIFIED
           [Ttl(2)]                       if FLAG_HAS_TTL
           [PairsSize(2 BE) | Pairs]      if FLAG_HAS_PAIRS
  tail   : Checksum(4 BE, CRC32C of Data) | [AppendAtNs(8 BE), v3 only]
           | zero padding to an 8-byte record boundary

`Size` (the .idx/.ecx size field) counts the body bytes only.
"""

from __future__ import annotations

import struct
import time
from dataclasses import dataclass, field

from seaweedfs_tpu_torch.storage import types
from seaweedfs_tpu_torch.utils.native import crc32c

VERSION2 = 2
VERSION3 = 3
CURRENT_VERSION = VERSION3

FLAG_IS_COMPRESSED = 0x01
FLAG_HAS_NAME = 0x02
FLAG_HAS_MIME = 0x04
FLAG_HAS_LAST_MODIFIED = 0x08
FLAG_HAS_TTL = 0x10
FLAG_HAS_PAIRS = 0x20
FLAG_IS_CHUNK_MANIFEST = 0x80

LAST_MODIFIED_BYTES = 5
TTL_BYTES = 2


class CrcError(ValueError):
    pass


@dataclass
class Needle:
    cookie: int = 0
    id: int = 0
    data: bytes = b""
    name: bytes = b""
    mime: bytes = b""
    pairs: bytes = b""
    last_modified: int = 0  # unix seconds (40-bit on disk)
    ttl: bytes = b""  # 2 raw bytes (count, unit); empty = no ttl
    is_compressed: bool = False
    is_chunk_manifest: bool = False
    append_at_ns: int = 0
    checksum: int = 0
    size: int = field(default=0, init=False)  # body size, set on encode/parse

    def _has_ttl(self) -> bool:
        return bool(self.ttl) and self.ttl != b"\x00\x00"

    @property
    def flags(self) -> int:
        f = 0
        if self.is_compressed:
            f |= FLAG_IS_COMPRESSED
        if self.name:
            f |= FLAG_HAS_NAME
        if self.mime:
            f |= FLAG_HAS_MIME
        if self.last_modified:
            f |= FLAG_HAS_LAST_MODIFIED
        if self._has_ttl():
            f |= FLAG_HAS_TTL
        if self.pairs:
            f |= FLAG_HAS_PAIRS
        if self.is_chunk_manifest:
            f |= FLAG_IS_CHUNK_MANIFEST
        return f

    def to_bytes(self, version: int = CURRENT_VERSION, tombstone: bool = False) -> bytes:
        """Encode the record. A live needle always carries a body (DataSize
        and flags at least, so size >= 5 even for empty data); a tombstone
        (the delete marker `Volume.delete_needle` appends) has size 0,
        which tells deletes from empty writes when an index is rebuilt by
        scanning the .dat."""
        if version not in (VERSION2, VERSION3):
            raise ValueError(f"unsupported needle version {version}")
        if len(self.name) > 255 or len(self.mime) > 255:
            raise ValueError("name/mime limited to 255 bytes")
        body = bytearray()
        if not tombstone:
            body += struct.pack(">I", len(self.data))
            body += self.data
            body.append(self.flags)
            if self.name:
                body.append(len(self.name))
                body += self.name
            if self.mime:
                body.append(len(self.mime))
                body += self.mime
            if self.last_modified:
                body += self.last_modified.to_bytes(LAST_MODIFIED_BYTES, "big")
            if self._has_ttl():
                body += self.ttl[:TTL_BYTES].ljust(TTL_BYTES, b"\x00")
            if self.pairs:
                body += struct.pack(">H", len(self.pairs))
                body += self.pairs
        self.size = len(body)
        self.checksum = crc32c(self.data)
        out = bytearray(struct.pack(">IQi", self.cookie, self.id, self.size))
        out += body
        out += struct.pack(">I", self.checksum)
        if version == VERSION3:
            if not self.append_at_ns:
                self.append_at_ns = time.time_ns()
            out += struct.pack(">Q", self.append_at_ns)
        out += b"\x00" * types.padding_length(self.size, version)
        return bytes(out)

    @classmethod
    def from_bytes(cls, buf: bytes, version: int = CURRENT_VERSION, verify: bool = True) -> "Needle":
        if len(buf) < types.NEEDLE_HEADER_SIZE:
            raise ValueError("buffer shorter than needle header")
        cookie, nid, size = struct.unpack_from(">IQi", buf, 0)
        n = cls(cookie=cookie, id=nid)
        n.size = size
        pos = types.NEEDLE_HEADER_SIZE
        end_of_body = pos + max(size, 0)
        if len(buf) < end_of_body + types.NEEDLE_CHECKSUM_SIZE:
            raise ValueError(f"buffer too short: body says {size}, have {len(buf) - pos}")

        def need(k: int) -> None:
            if pos + k > end_of_body:
                raise ValueError(
                    f"needle {nid:x}: corrupt body — field of {k} bytes at "
                    f"{pos} exceeds body end {end_of_body}"
                )

        if size > 0:
            need(4)
            (data_size,) = struct.unpack_from(">I", buf, pos)
            pos += 4
            need(data_size + 1)
            n.data = bytes(buf[pos : pos + data_size])
            pos += data_size
            flags = buf[pos]
            pos += 1
            n.is_compressed = bool(flags & FLAG_IS_COMPRESSED)
            n.is_chunk_manifest = bool(flags & FLAG_IS_CHUNK_MANIFEST)
            if flags & FLAG_HAS_NAME:
                need(1)
                ln = buf[pos]
                pos += 1
                need(ln)
                n.name = bytes(buf[pos : pos + ln])
                pos += ln
            if flags & FLAG_HAS_MIME:
                need(1)
                lm = buf[pos]
                pos += 1
                need(lm)
                n.mime = bytes(buf[pos : pos + lm])
                pos += lm
            if flags & FLAG_HAS_LAST_MODIFIED:
                need(LAST_MODIFIED_BYTES)
                n.last_modified = int.from_bytes(buf[pos : pos + LAST_MODIFIED_BYTES], "big")
                pos += LAST_MODIFIED_BYTES
            if flags & FLAG_HAS_TTL:
                need(TTL_BYTES)
                n.ttl = bytes(buf[pos : pos + TTL_BYTES])
                pos += TTL_BYTES
            if flags & FLAG_HAS_PAIRS:
                need(2)
                (lp,) = struct.unpack_from(">H", buf, pos)
                pos += 2
                need(lp)
                n.pairs = bytes(buf[pos : pos + lp])
                pos += lp
            if pos != end_of_body:
                raise ValueError(f"body parse mismatch: at {pos}, size says {end_of_body}")
        (n.checksum,) = struct.unpack_from(">I", buf, end_of_body)
        if version == VERSION3 and len(buf) >= end_of_body + 4 + 8:
            (n.append_at_ns,) = struct.unpack_from(">Q", buf, end_of_body + 4)
        if verify and crc32c(n.data) != n.checksum:
            raise CrcError(f"needle {nid:x}: crc mismatch")
        return n

    def actual_size(self, version: int = CURRENT_VERSION) -> int:
        return types.actual_size(self.size, version)
