"""The volume superblock, replica placement and TTL of upstream SeaweedFS
(weed/storage/super_block).

Superblock: 8 bytes at .dat offset 0:
  version(1) | replica_placement(1) | ttl(2) | compact_revision(2 BE) | extra(2)

ReplicaPlacement packs three digits x,y,z (copies on other DCs, other racks,
same rack) into one byte as x*100 + y*10 + z.

TTL packs (count, unit) into 2 bytes; units: minute/hour/day/week/month/year.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

SUPER_BLOCK_SIZE = 8

TTL_UNITS = {0: "", 1: "m", 2: "h", 3: "d", 4: "w", 5: "M", 6: "y"}
TTL_UNIT_CODES = {v: k for k, v in TTL_UNITS.items() if v}
_TTL_MINUTES = {"m": 1, "h": 60, "d": 24 * 60, "w": 7 * 24 * 60, "M": 31 * 24 * 60,
                "y": 365 * 24 * 60}


@dataclass(frozen=True)
class TTL:
    count: int = 0
    unit: str = ""

    @classmethod
    def parse(cls, s: str) -> "TTL":
        s = (s or "").strip()
        if not s:
            return cls()
        unit = s[-1]
        if unit.isdigit():
            count, unit = int(s), "m"
        elif unit not in TTL_UNIT_CODES:
            raise ValueError(f"bad ttl unit {unit!r}")
        else:
            count = int(s[:-1] or "0")
        if not 0 <= count <= 255:
            # one on-disk byte holds the count: wrapping (300m -> 44m)
            # would expire data early, so reject at the boundary
            raise ValueError(f"ttl count {count}{unit} exceeds 255 — use a larger unit")
        return cls(count, unit)

    def to_bytes(self) -> bytes:
        if not self.count:
            return b"\x00\x00"
        if not 0 < self.count <= 255:
            raise ValueError(f"ttl count {self.count} not storable in one byte")
        return bytes([self.count, TTL_UNIT_CODES[self.unit]])

    @classmethod
    def from_bytes(cls, b: bytes) -> "TTL":
        if len(b) < 2 or b[0] == 0:
            return cls()
        return cls(b[0], TTL_UNITS.get(b[1], "m"))

    @property
    def seconds(self) -> int:
        """0 = no expiry."""
        if not self.count:
            return 0
        return self.count * _TTL_MINUTES[self.unit or "m"] * 60

    @property
    def minutes(self) -> int:
        return self.count * _TTL_MINUTES.get(self.unit, 0) if self.count else 0

    def __str__(self) -> str:
        return f"{self.count}{self.unit}" if self.count else ""


@dataclass(frozen=True)
class ReplicaPlacement:
    same_rack: int = 0
    diff_rack: int = 0
    diff_dc: int = 0

    @classmethod
    def parse(cls, s: str) -> "ReplicaPlacement":
        s = (s or "000").strip()
        if len(s) != 3 or not s.isdigit():
            raise ValueError(f"replica placement must be 3 digits, got {s!r}")
        return cls(diff_dc=int(s[0]), diff_rack=int(s[1]), same_rack=int(s[2]))

    def to_byte(self) -> int:
        return self.diff_dc * 100 + self.diff_rack * 10 + self.same_rack

    @classmethod
    def from_byte(cls, b: int) -> "ReplicaPlacement":
        return cls(diff_dc=b // 100, diff_rack=(b // 10) % 10, same_rack=b % 10)

    @property
    def copy_count(self) -> int:
        return self.same_rack + self.diff_rack + self.diff_dc + 1

    def __str__(self) -> str:
        return f"{self.diff_dc}{self.diff_rack}{self.same_rack}"


@dataclass
class SuperBlock:
    version: int = 3
    replica_placement: ReplicaPlacement = field(default_factory=ReplicaPlacement)
    ttl: TTL = field(default_factory=TTL)
    compact_revision: int = 0

    def to_bytes(self) -> bytes:
        return struct.pack(">BB2sHH", self.version, self.replica_placement.to_byte(),
                           self.ttl.to_bytes(), self.compact_revision, 0)

    @classmethod
    def from_bytes(cls, b: bytes) -> "SuperBlock":
        if len(b) < SUPER_BLOCK_SIZE:
            raise ValueError("superblock too short")
        version, rp, ttl_b, rev, _ = struct.unpack(">BB2sHH", b[:SUPER_BLOCK_SIZE])
        return cls(version=version, replica_placement=ReplicaPlacement.from_byte(rp),
                   ttl=TTL.from_bytes(ttl_b), compact_revision=rev)
