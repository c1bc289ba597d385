"""The volume engine of upstream SeaweedFS (weed/storage/volume*.go): an
append-only needle log and its index. A volume is <collection>_<vid>.dat
(superblock + needle records at 8-aligned offsets) plus <...>.idx
(append-only 16-byte entries). A delete appends a tombstone record and a
tombstone index entry; compaction rewrites the live needles into a fresh
.dat/.idx pair.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from seaweedfs_tpu_torch.storage import idx as idx_mod
from seaweedfs_tpu_torch.storage import types
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.needle_map import CompactMap, new_needle_map
from seaweedfs_tpu_torch.storage.scan import rebuild_idx
from seaweedfs_tpu_torch.storage.super_block import SUPER_BLOCK_SIZE, ReplicaPlacement, SuperBlock


class NeedleExpired(KeyError):
    """A TTL needle aged out: it reads as absent; compaction reclaims it."""


class VolumeReadOnly(IOError):
    pass


class Volume:
    def __init__(
        self,
        dir_: str,
        volume_id: int,
        collection: str = "",
        super_block: Optional[SuperBlock] = None,
        needle_map_kind: str = "memory",
    ):
        self.dir = dir_
        self.id = volume_id
        self.collection = collection
        self.read_only = False
        self._lock = threading.RLock()
        self.needle_map_kind = needle_map_kind
        self.nm = CompactMap()
        base = f"{collection}_{volume_id}" if collection else str(volume_id)
        self.base_path = os.path.join(dir_, base)
        self.dat_path = self.base_path + ".dat"
        self.idx_path = self.base_path + ".idx"

        self.tiered = False
        if os.path.exists(self.base_path + ".tierinfo") and not os.path.exists(self.dat_path):
            # a cold volume: its .dat lives in remote storage, and reads go
            # through the remote backend (imported here, so the local
            # commands import no vendor)
            from seaweedfs_tpu_torch.remote_storage.tier import open_tiered_dat

            self._dat = open_tiered_dat(self.base_path)
            self.tiered = True
            self.read_only = True
            exists = True
        else:
            exists = os.path.exists(self.dat_path)
            self._dat = open(self.dat_path, "r+b" if exists else "w+b")
        try:
            if exists:
                self._dat.seek(0, os.SEEK_END)
                dat_size = self._dat.tell()
                if dat_size >= SUPER_BLOCK_SIZE:
                    self._dat.seek(0)
                    self.super_block = SuperBlock.from_bytes(self._dat.read(SUPER_BLOCK_SIZE))
                else:
                    self.super_block = super_block or SuperBlock()
                    self._write_super_block()
                if (not os.path.exists(self.idx_path) and dat_size > SUPER_BLOCK_SIZE
                        and not self.tiered):
                    # the .dat has records but the index is gone (a crash, a
                    # manual delete): rebuild it by scan before serving, or
                    # reads miss and a compact would wipe the volume. A
                    # structure-only scan: a flipped data bit surfaces on that
                    # needle's read, not as a refusal to open the volume
                    rebuild_idx(self.base_path, verify_crc=False)
                if needle_map_kind != "memory":
                    # a persistent map mounts in O(tail): it binary-searches
                    # the .sdx sidecar instead of rebuilding the map in RAM
                    self.nm = new_needle_map(needle_map_kind, self.base_path)
                elif os.path.exists(self.idx_path):
                    self.nm.load_from_idx(self.idx_path)
            else:
                self.super_block = super_block or SuperBlock()
                self._write_super_block()
                if needle_map_kind != "memory":
                    self.nm = new_needle_map(needle_map_kind, self.base_path)
            self._idx = open(self.idx_path, "ab")
            # live bytes for the garbage ratio that drives automatic vacuum:
            # one O(live) pass at mount, then kept up to date
            self._live_bytes = sum(
                types.actual_size(size, self.version) for _, _, size in self.nm.ascending_visit()
            )
        except BaseException:
            self._dat.close()
            raise

    def _write_super_block(self) -> None:
        self._dat.seek(0)
        self._dat.write(self.super_block.to_bytes())
        self._dat.flush()

    @property
    def version(self) -> int:
        return self.super_block.version

    def configure_replication(self, replication: str) -> None:
        """Rewrite the superblock's replica-placement byte in place, so the
        change survives a remount."""
        with self._lock:
            self.super_block.replica_placement = ReplicaPlacement.parse(replication)
            self._write_super_block()

    def close(self) -> None:
        with self._lock:
            # the .idx must be durable before a persistent map advances its
            # watermark past it
            self._idx.flush()
            self.nm.close()
            self._dat.close()
            self._idx.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- write path ----------------------------------------------------------

    def write_needle(self, n: Needle) -> tuple[int, int]:
        """Append a needle; returns (offset, body_size)."""
        with self._lock:
            if self.read_only:
                raise VolumeReadOnly(f"volume {self.id} is read-only")
            self._dat.seek(0, os.SEEK_END)
            offset = self._dat.tell()
            if offset % types.NEEDLE_PADDING_SIZE:
                pad = types.NEEDLE_PADDING_SIZE - offset % types.NEEDLE_PADDING_SIZE
                self._dat.write(b"\x00" * pad)
                offset += pad
            self._dat.write(n.to_bytes(self.version))
            self._dat.flush()
            stored = types.offset_to_bytes(offset)
            old = self.nm.get(n.id)
            if old is not None:  # an overwrite: the old record becomes garbage
                self._live_bytes -= types.actual_size(old[1], self.version)
            self.nm.set(n.id, stored, n.size)
            self._live_bytes += types.actual_size(n.size, self.version)
            self._idx.write(types.pack_index_entry(n.id, stored, n.size))
            self._idx.flush()
            return offset, n.size

    def delete_needle(self, needle_id: int) -> bool:
        """Tombstone a needle; returns False if it is absent."""
        with self._lock:
            if self.read_only:
                raise VolumeReadOnly(f"volume {self.id} is read-only")
            old = self.nm.get(needle_id)
            if old is None:
                return False
            self._live_bytes -= types.actual_size(old[1], self.version)
            self._dat.seek(0, os.SEEK_END)
            self._dat.write(Needle(id=needle_id, cookie=0).to_bytes(self.version, tombstone=True))
            self._dat.flush()
            self.nm.delete(needle_id)
            self._idx.write(types.pack_index_entry(needle_id, 0, types.TOMBSTONE_FILE_SIZE))
            self._idx.flush()
            return True

    # -- read path -----------------------------------------------------------

    def read_needle(self, needle_id: int, cookie: Optional[int] = None) -> Needle:
        with self._lock:
            loc = self.nm.get(needle_id)
            if loc is None:
                raise KeyError(f"needle {needle_id} not found in volume {self.id}")
            stored, size = loc
            offset = types.offset_to_actual(stored)
            self._dat.seek(offset)
            buf = self._dat.read(types.actual_size(size, self.version))
        n = Needle.from_bytes(buf, self.version)
        if n.id != needle_id:
            raise IOError(f"needle id mismatch at {offset}: {n.id:x} != {needle_id:x}")
        if cookie is not None and n.cookie != cookie:
            raise PermissionError(f"needle {needle_id:x}: cookie mismatch")
        # needle-level TTL: on a TTL volume an aged-out needle reads as
        # absent before the whole volume is reaped
        ttl_s = self.super_block.ttl.seconds
        if ttl_s and n.append_at_ns and n.append_at_ns / 1e9 + ttl_s < time.time():
            raise NeedleExpired(f"needle {needle_id} expired (ttl)")
        return n

    def content_size(self) -> int:
        with self._lock:
            self._dat.seek(0, os.SEEK_END)
            return self._dat.tell()

    def needle_count(self) -> int:
        return len(self.nm)

    def needle_entries_page(self, start: int, limit: int) -> tuple[list[list[int]], bool]:
        """One page of live (id, size) pairs ascending from `start`, under
        the volume lock (writers change the map under it, and an unlocked
        visit can fault mid-iteration). Returns (page, truncated)."""
        with self._lock:
            out: list[list[int]] = []
            for key, _off, size in self.nm.ascending_visit(start):
                out.append([key, size])
                if len(out) >= limit:
                    break
            return out, len(out) >= limit

    def needle_append_ts(self, needle_ids: list[int]) -> dict[int, int]:
        """append_at_ns of each requested live needle: 0 when the volume
        predates v3 timestamps, absent when the needle is not in the map.
        One 8-byte read per needle: the timestamp sits right after header,
        body and checksum."""
        out: dict[int, int] = {}
        with self._lock:
            for nid in needle_ids:
                loc = self.nm.get(nid)
                if loc is None:
                    continue
                if self.version < 3:
                    out[nid] = 0
                    continue
                stored, size = loc
                self._dat.seek(types.offset_to_actual(stored) + types.NEEDLE_HEADER_SIZE
                               + max(size, 0) + types.NEEDLE_CHECKSUM_SIZE)
                raw = self._dat.read(8)
                out[nid] = int.from_bytes(raw, "big") if len(raw) == 8 else 0
        return out

    def tombstone_history(self, start: int = 0, limit: int = 0) -> tuple[list[list[int]], bool]:
        """Ids (ascending from `start`) with a tombstone anywhere in the .idx
        history, each with 1 when its final state is deleted and 0 when it
        was written again after the delete. O(idx); returns (page,
        truncated); limit <= 0 means unbounded."""
        with self._lock:
            self._idx.flush()
            with open(self.idx_path, "rb") as f:
                buf = f.read()
        ever: set[int] = set()
        final: dict[int, bool] = {}
        for key, off, size in idx_mod.walk_index_buffer(buf):
            dead = off == 0 or types.is_deleted(size)
            if dead:
                ever.add(key)
            final[key] = dead
        rows = [[k, 1 if final[k] else 0] for k in sorted(ever) if k >= start]
        if limit > 0 and len(rows) > limit:
            return rows[:limit], True
        return rows, False

    def is_expired(self) -> bool:
        """True when this is a TTL volume whose newest write (.dat mtime) has
        aged out. A caller that deletes must check again under the volume
        lock: a write acknowledged meanwhile refreshed the mtime."""
        ttl_s = self.super_block.ttl.seconds
        if not ttl_s or self.tiered:
            return False
        lm = self.last_modified()
        return bool(lm) and lm + ttl_s < time.time()

    def last_modified(self) -> int:
        """Unix seconds of the last append (.dat mtime; 0 when unreadable)."""
        try:
            return int(os.path.getmtime(self.dat_path))
        except OSError:
            return 0

    def garbage_ratio(self) -> float:
        """The dead share of the .dat body (deleted and overwritten records,
        tombstones): the automatic vacuum's trigger."""
        with self._lock:
            return self._garbage_from(self.content_size())

    def _garbage_from(self, size: int) -> float:
        body = size - SUPER_BLOCK_SIZE
        if body <= 0:
            return 0.0
        return max(0.0, (body - self._live_bytes) / body)

    def stats_snapshot(self) -> tuple[int, int, float]:
        """(size, needle_count, garbage_ratio) without the volume lock: a
        heartbeat must keep reporting while a compaction holds the lock for
        minutes. The values may be a moment stale."""
        try:
            size = os.path.getsize(self.dat_path)
        except OSError:
            if not self.tiered:
                return 0, len(self.nm), 0.0
            # a remote .dat: take the locked path (a tiered volume cannot
            # compact, so nothing holds the lock for minutes)
            size = self.content_size()
        return size, len(self.nm), self._garbage_from(size)

    # -- maintenance ---------------------------------------------------------

    def check_integrity(self) -> int:
        """Read (parse and CRC) every indexed needle; returns the live count."""
        ok = 0
        for key, _stored, _size in self.nm.ascending_visit():
            try:
                self.read_needle(key)
            except NeedleExpired:
                continue  # an aged-out TTL needle: absent, not corrupt
            ok += 1
        return ok

    def compact(self) -> tuple[int, int]:
        """Vacuum: rewrite the live needles into a fresh .dat/.idx. Returns
        (bytes_before, bytes_after)."""
        with self._lock:
            if self.tiered:
                raise IOError(
                    f"volume {self.id} is tiered to remote storage — "
                    "fetch it back (volume.tier.fetch) before compacting"
                )
            before = self.content_size()
            idx_bytes = os.path.getsize(self.idx_path) if os.path.exists(self.idx_path) else 0
            if (len(self.nm) == 0 and before > SUPER_BLOCK_SIZE
                    and idx_bytes < types.NEEDLE_MAP_ENTRY_SIZE):
                # an empty map over a non-empty .dat with no index entry at
                # all means the .idx was lost: compacting would destroy every
                # needle. (A fully deleted volume also has an empty map, but
                # its .idx holds tombstones, so it passes.)
                raise IOError(
                    f"volume {self.id}: index is empty but .dat holds "
                    f"{before} bytes — refusing to compact (run fix)"
                )
            cpd_dat, cpd_idx = self.dat_path + ".cpd", self.idx_path + ".cpx"
            new_sb = SuperBlock(
                version=self.super_block.version,
                replica_placement=self.super_block.replica_placement,
                ttl=self.super_block.ttl,
                compact_revision=self.super_block.compact_revision + 1,
            )
            with open(cpd_dat, "wb") as dat, open(cpd_idx, "wb") as idxf:
                dat.write(new_sb.to_bytes())
                for key, _stored, size in self.nm.ascending_visit():
                    try:
                        n = self.read_needle(key)
                    except NeedleExpired:
                        # an aged-out TTL needle: dropping it is the reclaim
                        self._live_bytes -= types.actual_size(size, self.version)
                        continue
                    offset = dat.tell()
                    dat.write(n.to_bytes(self.version))
                    idxf.write(types.pack_index_entry(key, types.offset_to_bytes(offset), n.size))
                dat.flush()
                os.fsync(dat.fileno())
                idxf.flush()
                os.fsync(idxf.fileno())
            self._dat.close()
            self._idx.close()
            os.replace(cpd_dat, self.dat_path)
            os.replace(cpd_idx, self.idx_path)
            self._dat = open(self.dat_path, "r+b")
            self._idx = open(self.idx_path, "ab")
            self.super_block = new_sb
            if self.needle_map_kind != "memory":
                # the sidecar's watermark refers to the old .idx: drop it so
                # the map rebuilds from the fresh index
                for ext in (".sdx", ".sdx.meta"):
                    if os.path.exists(self.base_path + ext):
                        os.unlink(self.base_path + ext)
                self.nm = new_needle_map(self.needle_map_kind, self.base_path)
            else:
                self.nm = CompactMap()
                self.nm.load_from_idx(self.idx_path)
            return before, self.content_size()

    def incremental_backup_since(self, offset: int) -> bytes:
        """The .dat bytes appended since `offset`."""
        with self._lock:
            self._dat.seek(offset)
            return self._dat.read()
