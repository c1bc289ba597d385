"""The store of upstream SeaweedFS (weed/storage/store.go, disk_location*.go,
store_ec.go): a server's disk locations with their normal and EC volumes.
Its encoder, the one every EC volume it mounts decodes with, is the
factory's (`new_encoder()`: the card and the factory's kernel) unless the
caller passes one."""

from __future__ import annotations

import glob
import os
import re
import threading
import time
from typing import Callable, Optional

from seaweedfs_tpu_torch.ec import stripe
from seaweedfs_tpu_torch.ec.ec_volume import EcVolume
from seaweedfs_tpu_torch.ec.shard_bits import EcVolumeInfo, ShardBits
from seaweedfs_tpu_torch.ops.rs_codec import Encoder, new_encoder
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.super_block import TTL, ReplicaPlacement, SuperBlock
from seaweedfs_tpu_torch.storage.volume import Volume
from seaweedfs_tpu_torch.utils import glog

_BASE_RE = re.compile(r"^(?:(?P<col>.+)_)?(?P<vid>\d+)$")


def parse_base_name(base: str) -> Optional[tuple[str, int]]:
    m = _BASE_RE.match(base)
    if not m:
        return None
    return m.group("col") or "", int(m.group("vid"))


def _volume_files(directory: str) -> list[str]:
    """A location's normal volumes: each .dat, and each .tierinfo (a .dat
    tiered to remote storage)."""
    return (glob.glob(os.path.join(directory, "*.dat"))
            + glob.glob(os.path.join(directory, "*.tierinfo")))


class DiskLocation:
    def __init__(self, directory: str):
        # normalised: a trailing slash must not break matching a base path
        # to the location that owns it
        self.directory = os.path.normpath(directory)
        os.makedirs(directory, exist_ok=True)
        self.volumes: dict[int, Volume] = {}
        self.ec_volumes: dict[int, EcVolume] = {}

    def load(self, encoder: Optional[Encoder] = None, needle_map_kind: str = "memory") -> None:
        for path in _volume_files(self.directory):
            parsed = parse_base_name(os.path.basename(path).rsplit(".", 1)[0])
            if parsed is None:
                continue
            collection, vid = parsed
            if vid not in self.volumes:
                self.volumes[vid] = Volume(self.directory, vid, collection,
                                           needle_map_kind=needle_map_kind)
        for ecx in glob.glob(os.path.join(self.directory, "*.ecx")):
            base = os.path.basename(ecx)[: -len(".ecx")]
            parsed = parse_base_name(base)
            if parsed is None:
                continue
            vid = parsed[1]
            base_path = os.path.join(self.directory, base)
            if vid not in self.ec_volumes and stripe.find_local_shards(base_path):
                try:
                    self.ec_volumes[vid] = EcVolume(base_path, encoder=encoder)
                except (ValueError, KeyError) as e:
                    # a shard set that contradicts its .eci (EcGeometryError:
                    # a crash mid-conversion cut-over) or a malformed .eci
                    # must neither stop the load nor be served: skip it
                    # loudly, and the next load takes the healed volume
                    glog.warning("skipping ec volume %d: %s", vid, e)


class Store:
    def __init__(
        self,
        directories: list[str],
        encoder: Optional[Encoder] = None,
        needle_map_kind: str = "memory",
    ):
        self.encoder = encoder or new_encoder()
        self.locations = [DiskLocation(d) for d in directories]
        # the -index flag: memory rebuilds the id map in RAM at each mount,
        # sorted_file binary-searches a persistent .sdx sidecar
        self.needle_map_kind = needle_map_kind
        self._lock = threading.RLock()
        #: optional hook `callback(vid)`, called after every acknowledged
        #: needle write or delete (both append to the .dat): the inline-EC
        #: ingest manager polls its builders through it. It must not raise
        #: into the write path.
        self.on_write: Optional[Callable[[int], None]] = None

    def load(self) -> None:
        with self._lock:
            for loc in self.locations:
                loc.load(self.encoder, self.needle_map_kind)

    def close(self) -> None:
        with self._lock:
            for loc in self.locations:
                for v in loc.volumes.values():
                    v.close()
                for ev in loc.ec_volumes.values():
                    ev.close()

    # -- normal volumes ------------------------------------------------------

    def _pick_location(self) -> DiskLocation:
        return min(self.locations, key=lambda loc: len(loc.volumes) + len(loc.ec_volumes))

    def create_volume(self, vid: int, collection: str = "", replication: str = "000",
                      ttl: str = "", version: int = 3) -> Volume:
        with self._lock:
            if self.get_volume(vid) is not None:
                raise ValueError(f"volume {vid} already exists")
            sb = SuperBlock(version=version, replica_placement=ReplicaPlacement.parse(replication),
                            ttl=TTL.parse(ttl))
            loc = self._pick_location()
            v = Volume(loc.directory, vid, collection, super_block=sb,
                       needle_map_kind=self.needle_map_kind)
            loc.volumes[vid] = v
            return v

    def get_volume(self, vid: int) -> Optional[Volume]:
        for loc in self.locations:
            if vid in loc.volumes:
                return loc.volumes[vid]
        return None

    def get_ec_volume(self, vid: int) -> Optional[EcVolume]:
        for loc in self.locations:
            if vid in loc.ec_volumes:
                return loc.ec_volumes[vid]
        return None

    def write_needle(self, vid: int, n: Needle) -> tuple[int, int]:
        v = self.get_volume(vid)
        if v is None:
            raise KeyError(f"volume {vid} not found")
        out = v.write_needle(n)
        if self.on_write is not None:
            self.on_write(vid)
        return out

    def read_needle(self, vid: int, needle_id: int, cookie: Optional[int] = None) -> Needle:
        v = self.get_volume(vid)
        if v is not None:
            return v.read_needle(needle_id, cookie)
        if self.get_ec_volume(vid) is not None:
            return self.read_ec_needle(vid, needle_id, cookie)
        raise KeyError(f"volume {vid} not found")

    def delete_needle(self, vid: int, needle_id: int) -> bool:
        v = self.get_volume(vid)
        if v is not None:
            found = v.delete_needle(needle_id)
            if self.on_write is not None:
                self.on_write(vid)  # a tombstone is a .dat append too
            return found
        ev = self.get_ec_volume(vid)
        if ev is not None:
            return ev.delete_needle(needle_id)
        raise KeyError(f"volume {vid} not found")

    # -- EC volumes ----------------------------------------------------------

    def read_ec_needle(self, vid: int, needle_id: int, cookie: Optional[int] = None) -> Needle:
        ev = self.get_ec_volume(vid)
        if ev is None:
            raise KeyError(f"ec volume {vid} not found")
        n = Needle.from_bytes(ev.read_needle_blob(needle_id), ev.version)
        if n.id != needle_id:
            raise IOError(f"ec needle id mismatch: {n.id:x} != {needle_id:x}")
        if cookie is not None and n.cookie != cookie:
            raise PermissionError(f"needle {needle_id:x}: cookie mismatch")
        return n

    def mount_ec_volume(self, vid: int, base_path: str) -> EcVolume:
        with self._lock:
            loc = next((loc for loc in self.locations
                        if os.path.dirname(base_path) == loc.directory), self.locations[0])
            old = loc.ec_volumes.pop(vid, None)
            if old is not None:
                old.close()
            ev = EcVolume(base_path, encoder=self.encoder)
            loc.ec_volumes[vid] = ev
            return ev

    def unmount_ec_volume(self, vid: int) -> None:
        with self._lock:
            for loc in self.locations:
                ev = loc.ec_volumes.pop(vid, None)
                if ev is not None:
                    ev.close()

    # -- status --------------------------------------------------------------

    def _pop_volume(self, vid: int) -> list[Volume]:
        """Take a volume out of every location's map. Only the pop holds the
        store lock: closing can wait behind a minutes-long compaction's
        volume lock, and holding the store lock through that would stall
        every create and mount."""
        with self._lock:
            return [v for loc in self.locations
                    if (v := loc.volumes.pop(vid, None)) is not None]

    def remove_volume(self, vid: int) -> bool:
        """Close a local volume and unlink its files."""
        popped = self._pop_volume(vid)
        for v in popped:
            v.close()
            # .tierinfo too: left behind, it would bring the volume back at
            # the next load
            for ext in (".dat", ".idx", ".sdx", ".sdx.meta", ".tierinfo"):
                if os.path.exists(v.base_path + ext):
                    os.remove(v.base_path + ext)
        return bool(popped)

    def unmount_volume(self, vid: int) -> bool:
        """Close a volume and stop serving it, keeping its files."""
        popped = self._pop_volume(vid)
        for v in popped:
            v.close()
        return bool(popped)

    def mount_volume(self, vid: int) -> bool:
        """(Re)open an unmounted volume from its files; False when there are
        none. The index replay can take minutes, so it runs outside the
        store lock."""
        target: Optional[tuple[DiskLocation, str]] = None
        with self._lock:
            if self.get_volume(vid) is not None:
                return True
            for loc in self.locations:
                for path in _volume_files(loc.directory):
                    parsed = parse_base_name(os.path.basename(path).rsplit(".", 1)[0])
                    if parsed is not None and parsed[1] == vid:
                        target = (loc, parsed[0])
                        break
                if target:
                    break
        if target is None:
            return False
        loc, collection = target
        v = Volume(loc.directory, vid, collection, needle_map_kind=self.needle_map_kind)
        with self._lock:
            if vid in loc.volumes:  # another mount won the race: keep theirs
                v.close()
            else:
                loc.volumes[vid] = v
        return True

    def expired_volume_ids(self) -> list[int]:
        """TTL volumes whose newest write has aged out (.dat mtime is the
        last append, so mtime + ttl < now means every needle in it has).
        Only a scan: a server deletes under its own maintenance lock."""
        expired = []
        with self._lock:
            for loc in self.locations:
                for vid, v in loc.volumes.items():
                    ttl_s = v.super_block.ttl.seconds
                    if not ttl_s:
                        continue
                    mtime = v.last_modified()
                    if mtime and mtime + ttl_s < time.time():
                        expired.append(vid)
        return expired

    def reap_expired_volumes(self) -> list[int]:
        """Remove the expired, writable TTL volumes (the expiry pass of a
        store without a volume server)."""
        expired = [vid for vid in self.expired_volume_ids()
                   if (v := self.get_volume(vid)) is not None and not v.read_only]
        for vid in expired:
            self.remove_volume(vid)
        return expired

    def volume_infos(self) -> list[dict]:
        out = []
        for loc in self.locations:
            for vid, v in loc.volumes.items():
                # lock-free: a heartbeat must not wait behind a compaction
                size, count, garbage = v.stats_snapshot()
                out.append({
                    "id": vid,
                    "collection": v.collection,
                    "size": size,
                    "file_count": count,
                    "read_only": v.read_only,
                    "replica_placement": str(v.super_block.replica_placement),
                    "ttl": str(v.super_block.ttl),
                    "version": v.version,
                    "disk_type": "",
                    "garbage_ratio": round(garbage, 4),
                    "last_modified": v.last_modified(),
                })
        return out

    def ec_volume_infos(self) -> list[EcVolumeInfo]:
        out = []
        for loc in self.locations:
            for vid, ev in loc.ec_volumes.items():
                parsed = parse_base_name(os.path.basename(ev.base))
                out.append(EcVolumeInfo(
                    volume_id=vid,
                    collection=parsed[0] if parsed else "",
                    shard_bits=ShardBits.from_ids(ev.shard_ids),
                    shard_size=int(ev.shard_size or 0),
                    data_shards=int(ev.data_shards),
                    total_shards=int(ev.total_shards),
                ))
        return out
