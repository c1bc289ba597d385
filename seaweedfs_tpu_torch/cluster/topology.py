"""Cluster topology — mirror of weed/topology (topology.go, topology_ec.go,
data_node.go, rack.go, data_center.go, volume_layout.go, volume_growth.go).

DC -> rack -> node tree fed by volume-server heartbeats; per-(collection,
replication, ttl) VolumeLayout tracking writable volumes and locations; the
EcShardLocations registry (vid -> shard id -> nodes); replica-placement-aware
volume growth. Pure in-process data structure — the master server wraps it
with RPC; tests drive it with fake heartbeats."""

from __future__ import annotations

import threading
import time
from typing import Optional

from seaweedfs_tpu_torch.ec.shard_bits import EcVolumeInfo, ShardBits
from seaweedfs_tpu_torch.pb import Heartbeat, VolumeInformation
from seaweedfs_tpu_torch.storage.super_block import ReplicaPlacement

VOLUME_SIZE_LIMIT = 30 * 1024 * 1024 * 1024  # 30 GB, the reference default
DEAD_NODE_SECONDS = 5 * 60


class DataNode:
    def __init__(self, hb: Heartbeat):
        self.ip = hb.ip
        self.port = hb.port
        self.grpc_port = hb.grpc_port
        self.public_url = hb.public_url or hb.url
        self.data_center = hb.data_center
        self.rack = hb.rack
        self.max_volume_count = hb.max_volume_count
        self.volumes: dict[int, VolumeInformation] = {}
        self.ec_shards: dict[int, ShardBits] = {}
        self.last_seen = time.monotonic()

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    @property
    def grpc_address(self) -> str:
        return f"{self.ip}:{self.grpc_port}"

    def is_alive(self, now: Optional[float] = None) -> bool:
        return ((now or time.monotonic()) - self.last_seen) < DEAD_NODE_SECONDS

    def free_slots(self) -> int:
        # an EC volume's shard set costs roughly shards/total of a slot;
        # count any presence as one slot for simplicity (reference counts
        # ec shards separately against max)
        return self.max_volume_count - len(self.volumes) - len(self.ec_shards)

    def to_dict(self) -> dict:
        return {
            "url": self.url,
            "public_url": self.public_url,
            "grpc_port": self.grpc_port,
            "data_center": self.data_center,
            "rack": self.rack,
            "max_volume_count": self.max_volume_count,
            "volumes": [v.to_dict() for v in self.volumes.values()],
            "ec_shards": [
                EcVolumeInfo(vid, shard_bits=bits).to_dict()
                for vid, bits in self.ec_shards.items()
            ],
        }


class VolumeLayout:
    """Writable/readonly volume tracking for one (collection, rp, ttl)."""

    def __init__(self, replica_placement: ReplicaPlacement, ttl: str):
        self.rp = replica_placement
        self.ttl = ttl
        self.locations: dict[int, list[DataNode]] = {}
        self.writable: set[int] = set()
        self.readonly: set[int] = set()

    def register(self, vi: VolumeInformation, node: DataNode) -> None:
        nodes = self.locations.setdefault(vi.id, [])
        if node not in nodes:
            nodes.append(node)
        if vi.read_only or vi.size >= VOLUME_SIZE_LIMIT:
            self.readonly.add(vi.id)
            self.writable.discard(vi.id)
        elif len(nodes) >= self.rp.copy_count:
            self.readonly.discard(vi.id)
            self.writable.add(vi.id)

    def unregister(self, vid: int, node: DataNode) -> None:
        nodes = self.locations.get(vid)
        if not nodes:
            return
        if node in nodes:
            nodes.remove(node)
        if not nodes:
            del self.locations[vid]
            self.writable.discard(vid)
            self.readonly.discard(vid)
        elif len(nodes) < self.rp.copy_count:
            self.writable.discard(vid)

    def pick_writable(self, rng) -> Optional[int]:
        if not self.writable:
            return None
        return rng.choice(sorted(self.writable))


def _layout_key(collection: str, replication: str, ttl: str) -> tuple:
    return (collection, replication, ttl)


class Topology:
    def __init__(self, volume_size_limit: int = VOLUME_SIZE_LIMIT):
        self._lock = threading.RLock()
        self.volume_size_limit = volume_size_limit
        self.nodes: dict[str, DataNode] = {}  # url -> node
        self.layouts: dict[tuple, VolumeLayout] = {}
        # EC registry: vid -> {shard_id -> set of node urls}
        self.ec_locations: dict[int, dict[int, set[str]]] = {}
        self.ec_collections: dict[int, str] = {}
        # per-volume code geometry + shard size, from heartbeats: the
        # repair scheduler ranks stripes by bytes at risk and computes
        # missing counts against the VOLUME's (k, k+m), not the legacy 14
        self.ec_geometry: dict[int, dict] = {}
        self.max_volume_id = 0
        # optional observer (the master's repair scheduler): called OUTSIDE
        # the topology lock whenever a heartbeat/unregister SHRANK some
        # node's EC shard coverage — the death/quarantine signal that makes
        # mass repair react in heartbeat time instead of scan time
        self.on_ec_shrink = None

    # -- heartbeat ingest ----------------------------------------------------

    def process_heartbeat(self, hb: Heartbeat) -> None:
        shrank = False
        with self._lock:
            node = self.nodes.get(hb.url)
            if node is None:
                node = DataNode(hb)
                self.nodes[hb.url] = node
            node.last_seen = time.monotonic()
            node.max_volume_count = hb.max_volume_count
            node.grpc_port = hb.grpc_port
            node.public_url = hb.public_url or hb.url
            node.data_center = hb.data_center
            node.rack = hb.rack

            new_volumes = {}
            for vd in hb.volumes:
                vi = VolumeInformation.from_dict(vd)
                new_volumes[vi.id] = vi
                self.max_volume_id = max(self.max_volume_id, vi.id)
            # unregister volumes that disappeared
            for vid in set(node.volumes) - set(new_volumes):
                self._layout_for_volume(node.volumes[vid]).unregister(vid, node)
            node.volumes = new_volumes
            for vi in new_volumes.values():
                self._layout_for_volume(vi).register(vi, node)

            new_shards: dict[int, ShardBits] = {}
            for ed in hb.ec_shards:
                info = EcVolumeInfo.from_dict(ed)
                new_shards[info.volume_id] = info.shard_bits
                self.max_volume_id = max(self.max_volume_id, info.volume_id)
                if getattr(info, "collection", ""):
                    self.ec_collections[info.volume_id] = info.collection
                if info.total_shards or info.shard_size:
                    self.ec_geometry[info.volume_id] = {
                        "data_shards": info.data_shards,
                        "total_shards": info.total_shards,
                        "shard_size": info.shard_size,
                    }
            for vid, bits in node.ec_shards.items():
                if bits.minus(new_shards.get(vid, ShardBits(0))):
                    shrank = True  # some shard this node held is gone
            self._sync_ec_shards(node, new_shards)
            node.ec_shards = new_shards
        if shrank and self.on_ec_shrink is not None:
            try:
                self.on_ec_shrink()
            except Exception:  # noqa: BLE001 — observers must not break ingest
                pass

    def _sync_ec_shards(self, node: DataNode, new: dict[int, ShardBits]) -> None:
        old = node.ec_shards
        for vid in set(old) | set(new):
            old_bits = old.get(vid, ShardBits(0))
            new_bits = new.get(vid, ShardBits(0))
            for sid in old_bits.minus(new_bits).shard_ids():
                holders = self.ec_locations.get(vid, {}).get(sid)
                if holders:
                    holders.discard(node.url)
            for sid in new_bits.shard_ids():
                self.ec_locations.setdefault(vid, {}).setdefault(sid, set()).add(node.url)
        # drop empty registries
        for vid in list(self.ec_locations):
            m = self.ec_locations[vid]
            for sid in list(m):
                if not m[sid]:
                    del m[sid]
            if not m:
                del self.ec_locations[vid]
                self.ec_collections.pop(vid, None)
                self.ec_geometry.pop(vid, None)

    def unregister_node(self, url: str) -> None:
        with self._lock:
            node = self.nodes.pop(url, None)
            if node is None:
                return
            for vi in node.volumes.values():
                self._layout_for_volume(vi).unregister(vi.id, node)
            held_ec = bool(node.ec_shards)
            self._sync_ec_shards(node, {})
        if held_ec and self.on_ec_shrink is not None:
            try:
                self.on_ec_shrink()
            except Exception:  # noqa: BLE001 — observers must not break ingest
                pass

    def reap_dead_nodes(self) -> list[str]:
        with self._lock:
            now = time.monotonic()
            dead = [u for u, n in self.nodes.items() if not n.is_alive(now)]
        for u in dead:
            self.unregister_node(u)
        return dead

    # -- layouts / lookup ----------------------------------------------------

    def _layout_for_volume(self, vi: VolumeInformation) -> VolumeLayout:
        return self.get_layout(vi.collection, vi.replica_placement, vi.ttl)

    def get_layout(self, collection: str, replication: str, ttl: str) -> VolumeLayout:
        with self._lock:
            key = _layout_key(collection, replication or "000", ttl)
            layout = self.layouts.get(key)
            if layout is None:
                layout = VolumeLayout(ReplicaPlacement.parse(replication or "000"), ttl)
                self.layouts[key] = layout
            return layout

    def pick_writable(self, layout: VolumeLayout, rng) -> Optional[tuple[int, list[DataNode]]]:
        """(vid, locations) for a writable volume of `layout`, chosen under
        the topology lock so heartbeat ingest can't race the read."""
        with self._lock:
            vid = layout.pick_writable(rng)
            if vid is None:
                return None
            return vid, list(layout.locations.get(vid, []))

    def lookup(self, vid: int, collection: str = "") -> list[DataNode]:
        """All nodes holding `vid` as a normal volume (any layout)."""
        with self._lock:
            out: list[DataNode] = []
            for layout in self.layouts.values():
                for node in layout.locations.get(vid, []):
                    if node not in out:
                        out.append(node)
            return out

    def lookup_ec_shards(self, vid: int) -> dict[int, list[DataNode]]:
        with self._lock:
            m = self.ec_locations.get(vid, {})
            return {
                sid: [self.nodes[u] for u in urls if u in self.nodes]
                for sid, urls in m.items()
            }

    def next_volume_id(self) -> int:
        with self._lock:
            self.max_volume_id += 1
            return self.max_volume_id

    # -- placement (volume_growth.go analog) ---------------------------------

    def place_replicas(self, rp: ReplicaPlacement) -> Optional[list[DataNode]]:
        """Pick copy_count nodes honoring the xyz placement digits:
        same_rack extra copies on the primary's rack, diff_rack copies on
        other racks of the primary's DC, diff_dc copies in other DCs."""
        with self._lock:
            alive = [n for n in self.nodes.values() if n.is_alive() and n.free_slots() > 0]
            if not alive:
                return None
            alive.sort(key=lambda n: -n.free_slots())
            primary = alive[0]
            chosen = [primary]

            def pick(pred, count):
                got = []
                for n in alive:
                    if len(got) >= count:
                        break
                    if n not in chosen and pred(n):
                        got.append(n)
                return got if len(got) >= count else None

            same_rack = pick(
                lambda n: n.data_center == primary.data_center and n.rack == primary.rack,
                rp.same_rack,
            )
            if same_rack is None:
                return None
            chosen += same_rack
            diff_rack = pick(
                lambda n: n.data_center == primary.data_center and n.rack != primary.rack,
                rp.diff_rack,
            )
            if diff_rack is None:
                return None
            chosen += diff_rack
            diff_dc = pick(lambda n: n.data_center != primary.data_center, rp.diff_dc)
            if diff_dc is None:
                return None
            chosen += diff_dc
            return chosen

    # -- introspection -------------------------------------------------------

    def to_dict(self) -> dict:
        with self._lock:
            dcs: dict[str, dict[str, list[dict]]] = {}
            for node in self.nodes.values():
                dcs.setdefault(node.data_center, {}).setdefault(node.rack, []).append(
                    node.to_dict()
                )
            return {
                "max_volume_id": self.max_volume_id,
                "volume_size_limit": self.volume_size_limit,
                "data_centers": dcs,
                "ec_volumes": {
                    str(vid): {str(sid): sorted(urls) for sid, urls in m.items()}
                    for vid, m in self.ec_locations.items()
                },
                "ec_collections": {
                    str(vid): coll for vid, coll in self.ec_collections.items()
                },
            }
