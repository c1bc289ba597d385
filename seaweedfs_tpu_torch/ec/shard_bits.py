"""ShardBits and EcVolumeInfo of upstream SeaweedFS (erasure_coding/
ec_volume_info.go): a uint32 mask of the shards a node holds, sized to
MAX_SHARD_COUNT so geometries past the legacy 14 shards register too."""

from __future__ import annotations

from dataclasses import dataclass, field

from seaweedfs_tpu_torch.ec.constants import MAX_SHARD_COUNT


class ShardBits(int):
    def add_shard_id(self, shard_id: int) -> "ShardBits":
        return ShardBits(self | (1 << shard_id))

    def remove_shard_id(self, shard_id: int) -> "ShardBits":
        return ShardBits(self & ~(1 << shard_id))

    def has_shard_id(self, shard_id: int) -> bool:
        return bool(self & (1 << shard_id))

    def shard_ids(self) -> list[int]:
        return [i for i in range(MAX_SHARD_COUNT) if self.has_shard_id(i)]

    def shard_id_count(self) -> int:
        return bin(self & ((1 << MAX_SHARD_COUNT) - 1)).count("1")

    def plus(self, other: "ShardBits") -> "ShardBits":
        return ShardBits(self | other)

    def minus(self, other: "ShardBits") -> "ShardBits":
        return ShardBits(self & ~other)

    @classmethod
    def from_ids(cls, ids) -> "ShardBits":
        b = cls(0)
        for i in ids:
            b = b.add_shard_id(i)
        return b


@dataclass
class EcVolumeInfo:
    volume_id: int
    collection: str = ""
    shard_bits: ShardBits = field(default_factory=lambda: ShardBits(0))
    # the code geometry and per-shard bytes a heartbeat carries, so a repair
    # scheduler counts missing shards against the volume's real (k, k+m)
    # and ranks stripes by bytes at risk; 0 = an old reporter (10+4)
    shard_size: int = 0
    data_shards: int = 0
    total_shards: int = 0

    def to_dict(self) -> dict:
        return {
            "volume_id": self.volume_id,
            "collection": self.collection,
            "shard_bits": int(self.shard_bits),
            "shard_size": int(self.shard_size),
            "data_shards": int(self.data_shards),
            "total_shards": int(self.total_shards),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "EcVolumeInfo":
        return cls(
            d["volume_id"],
            d.get("collection", ""),
            ShardBits(d.get("shard_bits", 0)),
            shard_size=int(d.get("shard_size", 0) or 0),
            data_shards=int(d.get("data_shards", 0) or 0),
            total_shards=int(d.get("total_shards", 0) or 0),
        )
