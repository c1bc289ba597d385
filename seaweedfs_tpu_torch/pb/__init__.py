"""Wire contracts — the dataclass mirror of upstream's weed/pb/master.proto
+ volume_server.proto.

Two wire formats share the contracts.proto schema: the default JSON
transport over seaweedfs_tpu_torch.rpc's generic handlers, and a BINARY
PROTOBUF wire (WEEDTPU_WIRE=proto) built by pb/wire.py from a protoc
FileDescriptorSet at runtime — message classes come from
google.protobuf.message_factory instead of generated _pb2 modules.
Field names below match upstream's protos. This module imports neither
grpc nor protobuf; pb/wire.py does.

Services and methods (paths are /<service>/<method>):

  weedtpu.Master       — Assign, Lookup, LookupEcVolume, VolumeList,
                         Heartbeat (unary here: full-state report returning
                         config; the reference's bidi stream collapses to
                         periodic unaries), LeaveCluster, Statistics
  weedtpu.VolumeServer — WriteNeedle, ReadNeedle, DeleteNeedle (data path
                         also has HTTP); VolumeCreate, VolumeDelete,
                         VolumeMarkReadonly, VolumeMarkWritable,
                         VolumeCompact, VolumeStatus,
                         + the EC surface (SURVEY.md §2.4):
                         VolumeEcShardsGenerate, VolumeEcShardsCopy (stream),
                         VolumeEcShardsRebuild, VolumeEcShardsConvert,
                         VolumeEcShardsVerify,
                         VolumeEcShardsMount,
                         VolumeEcShardsUnmount, VolumeEcShardRead (stream),
                         VolumeEcBlobDelete, VolumeEcShardsToVolume,
                         VolumeEcShardsDelete
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Optional

MASTER_SERVICE = "weedtpu.Master"
VOLUME_SERVICE = "weedtpu.VolumeServer"
FILER_SERVICE = "weedtpu.Filer"
MQ_SERVICE = "weedtpu.MessageQueue"


@dataclass
class Location:
    url: str  # host:port of the volume server HTTP endpoint
    public_url: str = ""
    grpc_port: int = 0

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Location":
        return cls(
            url=d["url"],
            public_url=d.get("public_url") or d["url"],
            grpc_port=int(d.get("grpc_port", 0)),
        )

    @property
    def grpc_address(self) -> str:
        host = self.url.rsplit(":", 1)[0]
        return f"{host}:{self.grpc_port}"


@dataclass
class VolumeInformation:
    """One volume's heartbeat row (VolumeInformationMessage analog)."""

    id: int
    size: int = 0
    collection: str = ""
    file_count: int = 0
    delete_count: int = 0
    read_only: bool = False
    replica_placement: str = "000"
    ttl: str = ""
    version: int = 3
    disk_type: str = ""
    garbage_ratio: float = 0.0  # dead fraction of .dat; auto-vacuum signal
    last_modified: int = 0      # unix secs of the last append (.dat mtime)

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "VolumeInformation":
        return cls(
            id=int(d["id"]),
            size=int(d.get("size", 0)),
            collection=d.get("collection", ""),
            file_count=int(d.get("file_count", 0)),
            delete_count=int(d.get("delete_count", 0)),
            read_only=bool(d.get("read_only", False)),
            replica_placement=d.get("replica_placement", "000"),
            ttl=d.get("ttl", ""),
            version=int(d.get("version", 3)),
            disk_type=d.get("disk_type", ""),
            last_modified=int(d.get("last_modified", 0)),
            garbage_ratio=float(d.get("garbage_ratio", 0.0)),
        )


@dataclass
class Heartbeat:
    """Full-state volume-server report (HeartbeatMessage analog)."""

    ip: str
    port: int
    grpc_port: int
    public_url: str = ""
    data_center: str = "DefaultDataCenter"
    rack: str = "DefaultRack"
    max_volume_count: int = 8
    volumes: list[dict] = field(default_factory=list)  # VolumeInformation dicts
    ec_shards: list[dict] = field(default_factory=list)  # EcVolumeInfo dicts
    # peers (grpc host:port) this server repeatedly failed to reach on
    # the degraded-read/rebuild paths — the master's repair scheduler
    # cross-checks them against heartbeat silence to learn about dead
    # holders without waiting for the topology reaper
    unreachable_peers: list[str] = field(default_factory=list)

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Heartbeat":
        return cls(
            ip=d["ip"],
            port=int(d["port"]),
            grpc_port=int(d["grpc_port"]),
            public_url=d.get("public_url", ""),
            data_center=d.get("data_center", "DefaultDataCenter"),
            rack=d.get("rack", "DefaultRack"),
            max_volume_count=int(d.get("max_volume_count", 8)),
            volumes=list(d.get("volumes", [])),
            ec_shards=list(d.get("ec_shards", [])),
            unreachable_peers=list(d.get("unreachable_peers", [])),
        )

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"


@dataclass
class AssignRequest:
    count: int = 1
    collection: str = ""
    replication: str = ""
    ttl: str = ""
    data_center: str = ""

    def to_dict(self) -> dict:
        return asdict(self)


@dataclass
class AssignResponse:
    fid: str = ""
    url: str = ""
    public_url: str = ""
    grpc_port: int = 0
    count: int = 0
    error: str = ""
    auth: str = ""  # JWT authorizing the write of fid (when security is on)

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "AssignResponse":
        return cls(
            fid=d.get("fid", ""),
            url=d.get("url", ""),
            public_url=d.get("public_url", ""),
            grpc_port=int(d.get("grpc_port", 0)),
            count=int(d.get("count", 0)),
            error=d.get("error", ""),
            auth=d.get("auth", ""),
        )
