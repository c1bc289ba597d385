"""FilerClient — RPC client for the weedtpu.Filer service, the analog of
the filer_pb client helpers in weed/pb/filer_pb_helper.go and the
FilerClient wrappers used by mount / s3 / replication.

Gateways running in-process with the FilerServer can skip RPC and use
`server.filer` directly; this client is for separate processes
(mount, filer.sync, mq broker)."""

from __future__ import annotations

import base64
from typing import Iterator, Optional

from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.filer.entry import Entry
from seaweedfs_tpu_torch.filer.filer import MetaEvent
from seaweedfs_tpu_torch.pb import FILER_SERVICE


class FilerClient:
    def __init__(self, grpc_address: str):
        self._rpc = rpc.RpcClient(grpc_address)

    def close(self) -> None:
        self._rpc.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def lookup(self, path: str) -> Optional[Entry]:
        import grpc as _grpc

        try:
            resp = self._rpc.call(FILER_SERVICE, "LookupDirectoryEntry", {"path": path})
        except _grpc.RpcError as e:
            if e.code() == _grpc.StatusCode.NOT_FOUND:
                return None
            raise
        return Entry.from_dict(resp["entry"])

    def list(
        self,
        directory: str,
        start_from: str = "",
        limit: int = 1024,
        prefix: str = "",
        include_start: bool = False,
    ) -> list[Entry]:
        resp = self._rpc.call(
            FILER_SERVICE,
            "ListEntries",
            {
                "directory": directory,
                "start_from": start_from,
                "inclusive_start_from": include_start,
                "limit": limit,
                "prefix": prefix,
            },
        )
        return [Entry.from_dict(d) for d in resp["entries"]]

    def create(self, entry: Entry, o_excl: bool = False) -> None:
        import grpc as _grpc

        try:
            self._rpc.call(
                FILER_SERVICE, "CreateEntry", {"entry": entry.to_dict(), "o_excl": o_excl}
            )
        except _grpc.RpcError as e:
            if e.code() == _grpc.StatusCode.FAILED_PRECONDITION:
                raise IsADirectoryError(entry.path) from None
            if e.code() == _grpc.StatusCode.ALREADY_EXISTS:
                raise FileExistsError(entry.path) from None
            raise

    def update(self, entry: Entry) -> None:
        self._rpc.call(FILER_SERVICE, "UpdateEntry", {"entry": entry.to_dict()})

    def delete(
        self, path: str, recursive: bool = False, delete_data: bool = True
    ) -> None:
        self._rpc.call(
            FILER_SERVICE,
            "DeleteEntry",
            {"path": path, "is_recursive": recursive, "is_delete_data": delete_data},
        )

    def rename(self, old_path: str, new_path: str) -> None:
        import grpc as _grpc

        try:
            self._rpc.call(
                FILER_SERVICE,
                "AtomicRenameEntry",
                {"old_path": old_path, "new_path": new_path},
            )
        except _grpc.RpcError as e:
            if e.code() == _grpc.StatusCode.FAILED_PRECONDITION:
                raise IsADirectoryError(new_path) from None
            if e.code() == _grpc.StatusCode.NOT_FOUND:
                raise FileNotFoundError(old_path) from None
            raise

    def read_file(self, path: str) -> bytes:
        return b"".join(self._rpc.stream(FILER_SERVICE, "ReadFile", {"path": path}))

    def read_range(self, path: str, offset: int, size: int) -> bytes:
        return b"".join(
            self._rpc.stream(
                FILER_SERVICE,
                "ReadFileRange",
                {"path": path, "offset": offset, "size": size},
            )
        )

    def configuration(self) -> dict:
        return self._rpc.call(FILER_SERVICE, "GetFilerConfiguration", {})

    def kv_get(self, key: str) -> Optional[bytes]:
        import grpc as _grpc

        try:
            resp = self._rpc.call(FILER_SERVICE, "KvGet", {"key": key})
        except _grpc.RpcError as e:
            if e.code() == _grpc.StatusCode.NOT_FOUND:
                return None
            raise
        return base64.b64decode(resp["value"])

    def get_filer_conf(self) -> list[dict]:
        """Per-path storage rules (fs.configure / filer_conf.go analog)."""
        return self._rpc.call(FILER_SERVICE, "GetFilerConf", {}).get("rules", [])

    def set_filer_conf(
        self,
        location_prefix: str,
        collection: str = "",
        replication: str = "",
        ttl: str = "",
        read_only: bool = False,
        delete: bool = False,
    ) -> list[dict]:
        """Upsert (or delete) one per-path rule; returns the full rule set."""
        resp = self._rpc.call(
            FILER_SERVICE,
            "SetFilerConf",
            {
                "location_prefix": location_prefix,
                "collection": collection,
                "replication": replication,
                "ttl": ttl,
                "read_only": read_only,
                "delete": delete,
            },
        )
        return resp.get("rules", [])

    def delete_collection(self, collection: str) -> int:
        """Drop every volume of a collection cluster-wide (via the master);
        returns the number of volume/shard-set drops."""
        resp = self._rpc.call(
            FILER_SERVICE, "DeleteCollection", {"collection": collection}
        )
        return int(resp.get("deleted", 0))

    def kv_put(self, key: str, value: bytes) -> None:
        self._rpc.call(
            FILER_SERVICE, "KvPut", {"key": key, "value": base64.b64encode(value).decode()}
        )

    def subscribe(
        self, since_ns: int = 0, path_prefix: str = "/", max_idle_s: float = 0
    ) -> Iterator[MetaEvent]:
        for d in self._rpc.stream(
            FILER_SERVICE,
            "SubscribeMetadata",
            {"since_ns": since_ns, "path_prefix": path_prefix, "max_idle_s": max_idle_s},
            resp_format="json",
        ):
            yield MetaEvent.from_dict(d)
