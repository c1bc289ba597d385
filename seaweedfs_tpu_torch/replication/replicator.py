"""Replicator, after upstream's weed/replication/replicator.go and the
offset bookkeeping in command/filer_sync.go.

Tails the source filer's metadata subscription from the last checkpoint
and applies each event to the sink:

  new only            -> create (file data streamed from the source)
  old only            -> delete
  old+new, same path  -> overwrite
  old+new, moved      -> delete old + create new

The checkpoint (last applied ts_ns) lives in the SOURCE filer's KV store
under `replication.offset.<sink-id>`, so a restarted sync resumes where
it stopped.
"""

from __future__ import annotations

import threading
from typing import Optional

from seaweedfs_tpu_torch.filer.client import FilerClient
from seaweedfs_tpu_torch.filer.filer import MetaEvent
from seaweedfs_tpu_torch.replication.sinks import ReplicationSink


class Replicator:
    def __init__(
        self,
        source_grpc_address: str,
        sink: ReplicationSink,
        prefix: str = "/",
        sink_id: str = "",
    ):
        self.source = FilerClient(source_grpc_address)
        self.sink = sink
        self.prefix = "/" + prefix.strip("/") if prefix.strip("/") else "/"
        self.sink_id = sink_id or f"{sink.name}"
        self._offset_key = f"replication.offset.{self.sink_id}"

    def close(self) -> None:
        self.source.close()
        self.sink.close()

    # -- checkpoint -----------------------------------------------------------

    def load_offset(self) -> int:
        raw = self.source.kv_get(self._offset_key)
        return int(raw.decode()) if raw else 0

    def save_offset(self, ts_ns: int) -> None:
        self.source.kv_put(self._offset_key, str(ts_ns).encode())

    # -- apply ----------------------------------------------------------------

    def _key_of(self, path: str) -> Optional[str]:
        root = self.prefix.rstrip("/")
        if root and not (path == root or path.startswith(root + "/")):
            return None
        rel = path[len(root) :].lstrip("/")
        return rel or None

    def apply(self, ev: MetaEvent) -> None:
        import grpc

        old, new = ev.old_entry, ev.new_entry
        old_key = self._key_of(old["path"]) if old else None
        new_key = self._key_of(new["path"]) if new else None
        if old_key and (not new_key or new_key != old_key):
            self.sink.delete(old_key, is_dir=bool(old.get("is_directory")))
        if new_key:
            is_dir = bool(new.get("is_directory"))
            data = b""
            if not is_dir and new.get("chunks"):
                try:
                    data = self.source.read_file(new["path"])
                except grpc.RpcError as e:
                    if e.code() == grpc.StatusCode.NOT_FOUND:
                        # replaying history: the entry was renamed/deleted
                        # by a LATER event, which will reconcile the sink —
                        # don't let one vanished path poison the stream
                        return
                    raise
            mime = (new.get("attributes") or {}).get("mime", "")
            self.sink.create(new_key, data, mime=mime, is_dir=is_dir)

    # -- run loops ------------------------------------------------------------

    def run_once(self, max_idle_s: float = 1.0) -> int:
        """Drain events since the checkpoint until the stream idles;
        returns the number applied. (filer.backup shape)"""
        applied = 0
        last = self.load_offset()
        for ev in self.source.subscribe(
            since_ns=last, path_prefix=self.prefix, max_idle_s=max_idle_s
        ):
            self.apply(ev)
            last = ev.ts_ns
            self.save_offset(last)
            applied += 1
        return applied

    def run(self, stop: threading.Event, max_idle_s: float = 2.0) -> None:
        """Continuous sync until `stop` is set. (filer.sync shape)"""
        while not stop.is_set():
            try:
                self.run_once(max_idle_s=max_idle_s)
            except Exception:  # noqa: BLE001 — source hiccup; retry
                if stop.wait(1.0):
                    return
            stop.wait(0.2)
