"""Filer — the namespace layer (L5): a directory tree of entries, each a
list of chunks stored on the volume tier. Mirror of weed/filer/.

Components:
  entry.py   — Entry / Attributes / FileChunk records (filer.proto analogs)
  store.py   — FilerStore interface + memory / sqlite implementations
               (the reference's pluggable leveldb/mysql/... store wall)
  chunks.py  — chunk upload/read against the volume tier, manifests, etags
  filer.py   — Filer core: mkdirs, CRUD, recursive delete, rename,
               metadata event log with subscriptions
  server.py  — FilerServer: HTTP file API + weedtpu.Filer RPC service
  client.py  — FilerClient over the weedtpu.Filer RPC service

The filer runs no kernel and opens no CUDA context: its chunk reads go
through `MasterClient.read` to the volume servers, which reconstruct a
chunk on a lost shard on their own card.
"""

from seaweedfs_tpu_torch.filer.entry import Attributes, Entry, FileChunk
from seaweedfs_tpu_torch.filer.filer import Filer, MetaEvent
from seaweedfs_tpu_torch.filer.store import FilerStore, MemoryStore, SqliteStore, make_store
from seaweedfs_tpu_torch.filer.server import FilerServer
from seaweedfs_tpu_torch.filer.client import FilerClient

__all__ = [
    "Attributes",
    "Entry",
    "FileChunk",
    "Filer",
    "MetaEvent",
    "FilerStore",
    "MemoryStore",
    "SqliteStore",
    "make_store",
    "FilerServer",
    "FilerClient",
]
