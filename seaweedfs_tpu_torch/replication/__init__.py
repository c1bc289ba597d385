"""Replication, after upstream's weed/replication/ (Replicator + sink wall:
filer/s3/gcs/azure/b2/local) driven by the filer metadata event log.

  sinks.py      — ReplicationSink interface + LocalSink (directory),
                  FilerSink (another filer), S3Sink (any S3 endpoint,
                  including this framework's own gateway)
  replicator.py — tails a source filer's metadata subscription and
                  applies each event to a sink; resumes from a
                  checkpoint stored in the source filer's KV store
                  (the same key and bytes as the reference package's,
                  so either package resumes the other's sync).

Drives `filer.sync` (continuous filer->filer) and `filer.backup`
(filer->local directory), the command/filer_sync.go / filer_backup.go
analogs.
"""

from seaweedfs_tpu_torch.replication.sinks import (
    FilerSink,
    LocalSink,
    ReplicationSink,
    S3Sink,
)
from seaweedfs_tpu_torch.replication.replicator import Replicator

__all__ = ["ReplicationSink", "LocalSink", "FilerSink", "S3Sink", "Replicator"]
