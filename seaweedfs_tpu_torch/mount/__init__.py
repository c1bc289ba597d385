"""Mount — POSIX view of the filer, after upstream's weed/mount/
(hanwen/go-fuse v2 WFS + page_writer/).

The core is FUSE-independent so it runs and tests anywhere:

  page_writer.py — write-back page cache: dirty interval list per open
                   file, merged on overlap (weed/mount/page_writer/)
  wfs.py         — WFS: the filesystem operation set (lookup/getattr/
                   read/write/mkdir/unlink/rename/...), entry cache,
                   flush-to-filer via chunk upload (weed/mount/wfs.go,
                   weedfs_file_*.go, weedfs_dir_*.go)
  fuse_adapter.py— optional kernel binding when a fusepy-compatible
                   module is importable (optional; without it the
                   adapter degrades with a clear error)

Writes buffer in DirtyPages; flush uploads the dirty intervals as chunks
(assign+POST to the volume tier, discovered through the filer's
GetFilerConfiguration) and updates the entry chunk list over filer RPC —
the same write path shape as the reference's page_writer upload pipeline.
"""

from seaweedfs_tpu_torch.mount.page_writer import DirtyPages
from seaweedfs_tpu_torch.mount.wfs import WFS, FileHandle

__all__ = ["DirtyPages", "WFS", "FileHandle"]
