"""Kernel FUSE binding for WFS — the weed/mount/ <-> hanwen/go-fuse
equivalent seam.

FUSE stays optional and adds no dependency: import
`mount_and_serve` and it raises a clear error unless a fusepy-compatible
`fuse` module is importable. The WFS core (wfs.py) is fully exercised
without the kernel; this adapter is a thin translation layer from fusepy
Operations callbacks onto WFS ops.
"""

from __future__ import annotations

import errno
import os
import stat as stat_mod

from seaweedfs_tpu_torch.mount.wfs import WFS


def fuse_available() -> bool:
    try:
        import fuse  # noqa: F401

        return hasattr(fuse, "FUSE") and hasattr(fuse, "Operations")
    except ImportError:
        return False


def mount_and_serve(filer_grpc_address: str, mountpoint: str, foreground: bool = True):
    """Block serving the FUSE mount (fusepy main loop)."""
    if not fuse_available():
        raise RuntimeError(
            "kernel FUSE needs the 'fusepy' module + /dev/fuse; neither is "
            "available here. The WFS API (seaweedfs_tpu_torch.mount.WFS) "
            "offers the same operations in-process."
        )
    import fuse

    wfs = WFS(filer_grpc_address, watch=True)

    class _Ops(fuse.Operations):
        def __init__(self):
            import threading

            self._handles = {}
            self._next_fh = 0
            self._h_lock = threading.Lock()

        def _register(self, handle) -> int:
            # callbacks run concurrently (nothreads=False): allocation
            # must be atomic or two opens share an fh
            with self._h_lock:
                self._next_fh += 1
                self._handles[self._next_fh] = handle
                return self._next_fh

        def _attr_dict(self, a):
            mode = a.mode
            if a.is_dir:
                mode = stat_mod.S_IFDIR | (mode & 0o7777)
            else:
                mode = stat_mod.S_IFREG | (mode & 0o7777)
            return {
                "st_mode": mode,
                "st_size": a.size,
                "st_mtime": a.mtime,
                "st_ctime": a.crtime,
                "st_atime": a.mtime,
                "st_uid": a.uid or os.getuid(),
                "st_gid": a.gid or os.getgid(),
                "st_nlink": 1,
            }

        def getattr(self, path, fh=None):
            a = wfs.getattr(path)
            if a is None:
                raise fuse.FuseOSError(errno.ENOENT)
            return self._attr_dict(a)

        def readdir(self, path, fh):
            yield "."
            yield ".."
            for a in wfs.readdir(path):
                yield a.path.rsplit("/", 1)[-1]

        def mkdir(self, path, mode):
            wfs.mkdir(path, mode)

        def rmdir(self, path):
            wfs.rmdir(path)

        def unlink(self, path):
            wfs.unlink(path)

        def rename(self, old, new):
            wfs.rename(old, new)

        def create(self, path, mode, fi=None):
            return self._register(wfs.create(path, mode))

        def open(self, path, flags):
            return self._register(wfs.open(path))

        def read(self, path, size, offset, fh):
            return self._handles[fh].read(offset, size)

        def write(self, path, data, offset, fh):
            return self._handles[fh].write(offset, data)

        def truncate(self, path, length, fh=None):
            if fh and fh in self._handles:
                self._handles[fh].truncate(length)
            else:
                h = wfs.open(path)
                h.truncate(length)
                h.flush()

        def flush(self, path, fh):
            self._handles[fh].flush()

        def release(self, path, fh):
            with self._h_lock:
                h = self._handles.pop(fh, None)
            if h:
                h.release()

    return fuse.FUSE(_Ops(), mountpoint, foreground=foreground, nothreads=False)
