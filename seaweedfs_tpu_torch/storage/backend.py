"""Storage backends, after upstream's weed/storage/backend/
(BackendStorageFile over local disk, mmap and S3-tiered volumes).

All backends expose the small file-like surface Volume uses (seek/read/
tell/flush/close, and write for local ones), so a tiered volume swaps its
.dat handle for a RemoteDatFile without touching the needle read path.
"""

from __future__ import annotations

import mmap
import os
import threading
from typing import Optional

from seaweedfs_tpu_torch.remote_storage import RemoteStorageClient


class DiskFile:
    """Plain local file (the default backend) — thin alias of the stdlib
    file object, named to mark the seam."""

    def __init__(self, path: str, writable: bool = True):
        exists = os.path.exists(path)
        mode = ("r+b" if exists else "w+b") if writable else "rb"
        # a backend-lifetime handle, closed through the seam's close()
        self.f = open(path, mode)
        self.path = path

    def __getattr__(self, name):
        return getattr(self.f, name)


class MemoryMappedFile:
    """Read-only mmap backend (weed/storage/backend/memory_map): serves
    hot read-only volumes straight from the page cache."""

    def __init__(self, path: str):
        self.path = path
        # pinned open while the mmap lives, closed in close()
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        self._pos = 0
        self._lock = threading.Lock()

    def seek(self, pos: int, whence: int = os.SEEK_SET) -> int:
        with self._lock:
            if whence == os.SEEK_SET:
                self._pos = pos
            elif whence == os.SEEK_CUR:
                self._pos += pos
            else:
                self._pos = len(self._mm) + pos
            return self._pos

    def tell(self) -> int:
        return self._pos

    def read(self, size: int = -1) -> bytes:
        with self._lock:
            if size < 0:
                size = len(self._mm) - self._pos
            out = self._mm[self._pos : self._pos + size]
            self._pos += len(out)
            return out

    def write(self, data: bytes):
        raise IOError("memory-mapped backend is read-only")

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self._mm.close()
        self._f.close()


class RemoteDatFile:
    """Read-only file view over a remote-storage object (the tiered
    volume backend, weed/storage/backend/s3_backend analog)."""

    def __init__(self, client: RemoteStorageClient, key: str, size: Optional[int] = None):
        self.client = client
        self.key = key
        self._size = client.size(key) if size is None else size
        self._pos = 0
        self._lock = threading.Lock()

    def seek(self, pos: int, whence: int = os.SEEK_SET) -> int:
        with self._lock:
            if whence == os.SEEK_SET:
                self._pos = pos
            elif whence == os.SEEK_CUR:
                self._pos += pos
            else:
                self._pos = self._size + pos
            return self._pos

    def tell(self) -> int:
        return self._pos

    def read(self, size: int = -1) -> bytes:
        with self._lock:
            if size < 0:
                size = self._size - self._pos
            size = max(0, min(size, self._size - self._pos))
            if size == 0:
                return b""
            data = self.client.read_range(self.key, self._pos, size)
            self._pos += len(data)
            return data

    def write(self, data: bytes):
        raise IOError("tiered volume is read-only")

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass
