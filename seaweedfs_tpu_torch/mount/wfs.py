"""WFS — the mount filesystem core, after upstream's weed/mount/wfs.go +
weedfs_file_io.go / weedfs_file_sync.go / weedfs_dir_*.go /
weedfs_attr.go.

Path-keyed operation set (the kernel-facing inode table lives in the
FUSE adapter; keeping the core on paths makes it directly testable):

  lookup/getattr, readdir, mkdir, rmdir, create/open -> FileHandle,
  read/write/truncate/flush/release, unlink, rename, statfs.

Data path: reads go filer RPC ReadFileRange (only overlapping chunks are
touched) overlaid with local dirty pages; writes buffer in DirtyPages and
flush as chunk uploads straight to the volume tier (assign+POST through a
MasterClient discovered via GetFilerConfiguration), then an UpdateEntry
with the appended chunk list — the reference's page_writer upload
pipeline shape. Entry metadata is cached with a TTL and invalidated by
the filer's metadata subscription when `watch=True`.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional

from seaweedfs_tpu_torch.cluster.client import MasterClient
from seaweedfs_tpu_torch.filer.chunks import ChunkIO
from seaweedfs_tpu_torch.filer.client import FilerClient
from seaweedfs_tpu_torch.filer.entry import Attributes, Entry, normalize_path
from seaweedfs_tpu_torch.mount.page_writer import DirtyPages

_ATTR_TTL = 1.0


@dataclass
class Attr:
    """Stat-like view of an entry (FUSE attr analog)."""

    path: str
    is_dir: bool
    size: int
    mtime: float
    crtime: float
    mode: int
    uid: int
    gid: int


class FileHandle:
    def __init__(self, wfs: "WFS", entry: Entry):
        self.wfs = wfs
        self.entry = entry
        self.dirty = DirtyPages()
        self.lock = threading.Lock()
        self._truncated_to: Optional[int] = None

    @property
    def size(self) -> int:
        base = self.entry.size if self._truncated_to is None else self._truncated_to
        return max(base, self.dirty.max_extent())

    def read(self, offset: int, size: int) -> bytes:
        with self.lock:
            end = min(offset + size, self.size)
            if end <= offset:
                return b""
            buf = bytearray(end - offset)
            stored_end = self.entry.size
            if self._truncated_to is not None:
                stored_end = min(stored_end, self._truncated_to)
            want = min(end, stored_end) - offset
            if want > 0 and self.entry.chunks:
                data = self.wfs.filer.read_range(self.entry.path, offset, want)
                buf[: len(data)] = data
            self.dirty.read_overlay(offset, buf)
            return bytes(buf)

    def write(self, offset: int, data: bytes) -> int:
        with self.lock:
            self.dirty.write(offset, data)
            if (
                self.wfs.auto_flush_bytes
                and self.dirty.byte_count >= self.wfs.auto_flush_bytes
            ):
                self._flush_locked()
            return len(data)

    def truncate(self, size: int) -> None:
        with self.lock:
            self.dirty.truncate(size)
            self._truncated_to = size

    def flush(self) -> None:
        with self.lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        runs = self.dirty.drain()
        if not runs and self._truncated_to is None:
            return
        if self._truncated_to is not None:
            size = self._truncated_to
            # dropping chunks fully past the cut; the filer reclaims the
            # needles of chunks not carried into the updated entry
            self.entry.chunks = [
                c for c in self.entry.chunks if c.offset < size
            ]
            for c in self.entry.chunks:
                if c.offset + c.size > size:
                    c.size = size - c.offset
            self.entry.attributes.file_size = size
            self._truncated_to = None
        for off, data in runs:
            chunk = self.wfs.chunk_io.upload_chunk(
                data,
                off,
                collection=self.wfs.collection,
                replication=self.wfs.replication,
            )
            self.entry.chunks.append(chunk)
        self.entry.attributes.file_size = max(
            self.entry.attributes.file_size,
            max((c.offset + c.size for c in self.entry.chunks), default=0),
        )
        self.entry.attributes.mtime = time.time()
        self.entry.attributes.md5 = ""  # stale after partial rewrite
        self.wfs._put_entry(self.entry)

    def release(self) -> None:
        self.flush()


class WFS:
    def __init__(
        self,
        filer_grpc_address: str,
        auto_flush_bytes: int = 8 * 1024 * 1024,
        watch: bool = False,
        chunk_cache_bytes: int = 64 << 20,
    ):
        self.filer = FilerClient(filer_grpc_address)
        conf = self.filer.configuration()
        self.master = MasterClient(conf["masters"][0])
        from seaweedfs_tpu_torch.utils.chunk_cache import ChunkCache

        # the mount is the reference's heaviest chunk_cache user: page
        # reads re-fetch the same chunks constantly; 0 disables
        cache = ChunkCache(memory_bytes=chunk_cache_bytes) if chunk_cache_bytes else None
        self.chunk_io = ChunkIO(
            self.master, chunk_size=int(conf["chunk_size"]), cache=cache
        )
        self.collection = conf.get("collection", "")
        self.replication = conf.get("replication", "")
        self.auto_flush_bytes = auto_flush_bytes
        self._attr_cache: dict[str, tuple[float, Entry]] = {}
        self._cache_lock = threading.Lock()
        self._stop = threading.Event()
        self._watcher: Optional[threading.Thread] = None
        if watch:
            self._watcher = threading.Thread(target=self._watch_loop, daemon=True)
            self._watcher.start()

    def close(self) -> None:
        self._stop.set()
        self.filer.close()
        self.master.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- metadata cache -------------------------------------------------------

    def _watch_loop(self) -> None:
        """Invalidate cached attrs when other clients mutate the tree."""
        while not self._stop.is_set():
            try:
                for ev in self.filer.subscribe(
                    since_ns=time.time_ns(), max_idle_s=2.0
                ):
                    for d in (ev.old_entry, ev.new_entry):
                        if d:
                            self._invalidate(d["path"])
            except Exception:  # noqa: BLE001 — filer restart; retry
                if self._stop.wait(0.5):
                    return

    def _invalidate(self, path: str) -> None:
        with self._cache_lock:
            self._attr_cache.pop(path, None)

    def _get_entry(self, path: str) -> Optional[Entry]:
        path = normalize_path(path)
        now = time.monotonic()
        with self._cache_lock:
            hit = self._attr_cache.get(path)
            if hit and now - hit[0] < _ATTR_TTL:
                return hit[1]
        e = self.filer.lookup(path)
        if e is not None:
            with self._cache_lock:
                self._attr_cache[path] = (now, e)
        return e

    def _put_entry(self, entry: Entry) -> None:
        self.filer.create(entry)
        with self._cache_lock:
            self._attr_cache[entry.path] = (time.monotonic(), entry)

    # -- operations -----------------------------------------------------------

    @staticmethod
    def _attr(e: Entry) -> Attr:
        return Attr(
            path=e.path,
            is_dir=e.is_directory,
            size=e.size,
            mtime=e.attributes.mtime,
            crtime=e.attributes.crtime,
            mode=e.attributes.mode,
            uid=e.attributes.uid,
            gid=e.attributes.gid,
        )

    def lookup(self, path: str) -> Optional[Attr]:
        e = self._get_entry(path)
        return self._attr(e) if e else None

    getattr = lookup

    def readdir(self, path: str) -> list[Attr]:
        out = []
        start = ""
        while True:
            batch = self.filer.list(path, start_from=start, limit=1024)
            if not batch:
                break
            out.extend(self._attr(e) for e in batch)
            start = batch[-1].name
            if len(batch) < 1024:
                break
        return out

    def mkdir(self, path: str, mode: int = 0o755) -> Attr:
        e = Entry(
            path=path,
            is_directory=True,
            attributes=Attributes(mtime=time.time(), mode=mode | 0o040000),
        )
        self._put_entry(e)
        return self._attr(e)

    def create(self, path: str, mode: int = 0o644) -> FileHandle:
        e = Entry(path=path, attributes=Attributes(mtime=time.time(), mode=mode))
        self._put_entry(e)
        return FileHandle(self, e)

    def open(self, path: str) -> FileHandle:
        e = self._get_entry(path)
        if e is None:
            raise FileNotFoundError(path)
        if e.is_directory:
            raise IsADirectoryError(path)
        return FileHandle(self, e)

    def unlink(self, path: str) -> None:
        self.filer.delete(path)
        self._invalidate(path)

    def rmdir(self, path: str) -> None:
        e = self._get_entry(path)
        if e is None:
            raise FileNotFoundError(path)
        if not e.is_directory:
            raise NotADirectoryError(path)
        if self.filer.list(path, limit=1):
            raise OSError(39, "directory not empty", path)  # ENOTEMPTY
        self.filer.delete(path, recursive=True)
        self._invalidate(path)

    def rename(self, old: str, new: str) -> None:
        self.filer.rename(old, new)
        self._invalidate(old)
        self._invalidate(new)

    def statfs(self) -> dict:
        try:
            return self.master.statistics()
        except Exception:  # noqa: BLE001
            return {}
