"""LogStore — a from-scratch embedded log-structured KV engine, filling the
role of upstream's leveldb2/leveldb3 filer backends (weed/filer/leveldb2:
a durable embedded store with no external server), without a leveldb:
the same design point built from primitives:

  on disk     append-only log of CRC-framed records
                [crc32(4) | klen(4) | vlen(4) | key | value]
              vlen == 0xFFFFFFFF is a tombstone. Torn/corrupt tail records
              are truncated at replay, like the needle log (.dat) replay.
  in memory   index: key -> (offset, vlen) into the log + a per-directory
              name set for ordered listings (the memtable analog)
  compaction  when dead bytes exceed half the log, live records are
              rewritten to <log>.compact and atomically swapped — the
              LSM merge collapsed to one level, which is the right size
              for filer metadata (entries are small JSON; the value log
              IS the database)

`LogFilerStore` adapts it to the FilerStore interface: entries live under
`e\\x00<dir>\\x00<name>`, the KV facet under `k\\x00<key>`.
"""

from __future__ import annotations

import json
import os
import posixpath
import struct
import threading
import zlib
from typing import Iterator, Optional

from seaweedfs_tpu_torch.filer.entry import Entry, normalize_path
from seaweedfs_tpu_torch.filer.store import EntryNotFound, FilerStore

_HDR = struct.Struct("<III")  # crc32, klen, vlen
_TOMBSTONE = 0xFFFFFFFF


class LogKv:
    """The raw engine: durable byte-key/byte-value with crash-safe replay."""

    def __init__(self, path: str, compact_ratio: float = 0.5):
        self.path = path
        self.compact_ratio = compact_ratio
        self._lock = threading.RLock()
        self._index: dict[bytes, tuple[int, int]] = {}  # key -> (offset, total_len)
        self._dead_bytes = 0
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._replay()
        # weedlint: ignore[open-no-ctx] store-lifetime append+read handles, closed in close()
        self._f = open(path, "ab")
        self._r = open(path, "rb")  # weedlint: ignore[open-no-ctx] see above

    # -- log format -----------------------------------------------------------

    @staticmethod
    def _frame(key: bytes, value: Optional[bytes]) -> bytes:
        vlen = _TOMBSTONE if value is None else len(value)
        body = key + (value or b"")
        crc = zlib.crc32(_HDR.pack(0, len(key), vlen)[4:] + body)
        return _HDR.pack(crc, len(key), vlen) + body

    def _replay(self) -> None:
        """Rebuild the index from the log; truncate a torn tail in place."""
        if not os.path.exists(self.path):
            return
        good = 0
        with open(self.path, "rb") as f:
            data = f.read()
        pos = 0
        while pos + _HDR.size <= len(data):
            crc, klen, vlen = _HDR.unpack_from(data, pos)
            vbytes = 0 if vlen == _TOMBSTONE else vlen
            end = pos + _HDR.size + klen + vbytes
            if end > len(data):
                break  # torn tail
            body = data[pos + _HDR.size : end]
            if zlib.crc32(_HDR.pack(0, klen, vlen)[4:] + body) != crc:
                break  # corrupt record: everything after is suspect
            key = body[:klen]
            old = self._index.pop(key, None)
            if old is not None:
                self._dead_bytes += old[1]
            if vlen == _TOMBSTONE:
                self._dead_bytes += end - pos  # the tombstone itself is dead
            else:
                self._index[key] = (pos, end - pos)
            good = end
            pos = end
        if good < len(data):
            with open(self.path, "r+b") as f:
                f.truncate(good)

    # -- public API -----------------------------------------------------------

    def put(self, key: bytes, value: bytes) -> None:
        rec = self._frame(key, value)
        with self._lock:
            off = self._f.tell()
            self._f.write(rec)
            self._f.flush()
            old = self._index.get(key)
            if old is not None:
                self._dead_bytes += old[1]
            self._index[key] = (off, len(rec))
            self._maybe_compact()

    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            hit = self._index.get(key)
            if hit is None:
                return None
            off, total = hit
            self._r.seek(off)
            rec = self._r.read(total)
        _, klen, vlen = _HDR.unpack_from(rec, 0)
        return rec[_HDR.size + klen : _HDR.size + klen + vlen]

    def delete(self, key: bytes) -> None:
        with self._lock:
            old = self._index.pop(key, None)
            if old is None:
                return
            rec = self._frame(key, None)
            self._f.write(rec)
            self._f.flush()
            self._dead_bytes += old[1] + len(rec)
            self._maybe_compact()

    def keys(self) -> list[bytes]:
        with self._lock:
            return list(self._index)

    def __contains__(self, key: bytes) -> bool:
        with self._lock:
            return key in self._index

    def __len__(self) -> int:
        with self._lock:
            return len(self._index)

    def close(self) -> None:
        with self._lock:
            self._f.close()
            self._r.close()

    def sync(self) -> None:
        with self._lock:
            self._f.flush()
            os.fsync(self._f.fileno())

    # -- compaction -----------------------------------------------------------

    def _maybe_compact(self) -> None:
        """Caller holds the lock. Rewrite live records when the log is more
        than `compact_ratio` dead (and big enough to bother)."""
        size = self._f.tell()
        if size < 1 << 16 or self._dead_bytes < size * self.compact_ratio:
            return
        self.compact()

    def compact(self) -> None:
        with self._lock:
            tmp = self.path + ".compact"
            new_index: dict[bytes, tuple[int, int]] = {}
            with open(tmp, "wb") as out:
                for key, (off, total) in self._index.items():
                    self._r.seek(off)
                    rec = self._r.read(total)
                    new_index[key] = (out.tell(), total)
                    out.write(rec)
                out.flush()
                os.fsync(out.fileno())
            self._f.close()
            self._r.close()
            os.replace(tmp, self.path)
            # restore a fully usable store BEFORE the durability barrier: a
            # failing dir-fsync must surface the error without leaving
            # closed handles and a stale index behind
            # weedlint: ignore[open-no-ctx] compaction swap reopens the store-lifetime handles
            self._f = open(self.path, "ab")
            self._r = open(self.path, "rb")  # weedlint: ignore[open-no-ctx] see above
            self._index = new_index
            self._dead_bytes = 0
            # the rename itself must survive power loss: fsync the parent
            # directory or the swap may vanish and resurrect pre-compaction
            # state (including data deleted since)
            dfd = os.open(os.path.dirname(self.path) or ".", os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)


class LogFilerStore(FilerStore):
    """FilerStore over LogKv — the leveldb2-analog backend."""

    name = "log"

    _E, _K = b"e", b"k"

    def __init__(self, directory: str):
        self._kvlog = LogKv(os.path.join(directory, "filer.log"))
        self._lock = threading.RLock()
        # dir -> sorted-on-demand name set, rebuilt from the index at open
        self._dirs: dict[str, set[str]] = {"/": set()}
        for key in self._kvlog.keys():
            if key[:1] != self._E:
                continue
            _, d, name = key.split(b"\x00", 2)
            self._dirs.setdefault(d.decode(), set()).add(name.decode())

    @classmethod
    def _ekey(cls, dir_path: str, name: str) -> bytes:
        return b"\x00".join((cls._E, dir_path.encode(), name.encode()))

    def insert(self, entry: Entry) -> None:
        with self._lock:
            self._kvlog.put(
                self._ekey(entry.dir, entry.name),
                json.dumps(entry.to_dict()).encode(),
            )
            self._dirs.setdefault(entry.dir, set()).add(entry.name)
            if entry.is_directory:
                self._dirs.setdefault(entry.path, set())

    update = insert

    def find(self, path: str) -> Entry:
        path = normalize_path(path)
        if path == "/":
            return Entry(path="/", is_directory=True)
        raw = self._kvlog.get(
            self._ekey(posixpath.dirname(path) or "/", posixpath.basename(path))
        )
        if raw is None:
            raise EntryNotFound(path)
        return Entry.from_dict(json.loads(raw.decode()))

    def delete(self, path: str) -> None:
        path = normalize_path(path)
        d, name = posixpath.dirname(path) or "/", posixpath.basename(path)
        with self._lock:
            self._kvlog.delete(self._ekey(d, name))
            self._dirs.get(d, set()).discard(name)
            self._dirs.pop(path, None)

    def delete_folder_children(self, path: str) -> None:
        path = normalize_path(path)
        with self._lock:
            for name in sorted(self._dirs.get(path, set())):
                child = posixpath.join(path, name)
                self.delete_folder_children(child)
                self.delete(child)

    def list(self, dir_path, start_from="", include_start=False, limit=1024, prefix=""):
        dir_path = normalize_path(dir_path)
        with self._lock:
            names = sorted(self._dirs.get(dir_path, set()))
        out = []
        for n in names:
            if prefix and not n.startswith(prefix):
                continue
            if start_from:
                if n < start_from or (n == start_from and not include_start):
                    continue
            try:
                out.append(self.find(posixpath.join(dir_path, n)))
            except EntryNotFound:  # pragma: no cover — index/log raced
                continue
            if len(out) >= limit:
                break
        return out

    def kv_put(self, key, value):
        self._kvlog.put(b"\x00".join((self._K, key.encode())), bytes(value))

    def kv_get(self, key):
        return self._kvlog.get(b"\x00".join((self._K, key.encode())))

    def kv_delete(self, key):
        self._kvlog.delete(b"\x00".join((self._K, key.encode())))

    def close(self):
        self._kvlog.close()
