"""FilerStore — the pluggable metadata-store wall, mirror of
weed/filer/filerstore.go and the per-backend subpackages (leveldb2/3,
sqlite, mysql, redis, ... ). With no leveldb/redis/sql servers at hand, so the two natural
backends are:

  MemoryStore — dict-of-dirs (the reference's tests use an in-memory store)
  SqliteStore — stdlib sqlite3, matching the reference's sqlite backend
                (weed/filer/sqlite) in role: a durable single-file store

Both implement the same five namespace primitives + a KV facet (the
reference stores its own bookkeeping — e.g. remote-storage mappings —
through FilerStore.KvPut/KvGet).
"""

from __future__ import annotations

import contextlib
import json
import posixpath
import sqlite3
import threading
from typing import Iterator, Optional

from seaweedfs_tpu_torch.filer.entry import Entry, normalize_path


class EntryNotFound(KeyError):
    pass


class FilerStore:
    """Abstract store. Directory listings are lexicographic by name."""

    name = "abstract"

    def insert(self, entry: Entry) -> None:
        raise NotImplementedError

    def update(self, entry: Entry) -> None:
        raise NotImplementedError

    def find(self, path: str) -> Entry:
        raise NotImplementedError

    def delete(self, path: str) -> None:
        raise NotImplementedError

    def delete_folder_children(self, path: str) -> None:
        raise NotImplementedError

    def list(
        self,
        dir_path: str,
        start_from: str = "",
        include_start: bool = False,
        limit: int = 1024,
        prefix: str = "",
    ) -> list[Entry]:
        raise NotImplementedError

    def kv_put(self, key: str, value: bytes) -> None:
        raise NotImplementedError

    def kv_get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def kv_delete(self, key: str) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass

    # -- transactions / batch (filerstore.go BeginTransaction/... analog) ----
    #
    # Default: no-op, matching the reference's non-transactional backends
    # (its memory/redis stores accept Begin/Commit without grouping). Stores
    # with real atomicity (sqlite) override all three.

    def begin_transaction(self) -> None:
        pass

    def commit_transaction(self) -> None:
        pass

    def rollback_transaction(self) -> None:
        pass

    @contextlib.contextmanager
    def transaction(self):
        """`with store.transaction():` — commit on success, rollback on
        exception. Multi-entry operations (rename subtree, batch imports)
        group their writes through this."""
        self.begin_transaction()
        try:
            yield self
        except BaseException:
            self.rollback_transaction()
            raise
        else:
            self.commit_transaction()

    def insert_batch(self, entries: list[Entry]) -> None:
        """Insert many entries atomically where the store supports it."""
        with self.transaction():
            for e in entries:
                self.insert(e)


class MemoryStore(FilerStore):
    name = "memory"

    def __init__(self):
        self._lock = threading.RLock()
        # dir -> {name -> Entry}
        self._dirs: dict[str, dict[str, Entry]] = {"/": {}}
        self._kv: dict[str, bytes] = {}

    def insert(self, entry: Entry) -> None:
        with self._lock:
            self._dirs.setdefault(entry.dir, {})[entry.name] = entry
            if entry.is_directory:
                self._dirs.setdefault(entry.path, {})

    update = insert

    def find(self, path: str) -> Entry:
        path = normalize_path(path)
        if path == "/":
            return Entry(path="/", is_directory=True)
        with self._lock:
            d = self._dirs.get(posixpath.dirname(path) or "/", {})
            e = d.get(posixpath.basename(path))
            if e is None:
                raise EntryNotFound(path)
            return e

    def delete(self, path: str) -> None:
        path = normalize_path(path)
        with self._lock:
            d = self._dirs.get(posixpath.dirname(path) or "/", {})
            d.pop(posixpath.basename(path), None)
            self._dirs.pop(path, None)

    def delete_folder_children(self, path: str) -> None:
        path = normalize_path(path)
        with self._lock:
            for name in list(self._dirs.get(path, {})):
                child = posixpath.join(path, name)
                self.delete_folder_children(child)
                self.delete(child)

    def list(self, dir_path, start_from="", include_start=False, limit=1024, prefix=""):
        dir_path = normalize_path(dir_path)
        with self._lock:
            names = sorted(self._dirs.get(dir_path, {}))
            out = []
            for n in names:
                if prefix and not n.startswith(prefix):
                    continue
                if start_from:
                    if n < start_from or (n == start_from and not include_start):
                        continue
                out.append(self._dirs[dir_path][n])
                if len(out) >= limit:
                    break
            return out

    def kv_put(self, key, value):
        with self._lock:
            self._kv[key] = bytes(value)

    def kv_get(self, key):
        with self._lock:
            return self._kv.get(key)

    def kv_delete(self, key):
        with self._lock:
            self._kv.pop(key, None)


class SqliteStore(FilerStore):
    """Durable store on stdlib sqlite3 (one connection, one writer lock —
    the filer serializes writes through Filer's own locking anyway)."""

    name = "sqlite"

    def __init__(self, db_path: str):
        self._lock = threading.RLock()
        self._txn_depth = 0
        self._conn = sqlite3.connect(db_path, check_same_thread=False)
        with self._lock:
            self._conn.executescript(
                """
                CREATE TABLE IF NOT EXISTS entries (
                    dir  TEXT NOT NULL,
                    name TEXT NOT NULL,
                    meta TEXT NOT NULL,
                    PRIMARY KEY (dir, name)
                );
                CREATE TABLE IF NOT EXISTS kv (
                    k TEXT PRIMARY KEY,
                    v BLOB NOT NULL
                );
                """
            )
            self._conn.commit()

    def _maybe_commit(self) -> None:
        if self._txn_depth == 0:
            self._conn.commit()

    # Transactions HOLD the store's RLock from begin to commit/rollback:
    # sqlite's txn state is connection-global, so without the lock a write
    # from another thread (e.g. a KvPut RPC that bypasses Filer._lock)
    # would silently join — and be rolled back with — this transaction
    # while its caller already saw success. Holding the RLock serializes
    # other writers until the commit; the owning thread re-enters freely.

    def begin_transaction(self) -> None:
        self._lock.acquire()
        self._txn_depth += 1

    def commit_transaction(self) -> None:
        if self._txn_depth == 0:
            return
        self._txn_depth -= 1
        if self._txn_depth == 0:
            self._conn.commit()
        self._lock.release()

    def rollback_transaction(self) -> None:
        if self._txn_depth == 0:
            return
        self._conn.rollback()
        while self._txn_depth:
            self._txn_depth -= 1
            self._lock.release()

    def insert_batch(self, entries) -> None:
        with self._lock, self.transaction():
            self._conn.executemany(
                "INSERT OR REPLACE INTO entries (dir, name, meta) VALUES (?,?,?)",
                [(e.dir, e.name, json.dumps(e.to_dict())) for e in entries],
            )

    def close(self) -> None:
        with self._lock:
            self._conn.close()

    def insert(self, entry: Entry) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO entries (dir, name, meta) VALUES (?,?,?)",
                (entry.dir, entry.name, json.dumps(entry.to_dict())),
            )
            self._maybe_commit()

    update = insert

    def find(self, path: str) -> Entry:
        path = normalize_path(path)
        if path == "/":
            return Entry(path="/", is_directory=True)
        with self._lock:
            row = self._conn.execute(
                "SELECT meta FROM entries WHERE dir=? AND name=?",
                (posixpath.dirname(path) or "/", posixpath.basename(path)),
            ).fetchone()
        if row is None:
            raise EntryNotFound(path)
        return Entry.from_dict(json.loads(row[0]))

    def delete(self, path: str) -> None:
        path = normalize_path(path)
        with self._lock:
            self._conn.execute(
                "DELETE FROM entries WHERE dir=? AND name=?",
                (posixpath.dirname(path) or "/", posixpath.basename(path)),
            )
            self._maybe_commit()

    def delete_folder_children(self, path: str) -> None:
        path = normalize_path(path)
        like = path.rstrip("/") + "/%" if path != "/" else "/%"
        with self._lock:
            self._conn.execute(
                "DELETE FROM entries WHERE dir=? OR dir LIKE ?", (path, like)
            )
            self._maybe_commit()

    def list(self, dir_path, start_from="", include_start=False, limit=1024, prefix=""):
        dir_path = normalize_path(dir_path)
        q = "SELECT meta FROM entries WHERE dir=?"
        args: list = [dir_path]
        if prefix:
            q += " AND name GLOB ?"
            # escape every GLOB metachar so the prefix matches literally
            escaped = (
                prefix.replace("[", "[[]").replace("*", "[*]").replace("?", "[?]")
            )
            args.append(escaped + "*")
        if start_from:
            q += " AND name >= ?" if include_start else " AND name > ?"
            args.append(start_from)
        q += " ORDER BY name LIMIT ?"
        args.append(limit)
        with self._lock:
            rows = self._conn.execute(q, args).fetchall()
        return [Entry.from_dict(json.loads(r[0])) for r in rows]

    def kv_put(self, key, value):
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO kv (k, v) VALUES (?,?)", (key, bytes(value))
            )
            self._maybe_commit()

    def kv_get(self, key):
        with self._lock:
            row = self._conn.execute("SELECT v FROM kv WHERE k=?", (key,)).fetchone()
        return bytes(row[0]) if row else None

    def kv_delete(self, key):
        with self._lock:
            self._conn.execute("DELETE FROM kv WHERE k=?", (key,))
            self._maybe_commit()


def make_store(kind: str = "memory", path: str = "") -> FilerStore:
    """Store factory, the `filer.toml` seam (reference: the [leveldb2] /
    [sqlite] / [mysql] sections of filer.toml select the backend)."""
    if kind == "memory":
        return MemoryStore()
    if kind == "sqlite":
        if not path:
            raise ValueError("sqlite store needs a db path")
        return SqliteStore(path)
    if kind in ("log", "weedkv", "leveldb", "leveldb2"):  # embedded engine
        if not path:
            raise ValueError("log store needs a directory")
        from seaweedfs_tpu_torch.filer.logstore import LogFilerStore

        return LogFilerStore(path)
    if kind in ("log3", "leveldb3"):  # per-bucket store separation
        if not path:
            raise ValueError("log3 store needs a directory")
        from seaweedfs_tpu_torch.filer.bucketstore import BucketedLogStore

        return BucketedLogStore(path)
    raise ValueError(f"unknown filer store {kind!r} (memory|sqlite|log|log3)")
