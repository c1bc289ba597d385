"""Filer core — mirror of weed/filer/filer.go, filer_delete_entry.go,
filer_notify.go (metadata event log), meta_aggregator.go subscription
semantics.

The Filer owns a FilerStore and layers on:
  - implicit parent-directory creation (mkdirs on CreateEntry)
  - recursive delete with chunk reclamation on the volume tier
  - atomic rename (subtree move)
  - a metadata event log: every mutation appends a MetaEvent; subscribers
    (replication, mq, mount cache invalidation) tail it from a timestamp.
    Events are kept in a bounded in-memory ring and appended to a JSONL
    file when `log_dir` is set, so `filer.sync` can resume after restart
    (checkpoint/resume).
"""

from __future__ import annotations

import json
import os
import posixpath
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Iterator, Optional

from seaweedfs_tpu_torch.filer.chunks import ChunkIO
from seaweedfs_tpu_torch.filer.entry import Attributes, Entry, normalize_path
from seaweedfs_tpu_torch.filer.store import EntryNotFound, FilerStore

_META_RING = 8192


from seaweedfs_tpu_torch.filer.filer_conf import path_prefix_match as _prefix_match


@dataclass
class MetaEvent:
    """One namespace mutation (EventNotification analog)."""

    ts_ns: int
    directory: str
    old_entry: Optional[dict]  # Entry dict or None
    new_entry: Optional[dict]

    def to_dict(self) -> dict:
        return {
            "ts_ns": self.ts_ns,
            "directory": self.directory,
            "old_entry": self.old_entry,
            "new_entry": self.new_entry,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "MetaEvent":
        return cls(
            ts_ns=int(d["ts_ns"]),
            directory=d["directory"],
            old_entry=d.get("old_entry"),
            new_entry=d.get("new_entry"),
        )


class Filer:
    def __init__(
        self,
        store: FilerStore,
        chunk_io: Optional[ChunkIO] = None,
        log_dir: str = "",
        notification_queue=None,
    ):
        self.store = store
        self.chunk_io = chunk_io
        # per-path rules (fs.configure / filer_conf.go): enforcement lives
        # HERE, not in the HTTP layer, so every mutation surface (HTTP,
        # gRPC CreateEntry/DeleteEntry/rename, S3, mount) honors read-only
        from seaweedfs_tpu_torch.filer.filer_conf import FilerConf

        self.path_conf = FilerConf()
        self.notification_queue = notification_queue
        # notifications dispatch off-thread: send_message may do I/O and
        # _notify runs under the filer lock on every mutation
        self._notif_buf: deque = deque()
        self._notif_cv = threading.Condition()
        self._notif_stop = threading.Event()
        self._notif_thread: Optional[threading.Thread] = None
        self._lock = threading.RLock()
        self._events: deque[MetaEvent] = deque(maxlen=_META_RING)
        self._event_cv = threading.Condition()
        self._log_file = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            # weedlint: ignore[open-no-ctx] append-only meta log, lives as long as the filer
            self._log_file = open(
                os.path.join(log_dir, "filer.meta.log"), "a", encoding="utf-8"
            )

    def _notif_loop(self) -> None:
        while True:
            with self._notif_cv:
                while not self._notif_buf:
                    if self._notif_stop.is_set():
                        return
                    self._notif_cv.wait(0.5)
                key, ev = self._notif_buf.popleft()
            q = self.notification_queue
            if q is not None:
                try:
                    q.send_message(key, ev)
                except Exception:  # noqa: BLE001 — never fail writes for it
                    pass

    def close(self) -> None:
        self._notif_stop.set()
        t = self._notif_thread
        if t is not None:
            with self._notif_cv:
                self._notif_cv.notify_all()
            t.join(timeout=2.0)
        if self._log_file:
            self._log_file.close()
            self._log_file = None
        self.store.close()

    # -- events ---------------------------------------------------------------

    def _notify(self, old: Optional[Entry], new: Optional[Entry]) -> None:
        directory = (new or old).dir if (new or old) else "/"
        ev = MetaEvent(
            ts_ns=time.time_ns(),
            directory=directory,
            old_entry=old.to_dict() if old else None,
            new_entry=new.to_dict() if new else None,
        )
        with self._event_cv:
            self._events.append(ev)
            if self._log_file:
                self._log_file.write(json.dumps(ev.to_dict()) + "\n")
                self._log_file.flush()
            self._event_cv.notify_all()
        if self.notification_queue is not None:
            key = (new or old).path if (new or old) else "/"
            with self._notif_cv:
                self._notif_buf.append((key, ev.to_dict()))
                if self._notif_thread is None:
                    self._notif_thread = threading.Thread(
                        target=self._notif_loop, daemon=True
                    )
                    self._notif_thread.start()
                self._notif_cv.notify()

    def subscribe(
        self,
        since_ns: int = 0,
        prefix: str = "/",
        stop: Optional[threading.Event] = None,
        poll_interval: float = 0.2,
        idle_timeout: float = 0.0,
    ) -> Iterator[MetaEvent]:
        """Tail the event log from `since_ns`, blocking for new events
        until `stop` is set (stop=None: return once drained). Catches up
        from the on-disk log when the ring no longer reaches back far
        enough. `idle_timeout` > 0 ends the tail after that many seconds
        without events (bounds server-side streams)."""
        last = since_ns
        last_activity = time.monotonic()
        for ev in self._read_log_since(since_ns):
            if _prefix_match(ev.directory, prefix):
                yield ev
            last = max(last, ev.ts_ns)
        while stop is None or not stop.is_set():
            batch: list[MetaEvent] = []
            with self._event_cv:
                batch = [e for e in self._events if e.ts_ns > last]
                if not batch:
                    self._event_cv.wait(poll_interval)
                    batch = [e for e in self._events if e.ts_ns > last]
            for ev in batch:
                last = max(last, ev.ts_ns)
                if _prefix_match(ev.directory, prefix):
                    yield ev
            if batch:
                last_activity = time.monotonic()
            elif stop is None:
                return  # non-blocking mode: drained
            if idle_timeout and time.monotonic() - last_activity > idle_timeout:
                return

    def _read_log_since(self, since_ns: int) -> list[MetaEvent]:
        with self._event_cv:
            ring = list(self._events)
        # the ring answers only when the subscriber's position falls inside
        # it; further back (ring evicted, or events from a prior process)
        # must come from the on-disk log
        if ring and ring[0].ts_ns <= since_ns:
            return [e for e in ring if e.ts_ns > since_ns]
        if self._log_file is None:
            return [e for e in ring if e.ts_ns > since_ns]
        path = self._log_file.name
        out: list[MetaEvent] = []
        try:
            with open(path, encoding="utf-8") as f:
                for line in f:
                    try:
                        ev = MetaEvent.from_dict(json.loads(line))
                    except (ValueError, KeyError):
                        continue  # torn tail write
                    if ev.ts_ns > since_ns:
                        out.append(ev)
        except OSError:
            return [e for e in ring if e.ts_ns > since_ns]
        return out

    # -- CRUD -----------------------------------------------------------------

    @staticmethod
    def _expired(e: Entry) -> bool:
        ttl = e.attributes.ttl_sec
        return ttl > 0 and not e.is_directory and e.attributes.mtime + ttl < time.time()

    def _reap_expired(self, e: Entry) -> None:
        """TTL'd entries are reaped lazily on access (the reference filer
        does the same on read)."""
        try:
            if e.chunks and self.chunk_io is not None:
                self.chunk_io.delete_chunks(e.chunks)
            self.store.delete(e.path)
            self._notify(e, None)
        except Exception:  # noqa: BLE001 — best-effort; retried next access
            pass

    def find_entry(self, path: str) -> Entry:
        e = self.store.find(path)
        if self._expired(e):
            self._reap_expired(e)
            raise EntryNotFound(path)
        return e

    def exists(self, path: str) -> bool:
        try:
            self.store.find(path)
            return True
        except EntryNotFound:
            return False

    def mkdirs(self, path: str, mode: int = 0o770, _events: Optional[list] = None) -> None:
        """Create parents. `_events` collects (old, new) pairs for deferred
        notification instead of emitting immediately — used by rename,
        whose store transaction may still roll back."""
        path = normalize_path(path)
        if path == "/":
            return
        parts = path.strip("/").split("/")
        cur = ""
        with self._lock:
            for p in parts:
                cur += "/" + p
                try:
                    e = self.store.find(cur)
                    if not e.is_directory:
                        raise NotADirectoryError(cur)
                except EntryNotFound:
                    e = Entry(
                        path=cur,
                        is_directory=True,
                        attributes=Attributes(mtime=time.time(), mode=mode | 0o040000),
                    )
                    self.store.insert(e)
                    if _events is None:
                        self._notify(None, e)
                    else:
                        _events.append((None, e))

    def create_entry(self, entry: Entry, o_excl: bool = False) -> Entry:
        """Insert (or overwrite) an entry; parents are created implicitly,
        like the reference's CreateEntry."""
        self._check_writable(entry.path)
        with self._lock:
            self.mkdirs(entry.dir)
            old = None
            try:
                old = self.store.find(entry.path)
                if o_excl:
                    raise FileExistsError(entry.path)
                if old.is_directory and not entry.is_directory:
                    # replacing a dir with a file would orphan its children
                    raise IsADirectoryError(entry.path)
            except EntryNotFound:
                pass
            if (
                old is not None
                and old.chunks
                and self.chunk_io is not None
                and not entry.is_directory
            ):
                # overwrite: reclaim chunks not carried into the new entry
                kept = {c.fid for c in entry.chunks}
                drop = [c for c in old.chunks if c.fid not in kept]
                if drop:
                    self.chunk_io.delete_chunks(drop)
            self.store.insert(entry)
            self._notify(old, entry)
            return entry

    def _check_writable(self, path: str, subtree: bool = False) -> None:
        """Refuse mutations covered by a read-only fs.configure rule.
        Matches the rule's subtree, its root directory itself (a rule
        '/frozen/' must also protect the entry '/frozen'), and — when
        `subtree` is set (delete/rename, which operate on whole subtrees)
        — any ancestor whose removal would take the protected prefix
        with it."""
        p = path.rstrip("/") or "/"
        for rule in self.path_conf.rules:
            if not rule.read_only:
                continue
            pre = rule.location_prefix
            pre_dir = pre.rstrip("/") or "/"
            # segment-boundary match: '/frozen' must not freeze '/frozen2'
            inside = _prefix_match(p, pre_dir)
            contains = subtree and (
                p == "/" or pre_dir == p or pre_dir.startswith(p + "/")
            )
            if inside or contains:
                raise PermissionError(f"{pre} is read-only (fs.configure)")

    def update_entry(self, entry: Entry) -> Entry:
        self._check_writable(entry.path)
        with self._lock:
            old = self.store.find(entry.path)  # raises if absent
            self.store.update(entry)
            self._notify(old, entry)
            return entry

    def delete_entry(
        self,
        path: str,
        recursive: bool = False,
        ignore_recursive_error: bool = False,
        delete_chunks: bool = True,
    ) -> None:
        """Delete an entry; directories require recursive=True when
        non-empty. Chunk needles are reclaimed on the volume tier."""
        path = normalize_path(path)
        self._check_writable(path, subtree=True)
        with self._lock:
            entry = self.store.find(path)
            if entry.is_directory:
                children = self.store.list(path, limit=2)
                if children and not recursive:
                    raise OSError(f"directory {path} not empty")
                self._delete_tree(path, ignore_recursive_error, delete_chunks)
            elif delete_chunks and entry.chunks and self.chunk_io is not None:
                self.chunk_io.delete_chunks(entry.chunks)
            self.store.delete(path)
            self._notify(entry, None)

    def _delete_tree(self, path: str, ignore_errors: bool, delete_chunks: bool) -> None:
        start = ""
        while True:
            batch = self.store.list(path, start_from=start, limit=256)
            if not batch:
                break
            for e in batch:
                try:
                    if e.is_directory:
                        self._delete_tree(e.path, ignore_errors, delete_chunks)
                    elif delete_chunks and e.chunks and self.chunk_io is not None:
                        self.chunk_io.delete_chunks(e.chunks)
                    self.store.delete(e.path)
                    self._notify(e, None)
                except Exception:  # noqa: BLE001
                    if not ignore_errors:
                        raise
            start = batch[-1].name

    def list_entries(
        self,
        dir_path: str,
        start_from: str = "",
        include_start: bool = False,
        limit: int = 1024,
        prefix: str = "",
    ) -> list[Entry]:
        out = self.store.list(
            dir_path,
            start_from=start_from,
            include_start=include_start,
            limit=limit,
            prefix=prefix,
        )
        live = []
        for e in out:
            if self._expired(e):
                self._reap_expired(e)
            else:
                live.append(e)
        return live

    def walk(self, dir_path: str = "/") -> Iterator[Entry]:
        """Depth-first traversal of the subtree (directories first)."""
        start = ""
        while True:
            batch = self.store.list(dir_path, start_from=start, limit=256)
            if not batch:
                return
            for e in batch:
                yield e
                if e.is_directory:
                    yield from self.walk(e.path)
            start = batch[-1].name

    def rename(self, old_path: str, new_path: str) -> Entry:
        """AtomicRenameEntry analog: move an entry (and its subtree) —
        chunks do not move, only namespace records. Stores with real
        transactions (sqlite) group the whole subtree move atomically: a
        crash mid-rename can never leave half the tree at each path.

        Irreversible side effects are deferred until the transaction
        commits: metadata events would replay phantom renames on
        subscribers after a rollback, and deleting a displaced target's
        chunks inside the txn would resurrect a chunk-less entry on
        rollback."""
        old_path = normalize_path(old_path)
        new_path = normalize_path(new_path)
        self._check_writable(old_path, subtree=True)  # both ends mutate
        self._check_writable(new_path, subtree=True)
        events: list[tuple[Entry, Entry]] = []
        reclaim: list = []
        with self._lock:
            with self.store.transaction():
                entry = self._rename_inner(old_path, new_path, events, reclaim)
            # committed: now the side effects are safe to apply
            for old_copy, moved in events:
                self._notify(old_copy, moved)
            if reclaim and self.chunk_io is not None:
                self.chunk_io.delete_chunks(reclaim)
            return entry

    def _rename_inner(
        self, old_path: str, new_path: str, events: list, reclaim: list
    ) -> Entry:
        """Namespace-only subtree move; collects deferred side effects."""
        entry = self.store.find(old_path)
        try:
            target = self.store.find(new_path)
            if target.is_directory and not entry.is_directory:
                raise IsADirectoryError(new_path)
            if target.chunks:  # overwrite: reclaim AFTER commit
                reclaim.extend(target.chunks)
        except EntryNotFound:
            pass
        self.mkdirs(posixpath.dirname(new_path) or "/", _events=events)
        if entry.is_directory:
            # move children first so events replay consistently
            for child in self.store.list(old_path, limit=1 << 30):
                self._rename_inner(
                    child.path, posixpath.join(new_path, child.name), events, reclaim
                )
        old_copy = Entry.from_dict(entry.to_dict())
        entry.path = new_path
        self.store.insert(entry)
        self.store.delete(old_path)
        events.append((old_copy, entry))
        return entry
