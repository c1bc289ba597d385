"""BucketedLogStore — per-bucket store separation, the leveldb3-analog
backend (weed/filer/leveldb3: upstream's modern default gives every /buckets/<name> subtree its
OWN embedded DB so a bucket drop is a directory unlink, not an
O(entries) scan, and one bucket's write load never shares a log or a
compaction with another's).

Routing: paths under /buckets/<name> (and the bucket directory entry
itself) go to data/<name>/filer.log; everything else — the rest of the
namespace, the KV facet (identities, filer.conf), /buckets itself — to
the default store. Each shard is a full LogFilerStore, so crash
recovery (torn-tail truncation, prefix consistency) and compaction hold
per bucket independently.

Deleting the subtree /buckets/<name> closes and REMOVES the bucket's
store directory wholesale — the upstream O(1) bucket-drop semantics the
S3 gateway's per-bucket collections pair with on the volume tier.
"""

from __future__ import annotations

import os
import re
import shutil
import threading

from seaweedfs_tpu_torch.filer.entry import Entry, normalize_path
from seaweedfs_tpu_torch.filer.store import EntryNotFound, FilerStore

BUCKETS_PREFIX = "/buckets"
_SAFE_BUCKET = re.compile(r"^[A-Za-z0-9._-]{1,255}$")


class BucketedLogStore(FilerStore):
    name = "log3"

    def __init__(self, directory: str):
        self._dir = directory
        from seaweedfs_tpu_torch.filer.logstore import LogFilerStore

        self._mk = LogFilerStore
        os.makedirs(os.path.join(directory, "buckets"), exist_ok=True)
        self._default = self._mk(os.path.join(directory, "default"))
        # /buckets is a REAL entry in the default store (not synthesized):
        # a synthetic find() would make mkdirs skip the insert and the
        # root listing would never show /buckets to namespace walkers
        try:
            self._default.find(BUCKETS_PREFIX)
        except EntryNotFound:
            self._default.insert(Entry(path=BUCKETS_PREFIX, is_directory=True))
        self._lock = threading.Lock()
        self._buckets: dict[str, FilerStore] = {}
        for name in sorted(os.listdir(os.path.join(directory, "buckets"))):
            p = os.path.join(directory, "buckets", name)
            # a stray FILE here must not crash the open: only directories
            # are shards
            if _SAFE_BUCKET.fullmatch(name) and os.path.isdir(p):
                self._buckets[name] = self._mk(p)

    # -- routing --------------------------------------------------------------

    def _bucket_of(self, path: str) -> str:
        """Bucket name when `path` is /buckets/<name>[/...] (with a name
        the per-bucket directory layout can host), else ''."""
        if not path.startswith(BUCKETS_PREFIX + "/"):
            return ""
        name = path[len(BUCKETS_PREFIX) + 1 :].split("/", 1)[0]
        return name if _SAFE_BUCKET.fullmatch(name) else ""

    def _route(self, path: str, create: bool = False) -> FilerStore:
        name = self._bucket_of(path)
        if not name:
            return self._default
        with self._lock:
            st = self._buckets.get(name)
            if st is None:
                if not create:
                    return self._default  # unknown bucket: consistent misses
                st = self._buckets[name] = self._mk(
                    os.path.join(self._dir, "buckets", name)
                )
            return st

    # -- FilerStore -----------------------------------------------------------

    def insert(self, entry: Entry) -> None:
        self._route(entry.path, create=True).insert(entry)

    def update(self, entry: Entry) -> None:
        self._route(entry.path, create=True).update(entry)

    def find(self, path: str) -> Entry:
        path = normalize_path(path)
        return self._route(path).find(path)

    def delete(self, path: str) -> None:
        path = normalize_path(path)
        name = self._bucket_of(path)
        if name and path == f"{BUCKETS_PREFIX}/{name}":
            self._drop_bucket(name)
            return
        self._route(path).delete(path)

    def delete_folder_children(self, path: str) -> None:
        path = normalize_path(path)
        name = self._bucket_of(path)
        if name and path == f"{BUCKETS_PREFIX}/{name}":
            # children live exclusively in the bucket shard: dropping and
            # recreating it is the upstream O(1) bucket wipe. The ROOT
            # entry (and its versioning/policy metadata) must survive a
            # children-only wipe per the FilerStore contract.
            try:
                root = self.find(path)
            except EntryNotFound:
                root = Entry(path=path, is_directory=True)
            self._drop_bucket(name)
            with self._lock:
                st = self._buckets[name] = self._mk(
                    os.path.join(self._dir, "buckets", name)
                )
            st.insert(root)
            return
        if path == BUCKETS_PREFIX:
            with self._lock:
                names = list(self._buckets)
            for n in names:
                self._drop_bucket(n)
        self._route(path).delete_folder_children(path)

    def _drop_bucket(self, name: str) -> None:
        with self._lock:
            self._buckets.pop(name, None)
        # deliberately NOT closing the popped store: lock-free readers may
        # still hold it mid-read, and POSIX keeps unlinked-but-open files
        # readable — a close here would turn their 404s into 500s. The
        # file handles fall with the last reference (refcount/GC).
        shutil.rmtree(os.path.join(self._dir, "buckets", name), ignore_errors=True)
        # the bucket DIRECTORY entry may live in the shard (dropped with
        # it) — make sure the default store holds no stale record either
        try:
            self._default.delete(f"{BUCKETS_PREFIX}/{name}")
        except EntryNotFound:
            pass

    def list(self, dir_path, start_from="", include_start=False, limit=1024, prefix=""):
        dir_path = normalize_path(dir_path)
        if dir_path == BUCKETS_PREFIX:
            # bucket roots come from the shard map (each shard holds its
            # own root entry), non-bucket children from the default store;
            # MERGE FIRST, paginate after — capping either source before
            # the merge would make pages skip entries forever
            with self._lock:
                names = sorted(self._buckets)
            merged = []
            for n in names:
                if prefix and not n.startswith(prefix):
                    continue
                with self._lock:
                    st = self._buckets.get(n)
                if st is None:
                    continue  # raced a bucket drop
                try:
                    merged.append(st.find(f"{BUCKETS_PREFIX}/{n}"))
                except EntryNotFound:
                    merged.append(Entry(path=f"{BUCKETS_PREFIX}/{n}", is_directory=True))
            for e in self._default.list(dir_path, limit=1 << 30, prefix=prefix):
                if not self._bucket_of(e.path):
                    merged.append(e)
            merged.sort(key=lambda e: e.name)
            out = []
            for e in merged:
                if start_from and (
                    e.name < start_from
                    or (e.name == start_from and not include_start)
                ):
                    continue
                out.append(e)
                if len(out) >= limit:
                    break
            return out
        return self._route(dir_path).list(
            dir_path, start_from=start_from, include_start=include_start,
            limit=limit, prefix=prefix,
        )

    # KV facet (identities, filer.conf, mq offsets) is cluster-global
    def kv_put(self, key, value):
        self._default.kv_put(key, value)

    def kv_get(self, key):
        return self._default.kv_get(key)

    def kv_delete(self, key):
        self._default.kv_delete(key)

    def close(self):
        self._default.close()
        with self._lock:
            stores, self._buckets = list(self._buckets.values()), {}
        for st in stores:
            st.close()
