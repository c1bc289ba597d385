"""The port's filer against the reference's: a twin of each of the 29 cases
of `tests/test_filer.py`, each running the reference case's own steps and
assertions on both packages (port clusters on `Encoder(10, 4,
device="cpu")`, reference ones on the numpy backend) and requiring what
comes out to be equal; and cross-package cases: a namespace written by
either package's log, log3 or sqlite store opens in the other with equal
listings and the same log bytes, and the same files uploaded through either
package's filer give equal etags, equal bytes and equal entries.

`Attributes` and events carry `time.time()` stamps and chunks a random fid
(the master's cookie): a twin either pins the clock (`pin_clock`: one
counter for both packages' filer modules, restarted per package; the
store and log-engine twins compare file bytes that way) or compares
entries with the stamp and fid fields masked (`mask`: the cluster twins,
whose masters draw cookies at random); each case says which. Tolerance 0
everywhere."""

import contextlib
import hashlib
import io
import json
import os
import posixpath
import random
import re
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import seaweedfs_tpu.filer as ref_filer
import seaweedfs_tpu.filer.bucketstore as ref_bucketstore
import seaweedfs_tpu.filer.chunks as ref_chunks
import seaweedfs_tpu.filer.entry as ref_entry
import seaweedfs_tpu.filer.filer as ref_filer_core
import seaweedfs_tpu.filer.filer_conf as ref_filer_conf
import seaweedfs_tpu.filer.logstore as ref_logstore
import seaweedfs_tpu.filer.server as ref_server
import seaweedfs_tpu.filer.store as ref_store
import seaweedfs_tpu.utils.chunk_cache as ref_chunk_cache
import seaweedfs_tpu_torch.filer as port_filer
import seaweedfs_tpu_torch.filer.bucketstore as port_bucketstore
import seaweedfs_tpu_torch.filer.chunks as port_chunks
import seaweedfs_tpu_torch.filer.entry as port_entry
import seaweedfs_tpu_torch.filer.filer as port_filer_core
import seaweedfs_tpu_torch.filer.filer_conf as port_filer_conf
import seaweedfs_tpu_torch.filer.logstore as port_logstore
import seaweedfs_tpu_torch.filer.server as port_server
import seaweedfs_tpu_torch.filer.store as port_store
import seaweedfs_tpu_torch.utils.chunk_cache as port_chunk_cache

from test_torch_cluster import PORT as PORT_CLUSTER
from test_torch_cluster import REF as REF_CLUSTER
from test_torch_cluster import stop_all


def _pkg(name, filer, bucketstore, chunks, entry, core, conf, logstore, server, store,
         chunk_cache, cl):
    return types.SimpleNamespace(
        name=name, filer=filer, bucketstore=bucketstore, chunks=chunks, entry=entry,
        core=core, conf=conf, logstore=logstore, server=server, store=store,
        chunk_cache=chunk_cache, cluster=cl,
        Attributes=entry.Attributes, Entry=entry.Entry, FileChunk=entry.FileChunk,
        Filer=core.Filer, FilerClient=filer.FilerClient, FilerServer=filer.FilerServer,
        MemoryStore=store.MemoryStore, SqliteStore=store.SqliteStore,
        EntryNotFound=store.EntryNotFound, LogKv=logstore.LogKv,
        LogFilerStore=logstore.LogFilerStore, BucketedLogStore=bucketstore.BucketedLogStore,
        ChunkCache=chunk_cache.ChunkCache, FilerConf=conf.FilerConf, PathConf=conf.PathConf,
        make_store=store.make_store, etag_of=chunks.etag_of,
    )


REF = _pkg("ref", ref_filer, ref_bucketstore, ref_chunks, ref_entry, ref_filer_core,
           ref_filer_conf, ref_logstore, ref_server, ref_store, ref_chunk_cache, REF_CLUSTER)
PORT = _pkg("port", port_filer, port_bucketstore, port_chunks, port_entry, port_filer_core,
            port_filer_conf, port_logstore, port_server, port_store, port_chunk_cache,
            PORT_CLUSTER)

#: entry and event fields that carry a clock stamp or a fid the master drew
STAMPS = frozenset({"mtime", "crtime", "mtime_ns", "ts_ns", "fid"})
T0 = 1_700_000_000.0


def mask(obj):
    """`obj` with every STAMPS field's value replaced by None, at any depth
    (and a manifest chunk's etag: the md5 of a payload that lists fids)."""
    if isinstance(obj, dict):
        drop = STAMPS | ({"etag"} if obj.get("is_chunk_manifest") else set())
        return {k: None if k in drop else mask(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [mask(v) for v in obj]
    return obj


def pin_clock(monkeypatch, p) -> None:
    """The package's filer modules read `time.time()` / `time.time_ns()`
    from one counter (a microsecond per call) that starts at T0 for each
    package, so their entries, events and logs carry the same stamps."""
    it = iter(range(1 << 40))
    shim = types.SimpleNamespace(**{k: getattr(time, k) for k in dir(time) if not k.startswith("_")})

    def tick() -> int:
        return next(it)

    shim.time = lambda: T0 + tick() * 1e-6
    shim.time_ns = lambda: int(T0 * 1e9) + tick() * 1000
    for mod in (p.entry, p.core, p.server, p.chunks):
        monkeypatch.setattr(mod, "time", shim)


def twin(scenario, tmp_path, pin=None, **kw):
    """`scenario(p, root, **kw)` on the reference, then on the port, each on
    a root of its own (and, given a monkeypatch as `pin`, a freshly pinned
    clock): both results must be equal."""
    out = {}
    for p in (REF, PORT):
        root = tmp_path / p.name
        root.mkdir()
        if pin is not None:
            pin_clock(pin, p)
        out[p.name] = scenario(p, root, **kw)
    assert out["port"] == out["ref"]
    return out["port"]


def sha(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def blob(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def _http(method, url, data=None, headers=None):
    req = urllib.request.Request(url, data=data, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


@contextlib.contextmanager
def stack(p, root, **fs_kw):
    """The reference case's `stack` fixture for one package: a master, one
    volume server (on the package's CPU encoder) and a filer server with
    1 KiB chunks and a meta log, on loopback; the master's cookies seeded."""
    c = p.cluster
    master = c.MasterServer(port=0, reap_interval=3600)
    master._rng = random.Random(7)
    master.start()
    d = root / "vol"
    d.mkdir()
    vs = c.VolumeServer([str(d)], master.address, heartbeat_interval=0.4, encoder=c.encoder())
    vs.start()
    fs = p.FilerServer(master.address, chunk_size=1024, log_dir=str(root / "meta"), **fs_kw)
    fs.start()
    try:
        yield master, vs, fs
    finally:
        stop_all([fs, vs, master])


# -- tests/test_filer.py twins: store parity (clock pinned: entries compared whole) ------


def _stores(p, root):
    return [
        p.MemoryStore(),
        p.SqliteStore(str(root / "f.db")),
        p.LogFilerStore(str(root / "lg")),
        p.BucketedLogStore(str(root / "lg3")),
    ]


def _store_crud_and_listing(p, root):
    out = []
    for store in _stores(p, root):
        e = p.Entry(path="/a/b/hello.txt", attributes=p.Attributes(mtime=1.0))
        store.insert(p.Entry(path="/a", is_directory=True))
        store.insert(p.Entry(path="/a/b", is_directory=True))
        store.insert(e)
        got = store.find("/a/b/hello.txt")
        assert got.path == "/a/b/hello.txt" and not got.is_directory
        with pytest.raises(p.EntryNotFound):
            store.find("/a/b/missing")
        for n in ("z.txt", "m.txt", "aa.txt"):
            store.insert(p.Entry(path=f"/a/b/{n}"))
        listed = store.list("/a/b")
        names = [x.name for x in listed]
        assert names == sorted(names)
        assert [x.name for x in store.list("/a/b", prefix="a")] == ["aa.txt"]
        page1 = store.list("/a/b", limit=2)
        page2 = store.list("/a/b", start_from=page1[-1].name, limit=10)
        assert [x.name for x in page1 + page2] == names
        store.delete("/a/b/z.txt")
        assert "z.txt" not in [x.name for x in store.list("/a/b")]
        store.delete_folder_children("/a")
        assert store.list("/a") == []
        store.kv_put("k1", b"v1")
        kv = store.kv_get("k1")
        assert kv == b"v1"
        store.kv_delete("k1")
        assert store.kv_get("k1") is None
        store.close()
        out.append({"store": store.name, "got": got.to_dict(),
                    "listed": [x.to_dict() for x in listed], "kv": kv})
    return out


def test_store_crud_and_listing(tmp_path, monkeypatch):
    twin(_store_crud_and_listing, tmp_path, pin=monkeypatch)


def _sqlite_store_persists(p, root):
    db = str(root / "p.db")
    s = p.SqliteStore(db)
    s.insert(p.Entry(path="/x", is_directory=True))
    s.insert(p.Entry(path="/x/f", attributes=p.Attributes(mtime=2.0)))
    s.close()
    s2 = p.SqliteStore(db)
    got = s2.find("/x/f")
    assert got.attributes.mtime == 2.0
    s2.close()
    return got.to_dict()


def test_sqlite_store_persists(tmp_path, monkeypatch):
    twin(_sqlite_store_persists, tmp_path, pin=monkeypatch)


# -- filer core (no cluster; clock pinned: events compared whole) ------------------------


def _filer_mkdirs_create_delete_rename(p, root):
    f = p.Filer(p.MemoryStore())
    f.create_entry(p.Entry(path="/d1/d2/file", attributes=p.Attributes(mtime=1.0)))
    assert f.find_entry("/d1").is_directory
    assert f.find_entry("/d1/d2").is_directory
    with pytest.raises(FileExistsError):
        f.create_entry(p.Entry(path="/d1/d2/file"), o_excl=True)
    with pytest.raises(OSError):
        f.delete_entry("/d1")
    f.rename("/d1/d2/file", "/d1/renamed")
    assert f.exists("/d1/renamed") and not f.exists("/d1/d2/file")
    f.delete_entry("/d1", recursive=True)
    assert not f.exists("/d1")
    evs = list(f.subscribe(since_ns=0, stop=None))
    assert len(evs) >= 5
    return [e.to_dict() for e in evs]


def test_filer_mkdirs_create_delete_rename(tmp_path, monkeypatch):
    twin(_filer_mkdirs_create_delete_rename, tmp_path, pin=monkeypatch)


def _filer_refuses_file_over_directory(p, root):
    f = p.Filer(p.MemoryStore())
    f.create_entry(p.Entry(path="/d/child"))
    with pytest.raises(IsADirectoryError):
        f.create_entry(p.Entry(path="/d"))
    f.create_entry(p.Entry(path="/plain"))
    with pytest.raises(IsADirectoryError):
        f.rename("/plain", "/d")
    assert f.exists("/d/child")
    return [e.to_dict() for e in f.walk("/")]


def test_filer_refuses_file_over_directory(tmp_path, monkeypatch):
    twin(_filer_refuses_file_over_directory, tmp_path, pin=monkeypatch)


def _filer_rename_subtree(p, root):
    f = p.Filer(p.MemoryStore())
    for path in ("/src/a/f1", "/src/a/f2", "/src/f3"):
        f.create_entry(p.Entry(path=path))
    f.rename("/src", "/dst")
    walked = [e.to_dict() for e in f.walk("/dst")]
    assert {e["path"] for e in walked} == {"/dst/a", "/dst/a/f1", "/dst/a/f2", "/dst/f3"}
    assert not f.exists("/src")
    return {"walk": walked, "events": [e.to_dict() for e in f.subscribe(0, stop=None)]}


def test_filer_rename_subtree(tmp_path, monkeypatch):
    twin(_filer_rename_subtree, tmp_path, pin=monkeypatch)


def _filer_meta_log_resume(p, root):
    f = p.Filer(p.MemoryStore(), log_dir=str(root))
    f.create_entry(p.Entry(path="/one"))
    f.create_entry(p.Entry(path="/two"))
    f.close()
    f2 = p.Filer(p.MemoryStore(), log_dir=str(root))
    evs = f2._read_log_since(0)
    paths = [e.new_entry["path"] for e in evs if e.new_entry]
    assert "/one" in paths and "/two" in paths
    f2.close()
    return {"paths": paths, "log": (root / "filer.meta.log").read_bytes()}


def test_filer_meta_log_resume(tmp_path, monkeypatch):
    """The meta log's JSONL bytes are equal under the pinned clock."""
    twin(_filer_meta_log_resume, tmp_path, pin=monkeypatch)


# -- integration with the volume tier (stamps and fids masked) ---------------------------


def _filer_http_roundtrip(p, root):
    with stack(p, root) as (_, _, fs):
        base = f"http://{fs.url}"
        payload = blob(1, 5000)
        code, _, body = _http("PUT", base + "/docs/report.bin", payload,
                              {"Content-Type": "application/x-bin"})
        assert code == 201, body
        meta = json.loads(body)
        assert meta["size"] == len(payload)
        entry = fs.filer.find_entry("/docs/report.bin")
        assert len(entry.chunks) == 5
        out = {"put": meta, "entry": mask(entry.to_dict())}
        code, headers, got = _http("GET", base + "/docs/report.bin")
        assert code == 200 and got == payload
        assert headers["Content-Type"] == "application/x-bin"
        out["get"] = (got, headers["Content-Type"], headers["ETag"])
        code, headers, got = _http("GET", base + "/docs/report.bin",
                                   headers={"Range": "bytes=1000-2999"})
        assert code == 206 and got == payload[1000:3000]
        assert headers["Content-Range"] == f"bytes 1000-2999/{len(payload)}"
        out["range"] = got
        code, _, got = _http("GET", base + "/docs/report.bin", headers={"Range": "bytes=-100"})
        assert code == 206 and got == payload[-100:]
        out["suffix"] = got
        code, _, body = _http("GET", base + "/docs")
        listing = json.loads(body)
        assert [e["path"] for e in listing["Entries"]] == ["/docs/report.bin"]
        out["listing"] = mask(listing)
        code, _, _ = _http("PUT", base + "/docs/report.bin", b"tiny")
        assert code == 201
        _, _, got = _http("GET", base + "/docs/report.bin")
        assert got == b"tiny"
        code, _, _ = _http("DELETE", base + "/docs/report.bin")
        assert code == 204
        code, _, _ = _http("GET", base + "/docs/report.bin")
        assert code == 404
        return out


def test_filer_http_roundtrip(tmp_path):
    twin(_filer_http_roundtrip, tmp_path)


def _filer_http_rename_and_mkdir(p, root):
    with stack(p, root) as (_, _, fs):
        base = f"http://{fs.url}"
        _http("PUT", base + "/a/x.txt", b"hello")
        code, _, moved = _http("POST", base + "/b/y.txt?mv.from=/a/x.txt", b"")
        assert code == 200
        code, _, got = _http("GET", base + "/b/y.txt")
        assert code == 200 and got == b"hello"
        code, _, made = _http("PUT", base + "/newdir/?op=mkdir", b"")
        assert code == 201
        assert fs.filer.find_entry("/newdir").is_directory
        return {"moved": moved, "got": got, "made": made,
                "tree": mask([e.to_dict() for e in fs.filer.walk("/")])}


def test_filer_http_rename_and_mkdir(tmp_path):
    twin(_filer_http_rename_and_mkdir, tmp_path)


def _filer_client_rpc(p, root):
    with stack(p, root) as (_, _, fs):
        _http("PUT", f"http://{fs.url}/rpc/data.bin", b"x" * 3000)
        with p.FilerClient(fs.grpc_address) as fc:
            e = fc.lookup("/rpc/data.bin")
            assert e is not None and e.size == 3000
            assert fc.lookup("/rpc/missing") is None
            data = fc.read_file("/rpc/data.bin")
            assert data == b"x" * 3000
            names = [x.name for x in fc.list("/rpc")]
            assert names == ["data.bin"]
            fc.rename("/rpc/data.bin", "/rpc/renamed.bin")
            assert fc.lookup("/rpc/renamed.bin") is not None
            fc.kv_put("mark", b"v")
            kv = fc.kv_get("mark")
            assert kv == b"v"
            fc.delete("/rpc", recursive=True)
            assert fc.lookup("/rpc") is None
            return {"entry": mask(e.to_dict()), "data": data, "names": names, "kv": kv,
                    "configuration": {k: v for k, v in fc.configuration().items()
                                      if k != "masters"}}


def test_filer_client_rpc(tmp_path):
    twin(_filer_client_rpc, tmp_path)


def _filer_subscribe_stream(p, root):
    with stack(p, root) as (_, _, fs):
        base = f"http://{fs.url}"
        seen = []
        done = threading.Event()

        def tail():
            with p.FilerClient(fs.grpc_address) as fc:
                for ev in fc.subscribe(since_ns=0, max_idle_s=3.0):
                    if ev.new_entry:
                        seen.append(ev.new_entry["path"])
                    if "/sub/a.txt" in seen and "/sub/b.txt" in seen:
                        break
            done.set()

        t = threading.Thread(target=tail, daemon=True)
        t.start()
        time.sleep(0.2)
        _http("PUT", base + "/sub/a.txt", b"1")
        _http("PUT", base + "/sub/b.txt", b"2")
        assert done.wait(10.0)
        assert "/sub/a.txt" in seen and "/sub/b.txt" in seen
        return seen


def test_filer_subscribe_stream(tmp_path):
    twin(_filer_subscribe_stream, tmp_path)


def _chunk_manifest_roundtrip(p, root):
    with stack(p, root) as (_, _, fs):
        old = p.chunks.MANIFEST_BATCH
        p.chunks.MANIFEST_BATCH = 3
        try:
            payload = blob(2, 1024 * 8)
            entry = fs.write_file("/mani/big.bin", io.BytesIO(payload))
            assert any(c.is_chunk_manifest for c in entry.chunks)
            assert len(entry.chunks) < 8
            got = fs.read_file(entry)
            assert got == payload
            resolved = fs.chunk_io.resolve_manifests(entry.chunks)
            fs.filer.delete_entry("/mani/big.bin")
        finally:
            p.chunks.MANIFEST_BATCH = old
        return {"entry": mask(entry.to_dict()), "read": got,
                "resolved": mask([c.to_dict() for c in resolved])}


def test_chunk_manifest_roundtrip(tmp_path):
    twin(_chunk_manifest_roundtrip, tmp_path)


# -- log-structured store engine (no clock: log bytes compared) --------------------------


def _logkv_persistence_and_torn_tail(p, root):
    path = str(root / "kv" / "filer.log")
    kv = p.LogKv(path)
    for i in range(50):
        kv.put(f"k{i:03d}".encode(), f"value-{i}".encode() * 3)
    kv.delete(b"k010")
    kv.put(b"k011", b"updated")
    kv.close()
    logs = [sha(path)]
    kv2 = p.LogKv(path)
    assert kv2.get(b"k010") is None
    assert kv2.get(b"k011") == b"updated"
    assert kv2.get(b"k049") == b"value-49" * 3
    assert len(kv2) == 49
    kv2.close()
    with open(path, "ab") as f:
        f.write(b"\x01\x02\x03half-a-record")
    kv3 = p.LogKv(path)
    assert len(kv3) == 49 and kv3.get(b"k011") == b"updated"
    logs.append(sha(path))  # the torn tail truncated at replay
    kv3.put(b"after", b"torn-tail-write")
    kv3.close()
    after = p.LogKv(path).get(b"after")
    assert after == b"torn-tail-write"
    return {"logs": logs + [sha(path)], "after": after}


def test_logkv_persistence_and_torn_tail(tmp_path):
    twin(_logkv_persistence_and_torn_tail, tmp_path)


def _logkv_compaction_reclaims_dead_bytes(p, root):
    path = str(root / "kv" / "filer.log")
    kv = p.LogKv(path, compact_ratio=100.0)
    value = b"x" * 4096
    for round_ in range(20):
        for i in range(16):
            kv.put(f"k{i}".encode(), value + str(round_).encode())
    size_before = os.path.getsize(path)
    kv.compact()
    size_after = os.path.getsize(path)
    assert size_after < size_before / 4, (size_before, size_after)
    for i in range(16):
        assert kv.get(f"k{i}".encode()) == value + b"19"
    kv.close()
    kv2 = p.LogKv(path)
    assert len(kv2) == 16
    kv2.close()
    return {"sizes": (size_before, size_after), "log": sha(path)}


def test_logkv_compaction_reclaims_dead_bytes(tmp_path):
    twin(_logkv_compaction_reclaims_dead_bytes, tmp_path)


def _log_filer_store_persists_namespace(p, root):
    d = str(root / "lgp")
    st = p.LogFilerStore(d)
    st.insert(p.Entry(path="/docs", is_directory=True))
    st.insert(p.Entry(path="/docs/a.txt"))
    st.insert(p.Entry(path="/docs/b.txt"))
    st.kv_put("bookkeeping", b"\x01\x02")
    st.close()
    st2 = p.LogFilerStore(d)
    listed = st2.list("/docs")
    assert [e.name for e in listed] == ["a.txt", "b.txt"]
    assert st2.kv_get("bookkeeping") == b"\x01\x02"
    st2.close()
    return {"listed": [e.to_dict() for e in listed], "log": sha(os.path.join(d, "filer.log"))}


def test_log_filer_store_persists_namespace(tmp_path, monkeypatch):
    twin(_log_filer_store_persists_namespace, tmp_path, pin=monkeypatch)


# -- transactions (clock pinned) ---------------------------------------------------------


def _sqlite_transaction_rollback_and_batch(p, root):
    st = p.SqliteStore(str(root / "t.db"))
    st.insert(p.Entry(path="/keep.txt"))
    with pytest.raises(RuntimeError):
        with st.transaction():
            st.insert(p.Entry(path="/doomed1.txt"))
            st.insert(p.Entry(path="/doomed2.txt"))
            raise RuntimeError("abort")
    with pytest.raises(p.EntryNotFound):
        st.find("/doomed1.txt")
    with pytest.raises(p.EntryNotFound):
        st.find("/doomed2.txt")
    assert st.find("/keep.txt").name == "keep.txt"
    st.insert_batch([p.Entry(path=f"/b{i}.txt") for i in range(10)])
    listed = st.list("/", prefix="b")
    assert len(listed) == 10
    st.close()
    return [e.to_dict() for e in listed]


def test_sqlite_transaction_rollback_and_batch(tmp_path, monkeypatch):
    twin(_sqlite_transaction_rollback_and_batch, tmp_path, pin=monkeypatch)


def _filer_rename_subtree_is_transactional(p, root):
    st = p.SqliteStore(str(root / "r.db"))
    f = p.Filer(st, None)
    f.mkdirs("/src/sub")
    for n in ("a", "b", "c"):
        f.create_entry(p.Entry(path=f"/src/sub/{n}.txt"))
    calls = {"n": 0}
    orig_insert = st.insert

    def failing_insert(entry):
        calls["n"] += 1
        if calls["n"] == 3:
            raise IOError("disk full")
        orig_insert(entry)

    st.insert = failing_insert
    events_before = len(f._events)
    with pytest.raises(IOError):
        f.rename("/src", "/dst")
    st.insert = orig_insert
    assert {e.name for e in st.list("/src/sub")} == {"a.txt", "b.txt", "c.txt"}
    with pytest.raises(p.EntryNotFound):
        st.find("/dst")
    assert len(f._events) == events_before, "rolled-back rename leaked events"
    f.rename("/src", "/dst2")
    assert len(f._events) > events_before
    listed = st.list("/dst2/sub")
    assert {e.name for e in listed} == {"a.txt", "b.txt", "c.txt"}
    st.close()
    return {"listed": [e.to_dict() for e in listed],
            "events": [e.to_dict() for e in f._events]}


def test_filer_rename_subtree_is_transactional(tmp_path, monkeypatch):
    twin(_filer_rename_subtree_is_transactional, tmp_path, pin=monkeypatch)


def _sqlite_transaction_blocks_other_writers(p, root):
    st = p.SqliteStore(str(root / "iso.db"))
    done = threading.Event()
    slipped = []

    def other_writer():
        st.kv_put("other", b"acknowledged")
        done.set()

    with pytest.raises(RuntimeError):
        with st.transaction():
            st.insert(p.Entry(path="/doomed.txt"))
            t = threading.Thread(target=other_writer, daemon=True)
            t.start()
            time.sleep(0.2)
            slipped.append(done.is_set())
            assert not done.is_set(), "writer slipped into the open txn"
            raise RuntimeError("abort")
    assert done.wait(5), "writer never unblocked after rollback"
    kv = st.kv_get("other")
    assert kv == b"acknowledged"
    with pytest.raises(p.EntryNotFound):
        st.find("/doomed.txt")
    st.close()
    return {"slipped": slipped, "kv": kv}


def test_sqlite_transaction_blocks_other_writers(tmp_path):
    twin(_sqlite_transaction_blocks_other_writers, tmp_path)


# -- chunk cache ---------------------------------------------------------------------------


def _chunk_cache_lru_and_tiers(p, root):
    cc = p.ChunkCache(memory_bytes=10_000, max_item_bytes=6_000,
                      disk_dir=str(root / "cc"), disk_bytes=50_000)
    cc.put("1,aa", b"x" * 4000)
    cc.put("2,bb", b"y" * 4000)
    assert cc.get("1,aa") == b"x" * 4000
    cc.put("3,cc", b"z" * 4000)
    used = cc.memory_bytes_used
    assert used <= 10_000
    assert cc.get("2,bb") == b"y" * 4000
    files = sorted(os.listdir(root / "cc"))
    cc.put("4,dd", b"w" * 7000)
    assert cc.get("4,dd") is None
    cc.delete("1,aa")
    cc.clear()
    assert cc.get("1,aa") is None
    assert cc.hits >= 2 and cc.misses >= 2
    return {"used": used, "disk_files": files, "hits": cc.hits, "misses": cc.misses,
            "after_clear": sorted(os.listdir(root / "cc"))}


def test_chunk_cache_lru_and_tiers(tmp_path):
    """The disk tier's file names (sha1 of the fid) are equal too."""
    twin(_chunk_cache_lru_and_tiers, tmp_path)


def _chunk_cache_serves_filer_rereads(p, root):
    with stack(p, root) as (_, _, fs):
        payload = blob(3, 4000)
        _http("PUT", f"http://{fs.url}/cached/file.bin", payload)
        _http("GET", f"http://{fs.url}/cached/file.bin")
        cache = fs.chunk_io.cache
        h0 = cache.hits
        reads = {"n": 0}
        orig = fs.chunk_io.master.read

        def counting_read(fid):
            reads["n"] += 1
            return orig(fid)

        fs.chunk_io.master.read = counting_read
        _, _, got = _http("GET", f"http://{fs.url}/cached/file.bin")
        fs.chunk_io.master.read = orig
        assert got == payload
        assert reads["n"] == 0, "re-read went to the volume tier despite cache"
        assert cache.hits > h0
        return {"got": got, "volume_reads": reads["n"], "hits": cache.hits - h0}


def test_chunk_cache_serves_filer_rereads(tmp_path):
    twin(_chunk_cache_serves_filer_rereads, tmp_path)


# -- filer.conf rules ------------------------------------------------------------------------


def _filer_conf_matches_on_segment_boundaries(p, root):
    conf = p.FilerConf()
    conf.upsert(p.PathConf(location_prefix="/buckets/logs", collection="logs"))
    conf.upsert(p.PathConf(location_prefix="/buckets/logs/hot/", ttl="1d"))
    assert conf.match("/buckets/logs").collection == "logs"
    assert conf.match("/buckets/logs/a.txt").collection == "logs"
    assert conf.match("/buckets/logs/hot/x").ttl == "1d"
    assert conf.match("/buckets/logs2/x") is None
    assert conf.match("/buckets/logsx") is None
    conf.upsert(p.PathConf(location_prefix="/", replication="001"))
    assert conf.match("/anything").replication == "001"
    assert conf.match("/buckets/logs/a.txt").collection == "logs"
    return {"json": conf.to_json(),
            "matches": [getattr(conf.match(x), "location_prefix", None) for x in (
                "/", "/buckets/logs", "/buckets/logs/hot", "/buckets/logs2/x", "/x/y")],
            "reloaded": p.FilerConf.from_json(conf.to_json()).to_json()}


def test_filer_conf_matches_on_segment_boundaries(tmp_path):
    """The rule set's JSON (the KV value) is byte-equal."""
    twin(_filer_conf_matches_on_segment_boundaries, tmp_path)


def _filer_readonly_rule_respects_segment_boundaries(p, root):
    f = p.Filer(p.MemoryStore())
    f.path_conf.upsert(p.PathConf(location_prefix="/frozen", read_only=True))
    errors = []
    for path in ("/frozen/a", "/frozen"):
        with pytest.raises(PermissionError) as ei:
            f.create_entry(p.Entry(path=path))
        errors.append(str(ei.value))
    f.create_entry(p.Entry(path="/frozen2/a"))
    assert f.find_entry("/frozen2/a")
    return {"errors": errors, "tree": [e.to_dict() for e in f.walk("/")]}


def test_filer_readonly_rule_respects_segment_boundaries(tmp_path, monkeypatch):
    twin(_filer_readonly_rule_respects_segment_boundaries, tmp_path, pin=monkeypatch)


# -- log engine crash safety -----------------------------------------------------------------


def _logkv_crash_before_compaction_swap_loses_nothing(p, root, monkeypatch):
    path = str(root / "kv.log")
    kv = p.LogKv(path)
    rng = random.Random(37)
    data = {f"k{i}".encode(): rng.randbytes(50) for i in range(40)}
    for k, v in data.items():
        kv.put(k, v)
    for i in range(0, 40, 2):
        kv.put(f"k{i}".encode(), data[f"k{i}".encode()] + b"v2")
        data[f"k{i}".encode()] += b"v2"
    real_replace = os.replace

    def boom(src, dst):
        raise OSError("killed mid-swap")

    monkeypatch.setattr(os, "replace", boom)
    with pytest.raises(OSError):
        kv.compact()
    monkeypatch.setattr(os, "replace", real_replace)
    assert os.path.exists(path + ".compact")
    staged = sha(path + ".compact")
    re1 = p.LogKv(path)
    assert {k: re1.get(k) for k in data} == data
    re1.compact()
    re1.close()
    re2 = p.LogKv(path)
    assert {k: re2.get(k) for k in data} == data
    assert not os.path.exists(path + ".compact")
    re2.close()
    return {"staged": staged, "log": sha(path)}


def test_logkv_crash_before_compaction_swap_loses_nothing(tmp_path, monkeypatch):
    twin(_logkv_crash_before_compaction_swap_loses_nothing, tmp_path, monkeypatch=monkeypatch)


def _logkv_compaction_fsyncs_before_swap(p, root, monkeypatch):
    path = str(root / "kv.log")
    kv = p.LogKv(path)
    for i in range(30):
        kv.put(f"k{i}".encode(), b"x" * 64)
        kv.put(f"k{i}".encode(), b"y" * 64)
    calls = []
    real_fsync, real_replace = os.fsync, os.replace
    monkeypatch.setattr(os, "fsync", lambda fd: (calls.append("fsync"), real_fsync(fd))[1])
    monkeypatch.setattr(os, "replace", lambda a, b: (calls.append("replace"), real_replace(a, b))[1])
    kv.compact()
    monkeypatch.setattr(os, "fsync", real_fsync)
    monkeypatch.setattr(os, "replace", real_replace)
    assert "replace" in calls and "fsync" in calls
    assert calls.index("fsync") < calls.index("replace"), calls
    kv.close()
    return {"calls": calls, "log": sha(path)}


def test_logkv_compaction_fsyncs_before_swap(tmp_path, monkeypatch):
    """The order of fsyncs and the swap is the same call for call (the
    data fsync, the swap, the directory fsync)."""
    out = twin(_logkv_compaction_fsyncs_before_swap, tmp_path, monkeypatch=monkeypatch)
    assert out["calls"] == ["fsync", "replace", "fsync"]


def _logkv_random_killpoint_fuzz_is_prefix_consistent(p, root):
    rng = random.Random(1234)
    out = []
    for trial in range(12):
        path = str(root / f"fuzz{trial}.log")
        kv = p.LogKv(path)
        snapshots = [dict()]
        model: dict[bytes, bytes] = {}
        for _ in range(rng.randrange(5, 40)):
            k = f"key{rng.randrange(8)}".encode()
            if rng.random() < 0.25 and model:
                kv.delete(k)
                model.pop(k, None)
            else:
                v = rng.randbytes(rng.randrange(1, 80))
                kv.put(k, v)
                model[k] = v
            snapshots.append(dict(model))
        kv.close()
        size = os.path.getsize(path)
        cut = rng.randrange(0, size + 1)
        with open(path, "r+b") as f:
            f.truncate(cut)
        re_ = p.LogKv(path)
        state = {k: re_.get(k) for k in re_.keys()}
        assert state in snapshots, f"trial {trial}: post-crash state matches no op prefix"
        re_.put(b"after", b"crash")
        re_.close()
        re2 = p.LogKv(path)
        assert re2.get(b"after") == b"crash"
        re2.close()
        out.append({"cut": cut, "size": size, "prefix": snapshots.index(state),
                    "log": sha(path)})
    return out


def test_logkv_random_killpoint_fuzz_is_prefix_consistent(tmp_path):
    """The seeded op stream (values from the seeded generator, not
    os.urandom) lands on the same op prefix and the same log bytes."""
    twin(_logkv_random_killpoint_fuzz_is_prefix_consistent, tmp_path)


def _log_filer_store_reopen_invariants_after_kill(p, root):
    rng = random.Random(99)
    out = []
    for trial in range(6):
        d = root / f"st{trial}"
        d.mkdir()
        st = p.LogFilerStore(str(d))
        for i in range(30):
            dir_i = f"/d{rng.randrange(4)}"
            st.insert(p.Entry(path=dir_i, is_directory=True))
            st.insert(p.Entry(path=f"{dir_i}/f{i}.txt"))
            if rng.random() < 0.2:
                st.kv_put(f"conf{i}", b"v" * i)
            if rng.random() < 0.15:
                victims = st.list(dir_i, limit=5)
                if victims:
                    st.delete(victims[0].path)
        st.close()
        log = os.path.join(str(d), "filer.log")
        size = os.path.getsize(log)
        with open(log, "r+b") as f:
            f.truncate(rng.randrange(0, size + 1))
        re_ = p.LogFilerStore(str(d))
        names = {}
        for sub, ns in re_._dirs.items():
            for name in ns:
                assert re_.find(posixpath.join(sub, name)).name == name
            names[sub] = sorted(ns)
        re_.close()
        out.append({"names": names, "log": sha(log)})
    return out


def test_log_filer_store_reopen_invariants_after_kill(tmp_path, monkeypatch):
    twin(_log_filer_store_reopen_invariants_after_kill, tmp_path, pin=monkeypatch)


# -- log3: per-bucket stores (clock pinned) --------------------------------------------------


def _bucket_logs(root) -> dict:
    return {os.path.relpath(os.path.join(dp, f), root): sha(os.path.join(dp, f))
            for dp, _, fs in os.walk(root) for f in fs if f == "filer.log"}


def _bucketed_store_routes_and_isolates(p, root):
    st = p.BucketedLogStore(str(root))
    f = p.Filer(st)
    f.create_entry(p.Entry(path="/buckets", is_directory=True))
    for b in ("alpha", "beta"):
        f.create_entry(p.Entry(path=f"/buckets/{b}", is_directory=True))
        f.create_entry(p.Entry(path=f"/buckets/{b}/obj.txt"))
        f.create_entry(p.Entry(path=f"/buckets/{b}/dir", is_directory=True))
        f.create_entry(p.Entry(path=f"/buckets/{b}/dir/deep.txt"))
    f.create_entry(p.Entry(path="/plain", is_directory=True))
    f.create_entry(p.Entry(path="/plain/file.txt"))
    st.kv_put("identities", b"kvdata")
    assert os.path.exists(root / "buckets" / "alpha" / "filer.log")
    assert os.path.exists(root / "buckets" / "beta" / "filer.log")
    assert os.path.exists(root / "default" / "filer.log")
    assert f.find_entry("/buckets/alpha/dir/deep.txt").name == "deep.txt"
    assert f.find_entry("/plain/file.txt").name == "file.txt"
    assert sorted(e.name for e in st.list("/buckets")) == ["alpha", "beta"]
    assert st.kv_get("identities") == b"kvdata"
    st.close()
    logs = _bucket_logs(root)
    re_ = p.BucketedLogStore(str(root))
    f2 = p.Filer(re_)
    assert f2.find_entry("/buckets/beta/obj.txt").name == "obj.txt"
    assert sorted(e.name for e in re_.list("/buckets")) == ["alpha", "beta"]
    f2.delete_entry("/buckets/alpha", recursive=True, delete_chunks=False)
    assert not os.path.exists(root / "buckets" / "alpha")
    assert [e.name for e in re_.list("/buckets")] == ["beta"]
    with pytest.raises(p.EntryNotFound):
        re_.find("/buckets/alpha/obj.txt")
    assert f2.find_entry("/buckets/beta/dir/deep.txt").name == "deep.txt"
    assert f2.find_entry("/plain/file.txt").name == "file.txt"
    tree = [e.to_dict() for e in f2.walk("/")]
    re_.close()
    return {"logs": logs, "after_drop": _bucket_logs(root), "tree": tree}


def test_bucketed_store_routes_and_isolates(tmp_path, monkeypatch):
    twin(_bucketed_store_routes_and_isolates, tmp_path, pin=monkeypatch)


def _bucketed_store_rename_across_buckets(p, root):
    st = p.BucketedLogStore(str(root))
    f = p.Filer(st)
    f.create_entry(p.Entry(path="/buckets/src", is_directory=True))
    f.create_entry(p.Entry(path="/buckets/src/a.txt"))
    f.create_entry(p.Entry(path="/buckets/src/sub", is_directory=True))
    f.create_entry(p.Entry(path="/buckets/src/sub/b.txt"))
    f.rename("/buckets/src", "/buckets/dst")
    assert f.find_entry("/buckets/dst/sub/b.txt").name == "b.txt"
    assert os.path.exists(root / "buckets" / "dst" / "filer.log")
    assert not os.path.exists(root / "buckets" / "src")
    assert [e.name for e in st.list("/buckets")] == ["dst"]
    tree = [e.to_dict() for e in f.walk("/")]
    st.close()
    return {"tree": tree, "logs": _bucket_logs(root)}


def test_bucketed_store_rename_across_buckets(tmp_path, monkeypatch):
    twin(_bucketed_store_rename_across_buckets, tmp_path, pin=monkeypatch)


# -- HTML listing ------------------------------------------------------------------------------


def _html(body: bytes) -> str:
    """An HTML listing with its modification times masked."""
    return re.sub(r"\d{4}-\d\d-\d\d \d\d:\d\d", "<mtime>", body.decode())


def _filer_html_directory_browsing(p, root):
    with stack(p, root) as (_, _, fs):
        base = f"http://{fs.url}"
        _http("PUT", base + "/web/sub/", None)
        _http("PUT", base + "/web/a.txt", b"x")
        _http("PUT", base + "/web/%3Cb%3Ename.txt", b"y")
        code, headers, body = _http(
            "GET", base + "/web", headers={"Accept": "text/html,application/xhtml+xml"})
        assert code == 200 and headers["Content-Type"].startswith("text/html")
        assert b"<table>" in body and b'href="/web/a.txt"' in body
        assert b"sub/" in body
        assert b"<b>name" not in body and b"&lt;b&gt;name.txt" in body
        code, headers2, body2 = _http("GET", base + "/web")
        assert headers2["Content-Type"].startswith("application/json")
        assert b'"Entries"' in body2
        return {"html": _html(body), "json": mask(json.loads(body2))}


def test_filer_html_directory_browsing(tmp_path):
    twin(_filer_html_directory_browsing, tmp_path)


def _bucketed_store_root_discovery_and_html_pagination(p, root):
    st = p.BucketedLogStore(str(root / "disc"))
    f = p.Filer(st)
    f.create_entry(p.Entry(path="/buckets/bb", is_directory=True))
    assert "/buckets" in {e.path for e in st.list("/")}, "root walk must see /buckets"
    st.close()
    pages = []
    with stack(p, root) as (_, _, fs):
        base = f"http://{fs.url}"
        for i in range(5):
            _http("PUT", base + f"/pagedir/f{i:02d}.txt", b"x")
        for q, want, unwanted in (("", b"5 entries", b"next page"),
                                  ("?limit=2", b"first 2 entries", None),
                                  ("?limit=2&lastFileName=f01.txt", b"f02.txt", b"f00.txt")):
            _, _, body = _http("GET", base + "/pagedir" + q, headers={"Accept": "text/html"})
            assert want in body
            if unwanted:
                assert unwanted not in body
            pages.append(_html(body))
        assert "next page" in pages[1] and "lastFileName=f01.txt" in pages[1]
    return pages


def test_bucketed_store_root_discovery_and_html_pagination(tmp_path):
    twin(_bucketed_store_root_discovery_and_html_pagination, tmp_path)


# -- across the packages -----------------------------------------------------------------------


def _namespace(p) -> list:
    """A namespace with every stamp given: directories, files with chunks
    (one of them a manifest), extended attributes, a TTL'd file."""
    A = p.Attributes
    out = [p.Entry(path="/docs", is_directory=True, attributes=A(mtime=T0, crtime=T0, mode=0o40770)),
           p.Entry(path="/docs/sub", is_directory=True, attributes=A(mtime=T0 + 1, crtime=T0 + 1)),
           p.Entry(path="/buckets", is_directory=True, attributes=A(mtime=T0, crtime=T0)),
           p.Entry(path="/buckets/bk", is_directory=True, attributes=A(mtime=T0, crtime=T0))]
    for i in range(12):
        chunks = [p.FileChunk(fid=f"{3 + i % 2},{i + 1:x}{j:02x}00ab12cd", offset=j * 4096,
                              size=4096, mtime_ns=int((T0 + i) * 1e9) + j,
                              etag=hashlib.md5(bytes([i, j])).hexdigest(),
                              is_chunk_manifest=(i == 5 and j == 0)) for j in range(i % 3 + 1)]
        parent = ("/docs", "/docs/sub", "/buckets/bk")[i % 3]
        out.append(p.Entry(
            path=f"{parent}/f{i:02d}.bin",
            attributes=A(mtime=T0 + i / 8, crtime=T0 + i / 16, mode=0o644, uid=i, gid=2 * i,
                         mime="application/x-bin", replication="001" if i % 4 == 0 else "",
                         collection="bk" if parent.startswith("/buckets") else "",
                         ttl_sec=3600 * (i % 5 == 0), md5=hashlib.md5(bytes([i])).hexdigest(),
                         file_size=4096 * len(chunks)),
            chunks=chunks, extended={"x-amz-meta-k": f"v{i}"} if i % 2 else {}))
    return out


def _dump_store(store, path="/") -> list:
    """Every entry under `path`, depth first in listing order, as dicts."""
    out = []
    for e in store.list(path, limit=1 << 30):
        out.append(e.to_dict())
        if e.is_directory:
            out.extend(_dump_store(store, e.path))
    return out


def _store_files(kind: str, root) -> dict:
    if kind == "sqlite":
        return {}  # sqlite's page layout is the library's; the rows are compared
    return {os.path.relpath(os.path.join(dp, f), root): sha(os.path.join(dp, f))
            for dp, _, fs in os.walk(root) for f in fs}


@pytest.mark.parametrize("kind", ["log", "log3", "sqlite"])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_a_store_written_by_either_package_opens_in_the_other(tmp_path, monkeypatch, kind,
                                                            writer):
    """The namespace (every stamp given; the clock pinned for the log3
    store's own `/buckets` entry) written through one package's store of
    `kind` (entries, a KV value, a delete, an overwrite) reopens in the other package's store with equal listings,
    finds and KV; both writers leave the same store files byte for byte
    (log, log3); the reader's own writes go on in the same file."""
    pkgs = {"ref": REF, "port": PORT}
    w, r = pkgs[writer], pkgs["port" if writer == "ref" else "ref"]
    roots, paths = {}, {}
    for p in (w, r):
        root = tmp_path / f"by_{p.name}"
        root.mkdir()
        roots[p.name] = root
        paths[p.name] = str(root / "filer.db") if kind == "sqlite" else str(root)
        pin_clock(monkeypatch, p)
        st = p.make_store(kind, paths[p.name])
        for e in _namespace(p):
            st.insert(e)
        st.kv_put("filer.conf", b'{"rules": []}')
        st.delete("/docs/f03.bin")
        st.update(_namespace(p)[4])
        st.close()
    if kind != "sqlite":
        assert _store_files(kind, roots["ref"]) == _store_files(kind, roots["port"])
    path = paths[w.name]
    mine = w.make_store(kind, path)
    theirs_written = _dump_store(mine)
    mine.close()
    other = r.make_store(kind, path)
    got = _dump_store(other)
    assert got == theirs_written and len(got) == len(_namespace(r)) - 1
    for e in _namespace(r):
        if e.path == "/docs/f03.bin":
            with pytest.raises(r.EntryNotFound):
                other.find(e.path)
        else:
            assert other.find(e.path).to_dict() == e.to_dict()
    assert other.kv_get("filer.conf") == b'{"rules": []}'
    other.insert(r.Entry(path="/docs/late.txt", attributes=r.Attributes(mtime=T0, crtime=T0)))
    other.close()
    back = w.make_store(kind, path)
    assert back.find("/docs/late.txt").attributes.mtime == T0
    back.close()


def test_the_sqlite_schema_is_the_same(tmp_path):
    """Both packages create the same tables, columns and keys."""
    import sqlite3

    schemas = []
    for p in (REF, PORT):
        db = str(tmp_path / f"{p.name}.db")
        p.SqliteStore(db).close()
        with contextlib.closing(sqlite3.connect(db)) as c:
            schemas.append(c.execute("SELECT type, name, sql FROM sqlite_master "
                                     "ORDER BY name").fetchall())
    assert schemas[0] == schemas[1]


def test_etag_and_manifest_formats_are_equal():
    """`etag_of` over the same chunk lists (single, multipart, empty,
    whole-file md5) and the manifest chunk's JSON payload are equal."""
    for n in (0, 1, 2, 7):
        lists = {}
        for p in (REF, PORT):
            chunks = [p.FileChunk(fid=f"1,{j:x}", offset=j * 10, size=10,
                                  etag=hashlib.md5(bytes([j])).hexdigest()) for j in range(n)]
            lists[p.name] = (p.etag_of(chunks), p.etag_of(chunks, "ab" * 16),
                             json.dumps([c.to_dict() for c in chunks]).encode())
        assert lists["ref"] == lists["port"]


def _upload_files(p, root):
    """Seeded files through the filer's HTTP PUT (several chunks, one
    chunk, empty, a manifest-folded one), then read back over HTTP and RPC."""
    with stack(p, root) as (_, _, fs):
        old = p.chunks.MANIFEST_BATCH
        p.chunks.MANIFEST_BATCH = 4
        out = {}
        try:
            for i, n in enumerate((0, 1, 1023, 1024, 1025, 5000, 12_000)):
                data = blob(40 + i, n)
                code, _, body = _http("PUT", f"http://{fs.url}/up/f{i}.bin", data)
                assert code == 201, body
                code, headers, got = _http("GET", f"http://{fs.url}/up/f{i}.bin")
                assert code == 200 and got == data
                with p.FilerClient(fs.grpc_address) as fc:
                    assert fc.read_file(f"/up/f{i}.bin") == data
                    part = fc.read_range(f"/up/f{i}.bin", n // 3, n // 2)
                    assert part == data[n // 3: n // 3 + n // 2]
                e = fs.filer.find_entry(f"/up/f{i}.bin")
                data_chunks = fs.chunk_io.resolve_manifests(e.chunks)
                out[n] = {"put": json.loads(body), "etag": headers["ETag"], "read": got,
                          "multipart_etag": p.etag_of(data_chunks), "entry": mask(e.to_dict())}
        finally:
            p.chunks.MANIFEST_BATCH = old
        return out


def test_files_uploaded_through_either_filer_have_equal_etags_and_bytes(tmp_path):
    """Stamps and fids masked (the masters draw cookies at random)."""
    out = twin(_upload_files, tmp_path)
    assert out[12_000]["entry"]["chunks"][0]["is_chunk_manifest"]


def test_a_meta_log_written_by_either_package_resumes_in_the_other(tmp_path, monkeypatch):
    """Clock pinned: a subscriber of either package replays the other's
    on-disk meta log to the same events."""
    logs = {}
    for p in (REF, PORT):
        pin_clock(monkeypatch, p)
        d = tmp_path / p.name
        f = p.Filer(p.MemoryStore(), log_dir=str(d))
        for e in _namespace(p)[:8]:
            f.create_entry(e)
        f.rename("/docs/sub", "/docs/moved")
        f.delete_entry("/docs/moved", recursive=True)
        f.close()
        logs[p.name] = d
    assert (logs["ref"] / "filer.meta.log").read_bytes() == \
        (logs["port"] / "filer.meta.log").read_bytes()
    replays = {}
    for reader in (REF, PORT):
        for writer in ("ref", "port"):
            f = reader.Filer(reader.MemoryStore(), log_dir=str(logs[writer]))
            replays[reader.name, writer] = [e.to_dict() for e in f._read_log_since(0)]
            f.close()
    assert len(set(map(json.dumps, replays.values()))) == 1 and replays["ref", "ref"]


def test_stop_ends_open_subscriptions(tmp_path):
    """A SubscribeMetadata stream with no idle limit ends when the port's
    filer server stops, and its handler leaves no thread behind."""
    with stack(PORT, tmp_path) as (_, _, fs):
        ended = threading.Event()

        def tail():
            with PORT.FilerClient(fs.grpc_address) as fc:
                try:
                    for _ in fc.subscribe(since_ns=0, max_idle_s=0):
                        pass
                except Exception:  # noqa: BLE001 — the server went away
                    pass
            ended.set()

        before = threading.active_count()
        t = threading.Thread(target=tail, daemon=True)
        t.start()
        deadline = time.monotonic() + 10
        while not fs._subscribers and time.monotonic() < deadline:
            time.sleep(0.02)
        assert fs._subscribers, "the stream never opened"
    assert ended.wait(10), "the subscription outlived the server"
    t.join(5)
    assert not fs._subscribers
    assert threading.active_count() <= before + 1


def test_the_filer_front_answers_without_nagle(tmp_path):
    """The port's filer sets TCP_NODELAY on every connection it accepts (as
    both packages' volume servers do): a reply's headers and body leave in
    two writes, and with Nagle on the body waited for the client's delayed
    ACK, ~40 ms per request on a keep-alive connection. The reference's
    filer front keeps Nagle on."""
    import http.client
    import socket

    seen = []
    orig = port_server._Handler.setup

    def setup(self):
        orig(self)
        seen.append(self.connection.getsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY))

    port_server._Handler.setup = setup
    try:
        with stack(PORT, tmp_path) as (_, _, fs):
            fs.write_file("/n/a.txt", io.BytesIO(b"x"))
            conn = http.client.HTTPConnection("127.0.0.1", fs.port, timeout=10)
            try:
                for _ in range(3):
                    conn.request("GET", "/n/a.txt")
                    r = conn.getresponse()
                    assert r.status == 200 and r.read() == b"x"
            finally:
                conn.close()
    finally:
        port_server._Handler.setup = orig
    assert seen == [1]  # one keep-alive connection, Nagle off
    assert not getattr(ref_server._Handler, "disable_nagle_algorithm", False)
