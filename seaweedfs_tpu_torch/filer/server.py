"""Filer server — mirror of weed/server/filer_server.go + the filer HTTP
handlers (filer_server_handlers_read.go/_write.go) and the weedtpu.Filer
gRPC surface from weed/pb/filer.proto.

HTTP file API (the data path):
  GET    /path/to/file          -> file bytes (Range: bytes=a-b honored)
  GET    /path/to/dir           -> JSON directory listing
                                   (?limit=&lastFileName=&prefix=)
  PUT    /path/to/file          -> chunked upload via assign+POST
  POST   /path/to/file?mv.from= -> rename
  DELETE /path[?recursive=true] -> delete (+chunk reclamation)

RPC service weedtpu.Filer: LookupDirectoryEntry, ListEntries, CreateEntry,
UpdateEntry, DeleteEntry, AtomicRenameEntry, Statistics, KvGet/KvPut,
SubscribeMetadata (server stream of MetaEvent JSON frames).
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from typing import Optional

import grpc

from seaweedfs_tpu_torch import rpc, stats
from seaweedfs_tpu_torch.utils import httpd
from seaweedfs_tpu_torch.cluster.client import MasterClient
from seaweedfs_tpu_torch.filer.chunks import ChunkIO, DEFAULT_CHUNK_SIZE, etag_of
from seaweedfs_tpu_torch.filer.entry import Attributes, Entry, normalize_path
from seaweedfs_tpu_torch.filer.filer import Filer, MetaEvent
from seaweedfs_tpu_torch.filer.store import EntryNotFound, FilerStore, make_store
from seaweedfs_tpu_torch.pb import FILER_SERVICE
from seaweedfs_tpu_torch.security import tls

import io
import time


class FilerServer:
    def __init__(
        self,
        master_address: str,
        store: Optional[FilerStore] = None,
        port: int = 0,
        grpc_port: int = 0,
        host: str = "127.0.0.1",
        chunk_size: int = DEFAULT_CHUNK_SIZE,
        log_dir: str = "",
        collection: str = "",
        replication: str = "",
        signing_key: Optional[bytes] = None,
        read_signing_key: Optional[bytes] = None,
        chunk_cache_bytes: int = 64 << 20,
    ):
        self.master_address = master_address
        self.master = MasterClient(
            master_address, signing_key=signing_key, read_signing_key=read_signing_key
        )
        from seaweedfs_tpu_torch.utils.chunk_cache import ChunkCache

        # hot-chunk read cache (weed/util/chunk_cache analog): fids are
        # immutable so hits never need validation; deletes evict.
        # chunk_cache_bytes=0 disables it (RAM-constrained deployments).
        cache = ChunkCache(memory_bytes=chunk_cache_bytes) if chunk_cache_bytes else None
        self.chunk_io = ChunkIO(self.master, chunk_size=chunk_size, cache=cache)
        self.filer = Filer(store or make_store("memory"), self.chunk_io, log_dir=log_dir)
        self.collection = collection
        self.replication = replication
        self.host = host
        # per-path storage rules (fs.configure), durable in the store's KV;
        # the live object is Filer.path_conf — enforcement happens in the
        # Filer core so every surface (gRPC, S3, mount) honors it
        from seaweedfs_tpu_torch.filer.filer_conf import CONF_KEY, FilerConf

        try:
            self.filer.path_conf = FilerConf.from_json(
                self.filer.store.kv_get(CONF_KEY)
            )
        except Exception:  # noqa: BLE001 — corrupt conf must not brick startup
            pass

        self._grpc = rpc.RpcServer(port=grpc_port, host=host)
        self._grpc.add_service(self._build_service())
        self.grpc_port = self._grpc.port

        self._http = _ThreadingHTTPServer((host, port), _Handler)
        tls.maybe_wrap_https(self._http)  # data-path HTTPS when configured
        self._http.filer_server = self
        self.port = self._http.server_address[1]
        self._http_thread = threading.Thread(target=self._http.serve_forever, daemon=True)
        self._stop = threading.Event()
        # the open SubscribeMetadata streams' stop events: stop() ends them
        self._subscribers: set[threading.Event] = set()
        self._subscribers_lock = threading.Lock()
        self._announce_thread = threading.Thread(target=self._announce_loop, daemon=True)

    # -- lifecycle -----------------------------------------------------------

    @property
    def filer_conf(self):
        """Alias of Filer.path_conf — one live rule-set object."""
        return self.filer.path_conf

    @property
    def url(self) -> str:
        return f"{self.host}:{self.port}"

    @property
    def grpc_address(self) -> str:
        return f"{self.host}:{self.grpc_port}"

    def start(self) -> None:
        self._grpc.start()
        self._http_thread.start()
        self._announce_thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._subscribers_lock:
            for ev in self._subscribers:
                ev.set()
        self._http.shutdown()
        self._http.server_close()
        self._grpc.stop()
        self.master.close()
        self.filer.close()

    def _announce_loop(self) -> None:
        """Register with the master cluster-node list so shells/mounts
        can discover filers (master_grpc_server_cluster.go analog)."""
        req = {"http_address": self.url, "grpc_address": self.grpc_address}
        while True:
            try:
                self.master.master_call("FilerHeartbeat", req, timeout=5)
            except Exception:  # noqa: BLE001 — master down; retry
                pass
            if self._stop.wait(5.0):
                return

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- upload/read helpers shared by HTTP and gateways ----------------------

    def write_file(
        self,
        path: str,
        reader,
        mime: str = "",
        mode: int = 0o660,
        collection: str = "",
        replication: str = "",
        ttl: str = "",
        extended: Optional[dict] = None,
        o_excl: bool = False,
    ) -> Entry:
        # per-path rules (fs.configure / filer_conf.go): explicit request
        # values win, then the longest-prefix rule, then the per-bucket
        # collection (objects under /buckets/<name>/ land in collection
        # <name>, so deleting a bucket is an O(volumes) collection drop),
        # then server defaults
        rule = self.filer_conf.match(path)
        if rule is not None:
            if rule.read_only:
                raise PermissionError(
                    f"{rule.location_prefix} is read-only (fs.configure)"
                )
            collection = collection or rule.collection
            replication = replication or rule.replication
            ttl = ttl or rule.ttl
        if not collection and path.startswith("/buckets/"):
            segs = path[len("/buckets/"):].split("/")
            # multipart parts stage under /buckets/.uploads/<bucket>/…:
            # they must land in the BUCKET's collection (Complete splices
            # these very fids into the final object) or the per-bucket
            # collection drop would never reclaim multipart objects
            if segs[0] == ".uploads" and len(segs) > 1:
                segs = segs[1:]
            if segs[0] and not segs[0].startswith("."):
                collection = segs[0]
        collection = collection or self.collection
        replication = replication or self.replication
        chunks, size, md5hex = self.chunk_io.upload_stream(
            reader, collection=collection, replication=replication, ttl=ttl
        )
        chunks = self.chunk_io.maybe_manifestize(
            chunks, collection=collection, replication=replication, ttl=ttl
        )
        ttl_sec = 0
        if ttl:
            from seaweedfs_tpu_torch.storage.super_block import TTL

            ttl_sec = TTL.parse(ttl).minutes() * 60
        entry = Entry(
            path=path,
            is_directory=False,
            attributes=Attributes(
                mtime=time.time(),
                mode=mode,
                mime=mime,
                collection=collection,
                replication=replication,
                ttl_sec=ttl_sec,
                md5=md5hex,
                file_size=size,
            ),
            chunks=chunks,
            extended=dict(extended or {}),
        )
        return self.filer.create_entry(entry, o_excl=o_excl)

    def read_file(self, entry: Entry) -> bytes:
        return self.chunk_io.read_all(entry.chunks)

    # -- RPC service ---------------------------------------------------------

    def _build_service(self) -> rpc.Service:
        svc = rpc.Service(FILER_SERVICE)
        add = svc.add
        add("LookupDirectoryEntry", self._rpc_lookup)
        add("ListEntries", self._rpc_list)
        add("CreateEntry", self._rpc_create)
        add("UpdateEntry", self._rpc_update)
        add("DeleteEntry", self._rpc_delete)
        add("AtomicRenameEntry", self._rpc_rename)
        add("Statistics", self._rpc_statistics)
        add("KvGet", self._rpc_kv_get)
        add("KvPut", self._rpc_kv_put)
        add("ReadFile", self._rpc_read_file, kind="unary_stream", resp_format="bytes")
        add("ReadFileRange", self._rpc_read_file_range, kind="unary_stream", resp_format="bytes")
        add("SubscribeMetadata", self._rpc_subscribe, kind="unary_stream", resp_format="json")
        add("GetFilerConfiguration", self._rpc_configuration)
        add("GetFilerConf", self._rpc_get_filer_conf)
        add("SetFilerConf", self._rpc_set_filer_conf)
        add("DeleteCollection", self._rpc_delete_collection)
        return svc

    def _rpc_delete_collection(self, req: dict, ctx) -> dict:
        """Forward a collection drop to the master (the reference's filer
        DeleteCollection does the same) — gateways only ever talk to the
        filer, so bucket deletion reclaims volumes through this hop.

        Collision guard: a collection name also serving as the filer's
        default collection, or pinned to a NON-bucket prefix by an
        fs.configure rule, holds data that is not the bucket's — dropping
        its volumes would destroy it. Refuse instead of guessing."""
        collection = req.get("collection", "")
        if collection and collection == self.collection:
            raise rpc.RpcFault(
                f"collection {collection!r} is this filer's default collection",
                grpc.StatusCode.FAILED_PRECONDITION,
            )
        for rule in self.filer_conf.rules:
            if rule.collection == collection and not rule.location_prefix.startswith(
                f"/buckets/{collection}/"
            ):
                raise rpc.RpcFault(
                    f"collection {collection!r} is mapped to "
                    f"{rule.location_prefix!r} by fs.configure",
                    grpc.StatusCode.FAILED_PRECONDITION,
                )
        return self.master.master_call("CollectionDelete", {"collection": collection})

    def _rpc_get_filer_conf(self, req: dict, ctx) -> dict:
        return {"rules": [r.to_dict() for r in self.filer_conf.rules]}

    def _rpc_set_filer_conf(self, req: dict, ctx) -> dict:
        """Upsert or delete one per-path rule (fs.configure analog); the
        whole rule set persists in the store KV so it survives restarts."""
        from seaweedfs_tpu_torch.filer.filer_conf import CONF_KEY, PathConf

        prefix = req.get("location_prefix", "")
        if not prefix.startswith("/"):
            raise rpc.RpcFault(
                f"location_prefix must be absolute, got {prefix!r}",
                grpc.StatusCode.INVALID_ARGUMENT,
            )
        if req.get("delete"):
            found = self.filer_conf.delete(prefix)
            if not found:
                raise rpc.NotFoundFault(f"no rule for {prefix!r}")
        else:
            if req.get("replication"):
                from seaweedfs_tpu_torch.storage.super_block import ReplicaPlacement

                ReplicaPlacement.parse(req["replication"])  # validate early
            if req.get("ttl"):
                from seaweedfs_tpu_torch.storage.super_block import TTL

                TTL.parse(req["ttl"])
            self.filer_conf.upsert(
                PathConf(
                    location_prefix=prefix,
                    collection=req.get("collection", ""),
                    replication=req.get("replication", ""),
                    ttl=req.get("ttl", ""),
                    read_only=bool(req.get("read_only", False)),
                )
            )
        self.filer.store.kv_put(CONF_KEY, self.filer_conf.to_json())
        return {"rules": [r.to_dict() for r in self.filer_conf.rules]}

    def _rpc_lookup(self, req: dict, ctx) -> dict:
        try:
            e = self.filer.find_entry(req["path"])
        except EntryNotFound:
            raise rpc.NotFoundFault(f"{req['path']} not found")
        return {"entry": e.to_dict()}

    def _rpc_list(self, req: dict, ctx) -> dict:
        entries = self.filer.list_entries(
            req["directory"],
            start_from=req.get("start_from", ""),
            include_start=bool(req.get("inclusive_start_from", False)),
            limit=int(req.get("limit") or 1024),
            prefix=req.get("prefix", ""),
        )
        return {"entries": [e.to_dict() for e in entries]}

    def _rpc_create(self, req: dict, ctx) -> dict:
        entry = Entry.from_dict(req["entry"])
        try:
            self.filer.create_entry(entry, o_excl=bool(req.get("o_excl", False)))
        except PermissionError as e:  # fs.configure read-only prefix
            raise rpc.RpcFault(str(e), grpc.StatusCode.PERMISSION_DENIED)
        except FileExistsError:
            raise rpc.RpcFault(f"{entry.path} exists", grpc.StatusCode.ALREADY_EXISTS)
        except IsADirectoryError:
            raise rpc.RpcFault(
                f"{entry.path} is a directory", grpc.StatusCode.FAILED_PRECONDITION
            )
        return {}

    def _rpc_update(self, req: dict, ctx) -> dict:
        entry = Entry.from_dict(req["entry"])
        try:
            self.filer.update_entry(entry)
        except PermissionError as e:  # fs.configure read-only prefix
            raise rpc.RpcFault(str(e), grpc.StatusCode.PERMISSION_DENIED)
        except EntryNotFound:
            raise rpc.NotFoundFault(f"{entry.path} not found")
        return {}

    def _rpc_delete(self, req: dict, ctx) -> dict:
        try:
            self.filer.delete_entry(
                req["path"],
                recursive=bool(req.get("is_recursive", False)),
                ignore_recursive_error=bool(req.get("ignore_recursive_error", False)),
                delete_chunks=bool(req.get("is_delete_data", True)),
            )
        except PermissionError as e:  # fs.configure read-only prefix
            raise rpc.RpcFault(str(e), grpc.StatusCode.PERMISSION_DENIED)
        except EntryNotFound:
            raise rpc.NotFoundFault(f"{req['path']} not found")
        except OSError as e:
            raise rpc.RpcFault(str(e))
        return {}

    def _rpc_rename(self, req: dict, ctx) -> dict:
        try:
            self.filer.rename(req["old_path"], req["new_path"])
        except PermissionError as e:  # fs.configure read-only prefix
            raise rpc.RpcFault(str(e), grpc.StatusCode.PERMISSION_DENIED)
        except EntryNotFound:
            raise rpc.NotFoundFault(f"{req['old_path']} not found")
        except IsADirectoryError:
            raise rpc.RpcFault(
                f"{req['new_path']} is a directory", grpc.StatusCode.FAILED_PRECONDITION
            )
        return {}

    def _rpc_statistics(self, req: dict, ctx) -> dict:
        return self.master.statistics()

    def _rpc_kv_get(self, req: dict, ctx) -> dict:
        v = self.filer.store.kv_get(req["key"])
        if v is None:
            raise rpc.NotFoundFault(f"key {req['key']} not found")
        import base64

        return {"value": base64.b64encode(v).decode()}

    def _rpc_kv_put(self, req: dict, ctx) -> dict:
        import base64

        self.filer.store.kv_put(req["key"], base64.b64decode(req["value"]))
        return {}

    def _rpc_read_file(self, req: dict, ctx):
        try:
            e = self.filer.find_entry(req["path"])
        except EntryNotFound:
            raise rpc.NotFoundFault(f"{req['path']} not found")
        yield from self.chunk_io.stream_all(e.chunks)

    def _rpc_read_file_range(self, req: dict, ctx):
        """Random-access read for mount clients: only overlapping chunks
        are fetched (ChunkIO.read_range)."""
        try:
            e = self.filer.find_entry(req["path"])
        except EntryNotFound:
            raise rpc.NotFoundFault(f"{req['path']} not found")
        offset = int(req.get("offset", 0))
        size = int(req.get("size", 0))
        size = max(0, min(size, e.size - offset))
        if size > 0:
            yield self.chunk_io.read_range(e.chunks, offset, size)

    def _rpc_configuration(self, req: dict, ctx) -> dict:
        """Mount/sync clients discover the cluster through the filer, as
        the reference's GetFilerConfiguration does."""
        return {
            "masters": [self.master_address],
            "chunk_size": self.chunk_io.chunk_size,
            "collection": self.collection,
            "replication": self.replication,
        }

    def _rpc_subscribe(self, req: dict, ctx):
        """Stream MetaEvents since ts_ns; ends when the client cancels
        (gRPC termination callback sets `stop`), after `max_idle_s`
        without events, or when the server stops, so the handler thread
        never leaks."""
        since = int(req.get("since_ns", 0))
        prefix = req.get("path_prefix", "/")
        idle_limit = float(req.get("max_idle_s", 0) or 0)
        stop = threading.Event()
        ctx.add_callback(stop.set)
        with self._subscribers_lock:
            if self._stop.is_set():
                return
            self._subscribers.add(stop)
        try:
            for ev in self.filer.subscribe(
                since_ns=since, prefix=prefix, stop=stop, idle_timeout=idle_limit
            ):
                yield ev.to_dict()
        finally:
            with self._subscribers_lock:
                self._subscribers.discard(stop)


# -- HTTP --------------------------------------------------------------------


class _ThreadingHTTPServer(httpd.ThreadingHTTPServer):
    filer_server: "FilerServer"


class _Handler(httpd.QuietHandler):
    # a reply's headers and body leave in two writes: with Nagle on, the
    # body waits for the client's delayed ACK of the headers (~40 ms per
    # request on a keep-alive connection), as on the volume server's front
    disable_nagle_algorithm = True

    @property
    def fs(self) -> FilerServer:
        return self.server.filer_server

    def _pq(self) -> tuple[str, dict]:
        u = urllib.parse.urlparse(self.path)
        q = {k: v[0] for k, v in urllib.parse.parse_qs(u.query).items()}
        return urllib.parse.unquote(u.path) or "/", q

    def _reply(self, code: int, body: bytes, ctype="application/octet-stream", headers=None, head=False):
        self.send_reply(code, body, ctype, headers=headers, head=head)

    def _reply_json(self, code: int, obj, head=False):
        self._reply(code, json.dumps(obj).encode(), "application/json", head=head)

    def _serve_get(self, head: bool) -> None:
        stats.FilerRequestCounter.labels("get").inc()
        path, q = self._pq()
        try:
            entry = self.fs.filer.find_entry(path)
        except EntryNotFound:
            self._reply_json(404, {"error": f"{path} not found"}, head=head)
            return
        if entry.is_directory:
            entries = self.fs.filer.list_entries(
                path,
                start_from=q.get("lastFileName", ""),
                limit=httpd.safe_int(q.get("limit"), 1024),
                prefix=q.get("prefix", ""),
            )
            accept = self.headers.get("Accept", "")
            if "text/html" in accept and "application/json" not in accept:
                # browser navigation (filer_ui analog): content-negotiated
                # HTML listing; curl/SDKs keep getting JSON
                limit = httpd.safe_int(q.get("limit"), 1024)
                self._reply_dir_html(path, entries, truncated=len(entries) >= limit, head=head)
                return
            self._reply_json(
                200,
                {
                    "Path": path,
                    "Entries": [e.to_dict() for e in entries],
                    "LastFileName": entries[-1].name if entries else "",
                },
                head=head,
            )
            return
        mime = entry.attributes.mime or "application/octet-stream"
        etag = etag_of(entry.chunks, entry.attributes.md5)
        base_headers = {
            "ETag": f'"{etag}"',
            "Last-Modified": time.strftime(
                "%a, %d %b %Y %H:%M:%S GMT", time.gmtime(entry.attributes.mtime)
            ),
            "Accept-Ranges": "bytes",
            **{k: v for k, v in entry.extended.items() if k.lower().startswith("x-")},
        }
        if head:
            base_headers["Content-Length"] = str(entry.size)
            self.send_response(200)
            self.send_header("Content-Type", mime)
            for k, v in base_headers.items():
                self.send_header(k, v)
            self.end_headers()
            return
        rng = self.headers.get("Range", "")
        if rng.startswith("bytes="):
            try:
                lo_s, hi_s = rng[len("bytes=") :].split("-", 1)
                size = entry.size
                if lo_s == "":  # suffix range: last N bytes
                    n = int(hi_s)
                    lo, hi = max(0, size - n), size - 1
                else:
                    lo = int(lo_s)
                    hi = int(hi_s) if hi_s else size - 1
                hi = min(hi, size - 1)
                if lo > hi or lo >= size:
                    self._reply_json(416, {"error": "bad range"})
                    return
                body = self.fs.chunk_io.read_range(entry.chunks, lo, hi - lo + 1)
                base_headers["Content-Range"] = f"bytes {lo}-{hi}/{size}"
                self._reply(206, body, mime, headers=base_headers)
                return
            except ValueError:
                pass
        body = self.fs.read_file(entry)
        self._reply(200, body, mime, headers=base_headers)

    def _reply_dir_html(self, path, entries, truncated: bool, head: bool) -> None:
        """HTML directory listing for browsers (filer_ui analog). Every
        name is escaped AND percent-encoded in hrefs: entry names arrive
        from arbitrary writers and render/navigate in a browser."""
        import urllib.parse as _up
        from html import escape as _esc

        crumbs, acc = ['<a href="/">/</a>'], ""
        for seg in [s for s in path.split("/") if s]:
            acc += "/" + seg
            crumbs.append(
                f'<a href="{_esc(_up.quote(acc))}/">{_esc(seg)}</a>'
            )
        rows = []
        for e in entries:
            href = _esc(_up.quote(e.path)) + ("/" if e.is_directory else "")
            name = _esc(e.name) + ("/" if e.is_directory else "")
            size = "" if e.is_directory else str(e.size)
            mtime = time.strftime(
                "%Y-%m-%d %H:%M", time.gmtime(e.attributes.mtime)
            )
            rows.append(
                f'<tr><td><a href="{href}">{name}</a></td>'
                f"<td>{size}</td><td>{mtime}</td></tr>"
            )
        more = ""
        if truncated and entries:
            nxt = _esc(
                _up.quote(path) + "?lastFileName=" + _up.quote(entries[-1].name)
            )
            more = f' &middot; <a href="{nxt}">next page &raquo;</a>'
        count = (
            f"first {len(entries)} entries" if truncated else f"{len(entries)} entries"
        )
        html = (
            "<!DOCTYPE html><html><head><title>weedtpu filer</title>"
            "<style>body{font-family:monospace}table{border-collapse:collapse}"
            "td,th{border:1px solid #999;padding:2px 8px}</style></head><body>"
            f"<h1>{' '.join(crumbs)}</h1>"
            "<table><tr><th>name</th><th>size</th><th>modified</th></tr>"
            f"{''.join(rows)}</table>"
            f"<p>{count} &middot; "
            f"store {_esc(self.fs.filer.store.name)} &middot; "
            f'<a href="/metrics">/metrics</a>{more}</p></body></html>'
        )
        self.send_reply(200, html.encode(), "text/html; charset=utf-8", head=head)

    def do_GET(self):
        self._serve_get(head=False)

    def do_HEAD(self):
        self._serve_get(head=True)

    def do_PUT(self):
        stats.FilerRequestCounter.labels("put").inc()
        path, q = self._pq()
        if "mv.from" in q:
            try:
                self.fs.filer.rename(q["mv.from"], path)
            except EntryNotFound:
                self._reply_json(404, {"error": f"{q['mv.from']} not found"})
                return
            except IsADirectoryError:
                self._reply_json(409, {"error": f"{path} is a directory"})
                return
            self._reply_json(200, {"path": path})
            return
        if path.endswith("/") or q.get("op") == "mkdir":
            self.fs.filer.mkdirs(path.rstrip("/") or "/")
            self._reply_json(201, {"path": path})
            return
        body = self.read_body()
        if body is None:
            self.reply_length_required()
            return
        extended = {
            k: v for k, v in self.headers.items() if k.lower().startswith("x-amz-")
        }
        try:
            entry = self.fs.write_file(
                path,
                io.BytesIO(body),
                mime=self.headers.get("Content-Type", ""),
                collection=q.get("collection", ""),
                replication=q.get("replication", ""),
                ttl=q.get("ttl", ""),
                extended=extended,
            )
        except IsADirectoryError:
            self._reply_json(409, {"error": f"{path} is a directory"})
            return
        except PermissionError as e:  # fs.configure read-only prefix
            self._reply_json(403, {"error": str(e)})
            return
        except Exception as e:  # noqa: BLE001 — e.g. no writable volumes:
            # answer 500 instead of killing the keep-alive connection
            self._reply_json(500, {"error": f"{type(e).__name__}: {e}"})
            return
        self._reply_json(
            201,
            {
                "name": entry.name,
                "size": entry.size,
                "etag": etag_of(entry.chunks, entry.attributes.md5),
            },
        )

    do_POST = do_PUT

    def do_DELETE(self):
        stats.FilerRequestCounter.labels("delete").inc()
        path, q = self._pq()
        try:
            self.fs.filer.delete_entry(
                path,
                recursive=q.get("recursive") == "true",
                ignore_recursive_error=q.get("ignoreRecursiveError") == "true",
            )
        except PermissionError as e:  # fs.configure read-only prefix
            self._reply_json(403, {"error": str(e)})
            return
        except EntryNotFound:
            self._reply_json(404, {"error": f"{path} not found"})
            return
        except OSError as e:
            self._reply_json(409, {"error": str(e)})
            return
        self.send_reply(204)
