"""WebDAV server on the filer — weed/server/webdav_server.go analog.
See package docstring for the supported method set."""

from __future__ import annotations

import posixpath
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from typing import Optional

from seaweedfs_tpu_torch.filer.client import FilerClient
from seaweedfs_tpu_torch.filer.entry import Entry
from seaweedfs_tpu_torch.utils import httpd
from seaweedfs_tpu_torch.security import tls

_DAV = "DAV:"


class WebDavServer:
    def __init__(
        self,
        filer_http_address: str,
        filer_grpc_address: str,
        port: int = 0,
        host: str = "127.0.0.1",
        root: str = "/",
    ):
        self.filer_http = filer_http_address
        self.filer = FilerClient(filer_grpc_address)
        self.root = root.rstrip("/") or ""
        self.host = host
        # class-2 write locks (RFC 4918 §6): path -> (token, owner, expiry).
        # Exclusive, depth-infinity: a collection lock protects its internal
        # members (enforced via lock_covering), and a member lock blocks
        # collection-level ops (lock_under) — what Finder, Windows, and
        # Office demand before they will mount read-write.
        self._locks: dict[str, tuple[str, str, float]] = {}
        self._locks_mu = threading.Lock()
        self._http = _ThreadingHTTPServer((host, port), _Handler)
        tls.maybe_wrap_https(self._http)  # data-path HTTPS when configured
        self._http.dav_server = self
        self.port = self._http.server_address[1]
        self._thread = threading.Thread(target=self._http.serve_forever, daemon=True)

    @property
    def url(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._http.shutdown()
        self._http.server_close()
        self.filer.close()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    def fpath(self, dav_path: str) -> str:
        p = posixpath.normpath("/" + dav_path.lstrip("/"))
        return (self.root + p) if p != "/" else (self.root or "/")

    # -- lock table -----------------------------------------------------------

    DEFAULT_LOCK_S = 600.0
    MAX_LOCK_S = 3600.0

    def lock_of(self, path: str):
        """(token, owner, expiry) or None; expired entries are dropped."""
        with self._locks_mu:
            entry = self._locks.get(path)
            if entry is not None and entry[2] < time.time():
                del self._locks[path]
                entry = None
            return entry

    def lock_under(self, path: str):
        """Any live lock AT or UNDER `path` (collection ops must honor
        child locks). Returns (locked_path, token) or None."""
        prefix = path.rstrip("/") + "/"
        now = time.time()
        with self._locks_mu:
            for p, (tok, _owner, exp) in list(self._locks.items()):
                if exp < now:
                    del self._locks[p]
                    continue
                if p == path or p.startswith(prefix):
                    return p, tok
            return None

    def lock_covering(self, path: str):
        """Any live lock at `path` or at an ANCESTOR of it (RFC 4918 §7:
        a write lock on a collection protects internal member creation,
        modification, and removal). Returns (locked_path, token) or None."""
        now = time.time()
        with self._locks_mu:
            cur = path.rstrip("/") or "/"
            while True:
                entry = self._locks.get(cur)
                if entry is not None:
                    if entry[2] < now:
                        del self._locks[cur]
                    else:
                        return cur, entry[0]
                if cur == "/" or "/" not in cur:
                    return None
                cur = cur.rsplit("/", 1)[0] or "/"

    def clear_under(self, path: str) -> None:
        """Drop every lock entry at/under `path` (the resources are gone —
        stale entries would 423-block whoever recreates the paths)."""
        prefix = path.rstrip("/") + "/"
        with self._locks_mu:
            for p in list(self._locks):
                if p == path or p.startswith(prefix):
                    del self._locks[p]

    def acquire_lock(self, path: str, owner: str, seconds: float, token: str = ""):
        """Grant (or refresh when `token` matches) the exclusive lock.
        Returns (token, seconds) or None when someone else holds it."""
        seconds = min(max(seconds, 1.0), self.MAX_LOCK_S)
        now = time.time()
        with self._locks_mu:
            # opportunistic sweep: expired entries must not accumulate for
            # the life of the gateway (clients lock every file they write)
            for p in [p for p, e in self._locks.items() if e[2] < now]:
                del self._locks[p]
            cur = self._locks.get(path)
            if cur is not None and cur[2] >= time.time() and cur[0] != token:
                return None
            if not token or cur is None or cur[0] != token:
                import uuid

                token = f"opaquelocktoken:{uuid.uuid4()}"
                owner = owner or (cur[1] if cur else "")
            else:
                owner = cur[1]
            self._locks[path] = (token, owner, time.time() + seconds)
            return token, seconds

    def release_lock(self, path: str, token: str) -> bool:
        with self._locks_mu:
            cur = self._locks.get(path)
            if cur is None or cur[0] != token:
                return False
            del self._locks[path]
            return True

    def filer_url(self, path: str) -> str:
        return f"{tls.scheme()}://{self.filer_http}{urllib.parse.quote(path)}"


class _ThreadingHTTPServer(httpd.ThreadingHTTPServer):
    dav_server: "WebDavServer"


def _http_date(ts: float) -> str:
    return time.strftime("%a, %d %b %Y %H:%M:%S GMT", time.gmtime(ts))


class _Handler(httpd.QuietHandler):
    # headers and body leave in two writes: with Nagle on, the body waits
    # for the client's delayed ACK (~40 ms per small reply on a keep-alive
    # connection), as on the filer's and the volume server's fronts
    disable_nagle_algorithm = True

    @property
    def dav(self) -> WebDavServer:
        return self.server.dav_server

    def _path(self) -> str:
        return urllib.parse.unquote(urllib.parse.urlparse(self.path).path) or "/"

    def _reply(self, code: int, body: bytes = b"", ctype="text/xml; charset=utf-8", headers=None):
        self.send_reply(code, body, ctype, headers=headers)

    # -- methods --------------------------------------------------------------

    # -- locking (RFC 4918 class 2) -------------------------------------------

    def _submitted_token(self) -> str:
        """Lock token from the If / Lock-Token headers (either form)."""
        import re as _re

        for h in (self.headers.get("If", ""), self.headers.get("Lock-Token", "")):
            m = _re.search(r"<(opaquelocktoken:[^>]+)>", h)
            if m:
                return m.group(1)
        return ""

    def _check_lock(self, path: str) -> bool:
        """True when `path` is writable by this request: unlocked, or the
        request submitted the covering lock's token. Both directions are
        enforced — a child lock blocks collection ops (lock_under), and a
        collection lock blocks tokenless writes to its members
        (lock_covering). Replies 423 otherwise."""
        hit = self.dav.lock_under(path) or self.dav.lock_covering(path)
        if hit is None or self._submitted_token() == hit[1]:
            return True
        self._reply(423, b"<?xml version=\"1.0\"?><D:error xmlns:D=\"DAV:\"/>")
        return False

    def _lock_seconds(self) -> float:
        t = self.headers.get("Timeout", "")
        for part in t.split(","):
            part = part.strip()
            if part.lower().startswith("second-"):
                try:
                    return float(part[len("second-"):])
                except ValueError:
                    break
        return self.dav.DEFAULT_LOCK_S

    def do_LOCK(self):
        path = self.dav.fpath(self._path())
        body = self.read_body()
        if body is None:  # chunked encoding: unread bytes would desync keep-alive
            self.reply_length_required()
            return
        owner = ""
        if body:
            try:
                root = ET.fromstring(body)
                o = root.find(f"{{{_DAV}}}owner")
                if o is not None:
                    owner = "".join(o.itertext()).strip()
            except ET.ParseError:
                self._reply(400, b"bad lockinfo")
                return
        token = "" if body else self._submitted_token()  # empty body = refresh
        # depth-infinity exclusivity: a new lock is refused while a DIFFERENT
        # lock exists anywhere on the path's subtree or its ancestors —
        # otherwise a child lock would tunnel through a collection lock
        conflict = self.dav.lock_under(path) or self.dav.lock_covering(path)
        if conflict is not None and conflict[1] != (token or self._submitted_token()):
            self._reply(423, b"<?xml version=\"1.0\"?><D:error xmlns:D=\"DAV:\"/>")
            return
        granted = self.dav.acquire_lock(path, owner, self._lock_seconds(), token=token)
        if granted is None:
            self._reply(423, b"<?xml version=\"1.0\"?><D:error xmlns:D=\"DAV:\"/>")
            return
        token, seconds = granted
        prop = ET.Element(f"{{{_DAV}}}prop")
        ld = ET.SubElement(prop, f"{{{_DAV}}}lockdiscovery")
        al = ET.SubElement(ld, f"{{{_DAV}}}activelock")
        ET.SubElement(ET.SubElement(al, f"{{{_DAV}}}locktype"), f"{{{_DAV}}}write")
        ET.SubElement(ET.SubElement(al, f"{{{_DAV}}}lockscope"), f"{{{_DAV}}}exclusive")
        ET.SubElement(al, f"{{{_DAV}}}depth").text = "infinity"
        if owner:
            ET.SubElement(al, f"{{{_DAV}}}owner").text = owner
        ET.SubElement(al, f"{{{_DAV}}}timeout").text = f"Second-{int(seconds)}"
        ET.SubElement(
            ET.SubElement(al, f"{{{_DAV}}}locktoken"), f"{{{_DAV}}}href"
        ).text = token
        out = ET.tostring(prop, xml_declaration=True, encoding="unicode").encode()
        self._reply(200, out, headers={"Lock-Token": f"<{token}>"})

    def do_UNLOCK(self):
        path = self.dav.fpath(self._path())
        if self.dav.release_lock(path, self._submitted_token()):
            self._reply(204)
        else:
            self._reply(409, b"no such lock")

    def do_OPTIONS(self):
        self._reply(
            200,
            headers={
                "DAV": "1,2",
                "Allow": "OPTIONS, PROPFIND, MKCOL, GET, HEAD, PUT, DELETE, "
                         "MOVE, COPY, LOCK, UNLOCK",
                "MS-Author-Via": "DAV",
            },
        )

    def _prop_response(self, ms: ET.Element, dav_path: str, entry: Entry) -> None:
        resp = ET.SubElement(ms, f"{{{_DAV}}}response")
        href = ET.SubElement(resp, f"{{{_DAV}}}href")
        href.text = urllib.parse.quote(dav_path + ("/" if entry.is_directory and dav_path != "/" else ""))
        propstat = ET.SubElement(resp, f"{{{_DAV}}}propstat")
        prop = ET.SubElement(propstat, f"{{{_DAV}}}prop")
        ET.SubElement(prop, f"{{{_DAV}}}displayname").text = (
            posixpath.basename(dav_path) or "/"
        )
        ET.SubElement(prop, f"{{{_DAV}}}getlastmodified").text = _http_date(
            entry.attributes.mtime
        )
        rt = ET.SubElement(prop, f"{{{_DAV}}}resourcetype")
        if entry.is_directory:
            ET.SubElement(rt, f"{{{_DAV}}}collection")
        else:
            ET.SubElement(prop, f"{{{_DAV}}}getcontentlength").text = str(entry.size)
            ET.SubElement(prop, f"{{{_DAV}}}getcontenttype").text = (
                entry.attributes.mime or "application/octet-stream"
            )
        status = ET.SubElement(propstat, f"{{{_DAV}}}status")
        status.text = "HTTP/1.1 200 OK"

    def do_PROPFIND(self):
        self.read_body()  # drain; we return the standard prop set regardless
        dav_path = self._path()
        fpath = self.dav.fpath(dav_path)
        entry = self.dav.filer.lookup(fpath)
        if entry is None:
            self._reply(404)
            return
        depth = self.headers.get("Depth", "1")
        ET.register_namespace("D", _DAV)
        ms = ET.Element(f"{{{_DAV}}}multistatus")
        self._prop_response(ms, dav_path, entry)
        if entry.is_directory and depth != "0":
            for child in self.dav.filer.list(fpath, limit=10000):
                self._prop_response(
                    ms, posixpath.join(dav_path, child.name), child
                )
        body = b'<?xml version="1.0" encoding="utf-8"?>\n' + ET.tostring(ms)
        self._reply(207, body)

    def do_MKCOL(self):
        if not self._check_lock(self.dav.fpath(self._path())):
            return
        fpath = self.dav.fpath(self._path())
        if self.dav.filer.lookup(fpath) is not None:
            self._reply(405)
            return
        self.dav.filer.create(Entry(path=fpath, is_directory=True))
        self._reply(201)

    def _serve_get(self, head: bool):
        fpath = self.dav.fpath(self._path())
        entry = self.dav.filer.lookup(fpath)
        if entry is None:
            self._reply(404)
            return
        if entry.is_directory:
            self._reply(405)
            return
        if head:
            self._reply(
                200,
                headers={
                    "Content-Length": str(entry.size),
                    "Last-Modified": _http_date(entry.attributes.mtime),
                },
            )
            return
        fwd = {}
        if self.headers.get("Range"):
            fwd["Range"] = self.headers["Range"]
        try:
            req = urllib.request.Request(self.dav.filer_url(fpath), headers=fwd)
            with tls.urlopen(req, timeout=60) as r:
                body = r.read()
                headers = {"Last-Modified": r.headers.get("Last-Modified", "")}
                if r.headers.get("Content-Range"):
                    headers["Content-Range"] = r.headers["Content-Range"]
                self._reply(
                    r.status, body,
                    r.headers.get("Content-Type", "application/octet-stream"),
                    headers=headers,
                )
        except urllib.error.URLError:
            self._reply(404)

    def do_GET(self):
        self._serve_get(head=False)

    def do_HEAD(self):
        self._serve_get(head=True)

    def do_PUT(self):
        fpath = self.dav.fpath(self._path())
        if not self._check_lock(fpath):
            return
        body = self.read_body()
        if body is None:
            self.reply_length_required()
            return
        req = urllib.request.Request(
            self.dav.filer_url(fpath),
            data=body,
            method="PUT",
            headers={"Content-Type": self.headers.get("Content-Type", "application/octet-stream")},
        )
        try:
            with tls.urlopen(req, timeout=60) as r:
                r.read()
        except urllib.error.URLError as e:
            self._reply(500, str(e).encode(), "text/plain")
            return
        self._reply(201)

    def do_DELETE(self):
        fpath = self.dav.fpath(self._path())
        if not self._check_lock(fpath):
            return
        if self.dav.filer.lookup(fpath) is None:
            self._reply(404)
            return
        self.dav.filer.delete(fpath, recursive=True)
        # RFC 4918: DELETE destroys the locks of everything it removed —
        # stale entries would 423-block whoever recreates the paths. The
        # request already passed _check_lock, so dropping them is safe.
        self.dav.clear_under(fpath)
        self._reply(204)

    def _dest_path(self) -> Optional[str]:
        dest = self.headers.get("Destination", "")
        if not dest:
            return None
        u = urllib.parse.urlparse(dest)
        return self.dav.fpath(urllib.parse.unquote(u.path))

    def do_MOVE(self):
        src = self.dav.fpath(self._path())
        dst = self._dest_path()
        if dst is None:
            self._reply(400)
            return
        if not self._check_lock(src):
            return
        if not self._check_lock(dst):
            return
        if self.dav.filer.lookup(src) is None:
            self._reply(404)
            return
        overwrote = self.dav.filer.lookup(dst) is not None
        if overwrote and self.headers.get("Overwrite", "T") == "F":
            self._reply(412)
            return
        try:
            self.dav.filer.rename(src, dst)
        except (IsADirectoryError, FileNotFoundError):
            self._reply(412)
            return
        # locks are URL-scoped and do not travel with the resource: clear
        # both subtrees so no path carries a stale 423
        self.dav.clear_under(src)
        self.dav.clear_under(dst)
        self._reply(204 if overwrote else 201)

    def do_COPY(self):
        src = self.dav.fpath(self._path())
        dst = self._dest_path()
        if dst is None:
            self._reply(400)
            return
        if not self._check_lock(dst):  # overwriting a locked target
            return
        entry = self.dav.filer.lookup(src)
        if entry is None:
            self._reply(404)
            return
        if entry.is_directory:
            self._reply(501)  # collection COPY not supported (reference parity gap)
            return
        overwrote = self.dav.filer.lookup(dst) is not None
        if overwrote and self.headers.get("Overwrite", "T") == "F":
            self._reply(412)
            return
        try:
            with tls.urlopen(self.dav.filer_url(src), timeout=60) as r:
                data = r.read()
                ctype = r.headers.get("Content-Type", "application/octet-stream")
            req = urllib.request.Request(
                self.dav.filer_url(dst), data=data, method="PUT",
                headers={"Content-Type": ctype},
            )
            with tls.urlopen(req, timeout=60) as r:
                r.read()
        except urllib.error.URLError as e:
            self._reply(500, str(e).encode(), "text/plain")
            return
        self._reply(204 if overwrote else 201)
