"""Shared HTTP server plumbing for the volume server, master, filer and
gateways (and the port's `/debug/traces` surface): one threading server
class and one base handler, so body-framing and reply rules live in a
single place.
"""

from __future__ import annotations

import functools
import http.server
import socketserver
from typing import Optional


class ThreadingHTTPServer(socketserver.ThreadingMixIn, http.server.HTTPServer):
    daemon_threads = True
    allow_reuse_address = True


class QuietHandler(http.server.BaseHTTPRequestHandler):
    """Base handler: HTTP/1.1, silent access log, safe body read, uniform
    reply writer."""

    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # access log off (reference: glog -v)
        pass

    def read_body(self) -> Optional[bytes]:
        """Request body per Content-Length. Returns None for chunked
        transfer encoding (unsupported — callers must answer 411, not
        silently store an empty body)."""
        if "chunked" in (self.headers.get("Transfer-Encoding") or "").lower():
            return None
        length = int(self.headers.get("Content-Length", 0) or 0)
        return self.rfile.read(length) if length > 0 else b""

    def reply_length_required(self) -> None:
        self.send_reply(411, b"chunked transfer encoding not supported", "text/plain")

    def send_reply(
        self,
        code: int,
        body: bytes = b"",
        ctype: str = "application/octet-stream",
        headers: Optional[dict] = None,
        head: bool = False,
    ) -> None:
        """Write a full response. 204/304 carry no body (RFC 9110; a body
        there desyncs keep-alive clients). `head` sends headers only —
        pass the intended Content-Length via `headers`."""
        headers = dict(headers or {})
        if code in (204, 304):
            body = b""
        self.send_response(code)
        if body or head:
            self.send_header("Content-Type", ctype)
        if "Content-Length" not in headers:
            self.send_header("Content-Length", str(len(body)))
        for k, v in headers.items():
            self.send_header(k, v)
        self.end_headers()
        if body and not head:
            self.wfile.write(body)


def safe_int(value, default: int) -> int:
    """Parse client-supplied ints without letting ValueError kill the
    handler thread."""
    try:
        return int(value)
    except (TypeError, ValueError):
        return default


def loopback_aliases(host: str) -> set[str]:
    """Hostnames clients may legitimately sign for when a server binds
    loopback or a wildcard address — callers append ':port' once the bound
    port is known. Wildcard binds also include the machine's own hostname
    and addresses, so clients reaching the server via its LAN IP or DNS
    name aren't 403'd; deployments behind proxies/LBs still must list
    their advertised names explicitly (extra_hosts / -allowedHosts).
    All names are lower-cased — Host comparison is case-insensitive
    (RFC 9110 §4.2.3)."""
    aliases: set[str] = set()
    if host in ("0.0.0.0", "::", "127.0.0.1", "localhost", "::1"):
        aliases = {"127.0.0.1", "localhost", "[::1]"}
    if host in ("0.0.0.0", "::"):
        aliases |= _self_addresses()
    return {a.lower() for a in aliases}


@functools.lru_cache(maxsize=1)
def _self_addresses() -> frozenset[str]:
    """The machine's own hostname + addresses, resolved once per process —
    getaddrinfo can block for the resolver timeout on hosts with broken
    DNS, and every server constructor calls loopback_aliases."""
    import socket

    found: set[str] = set()
    try:
        name = socket.gethostname()
        found.add(name)
        for info in socket.getaddrinfo(name, None):
            addr = info[4][0]
            found.add(f"[{addr}]" if ":" in addr else addr)
    except OSError:
        pass
    return frozenset(found)
