"""The port's security package and HTTP plumbing against the reference's:
JWTs byte-equal for the same key, claims and pinned clock, tamper and
expiry, the guard's white list and read key; self-signed material, mTLS RPC
(plaintext and certificate-less clients rejected, reference client to port
server), the HTTPS wrap over `utils/httpd` (deferred handshake, mTLS on the
data path) and the fail-closed configuration; `utils/httpd`'s reply rules.
Modelled on tests/test_security_stats.py and tests/test_tls.py."""

import http.client
import socket
import ssl
import threading
import time
import types
import urllib.request

import grpc
import pytest

from seaweedfs_tpu import rpc as ref_rpc
from seaweedfs_tpu.security import Guard as RefGuard
from seaweedfs_tpu.security import jwt as ref_jwt
from seaweedfs_tpu.security import tls as ref_tls
from seaweedfs_tpu.utils import httpd as ref_httpd
from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.security import Guard, decode_jwt, encode_jwt, jwt, tls
from seaweedfs_tpu_torch.utils import httpd

KEY = b"test-signing-key"
JWTS = {"port": jwt, "ref": ref_jwt}


@pytest.fixture(params=sorted(JWTS))
def jw(request):
    return JWTS[request.param]


# -- jwt ----------------------------------------------------------------------


@pytest.mark.parametrize("claims, expires", [
    ({"fid": "3,0102deadbeef"}, 10), ({"fid": "7,aa11", "x": [1, "é"]}, 0),
    ({}, 3600), ({"fid": "1,ab", "exp": 5}, 60)])
def test_tokens_equal_the_reference_under_a_pinned_clock(monkeypatch, claims, expires):
    clock = types.SimpleNamespace(time=lambda: 1_760_000_000.25)
    for mod in JWTS.values():
        monkeypatch.setattr(mod, "time", clock)
    tok = jwt.encode_jwt(KEY, claims, expires_seconds=expires)
    assert tok == ref_jwt.encode_jwt(KEY, claims, expires_seconds=expires)
    assert jwt.decode_jwt(KEY, tok) == ref_jwt.decode_jwt(KEY, tok)
    assert jwt.mint_file_token(KEY, "9,ff", 30) == ref_jwt.mint_file_token(KEY, "9,ff", 30)
    assert encode_jwt is jwt.encode_jwt and decode_jwt is jwt.decode_jwt


def test_jwt_roundtrip_and_tamper(jw):
    tok = jw.encode_jwt(KEY, {"fid": "3,0102deadbeef"}, expires_seconds=60)
    claims = jw.decode_jwt(KEY, tok)
    assert claims["fid"] == "3,0102deadbeef" and claims["exp"] > time.time()
    with pytest.raises(jw.JwtError, match="bad signature"):
        jw.decode_jwt(b"other-key", tok)
    h, p, s = tok.split(".")
    with pytest.raises(jw.JwtError):
        jw.decode_jwt(KEY, h + "." + p + ".AAAA")
    with pytest.raises(jw.JwtError, match="malformed"):
        jw.decode_jwt(KEY, "not-a-token")
    other = JWTS["ref"] if jw is jwt else jwt  # the other package verifies it too
    assert other.decode_jwt(KEY, tok) == claims


def test_jwt_expiry_and_algorithm(jw):
    tok = jw.encode_jwt(KEY, {"fid": "1,ab"}, expires_seconds=-5)
    with pytest.raises(jw.JwtError, match="expired"):
        jw.decode_jwt(KEY, tok)
    import base64
    import hashlib
    import hmac

    def b64(raw: bytes) -> bytes:
        return base64.urlsafe_b64encode(raw).rstrip(b"=")

    signing = b64(b'{"alg":"none"}') + b"." + b64(b'{"fid":"1,ab"}')
    forged = (signing + b"." + b64(hmac.new(KEY, signing, hashlib.sha256).digest())).decode()
    with pytest.raises(jw.JwtError, match="unsupported alg"):
        jw.decode_jwt(KEY, forged)


def test_file_token_checks(jw):
    tok = jw.mint_file_token(KEY, "7,aa11", expires_seconds=60)
    assert jw.check_file_token(KEY, tok, "7,aa11")
    assert not jw.check_file_token(KEY, tok, "7,aa12")  # other fid
    assert not jw.check_file_token(KEY, "", "7,aa11")  # missing token
    assert not jw.check_file_token(KEY, "garbage", "7,aa11")
    assert jw.check_file_token(None, "", "7,aa11")  # auth disabled
    assert jw.mint_file_token(None, "7,aa11") == ""


@pytest.mark.parametrize("G", [Guard, RefGuard], ids=["port", "ref"])
def test_guard_white_list_and_read_key(G):
    g = G(signing_key=KEY, white_list=["10.0.0.9"])
    assert g.secured
    assert g.check_write("1,ab", "", remote_ip="10.0.0.9")
    assert not g.check_write("1,ab", "", remote_ip="10.0.0.7")
    tok = jwt.mint_file_token(KEY, "1,ab", 60)
    for header in (f"Bearer {tok}", f"BEAR {tok}", tok, f"  {tok} "):
        assert g.check_write("1,ab", header, remote_ip="10.0.0.7"), header
    assert not g.check_write("1,ac", f"Bearer {tok}")
    assert g.check_read("1,ab", "")  # no read key: reads are open
    # whitelist-ONLY mode must deny non-members, not degrade to auth-off
    g2 = G(white_list=["10.0.0.9"])
    assert g2.secured
    assert g2.check_write("1,ab", "", remote_ip="10.0.0.9")
    assert not g2.check_write("1,ab", "", remote_ip="10.0.0.7")
    g3 = G(read_signing_key=b"read-key", white_list=["10.0.0.9"])
    assert not g3.check_read("1,ab", "", remote_ip="10.0.0.7")
    assert g3.check_read("1,ab", "", remote_ip="10.0.0.9")
    assert g3.check_read("1,ab", "Bearer " + jwt.mint_file_token(b"read-key", "1,ab", 60))
    assert not G().secured and G().check_write("1,ab", "")


# -- httpd --------------------------------------------------------------------


@pytest.mark.parametrize("value, default", [("12", 0), (None, 7), ("x", -1), (3.9, 0), ("", 5)])
def test_safe_int(value, default):
    assert httpd.safe_int(value, default) == ref_httpd.safe_int(value, default)


@pytest.mark.parametrize("host", ["127.0.0.1", "localhost", "::1", "10.1.2.3", "0.0.0.0"])
def test_loopback_aliases(host):
    assert httpd.loopback_aliases(host) == ref_httpd.loopback_aliases(host)


class _Handler(httpd.QuietHandler):
    def do_GET(self):  # noqa: N802
        if self.path == "/status":
            self.send_reply(200, b'{"ok": true}', "application/json", {"X-Test": "1"})
        else:
            self.send_reply(204, b"dropped")

    def do_HEAD(self):  # noqa: N802
        self.send_reply(200, ctype="text/plain", headers={"Content-Length": "42"}, head=True)

    def do_PUT(self):  # noqa: N802
        body = self.read_body()
        if body is None:
            self.reply_length_required()
        else:
            self.send_reply(201, body[::-1])


@pytest.fixture
def http_server():
    srv = httpd.ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    tls.maybe_wrap_https(srv)  # a no-op unless https is configured
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield srv
    srv.shutdown()
    srv.server_close()


def test_httpd_reply_rules(http_server):
    host, port = http_server.server_address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=10)
    conn.request("GET", "/status")
    r = conn.getresponse()
    assert (r.status, r.read(), r.headers["X-Test"]) == (200, b'{"ok": true}', "1")
    conn.request("GET", "/other")  # a 204 carries no body, keep-alive survives
    r = conn.getresponse()
    assert (r.status, r.read()) == (204, b"")
    conn.request("HEAD", "/x")
    r = conn.getresponse()
    assert (r.status, r.headers["Content-Length"], r.read()) == (200, "42", b"")
    conn.request("PUT", "/x", body=b"abc")
    r = conn.getresponse()
    assert (r.status, r.read()) == (201, b"cba")
    conn.putrequest("PUT", "/x")
    conn.putheader("Transfer-Encoding", "chunked")
    conn.endheaders()
    conn.send(b"3\r\nabc\r\n0\r\n\r\n")
    r = conn.getresponse()
    assert r.status == 411
    conn.close()


# -- TLS ----------------------------------------------------------------------

@pytest.fixture()
def certs(tmp_path):
    pytest.importorskip("cryptography", reason="cryptography not installed")
    paths = tls.generate_self_signed(str(tmp_path / "certs"))
    yield paths
    tls.reset()
    ref_tls.reset()


def _configure(certs, **kw):
    for mod in (tls, ref_tls):
        mod.configure(certs["ca"], certs["cert"], certs["key"],
                      override_authority="weedtpu-cluster", **kw)


def _echo_server(mod):
    server = mod.RpcServer(port=0)
    svc = mod.Service("weedtpu.Test")
    svc.add("Echo", lambda req, ctx: {"echo": req.get("x")})
    server.add_service(svc)
    server.start()
    return server


def test_generate_self_signed_material(certs):
    for p in certs.values():
        with open(p, "rb") as f:
            assert b"BEGIN" in f.read()
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(certs["cert"], certs["key"])  # the key matches the leaf
    ctx.load_verify_locations(certs["ca"])


def test_rpc_over_mtls_and_plaintext_rejected(certs):
    _configure(certs)
    assert tls.enabled() and tls.scheme() == "http"  # https not asked for
    server = _echo_server(rpc)
    try:
        with rpc.RpcClient(f"127.0.0.1:{server.port}") as c:
            assert c.call("weedtpu.Test", "Echo", {"x": 42}, timeout=10) == {"echo": 42}
        with ref_rpc.RpcClient(f"127.0.0.1:{server.port}") as c:  # the reference's client
            assert c.call("weedtpu.Test", "Echo", {"x": 43}, timeout=10) == {"echo": 43}
        tls.reset()  # a plaintext client must NOT get through a TLS server
        with rpc.RpcClient(f"127.0.0.1:{server.port}") as c:
            with pytest.raises(grpc.RpcError):
                c.call("weedtpu.Test", "Echo", {"x": 1}, timeout=3)
    finally:
        server.stop()


def test_mtls_rejects_unauthenticated_client(certs):
    _configure(certs)
    server = _echo_server(rpc)
    try:
        with open(certs["ca"], "rb") as f:
            creds = grpc.ssl_channel_credentials(root_certificates=f.read())
        ch = grpc.secure_channel(f"127.0.0.1:{server.port}", creds,
                                 options=[("grpc.ssl_target_name_override", "weedtpu-cluster")])
        stub = ch.unary_unary("/weedtpu.Test/Echo", request_serializer=lambda o: b"{}",
                              response_deserializer=lambda b: b)
        with pytest.raises(grpc.RpcError):
            stub({}, timeout=3)
        ch.close()
    finally:
        server.stop()


def test_port_client_to_reference_mtls_server(certs):
    _configure(certs)
    server = _echo_server(ref_rpc)
    try:
        with rpc.RpcClient(f"127.0.0.1:{server.port}") as c:
            assert c.call("weedtpu.Test", "Echo", {"x": "tls"}, timeout=10) == {"echo": "tls"}
    finally:
        server.stop()


def _client_ctx(certs, with_cert: bool = True) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.load_verify_locations(certs["ca"])
    if with_cert:
        ctx.load_cert_chain(certs["cert"], certs["key"])
    ctx.check_hostname = False
    return ctx


def test_https_wrap_serves_tls_and_defers_the_handshake(certs):
    _configure(certs, https=True)
    assert tls.https_enabled() and tls.scheme() == "https"
    srv = httpd.ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    tls.maybe_wrap_https(srv)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    host, port = srv.server_address[:2]
    try:
        probe = socket.create_connection((host, port), timeout=5)  # never handshakes
        try:
            t0 = time.monotonic()
            with tls.urlopen(f"https://{host}:{port}/status", timeout=10) as r:
                assert (r.status, r.read()) == (200, b'{"ok": true}')
            with urllib.request.urlopen(f"https://{host}:{port}/status", timeout=10,
                                        context=_client_ctx(certs)) as r:
                assert r.status == 200
            assert time.monotonic() - t0 < 5, "the probe blocked the accept loop"
        finally:
            probe.close()
        with pytest.raises(Exception):  # plain HTTP against the TLS socket
            urllib.request.urlopen(f"http://{host}:{port}/status", timeout=3)
        with pytest.raises(Exception):  # require_client_auth: no certificate, no reply
            urllib.request.urlopen(f"https://{host}:{port}/status", timeout=5,
                                   context=_client_ctx(certs, with_cert=False))
    finally:
        srv.shutdown()
        srv.server_close()


def test_urlopen_is_plain_without_https(http_server):
    host, port = http_server.server_address[:2]
    assert tls.scheme() == "http"
    with tls.urlopen(f"http://{host}:{port}/status", timeout=10) as r:
        assert r.read() == b'{"ok": true}'


def test_configure_rejects_bad_material(certs, tmp_path):
    with pytest.raises(ValueError, match="must be set together"):
        tls.configure(certs["ca"], certs["cert"], "")
    with pytest.raises(ValueError, match="ca_file is required"):
        tls.configure("", certs["cert"], certs["key"])
    with pytest.raises(FileNotFoundError):
        tls.configure(str(tmp_path / "nope.crt"), certs["cert"], certs["key"])
    assert not tls.enabled()


def test_configure_from_conf(certs):
    """[https] enabled with no [grpc] ca fails closed, as the reference's."""
    for mod in (tls, ref_tls):
        with pytest.raises(ValueError, match="requires"):
            mod.configure_from_conf({"https": {"enabled": True}})
        assert mod.configure_from_conf({}) is False
    assert tls.configure_from_conf({"grpc": {"ca": certs["ca"], "cert": certs["cert"],
                                             "key": certs["key"],
                                             "require_client_auth": False},
                                    "https": {"enabled": True}})
    assert tls.https_enabled() and tls.channel_options() == []
    assert tls.https_server_context().verify_mode == ssl.CERT_NONE
    assert isinstance(tls.server_credentials(), grpc.ServerCredentials)
    tls.reset()
    assert tls.server_credentials() is None and tls.channel_credentials() is None
    assert tls.https_server_context() is None
