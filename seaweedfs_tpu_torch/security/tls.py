"""TLS/mTLS for the gRPC control plane + HTTPS for the HTTP data path —
upstream's weed/security/tls.go.

Configuration comes from `security.toml` (like every other key in the
reference's security config), loaded ONCE per process:

    [grpc]
    ca = "/etc/seaweedfs_tpu/ca.crt"          # trust anchor (mTLS)
    cert = "/etc/seaweedfs_tpu/node.crt"      # this process's identity
    key = "/etc/seaweedfs_tpu/node.key"
    require_client_auth = true                # mTLS (default when ca set)

    [https]
    enabled = true                            # serve the HTTP data path TLS
    # cert/key/ca default to the [grpc] values

Process-global state mirrors the reference's design: every RpcServer /
RpcClient / HTTP server in the process consults this module, so servers
and tools pick TLS up from the TOML without per-callsite plumbing.
`generate_self_signed()` creates a throwaway CA + leaf pair for tests
and the `security.toml` scaffold workflow.
"""

from __future__ import annotations

import datetime
import os
import ssl
import threading
import urllib.request
from dataclasses import dataclass
from typing import Optional

import grpc


@dataclass
class TlsState:
    ca_file: str
    cert_file: str
    key_file: str
    require_client_auth: bool = True
    https: bool = False
    # self-signed test certs are issued for a fixed name; gRPC needs the
    # target-name override to accept them when dialing by IP
    override_authority: Optional[str] = None


_state: Optional[TlsState] = None
_lock = threading.Lock()
# SSLContexts are immutable-config and thread-safe for wrapping: build them
# once per configure() — the data path calls urlopen per chunk, and a fresh
# context per request would re-read PEM files and forfeit TLS session reuse
_ctx_cache: dict = {}


def configure(
    ca_file: str,
    cert_file: str,
    key_file: str,
    require_client_auth: bool = True,
    https: bool = False,
    override_authority: Optional[str] = None,
) -> None:
    global _state
    # cert/key may be empty for pure clients of a require_client_auth=false
    # cluster; cluster nodes need all three
    for p in (ca_file, cert_file, key_file):
        if p and not os.path.exists(p):
            raise FileNotFoundError(f"tls file missing: {p}")
    if not ca_file:
        raise ValueError("tls: ca_file is required")
    if bool(cert_file) != bool(key_file):
        raise ValueError("tls: grpc.cert and grpc.key must be set together")
    with _lock:
        _state = TlsState(
            ca_file, cert_file, key_file, require_client_auth, https, override_authority
        )
        _ctx_cache.clear()


def configure_from_conf(conf: dict) -> bool:
    """Wire TLS up from a parsed security.toml. Returns True when enabled."""
    g = conf.get("grpc") or {}
    h = conf.get("https") or {}
    if not g.get("ca"):
        if h.get("enabled"):
            # fail CLOSED: the operator asked for an encrypted data path but
            # gave no trust anchor — silently serving plaintext would be a
            # security misconfiguration they can't see
            raise ValueError(
                "security.toml: [https] enabled=true requires [grpc] ca/cert/key"
            )
        return False
    configure(
        ca_file=g["ca"],
        cert_file=g.get("cert", ""),
        key_file=g.get("key", ""),
        require_client_auth=bool(g.get("require_client_auth", True)),
        https=bool(h.get("enabled", False)),
        override_authority=g.get("override_authority") or None,
    )
    return True


def reset() -> None:
    global _state
    with _lock:
        _state = None
        _ctx_cache.clear()


def enabled() -> bool:
    return _state is not None


def https_enabled() -> bool:
    return _state is not None and _state.https


def scheme() -> str:
    """URL scheme for the intra-cluster HTTP data path."""
    return "https" if https_enabled() else "http"


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


# -- gRPC credentials ---------------------------------------------------------


def server_credentials() -> Optional[grpc.ServerCredentials]:
    st = _state
    if st is None:
        return None
    if not st.cert_file or not st.key_file:
        raise ValueError("tls: servers need grpc.cert and grpc.key in security.toml")
    return grpc.ssl_server_credentials(
        [(_read(st.key_file), _read(st.cert_file))],
        root_certificates=_read(st.ca_file),
        require_client_auth=st.require_client_auth,
    )


def channel_credentials() -> Optional[grpc.ChannelCredentials]:
    st = _state
    if st is None:
        return None
    return grpc.ssl_channel_credentials(
        root_certificates=_read(st.ca_file),
        private_key=_read(st.key_file) if st.cert_file else None,
        certificate_chain=_read(st.cert_file) if st.cert_file else None,
    )


def channel_options() -> list:
    st = _state
    if st is None or not st.override_authority:
        return []
    return [("grpc.ssl_target_name_override", st.override_authority)]


# -- HTTPS (data path) --------------------------------------------------------


def https_server_context() -> Optional[ssl.SSLContext]:
    st = _state
    if st is None or not st.https:
        return None
    if not st.cert_file or not st.key_file:
        raise ValueError("tls: https servers need grpc.cert and grpc.key in security.toml")
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(st.cert_file, st.key_file)
    # require_client_auth means mTLS on the data path too — CERT_REQUIRED,
    # actually enforced by the handshake. Deployments whose gateways face
    # browsers / presigned-URL clients set require_client_auth=false and
    # rely on the gateway's own auth (SigV4/JWT) instead.
    if st.require_client_auth:
        ctx.load_verify_locations(st.ca_file)
        ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


_HANDSHAKE_TIMEOUT = 10.0


def maybe_wrap_https(server) -> None:
    """Wrap a bound-but-not-yet-serving HTTP server's socket in TLS when
    https is configured; no-op otherwise.

    The handshake is deferred to the per-connection worker thread
    (do_handshake_on_connect=False + an explicit do_handshake in
    finish_request): with the default eager handshake it would run inside
    accept() on the single serve_forever thread, where one idle or
    plaintext client parks the whole server."""
    ctx = https_server_context()
    if ctx is None:
        return
    server.socket = ctx.wrap_socket(
        server.socket, server_side=True, do_handshake_on_connect=False
    )
    orig_finish = server.finish_request

    def finish_request(request, client_address):
        request.settimeout(_HANDSHAKE_TIMEOUT)
        try:
            request.do_handshake()
        except (OSError, ValueError):  # plaintext probe / handshake timeout
            try:
                request.close()
            except OSError:
                pass
            return
        request.settimeout(None)
        orig_finish(request, client_address)

    server.finish_request = finish_request


def _client_context() -> ssl.SSLContext:
    st = _state
    cached = _ctx_cache.get("client")
    if cached is not None:
        return cached
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    if st is not None:
        ctx.load_verify_locations(st.ca_file)
        if st.cert_file:
            ctx.load_cert_chain(st.cert_file, st.key_file)
    else:
        ctx.load_default_certs()
    with _lock:
        _ctx_cache["client"] = ctx
    return ctx


def _relaxed_context() -> ssl.SSLContext:
    """CA-pinned but hostname-flexible: cluster nodes dial each other by
    IP:port while the shared cert names the cluster authority. The CA pin
    still authenticates the peer; only the name check is relaxed."""
    cached = _ctx_cache.get("relaxed")
    if cached is not None:
        return cached
    st = _state
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_REQUIRED
    if st is not None:
        ctx.load_verify_locations(st.ca_file)
        if st.cert_file:
            ctx.load_cert_chain(st.cert_file, st.key_file)
    with _lock:
        _ctx_cache["relaxed"] = ctx
    return ctx


def urlopen(req, timeout: float = 30.0):
    """Intra-cluster urlopen: plain HTTP when TLS is off; otherwise HTTPS
    with the cluster CA (and client cert, for data-path mTLS). Contexts
    are cached — this sits on the per-chunk hot path."""
    if not https_enabled():
        return urllib.request.urlopen(req, timeout=timeout)
    st = _state
    if st is not None and st.override_authority:
        # dials are by IP:port, certs name the cluster authority
        return urllib.request.urlopen(req, timeout=timeout, context=_relaxed_context())
    return urllib.request.urlopen(req, timeout=timeout, context=_client_context())


# -- self-signed material (tests / scaffold) ---------------------------------


def generate_self_signed(directory: str, common_name: str = "weedtpu-cluster") -> dict:
    """Issue a throwaway CA + one leaf cert/key signed by it (SANs cover
    localhost/127.0.0.1 so loopback clusters verify). Returns the paths:
    {"ca": ..., "cert": ..., "key": ...}."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    os.makedirs(directory, exist_ok=True)
    now = datetime.datetime.now(datetime.timezone.utc)

    def _key():
        return rsa.generate_private_key(public_exponent=65537, key_size=2048)

    def _write_key(key, path):
        with open(path, "wb") as f:
            f.write(
                key.private_bytes(
                    serialization.Encoding.PEM,
                    serialization.PrivateFormat.TraditionalOpenSSL,
                    serialization.NoEncryption(),
                )
            )

    def _write_cert(cert, path):
        with open(path, "wb") as f:
            f.write(cert.public_bytes(serialization.Encoding.PEM))

    ca_key = _key()
    ca_name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common_name + "-ca")])
    ca_cert = (
        x509.CertificateBuilder()
        .subject_name(ca_name)
        .issuer_name(ca_name)
        .public_key(ca_key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=365))
        .add_extension(x509.BasicConstraints(ca=True, path_length=None), critical=True)
        .sign(ca_key, hashes.SHA256())
    )

    leaf_key = _key()
    leaf_name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
    import ipaddress

    leaf_cert = (
        x509.CertificateBuilder()
        .subject_name(leaf_name)
        .issuer_name(ca_name)
        .public_key(leaf_key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=365))
        .add_extension(
            x509.SubjectAlternativeName(
                [
                    x509.DNSName(common_name),
                    x509.DNSName("localhost"),
                    x509.IPAddress(ipaddress.ip_address("127.0.0.1")),
                ]
            ),
            critical=False,
        )
        .sign(ca_key, hashes.SHA256())
    )

    paths = {
        "ca": os.path.join(directory, "ca.crt"),
        "cert": os.path.join(directory, "node.crt"),
        "key": os.path.join(directory, "node.key"),
    }
    _write_cert(ca_cert, paths["ca"])
    _write_cert(leaf_cert, paths["cert"])
    _write_key(leaf_key, paths["key"])
    return paths
