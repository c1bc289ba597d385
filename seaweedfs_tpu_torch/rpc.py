"""JSON-over-gRPC transport — the control-plane RPC layer, byte for byte
the reference's on the wire.

Upstream's control plane is gRPC with protobuf contracts (weed/pb/*.proto).
Instead of generated stubs (grpcio-tools may be absent) the framework
registers methods on grpc's *generic handler* API with two wire formats per
method:

  "json"  — request/response are UTF-8 JSON objects (control messages)
  "bytes" — raw byte frames (bulk data: shard copy streams, interval reads);
            metadata rides in gRPC invocation metadata, not the payload

`WEEDTPU_WIRE=proto` swaps every "json" side of a method in the pinned
schema for binary protobuf (pb/wire.py).

Method kinds: unary-unary, unary-stream (server streaming). That covers the
EC surface: control RPCs are unary, shard copy/read are server-streamed
byte frames.

Errors: handlers raising RpcFault abort with that code/detail; anything
else maps to INTERNAL. Clients get grpc.RpcError as usual.

A trace id rides the `weedtpu-trace` invocation metadata: the client sends
the ambient trace's id, and the server continues it (`continue_trace`) in
its own process's ring.
"""

from __future__ import annotations

import json
import threading
import time
import zlib
from concurrent import futures
from typing import Any, Callable, Iterator, Optional

import grpc

from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.obs import trace as trace_mod
from seaweedfs_tpu_torch.security import tls
from seaweedfs_tpu_torch.utils import glog


def _json_ser(obj: Any) -> bytes:
    return json.dumps(obj, separators=(",", ":")).encode()


def _json_de(data: bytes) -> Any:
    return json.loads(data.decode())


def _bytes_ser(b: bytes) -> bytes:
    return bytes(b)


def _bytes_de(b: bytes) -> bytes:
    return b


_FORMATS = {
    "json": (_json_ser, _json_de),
    "bytes": (_bytes_ser, _bytes_de),
}


def _resolve_serdes(service: str, method: str, req_format: str, resp_format: str):
    """(req_ser, req_de, resp_ser, resp_de) for one method, honoring the
    process-wide wire selection: WEEDTPU_WIRE=proto swaps every "json"
    side for binary protobuf built from pb/contracts.proto (pb/wire.py).
    "bytes" streams are already the reference's raw-frame shape and stay.

    Failures are LOUD by design: a process that silently fell back to
    JSON while its peers speak protobuf would corrupt every call — the
    operator asked for proto, so a missing schema entry or a codec load
    error must stop the process, not downgrade it."""
    req_ser, req_de = _FORMATS[req_format]
    resp_ser, resp_de = _FORMATS[resp_format]
    if "json" in (req_format, resp_format):
        from seaweedfs_tpu_torch.pb import wire

        if wire.wire_format() == "proto":
            codec = wire.codec()
            # a (service, method) outside the schema (ad-hoc test services)
            # falls back to JSON on BOTH ends — every process derives the
            # decision from the same descriptor set, so the fallback is
            # symmetric and interoperable. A codec load failure still
            # raises: that CAN diverge between processes.
            if codec.has(service, method):
                if req_format == "json":
                    req_ser, req_de = codec.request_serdes(service, method)
                if resp_format == "json":
                    resp_ser, resp_de = codec.response_serdes(service, method)
    return req_ser, req_de, resp_ser, resp_de


def crc_frame(chunk: bytes) -> bytes:
    """Frame one bulk-stream chunk as 4-byte big-endian CRC32 + payload.

    The slab-read bulk stream (VolumeEcShardSlabRead) carries rebuild
    input across the network: a flipped bit there would decode into a
    silently-wrong shard on the rebuilder, so every chunk is integrity-
    checked at the transport seam rather than trusting TCP checksums
    across proxies/retries."""
    return zlib.crc32(chunk).to_bytes(4, "big") + chunk


def crc_unframe(frame: bytes) -> bytes:
    """Inverse of crc_frame; raises IOError on checksum mismatch."""
    if len(frame) < 4:
        raise IOError(f"short CRC frame: {len(frame)} bytes")
    want = int.from_bytes(frame[:4], "big")
    chunk = frame[4:]
    got = zlib.crc32(chunk)
    if got != want:
        raise IOError(f"bulk-stream chunk CRC mismatch: got {got:08x}, want {want:08x}")
    return chunk


class RpcFault(Exception):
    """Handler-raised fault with an explicit status code."""

    def __init__(self, detail: str, code: grpc.StatusCode = grpc.StatusCode.INTERNAL):
        super().__init__(detail)
        self.code = code
        self.detail = detail


class NotFoundFault(RpcFault):
    def __init__(self, detail: str):
        super().__init__(detail, grpc.StatusCode.NOT_FOUND)


class NotLeaderFault(RpcFault):
    """Raised by a raft follower for leader-only operations; carries the
    current leader so facades can point clients at it in a structured way
    instead of burying the address in free text."""

    def __init__(self, leader: str):
        detail = f"not the raft leader; leader is {leader}" if leader else (
            "not the raft leader; no leader elected yet"
        )
        super().__init__(detail, grpc.StatusCode.FAILED_PRECONDITION)
        self.leader = leader


class Method:
    def __init__(
        self,
        fn: Callable,
        kind: str = "unary_unary",
        req_format: str = "json",
        resp_format: str = "json",
    ):
        if kind not in ("unary_unary", "unary_stream", "stream_unary", "stream_stream"):
            raise ValueError(f"bad rpc kind {kind}")
        self.fn = fn
        self.kind = kind
        self.req_format = req_format
        self.resp_format = resp_format


class Service:
    """A named bag of methods. Handlers receive (request, context)."""

    def __init__(self, name: str):
        self.name = name
        self.methods: dict[str, Method] = {}

    def method(self, name: str, kind: str = "unary_unary", req_format: str = "json", resp_format: str = "json"):
        def deco(fn):
            self.methods[name] = Method(fn, kind, req_format, resp_format)
            return fn

        return deco

    def add(self, name: str, fn: Callable, **kw) -> None:
        self.methods[name] = Method(fn, **kw)


def _inbound_trace_id(context) -> Optional[str]:
    """Propagated trace id from gRPC invocation metadata, if any — the
    one reserved metadata field tracing rides, so the pinned proto
    contracts (and every JSON/bytes payload) stay untouched."""
    try:
        for k, v in context.invocation_metadata() or ():
            if k == trace_mod.MD_KEY:
                return v if isinstance(v, str) else None
    except Exception:  # noqa: BLE001 — metadata is best-effort context
        pass
    return None


def _wrap_unary(fn, method: str = ""):
    def handler(request, context):
        stats.RpcInflight.labels(method).inc()
        t0 = time.monotonic()
        try:
            with trace_mod.continue_trace(
                "rpc.server", _inbound_trace_id(context)
            ) as sp:
                if sp is not None:
                    sp.annotate(method=method)
                try:
                    return fn(request, context)
                except RpcFault as e:
                    glog.V(1).infof("rpc %s fault: %s", method, e.detail)
                    context.abort(e.code, e.detail)
                except Exception as e:  # noqa: BLE001 — map to INTERNAL for the peer
                    glog.error("rpc %s failed: %s: %s", method, type(e).__name__, e)
                    context.abort(grpc.StatusCode.INTERNAL, f"{type(e).__name__}: {e}")
        finally:
            stats.RpcInflight.labels(method).dec()
            stats.RpcServerSeconds.labels(method).observe(time.monotonic() - t0)

    return handler


def _wrap_stream(fn, method: str = ""):
    def handler(request, context):
        stats.RpcInflight.labels(method).inc()
        t0 = time.monotonic()
        try:
            with trace_mod.continue_trace(
                "rpc.server", _inbound_trace_id(context)
            ) as sp:
                if sp is not None:
                    sp.annotate(method=method)
                try:
                    yield from fn(request, context)
                except RpcFault as e:
                    glog.V(1).infof("rpc %s fault: %s", method, e.detail)
                    context.abort(e.code, e.detail)
                except Exception as e:  # noqa: BLE001
                    glog.error("rpc %s failed: %s: %s", method, type(e).__name__, e)
                    context.abort(grpc.StatusCode.INTERNAL, f"{type(e).__name__}: {e}")
        finally:
            stats.RpcInflight.labels(method).dec()
            stats.RpcServerSeconds.labels(method).observe(time.monotonic() - t0)

    return handler


class _GenericHandler(grpc.GenericRpcHandler):
    def __init__(self, services: dict[str, Service]):
        self._services = services

    def service(self, handler_call_details):
        # method path: /<service>/<method>
        _, svc_name, m_name = handler_call_details.method.split("/", 2)
        svc = self._services.get(svc_name)
        if svc is None:
            return None
        m = svc.methods.get(m_name)
        if m is None:
            return None
        req_ser, req_de, resp_ser, resp_de = _resolve_serdes(
            svc_name, m_name, m.req_format, m.resp_format
        )
        if m.kind == "unary_unary":
            return grpc.unary_unary_rpc_method_handler(
                _wrap_unary(m.fn, m_name), request_deserializer=req_de, response_serializer=resp_ser
            )
        if m.kind == "unary_stream":
            return grpc.unary_stream_rpc_method_handler(
                _wrap_stream(m.fn, m_name), request_deserializer=req_de, response_serializer=resp_ser
            )
        if m.kind == "stream_unary":
            return grpc.stream_unary_rpc_method_handler(
                _wrap_unary(m.fn, m_name), request_deserializer=req_de, response_serializer=resp_ser
            )
        return grpc.stream_stream_rpc_method_handler(
            _wrap_stream(m.fn, m_name), request_deserializer=req_de, response_serializer=resp_ser
        )


class RpcServer:
    """grpc.server wrapper hosting Service objects on one port."""

    def __init__(self, port: int = 0, max_workers: int = 16, host: str = "127.0.0.1"):
        self._services: dict[str, Service] = {}
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers),
            options=[
                ("grpc.max_send_message_length", 64 * 1024 * 1024),
                ("grpc.max_receive_message_length", 64 * 1024 * 1024),
            ],
        )
        self._server.add_generic_rpc_handlers((_GenericHandler(self._services),))
        # process-wide TLS (security.toml [grpc]) — mTLS when configured,
        # matching the reference's per-process grpc cert wiring
        creds = tls.server_credentials()
        if creds is not None:
            self.port = self._server.add_secure_port(f"{host}:{port}", creds)
        else:
            self.port = self._server.add_insecure_port(f"{host}:{port}")
        self._started = False

    def add_service(self, svc: Service) -> None:
        self._services[svc.name] = svc

    def start(self) -> None:
        self._server.start()
        self._started = True

    def stop(self, grace: Optional[float] = 0.5) -> None:
        if self._started:
            self._server.stop(grace).wait()
            self._started = False


#: redial a refused address at least every second
RECONNECT_OPTIONS = (("grpc.max_reconnect_backoff_ms", 1000),)


class RpcClient:
    """Channel wrapper: call(service, method, request) with lazy per-method
    callables, JSON by default."""

    def __init__(self, address: str, options: tuple = ()):
        """`options`: more grpc channel arguments (raft's peer channels)."""
        self.address = address
        options = [
            ("grpc.max_send_message_length", 64 * 1024 * 1024),
            ("grpc.max_receive_message_length", 64 * 1024 * 1024),
            # grpc backs a refused address off for up to two minutes, and
            # every channel to it shares that state: a master or server
            # restarted on its address would stay unreachable that long
            *RECONNECT_OPTIONS,
            *tls.channel_options(),
            *options,
        ]
        creds = tls.channel_credentials()
        if creds is not None:
            self._channel = grpc.secure_channel(address, creds, options=options)
        else:
            self._channel = grpc.insecure_channel(address, options=options)
        self._lock = threading.Lock()
        self._stubs: dict[tuple, Callable] = {}

    def close(self) -> None:
        self._channel.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _stub(self, service: str, method: str, kind: str, req_format: str, resp_format: str):
        key = (service, method, kind)
        with self._lock:
            stub = self._stubs.get(key)
            if stub is None:
                req_ser, _, _, resp_de = _resolve_serdes(
                    service, method, req_format, resp_format
                )
                path = f"/{service}/{method}"
                factory = getattr(self._channel, kind)
                stub = factory(path, request_serializer=req_ser, response_deserializer=resp_de)
                self._stubs[key] = stub
        return stub

    @staticmethod
    def _trace_metadata():
        """Invocation metadata carrying the ambient trace id, when one is
        active in this thread — the client half of cross-process trace
        propagation. None (no metadata at all) otherwise."""
        tid = trace_mod.current_trace_id()
        return ((trace_mod.MD_KEY, tid),) if tid else None

    def call(self, service: str, method: str, request: Any = None, timeout: float = 30.0) -> Any:
        """Unary-unary JSON call."""
        stub = self._stub(service, method, "unary_unary", "json", "json")
        return stub(
            request if request is not None else {}, timeout=timeout,
            metadata=self._trace_metadata(),
        )

    def stream(
        self, service: str, method: str, request: Any = None, timeout: float = 600.0,
        resp_format: str = "bytes",
    ) -> Iterator:
        """Unary-stream call; defaults to raw byte frames (bulk transfer)."""
        stub = self._stub(service, method, "unary_stream", "json", resp_format)
        return stub(
            request if request is not None else {}, timeout=timeout,
            metadata=self._trace_metadata(),
        )


class ClientPool:
    """Long-lived RpcClient per peer address — the degraded-read ladder and
    replication fan-out dial the same few holders over and over; a fresh
    channel per read costs a TCP+HTTP/2 setup on the latency-critical path
    (upstream's weed/storage/erasure_coding/ec_volume.go ShardLocations and
    the grpc connection reuse in weed/operation).

    gRPC channels are thread-safe; the pool only guards the dict. A caller
    that sees a transport error should `invalidate(addr)` so the next use
    redials instead of reusing a broken channel.
    """

    def __init__(self) -> None:
        self._clients: dict[str, RpcClient] = {}
        self._lock = threading.Lock()

    def get(self, address: str) -> RpcClient:
        with self._lock:
            c = self._clients.get(address)
            if c is None:
                c = self._clients[address] = RpcClient(address)
            return c

    def invalidate(self, address: str) -> None:
        with self._lock:
            c = self._clients.pop(address, None)
        if c is not None:
            try:
                c.close()
            except Exception:  # noqa: BLE001 — already broken
                pass

    def close_all(self) -> None:
        with self._lock:
            clients, self._clients = list(self._clients.values()), {}
        for c in clients:
            try:
                c.close()
            except Exception:  # noqa: BLE001
                pass
