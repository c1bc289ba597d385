"""The port's RPC layer (`seaweedfs_tpu_torch/rpc.py`) over loopback, and
against the reference's: an ad-hoc service answering unary JSON and bytes
calls and a server stream of CRC frames, fault codes, a propagated trace id
continued in the server's ring, the client pool, the server metrics — and
interop both ways (port client to reference server, reference client to
port server) under `WEEDTPU_WIRE=json` and `proto`."""

import zlib

import grpc
import pytest

from seaweedfs_tpu import rpc as ref_rpc
from seaweedfs_tpu.obs import trace as ref_trace
from seaweedfs_tpu_torch import rpc, stats
from seaweedfs_tpu_torch.obs import trace
from seaweedfs_tpu_torch.pb import MASTER_SERVICE, VOLUME_SERVICE

SVC = "weedtpu.TorchTest"


def _service(mod, name: str = SVC):
    svc = mod.Service(name)

    @svc.method("Echo")
    def echo(req, ctx):
        return {"echo": req.get("x"), "n": len(req)}

    svc.add("Raw", lambda req, ctx: bytes(reversed(req)), req_format="bytes",
            resp_format="bytes")

    def chunks(req, ctx):
        for i in range(req["n"]):
            yield mod.crc_frame(bytes([i]) * (i + 1))

    svc.add("Chunks", chunks, kind="unary_stream", resp_format="bytes")

    def fault(req, ctx):
        kind = req["kind"]
        if kind == "notfound":
            raise mod.NotFoundFault("no such needle")
        if kind == "leader":
            raise mod.NotLeaderFault(req.get("leader", ""))
        if kind == "fault":
            raise mod.RpcFault("slow down", grpc.StatusCode.RESOURCE_EXHAUSTED)
        raise ValueError("boom")

    svc.add("Fault", fault)
    return svc


@pytest.fixture
def server():
    srv = rpc.RpcServer(port=0)
    srv.add_service(_service(rpc))
    srv.start()
    yield srv
    srv.stop()


def test_crc_frames():
    for mod in (rpc, ref_rpc):
        chunk = b"\x00slab bytes\xff" * 9
        frame = mod.crc_frame(chunk)
        assert frame == ref_rpc.crc_frame(chunk)
        assert frame[:4] == zlib.crc32(chunk).to_bytes(4, "big")
        assert mod.crc_unframe(frame) == chunk
        bad = frame[:-1] + bytes([frame[-1] ^ 1])
        with pytest.raises(IOError, match="CRC mismatch"):
            mod.crc_unframe(bad)
        with pytest.raises(IOError, match="short"):
            mod.crc_unframe(b"\x00\x01")


def test_unary_json_bytes_and_stream(server):
    with rpc.RpcClient(f"127.0.0.1:{server.port}") as c:
        assert c.call(SVC, "Echo", {"x": [1, "a"]}, timeout=10) == {"echo": [1, "a"], "n": 1}
        assert c.call(SVC, "Echo", timeout=10) == {"echo": None, "n": 0}
        raw = c._stub(SVC, "Raw", "unary_unary", "bytes", "bytes")
        assert raw(b"\x01\x02\x03", timeout=10) == b"\x03\x02\x01"
        frames = list(c.stream(SVC, "Chunks", {"n": 4}, timeout=10))
        assert [rpc.crc_unframe(f) for f in frames] == [bytes([i]) * (i + 1) for i in range(4)]


@pytest.mark.parametrize("kind, code, detail", [
    ("notfound", grpc.StatusCode.NOT_FOUND, "no such needle"),
    ("leader", grpc.StatusCode.FAILED_PRECONDITION, "not the raft leader; no leader elected yet"),
    ("fault", grpc.StatusCode.RESOURCE_EXHAUSTED, "slow down"),
    ("other", grpc.StatusCode.INTERNAL, "ValueError: boom"),
])
def test_fault_codes(server, kind, code, detail):
    with rpc.RpcClient(f"127.0.0.1:{server.port}") as c:
        with pytest.raises(grpc.RpcError) as ei:
            c.call(SVC, "Fault", {"kind": kind}, timeout=10)
    assert ei.value.code() == code and ei.value.details() == detail
    assert rpc.NotLeaderFault("h:9333").leader == "h:9333"
    assert "leader is h:9333" in rpc.NotLeaderFault("h:9333").detail


def test_unknown_method_is_unimplemented(server):
    with rpc.RpcClient(f"127.0.0.1:{server.port}") as c:
        with pytest.raises(grpc.RpcError) as ei:
            c.call(SVC, "Nope", {}, timeout=10)
    assert ei.value.code() == grpc.StatusCode.UNIMPLEMENTED
    with pytest.raises(ValueError):
        rpc.Method(lambda r, c: r, kind="bidi")


def test_trace_id_continues_in_the_server_ring(server, monkeypatch):
    monkeypatch.setenv("WEEDTPU_TRACE", "on")
    ring = trace.TraceRing(capacity=16, slowest_n=4, sample=1.0, seed=1)
    monkeypatch.setattr(trace, "RING", ring)
    with rpc.RpcClient(f"127.0.0.1:{server.port}") as c:
        c.call(SVC, "Echo", {"x": 0}, timeout=10)  # un-traced: no root on the server
        assert ring.snapshot() == []
        with trace.start("shell.command", klass="shell", trace_id="5eed0001", ring=ring):
            c.call(SVC, "Echo", {"x": 1}, timeout=10)
            list(c.stream(SVC, "Chunks", {"n": 2}, timeout=10))
    legs = [t for t in ring.snapshot() if t["kind"] == "rpc.server"]
    assert sorted(t["root"]["attrs"]["method"] for t in legs) == ["Chunks", "Echo"]
    assert {t["trace_id"] for t in legs} == {"5eed0001"} and {t["class"] for t in legs} == {"rpc"}


def test_server_metrics_tick(server):
    hist = stats.RpcServerSeconds.labels("Echo")
    before = hist.total
    with rpc.RpcClient(f"127.0.0.1:{server.port}") as c:
        for _ in range(3):
            c.call(SVC, "Echo", {}, timeout=10)
    assert hist.total == before + 3
    assert stats.RpcInflight.labels("Echo").value == 0.0
    assert 'weedtpu_rpc_server_seconds_count{method="Echo"}' in stats.REGISTRY.expose()


def test_client_pool(server):
    addr = f"127.0.0.1:{server.port}"
    pool = rpc.ClientPool()
    a = pool.get(addr)
    assert pool.get(addr) is a
    assert a.call(SVC, "Echo", {"x": 2}, timeout=10)["echo"] == 2
    pool.invalidate(addr)
    pool.invalidate("127.0.0.1:1")  # unknown: a no-op
    b = pool.get(addr)
    assert b is not a and b.call(SVC, "Echo", {"x": 3}, timeout=10)["echo"] == 3
    pool.close_all()
    assert pool.get(addr) is not b
    pool.close_all()


def _schema_service(mod):
    """Two methods of the pinned schema, so the proto wire applies."""
    svc = mod.Service(VOLUME_SERVICE)
    svc.add("VolumeNeedleTs", lambda req, ctx: {
        "ts": {nid: req["volume_id"] * 1000 + nid for nid in req.get("needle_ids", [])}})
    master = mod.Service(MASTER_SERVICE)
    master.add("Assign", lambda req, ctx: {
        "fid": f"{req.get('count', 1)},0123abcd", "count": req.get("count", 1),
        "url": "127.0.0.1:8080", "auth": ""})
    return svc, master


@pytest.mark.parametrize("wire_name", ["json", "proto"])
@pytest.mark.parametrize("client_pkg, server_pkg", [("port", "ref"), ("ref", "port"),
                                                    ("port", "port")])
def test_interop_both_ways(monkeypatch, wire_name, client_pkg, server_pkg):
    monkeypatch.setenv("WEEDTPU_WIRE", wire_name)
    monkeypatch.setenv("WEEDTPU_TRACE", "on")
    mods = {"port": (rpc, trace), "ref": (ref_rpc, ref_trace)}
    smod, stmod = mods[server_pkg]
    cmod, ctmod = mods[client_pkg]
    ring = stmod.TraceRing(capacity=16, slowest_n=4, sample=1.0, seed=1)
    monkeypatch.setattr(stmod, "RING", ring)
    srv = smod.RpcServer(port=0)
    for svc in (*_schema_service(smod), _service(smod)):
        srv.add_service(svc)
    srv.start()
    try:
        with cmod.RpcClient(f"127.0.0.1:{srv.port}") as c:
            got = c.call(VOLUME_SERVICE, "VolumeNeedleTs", {"volume_id": 3, "needle_ids": [1, 7]},
                         timeout=10)
            # JSON object keys come back as strings; protobuf map keys as ints
            keys = (1, 7) if wire_name == "proto" else ("1", "7")
            assert got == {"ts": dict(zip(keys, (3001, 3007)))}
            with ctmod.start("shell.command", trace_id="beef0002"):
                a = c.call(MASTER_SERVICE, "Assign", {"count": 2}, timeout=10)
            assert a["fid"] == "2,0123abcd" and a["count"] == 2
            if wire_name == "proto":  # every schema field present, defaults included
                assert a["public_url"] == "" and a["grpc_port"] == 0
            assert c.call(SVC, "Echo", {"x": wire_name}, timeout=10)["echo"] == wire_name
            frames = list(c.stream(SVC, "Chunks", {"n": 3}, timeout=10))
            assert [ref_rpc.crc_unframe(f) for f in frames] == [b"\x00", b"\x01" * 2, b"\x02" * 3]
    finally:
        srv.stop()
    [leg] = [t for t in ring.snapshot() if t["kind"] == "rpc.server"]
    assert (leg["trace_id"], leg["root"]["attrs"]) == ("beef0002", {"method": "Assign"})


@pytest.mark.parametrize("wire_name", ["json", "proto"])
def test_serdes_equal_the_reference(monkeypatch, wire_name):
    monkeypatch.setenv("WEEDTPU_WIRE", wire_name)
    req = {"volume_id": 9, "needle_ids": [5, 1 << 40]}
    for service, method, fmt in ((VOLUME_SERVICE, "VolumeNeedleTs", "json"),
                                 (SVC, "Echo", "json"), (SVC, "Raw", "bytes")):
        port = rpc._resolve_serdes(service, method, fmt, fmt)
        ref = ref_rpc._resolve_serdes(service, method, fmt, fmt)
        payload = b"\x00raw" if fmt == "bytes" else req
        assert port[0](payload) == ref[0](payload)
        assert port[1](ref[0](payload)) == ref[1](ref[0](payload))
