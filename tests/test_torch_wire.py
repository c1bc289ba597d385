"""The port's binary protobuf wire (`seaweedfs_tpu_torch/pb/wire.py`)
against the reference codec: for each of the 118 messages of
`contracts.proto`, seeded dicts encode to the same bytes and decode to the
same dicts in both packages; the codec covers every method; the cases of
tests/test_proto_wire.py (scalars and maps, base64 bytes, unknown keys,
presence, wrappers, binary frames) hold on both; and the port's committed
`contracts.desc` is what protoc emits for the port's `contracts.proto`."""

import base64
import json
import os
import re
import shutil

import numpy as np
import pytest
from google.protobuf import message_factory

from seaweedfs_tpu.pb import wire as ref_wire
from seaweedfs_tpu_torch import pb
from seaweedfs_tpu_torch.pb import FILER_SERVICE, MASTER_SERVICE, VOLUME_SERVICE, wire

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def codecs():
    return wire.WireCodec(), ref_wire.WireCodec()


def _messages(codec) -> list[str]:
    fd = codec._pool.FindFileByName("contracts.proto")
    return sorted(f"{fd.package}.{name}" for name in fd.message_types_by_name)


def _cls(codec, full: str):
    return message_factory.GetMessageClass(codec._pool.FindMessageTypeByName(full))


_INT_RANGES = {3: (-(1 << 63), 1 << 63), 4: (0, 1 << 64), 5: (-(1 << 31), 1 << 31),
               13: (0, 1 << 32)}


def _scalar(fd, rng):
    t = fd.type
    if t in _INT_RANGES:
        lo, hi = _INT_RANGES[t]
        if rng.random() < 0.3:  # small values too: one-byte varints, zero
            return int(rng.integers(0, 3))
        return lo + int.from_bytes(rng.bytes(8), "little") % (hi - lo)
    if t == fd.TYPE_DOUBLE:
        return float(rng.normal() * 10 ** int(rng.integers(-3, 12)))
    if t == fd.TYPE_BOOL:
        return bool(rng.integers(2))
    if t == fd.TYPE_STRING:
        return "".join(rng.choice(list("abcXYZ09:/,._-é✓"), int(rng.integers(0, 12))))
    if t == fd.TYPE_BYTES:
        return base64.b64encode(rng.bytes(int(rng.integers(0, 24)))).decode()
    raise AssertionError(f"{fd.name}: no generator for proto type {t}")


def _value(desc, rng, depth: int):
    """A seeded dict for one message, in the shape handlers use (wrapper
    messages in their bare form)."""
    wrap = wire.WRAPPER_FIELD.get(desc.full_name)
    if wrap is not None:
        return _field(desc.fields_by_name[wrap], rng, depth)
    out = {}
    for fd in desc.fields:
        if fd.has_presence and fd.message_type is None and rng.random() < 0.4:
            continue  # an absent `optional` scalar
        if fd.message_type is not None and not _is_map(fd) and not wire._is_repeated(fd) \
                and (depth > 3 or rng.random() < 0.25):
            continue  # an absent sub-message
        out[fd.name] = _field(fd, rng, depth)
    return out


def _is_map(fd) -> bool:
    return fd.message_type is not None and fd.message_type.GetOptions().map_entry


def _field(fd, rng, depth: int):
    n = int(rng.integers(0, 4)) if depth <= 3 else 0
    if _is_map(fd):
        key_fd = fd.message_type.fields_by_name["key"]
        val_fd = fd.message_type.fields_by_name["value"]
        out = {}
        for _ in range(n):
            k = _scalar(key_fd, rng)
            if key_fd.type != key_fd.TYPE_STRING and rng.random() < 0.5:
                k = str(k)  # the JSON habit of string keys for int maps
            out[k] = (_value(val_fd.message_type, rng, depth + 1)
                      if val_fd.message_type is not None else _scalar(val_fd, rng))
        return out
    if wire._is_repeated(fd):
        if fd.message_type is not None:
            return [_value(fd.message_type, rng, depth + 1) for _ in range(n)]
        return [_scalar(fd, rng) for _ in range(n)]
    if fd.message_type is not None:
        return _value(fd.message_type, rng, depth + 1)
    return _scalar(fd, rng)


def test_descriptor_artifact_is_fresh():
    """The port's contracts.desc is protoc's output for the port's
    contracts.proto (regenerate with
    `python -c 'from seaweedfs_tpu_torch.pb import wire; wire.regenerate_descriptor_artifact()'`),
    and that proto is the reference's, byte for byte."""
    if shutil.which("protoc") is None:
        pytest.skip("protoc not installed")
    with open(wire.DESC_PATH, "rb") as f:
        committed = f.read()
    assert committed == wire._descriptor_set_bytes()
    assert committed == ref_wire._descriptor_set_bytes()  # protoc of the same schema
    with open(wire.PROTO_PATH, "rb") as a, open(ref_wire.PROTO_PATH, "rb") as b:
        assert a.read() == b.read()


def test_same_messages_and_methods(codecs):
    port, ref = codecs
    assert _messages(port) == _messages(ref) and len(_messages(port)) == 118
    assert set(port._methods) == set(ref._methods)
    for key, (req, resp) in port._methods.items():
        ref_req, ref_resp = ref._methods[key]
        assert (req.DESCRIPTOR.full_name, resp.DESCRIPTOR.full_name) == (
            ref_req.DESCRIPTOR.full_name, ref_resp.DESCRIPTOR.full_name)
    assert {s for s, _ in port._methods} == {MASTER_SERVICE, VOLUME_SERVICE, FILER_SERVICE,
                                             pb.MQ_SERVICE, "weedtpu.Raft"}


def test_private_pools():
    """Each codec has its own pool: the port's, the reference's and a
    second port codec load side by side in one process."""
    a, b = wire.WireCodec(), wire.WireCodec()
    assert a._pool is not b._pool and a._pool is not wire.codec()._pool


@pytest.mark.parametrize("full", _messages(wire.codec()))
def test_message_frames_equal_the_reference(codecs, full):
    port, ref = codecs
    pcls, rcls = _cls(port, full), _cls(ref, full)
    rng = np.random.default_rng(sum(map(ord, full)))
    for _ in range(4):
        d = _value(port._pool.FindMessageTypeByName(full), rng, 0)
        raw = port.to_message(d, pcls).SerializeToString(deterministic=True)
        assert raw == ref.to_message(d, rcls).SerializeToString(deterministic=True), d
        back = port.to_dict(pcls.FromString(raw))
        assert back == ref.to_dict(rcls.FromString(raw))
        # what comes back encodes to the same frame again
        assert port.to_message(back, pcls).SerializeToString(deterministic=True) == raw


def test_codec_covers_every_registered_method(codecs):
    """Every (service, method) either package's servers register resolves
    to message classes in the port's codec."""
    registered = set()
    for pkg in ("seaweedfs_tpu", "seaweedfs_tpu_torch"):
        for dirpath, _, files in os.walk(os.path.join(ROOT, pkg)):
            for name in files:
                if name.endswith(".py"):
                    with open(os.path.join(dirpath, name), encoding="utf-8") as f:
                        registered.update(re.findall(r"\badd\(\s*\"(\w+)\"", f.read()))
    known = {m for (_s, m) in codecs[0]._methods}
    assert len(registered) > 40 and not registered - known, registered - known


@pytest.fixture(params=["port", "ref"])
def codec(request, codecs):
    return codecs[0] if request.param == "port" else codecs[1]


def test_scalar_and_map_conversions(codec):
    req_cls, resp_cls = codec.classes(VOLUME_SERVICE, "VolumeNeedleTs")
    msg = codec.to_message({"volume_id": 7, "needle_ids": [1, 2, 3]}, req_cls)
    assert codec.to_dict(req_cls.FromString(msg.SerializeToString())) == {
        "volume_id": 7, "needle_ids": [1, 2, 3]}
    m2 = codec.to_message({"ts": {"5": 123, 9: 456}}, resp_cls)
    assert codec.to_dict(resp_cls.FromString(m2.SerializeToString()))["ts"] == {5: 123, 9: 456}
    big = (1 << 62) + 3
    m3 = codec.to_message({"ts": {1: big}}, resp_cls)
    assert codec.to_dict(resp_cls.FromString(m3.SerializeToString()))["ts"][1] == big


def test_bytes_fields_carry_base64_strings(codec):
    req_cls, _ = codec.classes(VOLUME_SERVICE, "WriteNeedle")
    payload = b"\x00\x01\xfe raw"
    d = {"fid": "3,17abcdef01", "data": base64.b64encode(payload).decode()}
    msg = codec.to_message(d, req_cls)
    assert msg.data == payload  # raw bytes on the wire, not b64 text
    back = codec.to_dict(req_cls.FromString(msg.SerializeToString()))
    assert base64.b64decode(back["data"]) == payload


def test_unknown_dict_key_and_wrong_types_raise(codec):
    req_cls, _ = codec.classes(MASTER_SERVICE, "Assign")
    with pytest.raises(ValueError, match="not a schema field"):
        codec.to_message({"count": 1, "typo_field": "x"}, req_cls)
    with pytest.raises(ValueError, match="expected str"):
        codec.to_message({"collection": 7}, req_cls)


def test_optional_presence_round_trips(codec):
    req_cls, _ = codec.classes(VOLUME_SERVICE, "VolumeEcShardsCopy")
    base = {"volume_id": 1, "shard_ids": [0, 7], "source_data_node": "h:1"}
    for d, expect in ((base, None), ({**base, "copy_ecx_file": False}, False),
                      ({**base, "copy_ecx_file": True}, True)):
        out = codec.to_dict(req_cls.FromString(codec.to_message(d, req_cls).SerializeToString()))
        assert out.get("copy_ecx_file", None) is expect
        assert out["shard_ids"] == [0, 7]


def test_wrapper_messages_round_trip_bare_shapes(codec):
    _, resp_cls = codec.classes(MASTER_SERVICE, "VolumeList")
    d = {
        "max_volume_id": 9,
        "volume_size_limit": 1 << 30,
        "data_centers": {
            "dc1": {"rackA": [{"url": "h:1", "grpc_port": 2, "volumes": [{"id": 4}]}]},
            "dc2": {},
        },
        "ec_volumes": {"7": {"0": ["h:1", "h:2"], "13": ["h:3"]}},
        "ec_collections": {"7": "buck"},
    }
    out = codec.to_dict(resp_cls.FromString(codec.to_message(d, resp_cls).SerializeToString()))
    assert out["data_centers"]["dc1"]["rackA"][0]["url"] == "h:1"
    assert out["data_centers"]["dc1"]["rackA"][0]["volumes"][0]["id"] == 4
    assert out["data_centers"]["dc2"] == {}
    assert out["ec_volumes"]["7"]["0"] == ["h:1", "h:2"]
    assert out["ec_collections"] == {"7": "buck"}


def test_request_frames_are_binary_not_json(codecs):
    frames = []
    for c in codecs:
        ser, de = c.request_serdes(MASTER_SERVICE, "Assign")
        raw = ser({"count": 3, "collection": "c"})
        with pytest.raises(ValueError):
            json.loads(raw)  # a JSON frame would parse
        assert de(raw)["count"] == 3
        frames.append(raw)
        rser, rde = c.response_serdes(MASTER_SERVICE, "Assign")
        assert rde(rser({"fid": "3,01", "count": 1}))["fid"] == "3,01"
    assert frames[0] == frames[1]


def test_wire_format_follows_the_knob(monkeypatch):
    monkeypatch.delenv("WEEDTPU_WIRE", raising=False)
    assert wire.wire_format() == "json"
    for raw, want in (("proto", "proto"), (" PROTO ", "proto"), ("grpc", "json")):
        monkeypatch.setenv("WEEDTPU_WIRE", raw)
        assert wire.wire_format() == want == ref_wire.wire_format()


def test_dataclasses_match_the_reference():
    from seaweedfs_tpu import pb as ref_pb

    d = {"ip": "10.0.0.2", "port": 8080, "grpc_port": 18080, "volumes": [{"id": 3}],
         "unreachable_peers": ["h:1"]}
    assert pb.Heartbeat.from_dict(d).to_dict() == ref_pb.Heartbeat.from_dict(d).to_dict()
    assert pb.Heartbeat.from_dict(d).url == "10.0.0.2:8080"
    loc = {"url": "h:8080", "grpc_port": 18080}
    assert pb.Location.from_dict(loc).grpc_address == ref_pb.Location.from_dict(loc).grpc_address
    v = {"id": "5", "size": "10", "garbage_ratio": "0.5", "read_only": 1}
    assert pb.VolumeInformation.from_dict(v).to_dict() == \
        ref_pb.VolumeInformation.from_dict(v).to_dict()
    a = {"fid": "3,01", "count": "2", "auth": "t"}
    assert pb.AssignResponse.from_dict(a).to_dict() == ref_pb.AssignResponse.from_dict(a).to_dict()
    assert pb.AssignRequest().to_dict() == ref_pb.AssignRequest().to_dict()
    assert (pb.MASTER_SERVICE, pb.VOLUME_SERVICE, pb.FILER_SERVICE, pb.MQ_SERVICE) == (
        ref_pb.MASTER_SERVICE, ref_pb.VOLUME_SERVICE, ref_pb.FILER_SERVICE, ref_pb.MQ_SERVICE)
