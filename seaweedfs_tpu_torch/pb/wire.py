"""Binary protobuf wire for the pinned contracts — the protobuf transport
upstream speaks (weed/pb/*.proto), byte for byte the reference codec's.

No generated _pb2 modules are needed (grpcio-tools may be absent): the
codec builds message classes AT RUNTIME from a FileDescriptorSet.
protoc compiles `contracts.proto` to `contracts.desc` (regenerated on
demand when protoc is present; the committed artifact serves
protoc-less deploys), and `message_factory` turns each descriptor into
a concrete class. Each `WireCodec` loads its own private
`DescriptorPool`, so this codec and another package's can live in one
process.

Handlers keep their dict-shaped requests/responses — the codec converts
strictly between dicts and messages:

  - field names match 1:1 (the dict key IS the proto field name);
    an unknown dict key raises instead of silently dropping data
  - 64-bit ints stay Python ints (proto3 JSON would stringify them)
  - `bytes` fields carry base64 strings in the dicts (the JSON wire's
    convention) and raw bytes on the wire
  - maps accept str keys for integer key types ({"7": ...}), matching
    how JSON object keys arrive today

Switch: WEEDTPU_WIRE=proto flips every unary JSON method whose
(service, method) pair exists in the schema to binary protobuf on BOTH
the server's generic handlers and the client stubs; streams keep their
raw byte frames. All processes of a cluster must agree (same env),
like a reference cluster agrees on its .proto version.
"""

from __future__ import annotations

import base64
import functools
import os
import shutil
import subprocess
import threading

from seaweedfs_tpu_torch.utils import config

_HERE = os.path.dirname(os.path.abspath(__file__))
PROTO_PATH = os.path.join(_HERE, "contracts.proto")
DESC_PATH = os.path.join(_HERE, "contracts.desc")

_lock = threading.Lock()


# Wrapper messages: proto map values cannot themselves be maps or
# repeated, so the schema wraps them (RackMap{racks}, UrlList{urls}, ...)
# while the dicts keep their natural bare shape ({rack: [nodes]}). The
# codec unwraps/rewraps EXACTLY these registered messages — inferring
# wrapperness from shape would misfire on real single-field messages
# like LookupRequest.
WRAPPER_FIELD = {
    "weedtpu.DataNodeList": "nodes",
    "weedtpu.RackMap": "racks",
    "weedtpu.UrlList": "urls",
    "weedtpu.ShardHolderMap": "shards",
}


def _is_repeated(fd) -> bool:
    rep = getattr(fd, "is_repeated", None)
    if rep is not None:
        return rep() if callable(rep) else bool(rep)
    return fd.label == fd.LABEL_REPEATED  # older protobuf runtimes


def _bytes_in(value):
    if isinstance(value, (bytes, bytearray)):
        return bytes(value)
    return base64.b64decode(value)  # dicts carry b64 strings


def _scalar_converter(fd):
    """dict value -> proto field value coercion, resolved ONCE per field
    at plan-build time (the old path re-dispatched on fd.type per value)."""
    t = fd.type
    if t in (fd.TYPE_INT32, fd.TYPE_INT64, fd.TYPE_UINT32, fd.TYPE_UINT64,
             fd.TYPE_SINT32, fd.TYPE_SINT64, fd.TYPE_FIXED32, fd.TYPE_FIXED64,
             fd.TYPE_SFIXED32, fd.TYPE_SFIXED64):
        return int  # str keys like {"7": ...} arrive from JSON habits
    if t in (fd.TYPE_FLOAT, fd.TYPE_DOUBLE):
        return float
    if t == fd.TYPE_BOOL:
        return bool
    if t == fd.TYPE_BYTES:
        return _bytes_in
    if t == fd.TYPE_STRING:
        name = fd.name

        def check_str(value, _n=name):
            if not isinstance(value, str):
                raise ValueError(
                    f"field {_n}: expected str, got {type(value).__name__}"
                )
            return value

        return check_str
    name = fd.name

    def unsupported(value, _n=name, _t=t):
        raise ValueError(f"field {_n}: unsupported proto type {_t}")

    return unsupported


def _scalar_out_converter(fd):
    """proto field value -> dict value; None means identity (the common
    case — the caller skips the call entirely)."""
    if fd.type == fd.TYPE_BYTES:
        return lambda v: base64.b64encode(bytes(v)).decode()
    return None


def wire_format() -> str:
    """'proto' or 'json' — the process-wide wire selection."""
    return config.env("WEEDTPU_WIRE")


def _descriptor_set_bytes() -> bytes:
    """Fresh descriptor set from protoc when available (keeps the wire in
    lockstep with contracts.proto), else the committed artifact."""
    protoc = shutil.which("protoc")
    if protoc is not None:
        import tempfile

        with tempfile.NamedTemporaryFile(suffix=".desc") as tmp:
            proc = subprocess.run(
                [
                    protoc,
                    f"--proto_path={_HERE}",
                    "--include_imports",
                    f"--descriptor_set_out={tmp.name}",
                    PROTO_PATH,
                ],
                capture_output=True,
                timeout=60,
            )
            if proc.returncode == 0:
                tmp.seek(0)
                raw = tmp.read()
                if raw:
                    return raw
    with open(DESC_PATH, "rb") as f:
        return f.read()


class WireCodec:
    """(service, method) -> request/response message classes + strict
    dict<->message conversion.

    Conversion is PLAN-COMPILED: the first encounter of each message type
    builds per-field converter closures (field kind, scalar coercion,
    wrapper/presence semantics all resolved ONCE from the descriptor) and
    every later call is a dict walk over prebound closures — no per-value
    descriptor inspection or type-dispatch if-chains on the hot path."""

    def __init__(self) -> None:
        from google.protobuf import descriptor_pb2, descriptor_pool, message_factory

        self._pool = descriptor_pool.DescriptorPool()
        fds = descriptor_pb2.FileDescriptorSet.FromString(_descriptor_set_bytes())
        for fdp in fds.file:
            self._pool.Add(fdp)
        self._factory = message_factory
        # compiled conversion plans, keyed by message full_name
        self._fill_plans: dict[str, dict] = {}
        self._read_plans: dict[str, list] = {}
        # service methods: (service_full_name, method) -> (req_cls, resp_cls)
        self._methods: dict[tuple[str, str], tuple] = {}
        for fdp in fds.file:
            for svc in fdp.service:
                full = f"{fdp.package}.{svc.name}" if fdp.package else svc.name
                sdesc = self._pool.FindServiceByName(full)
                for m in sdesc.methods:
                    self._methods[(full, m.name)] = (
                        message_factory.GetMessageClass(m.input_type),
                        message_factory.GetMessageClass(m.output_type),
                    )

    def has(self, service: str, method: str) -> bool:
        return (service, method) in self._methods

    def classes(self, service: str, method: str):
        return self._methods[(service, method)]

    # -- dict -> message ------------------------------------------------------

    def to_message(self, d: dict, cls):
        msg = cls()
        self._fill(msg, d or {})
        return msg

    def _fill(self, msg, d) -> None:
        desc = msg.DESCRIPTOR
        wrap = WRAPPER_FIELD.get(desc.full_name)
        if wrap is not None:
            # wrapper values arrive in their natural bare shape, always
            # (to_dict only ever emits bare; a rack literally named
            # "racks" must not flip the interpretation)
            d = {wrap: d}
        if not isinstance(d, dict):
            raise ValueError(
                f"{desc.full_name}: expected an object, got {type(d).__name__}"
            )
        plan = self._fill_plans.get(desc.full_name)
        if plan is None:
            plan = self._build_fill_plan(desc)
        for key, value in d.items():
            filler = plan.get(key)
            if filler is None:
                raise ValueError(
                    f"{desc.full_name}: dict key {key!r} is not a schema field"
                )
            if value is None:
                continue  # absent on the wire, like a missing JSON key
            filler(msg, value)

    def _build_fill_plan(self, desc) -> dict:
        """field name -> filler(msg, value) closure, every per-field
        decision (map/repeated/message/scalar kind, scalar coercion)
        resolved once from the descriptor."""
        plan: dict = {}
        fill = self._fill
        for fd in desc.fields:
            name = fd.name
            if fd.message_type is not None and fd.message_type.GetOptions().map_entry:
                key_conv = _scalar_converter(fd.message_type.fields_by_name["key"])
                val_fd = fd.message_type.fields_by_name["value"]
                if val_fd.message_type is not None:
                    def filler(msg, value, _n=name, _kc=key_conv):
                        tgt = getattr(msg, _n)
                        for k, v in value.items():
                            fill(tgt[_kc(k)], v)
                else:
                    val_conv = _scalar_converter(val_fd)
                    def filler(msg, value, _n=name, _kc=key_conv, _vc=val_conv):
                        tgt = getattr(msg, _n)
                        for k, v in value.items():
                            tgt[_kc(k)] = _vc(v)
            elif _is_repeated(fd):
                if fd.message_type is not None:
                    def filler(msg, value, _n=name):
                        tgt = getattr(msg, _n)
                        for item in value:
                            fill(tgt.add(), item)
                else:
                    conv = _scalar_converter(fd)
                    def filler(msg, value, _n=name, _c=conv):
                        getattr(msg, _n).extend(_c(item) for item in value)
            elif fd.message_type is not None:
                def filler(msg, value, _n=name):
                    fill(getattr(msg, _n), value)
            else:
                conv = _scalar_converter(fd)
                def filler(msg, value, _n=name, _c=conv):
                    setattr(msg, _n, _c(value))
            plan[name] = filler
        self._fill_plans[desc.full_name] = plan
        return plan

    # -- message -> dict ------------------------------------------------------

    def to_dict(self, msg):
        desc = msg.DESCRIPTOR
        wrap = WRAPPER_FIELD.get(desc.full_name)
        if wrap is not None:
            inner = self._to_dict_fields(msg)
            fd = desc.fields_by_name[wrap]
            if fd.message_type is not None and fd.message_type.GetOptions().map_entry:
                return inner.get(wrap, {})
            return inner.get(wrap, [])
        return self._to_dict_fields(msg)

    def _to_dict_fields(self, msg) -> dict:
        desc = msg.DESCRIPTOR
        plan = self._read_plans.get(desc.full_name)
        if plan is None:
            plan = self._build_read_plan(desc)
        out: dict = {}
        for extract in plan:
            extract(msg, out)
        return out

    def _build_read_plan(self, desc) -> list:
        """List of extract(msg, out) closures — one per field, each with
        its map/repeated/presence/bytes handling prebound."""
        plan: list = []
        to_dict = self.to_dict
        for fd in desc.fields:
            name = fd.name
            if fd.message_type is not None and fd.message_type.GetOptions().map_entry:
                # maps always emit (possibly {}): readers index resp["x"]
                val_fd = fd.message_type.fields_by_name["value"]
                if val_fd.message_type is not None:
                    def extract(msg, out, _n=name):
                        out[_n] = {k: to_dict(v) for k, v in getattr(msg, _n).items()}
                elif val_fd.type == val_fd.TYPE_BYTES:
                    def extract(msg, out, _n=name):
                        out[_n] = {
                            k: base64.b64encode(bytes(v)).decode()
                            for k, v in getattr(msg, _n).items()
                        }
                else:
                    # JSON object keys are strings; handlers already int()
                    # them — keep native ints for int-keyed maps (both
                    # sides accept them)
                    def extract(msg, out, _n=name):
                        out[_n] = dict(getattr(msg, _n).items())
            elif _is_repeated(fd):
                # repeated always emits (possibly []), same reason
                if fd.message_type is not None:
                    def extract(msg, out, _n=name):
                        out[_n] = [to_dict(v) for v in getattr(msg, _n)]
                elif fd.type == fd.TYPE_BYTES:
                    def extract(msg, out, _n=name):
                        out[_n] = [
                            base64.b64encode(bytes(v)).decode()
                            for v in getattr(msg, _n)
                        ]
                else:
                    def extract(msg, out, _n=name):
                        out[_n] = list(getattr(msg, _n))
            elif fd.message_type is not None:
                def extract(msg, out, _n=name):
                    if msg.HasField(_n):
                        out[_n] = to_dict(getattr(msg, _n))
            elif fd.has_presence:
                # `optional` scalar: absent and explicit-default differ on
                # the wire AND to handlers (.get(k, True) patterns —
                # copy_ecx_file / is_delete_data)
                conv = _scalar_out_converter(fd)
                if conv is None:
                    def extract(msg, out, _n=name):
                        if msg.HasField(_n):
                            out[_n] = getattr(msg, _n)
                else:
                    def extract(msg, out, _n=name, _c=conv):
                        if msg.HasField(_n):
                            out[_n] = _c(getattr(msg, _n))
            else:
                # plain proto3 scalar: zero == unset on the wire, so the
                # dict always carries the key (the codebase's dominant
                # pattern is req["volume_id"]-style indexing; the few
                # handlers with NON-zero defaults use `.get(k) or default`
                # or-defaulting, which treats explicit zero as unset —
                # exactly proto3's semantics)
                conv = _scalar_out_converter(fd)
                if conv is None:
                    def extract(msg, out, _n=name):
                        out[_n] = getattr(msg, _n)
                else:
                    def extract(msg, out, _n=name, _c=conv):
                        out[_n] = _c(getattr(msg, _n))
            plan.append(extract)
        self._read_plans[desc.full_name] = plan
        return plan

    # -- gRPC (de)serializers --------------------------------------------------

    def request_serdes(self, service: str, method: str):
        """(serializer, deserializer) for the REQUEST message."""
        req_cls, _ = self.classes(service, method)
        return (
            lambda d: self.to_message(d, req_cls).SerializeToString(),
            lambda raw: self.to_dict(req_cls.FromString(raw)),
        )

    def response_serdes(self, service: str, method: str):
        _, resp_cls = self.classes(service, method)
        return (
            lambda d: self.to_message(d, resp_cls).SerializeToString(),
            lambda raw: self.to_dict(resp_cls.FromString(raw)),
        )


@functools.lru_cache(maxsize=1)
def codec() -> WireCodec:
    with _lock:
        return WireCodec()


def regenerate_descriptor_artifact() -> bytes:
    """Write contracts.desc next to the proto (CI/commit-time helper; the
    drift test asserts the artifact matches what protoc emits)."""
    raw = _descriptor_set_bytes()
    with open(DESC_PATH, "wb") as f:
        f.write(raw)
    return raw
