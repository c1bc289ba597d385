"""wire-drift checker (project-wide).

The RPC plane has three representations that must agree:

  1. `pb/contracts.proto` — the pinned schema (source of truth),
  2. `pb/contracts.desc` — the committed FileDescriptorSet artifact that
     serves protoc-less deploys (regenerated on demand when protoc is
     present, so it can silently go stale in a PR that edits the .proto),
  3. the dict-shaped handlers — `req["field"]` reads and `return {...}`
     literals whose keys ARE proto field names on the binary wire
     (an unknown key raises at conversion time, but only on the
     WEEDTPU_WIRE=proto path that tier-1 exercises least).

This checker cross-references all three: .proto vs .desc message/field
sets, wire.py's WRAPPER_FIELD registry vs the schema, and every
svc.add-registered handler's request-key reads and
response-literal keys vs the method's request/response messages.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Optional

from seaweedfs_tpu_torch.analysis import REPO_ROOT, FileContext, Finding, project_checker

_FIELD_RE = re.compile(
    r"^\s*(?:repeated\s+|optional\s+|required\s+)?"
    r"(?:map\s*<[^>]+>|[\w.]+)\s+(\w+)\s*=\s*\d+"
)
_RPC_RE = re.compile(
    r"^\s*rpc\s+(\w+)\s*\(\s*(?:stream\s+)?([\w.]+)\s*\)\s*"
    r"returns\s*\(\s*(stream\s+)?([\w.]+)\s*\)"
)
_KEYWORDS = ("message ", "service ", "enum ", "rpc ", "option ", "syntax",
             "package", "import ", "reserved ")


def parse_proto(path: str):
    """-> (messages: {qualname: set(field names)}, lines: {qualname: line},
    methods: {method: [(request_msg, response_msg, resp_is_stream), ...]}).
    Message qualnames are dotted for nesting (Outer.Inner); method message
    refs resolve to the bare name as written in the rpc line."""
    messages: dict[str, set[str]] = {}
    msg_lines: dict[str, int] = {}
    methods: dict[str, list[tuple[str, str, bool]]] = {}
    stack: list[tuple[str, Optional[str]]] = []  # (kind, name)

    with open(path, "r", encoding="utf-8") as f:
        for lineno, raw in enumerate(f, start=1):
            line = raw.split("//", 1)[0].rstrip()
            if not line.strip():
                continue
            stripped = line.strip()
            m = re.match(r"^(message|service|enum|oneof)\s+(\w+)?", stripped)
            if m and "{" in stripped:
                kind, name = m.group(1), m.group(2)
                if kind == "message":
                    qual = ".".join(
                        [n for k, n in stack if k == "message" and n] + [name]
                    )
                    messages[qual] = set()
                    msg_lines[qual] = lineno
                    stack.append(("message", qual))
                    # one-line bodies carry their fields on the same line:
                    #   message LookupRequest { repeated string ids = 1; }
                    body = stripped.split("{", 1)[1]
                    for decl in body.split(";"):
                        fm = _FIELD_RE.match(decl.strip())
                        if fm:
                            messages[qual].add(fm.group(1))
                else:
                    stack.append((kind, name))
                if stripped.count("}") >= stripped.count("{"):
                    stack.pop()  # one-line body closes immediately
                continue
            rm = _RPC_RE.match(stripped)
            if rm:
                # same-named methods across services merge: the handler
                # check unions their fields (a per-service split would
                # need the Service() wiring, and union only under-flags)
                methods.setdefault(rm.group(1), []).append((
                    rm.group(2).split(".")[-1],
                    rm.group(4).split(".")[-1],
                    bool(rm.group(3)),
                ))
                continue
            # fields attribute to the nearest enclosing MESSAGE — a field
            # inside `oneof { ... }` belongs to the message, not the oneof
            owner = next(
                (n for k, n in reversed(stack) if k == "message"), None
            )
            if owner is not None and stack[-1][0] in ("message", "oneof"):
                fm = _FIELD_RE.match(line)
                if fm and not stripped.startswith(_KEYWORDS):
                    messages[owner].add(fm.group(1))
            if stripped.startswith("}") or stripped == "};":
                if stack:
                    stack.pop()
    return messages, msg_lines, methods


def _bare(messages: dict[str, set[str]]) -> dict[str, set[str]]:
    """Leaf-name view (handlers and rpc lines use bare names; collisions
    between a top-level and a nested message would be a schema smell this
    project does not have)."""
    out: dict[str, set[str]] = {}
    for qual, fields in messages.items():
        out[qual.split(".")[-1]] = fields
    return out


def _desc_messages(desc_path: str) -> Optional[dict[str, set[str]]]:
    """Message -> field-name sets from the committed descriptor artifact
    (map-entry synthetic messages skipped). None when the protobuf
    runtime is unavailable."""
    try:
        from google.protobuf import descriptor_pb2
    except ImportError:  # pragma: no cover — runtime ships in this image
        return None
    with open(desc_path, "rb") as f:
        fds = descriptor_pb2.FileDescriptorSet.FromString(f.read())
    out: dict[str, set[str]] = {}

    def walk(msg, prefix: str) -> None:
        if msg.options.map_entry:
            return
        qual = f"{prefix}.{msg.name}" if prefix else msg.name
        out[qual] = {f.name for f in msg.field}
        for nested in msg.nested_type:
            walk(nested, qual)

    for fdp in fds.file:
        for msg in fdp.message_type:
            walk(msg, "")
    return out


def _handler_map(ctx: FileContext) -> dict[str, str]:
    """handler function name -> RPC method name, from svc.add / bare-add
    registration calls whose first arg is the method string literal."""
    out: dict[str, str] = {}
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call) and len(node.args) >= 2):
            continue
        f = node.func
        callee = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else None
        )
        if callee != "add":
            continue
        method, handler = node.args[0], node.args[1]
        if not (isinstance(method, ast.Constant) and isinstance(method.value, str)):
            continue
        if isinstance(handler, ast.Attribute):
            out[handler.attr] = method.value
        elif isinstance(handler, ast.Name):
            out[handler.id] = method.value
    return out


def _req_keys(fdef: ast.FunctionDef, req_name: str) -> list[tuple[str, int]]:
    keys = []
    for node in ast.walk(fdef):
        if (
            isinstance(node, ast.Subscript)
            and isinstance(node.value, ast.Name)
            and node.value.id == req_name
            and isinstance(node.slice, ast.Constant)
            and isinstance(node.slice.value, str)
        ):
            keys.append((node.slice.value, node.lineno))
        elif (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "get"
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == req_name
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            keys.append((node.args[0].value, node.lineno))
    return keys


def _resp_literal_keys(fdef: ast.FunctionDef) -> list[tuple[str, int]]:
    """Constant keys of dict literals returned DIRECTLY by the handler
    (built-up response dicts are out of static reach; the wire codec
    still catches them at runtime on the proto path)."""
    keys = []
    for node in ast.walk(fdef):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Dict):
            for k in node.value.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    keys.append((k.value, node.lineno))
    return keys


@project_checker
def check_wire_drift(ctxs: list[FileContext], root: str) -> list[Finding]:
    proto_path = os.path.join(root, "pb", "contracts.proto")
    if not os.path.exists(proto_path):
        return []
    proto_rel = os.path.relpath(proto_path, REPO_ROOT)
    messages, msg_lines, methods = parse_proto(proto_path)
    bare = _bare(messages)
    findings: list[Finding] = []

    # 1. committed descriptor artifact vs the .proto text
    desc_path = os.path.join(root, "pb", "contracts.desc")
    if os.path.exists(desc_path):
        desc = _desc_messages(desc_path)
        if desc is not None:
            for qual, fields in sorted(messages.items()):
                if qual not in desc:
                    findings.append(Finding(
                        "wire-drift", proto_rel, msg_lines.get(qual, 1),
                        f"message {qual} is in contracts.proto but not the "
                        "committed contracts.desc — regenerate the artifact "
                        "(pb.wire.regenerate_descriptor_artifact)",
                    ))
                elif fields != desc[qual]:
                    only_proto = sorted(fields - desc[qual])
                    only_desc = sorted(desc[qual] - fields)
                    findings.append(Finding(
                        "wire-drift", proto_rel, msg_lines.get(qual, 1),
                        f"message {qual} fields drifted from contracts.desc "
                        f"(proto-only: {only_proto}, desc-only: {only_desc}) "
                        "— regenerate the artifact",
                    ))
            for qual in sorted(set(desc) - set(messages)):
                findings.append(Finding(
                    "wire-drift", proto_rel, 1,
                    f"message {qual} is in contracts.desc but not "
                    "contracts.proto — regenerate the artifact",
                ))

    # 2. wire.py WRAPPER_FIELD registry vs the schema
    for ctx in ctxs:
        if not ctx.rel.replace("\\", "/").endswith("pb/wire.py"):
            continue
        for node in ast.walk(ctx.tree):
            if not (
                isinstance(node, ast.Assign)
                and any(
                    isinstance(t, ast.Name) and t.id == "WRAPPER_FIELD"
                    for t in node.targets
                )
                and isinstance(node.value, ast.Dict)
            ):
                continue
            for k, v in zip(node.value.keys, node.value.values):
                if not (isinstance(k, ast.Constant) and isinstance(v, ast.Constant)):
                    continue
                msg = str(k.value).split(".")[-1]
                if msg not in bare:
                    findings.append(Finding(
                        "wire-drift", ctx.rel, k.lineno,
                        f"WRAPPER_FIELD names unknown message {k.value!r}",
                    ))
                elif str(v.value) not in bare[msg]:
                    findings.append(Finding(
                        "wire-drift", ctx.rel, k.lineno,
                        f"WRAPPER_FIELD[{k.value!r}] = {v.value!r} is not a "
                        f"field of {msg} (has {sorted(bare[msg])})",
                    ))

    # 3. handler request reads / response literals vs the schema
    for ctx in ctxs:
        handlers = _handler_map(ctx)
        if not handlers:
            continue
        for fdef in ast.walk(ctx.tree):
            if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            method = handlers.get(fdef.name)
            if method is None or method not in methods:
                continue
            entries = methods[method]
            req_msgs = sorted({e[0] for e in entries})
            resp_msgs = sorted({e[1] for e in entries if not e[2]})
            args = [a.arg for a in fdef.args.args]
            req_name = args[1] if args and args[0] == "self" and len(args) > 1 else (
                args[0] if args else None
            )
            req_fields: Optional[set[str]] = None
            for msg in req_msgs:
                if msg in bare:
                    req_fields = (req_fields or set()) | bare[msg]
            if req_name and req_fields is not None:
                for key, line in _req_keys(fdef, req_name):
                    if key not in req_fields:
                        findings.append(Finding(
                            "wire-drift", ctx.rel, line,
                            f"handler {fdef.name} ({method}) reads "
                            f"req[{key!r}] but {'/'.join(req_msgs)} has no "
                            f"such field (has {sorted(req_fields)})",
                        ))
            resp_fields: Optional[set[str]] = None
            for msg in resp_msgs:
                if msg in bare:
                    resp_fields = (resp_fields or set()) | bare[msg]
            if resp_fields is not None:
                for key, line in _resp_literal_keys(fdef):
                    if key not in resp_fields:
                        findings.append(Finding(
                            "wire-drift", ctx.rel, line,
                            f"handler {fdef.name} ({method}) returns key "
                            f"{key!r} but {'/'.join(resp_msgs)} has no such "
                            f"field (has {sorted(resp_fields)})",
                        ))
    return findings
