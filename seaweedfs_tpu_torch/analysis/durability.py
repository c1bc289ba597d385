"""durability checkers — the crash-consistency half of weedlint (weedsafe).

The tree carries four hand-rolled crash contracts (the `.ecp` ingest
journal, the `.ecc` convert journal with `.eci`-first cutover, the fsync'd
scrub cursor, and the crash-resumable kernel_sweep JSONL) plus a dozen
smaller tmp+rename publication sites. Each promises the same discipline:
flush+fsync staged bytes BEFORE the rename that publishes them, fsync data
BEFORE the journal record that vouches for it, stage under a
non-serving-discoverable name, and treat a torn JSON-lines tail as
end-of-journal rather than an error. These checkers machine-check the
lexically-visible part of that discipline; the dynamic half (recording
real op traces and replaying every crash prefix) lives in
`analysis.fsrec`.

fsync-missing-before-rename: a function opens a path for writing and
later os.replace()/os.rename()s that same path expression with no
fsync-looking call in between — the rename can publish a file whose
bytes are still in the page cache, so a crash yields an empty or torn
file under the FINAL name (the one state the tmp+rename idiom exists to
prevent). Scope-local and expression-matched on purpose: cross-function
handoffs (parts opened in __init__, sealed elsewhere) are the replayer's
job, not a lexical rule's.

record-before-fsync: a journal append whose payload is a watermark/rows
record (a dict literal with kind/type in {"rows", "watermark"}) with no
fsync-looking call earlier in the same function. A watermark record
VOUCHES for data bytes; journaling it before the data fsync means a crash
can leave a journal that testifies to bytes the disk never got. Intent
records ({"kind": "ow"}, deltas) are exempt — those are deliberately
journaled BEFORE the mutation they describe.

tmp-visible-name: a write/truncate-mode open() whose path ends in a
serving-discoverable suffix (.dat/.idx/.eci/.ecx/.ecj/.ecNN). Staged
output must be created under .inp/.cv.*/dot-tmp names and renamed into
place, or a reader (or crash) can observe a half-written final file.

torn-tail-unhandled: a loop over journal lines that json.loads() the
line with no ValueError/JSONDecodeError guard — a torn tail (the one
crash artifact every JSON-lines journal here is allowed to have) would
raise instead of terminating the read.
"""

from __future__ import annotations

import ast
import re
from typing import Optional

from seaweedfs_tpu_torch.analysis import FileContext, Finding, per_file_checker

# modes that create/truncate a file (append/update modes never produce the
# "empty file under the final name" hazard these rules target)
_CREATE_MODE_RE = re.compile(r"^[wx]b?\+?$")
_WRITE_MODE_RE = re.compile(r"^[wxa]b?\+?$|^r\+b?$")

#: suffixes a serving/scan path discovers on disk — creating one of these
#: names directly (instead of staging + rename) races every reader
_SERVING_SUFFIX_RE = re.compile(r"\.(dat|idx|eci|ecx|ecj|ec\d\d)$")

#: journal-append seams: a call through one of these names carrying a
#: vouching record is the "record" side of record-before-fsync
_APPEND_NAMES = {"append", "_append", "_append_record", "append_ecj", "persist"}

#: record kinds that vouch for previously-written data bytes (vs intent
#: records, which are journaled BEFORE their mutation by design)
_VOUCHING_KINDS = {"rows", "watermark"}


def _callee_name(call: ast.Call) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def _is_fsync_call(call: ast.Call) -> bool:
    """os.fsync(...) or any helper whose name mentions fsync (covers
    `_fsync_all`, `fsync_dir`, methods like `self._fsync_parts`)."""
    name = _callee_name(call)
    return name is not None and "fsync" in name


def _is_os_call(call: ast.Call, attr: str) -> bool:
    f = call.func
    return (
        isinstance(f, ast.Attribute)
        and f.attr == attr
        and isinstance(f.value, ast.Name)
        and f.value.id == "os"
    )


def _mode_of(call: ast.Call) -> Optional[str]:
    """The constant mode string of an open() call, None if dynamic."""
    mode_node: Optional[ast.expr] = None
    if len(call.args) >= 2:
        mode_node = call.args[1]
    for kw in call.keywords:
        if kw.arg == "mode":
            mode_node = kw.value
    if mode_node is None:
        return "r"
    if isinstance(mode_node, ast.Constant) and isinstance(mode_node.value, str):
        return mode_node.value
    return None


def _scopes(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _direct_walk(scope: ast.AST):
    """Walk a function body WITHOUT descending into nested function
    definitions (their opens/renames are their own scope's business)."""
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


@per_file_checker
def check_fsync_missing_before_rename(ctx: FileContext) -> list[Finding]:
    findings: list[Finding] = []
    for scope in _scopes(ctx.tree):
        opened: dict[str, int] = {}  # path-expr dump -> open line
        fsync_lines: list[int] = []
        renames: list[tuple[ast.Call, str]] = []
        for node in _direct_walk(scope):
            if not isinstance(node, ast.Call):
                continue
            if (
                isinstance(node.func, ast.Name)
                and node.func.id == "open"
                and node.args
            ):
                mode = _mode_of(node)
                if mode is not None and _WRITE_MODE_RE.match(mode):
                    opened[ast.dump(node.args[0])] = node.lineno
            elif _is_fsync_call(node):
                fsync_lines.append(node.lineno)
            elif (_is_os_call(node, "replace") or _is_os_call(node, "rename")) and node.args:
                renames.append((node, ast.dump(node.args[0])))
        for call, src_dump in renames:
            open_line = opened.get(src_dump)
            if open_line is None or open_line > call.lineno:
                continue
            if any(open_line <= ln <= call.lineno for ln in fsync_lines):
                continue
            findings.append(Finding(
                "fsync-missing-before-rename", ctx.rel, call.lineno,
                f"`{scope.name}` renames a path it opened for writing at "
                f"line {open_line} with no fsync in between — a crash "
                "after the rename can publish an empty/torn file under "
                "the final name",
            ))
    return findings


def _vouching_dict_arg(call: ast.Call) -> bool:
    for arg in list(call.args) + [kw.value for kw in call.keywords]:
        if not isinstance(arg, ast.Dict):
            continue
        for k, v in zip(arg.keys, arg.values):
            if (
                isinstance(k, ast.Constant)
                and k.value in ("kind", "type")
                and isinstance(v, ast.Constant)
                and v.value in _VOUCHING_KINDS
            ):
                return True
    return False


@per_file_checker
def check_record_before_fsync(ctx: FileContext) -> list[Finding]:
    findings: list[Finding] = []
    for scope in _scopes(ctx.tree):
        fsync_lines: list[int] = []
        appends: list[ast.Call] = []
        for node in _direct_walk(scope):
            if not isinstance(node, ast.Call):
                continue
            if _is_fsync_call(node):
                fsync_lines.append(node.lineno)
            elif _callee_name(node) in _APPEND_NAMES and _vouching_dict_arg(node):
                appends.append(node)
        for call in appends:
            if any(ln <= call.lineno for ln in fsync_lines):
                continue
            findings.append(Finding(
                "record-before-fsync", ctx.rel, call.lineno,
                f"`{scope.name}` journals a vouching record with no data "
                "fsync before it — a crash can leave a journal testifying "
                "to bytes the disk never got",
            ))
    return findings


def _const_suffix(expr: ast.expr) -> Optional[str]:
    """The trailing constant string fragment of a path expression, if the
    expression's tail is lexically visible: a string constant, `x + ".dat"`,
    an f-string ending in a literal, `% `/`.format` on a literal with a
    constant tail, or os.path.join(..., const)."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
        return _const_suffix(expr.right)
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Mod):
        return _const_suffix(expr.left)
    if isinstance(expr, ast.JoinedStr) and expr.values:
        return _const_suffix(expr.values[-1])
    if (
        isinstance(expr, ast.Call)
        and isinstance(expr.func, ast.Attribute)
        and expr.func.attr in ("join", "format")
        and expr.args
    ):
        if expr.func.attr == "format":
            return _const_suffix(expr.func.value)
        return _const_suffix(expr.args[-1])
    return None


@per_file_checker
def check_tmp_visible_name(ctx: FileContext) -> list[Finding]:
    findings: list[Finding] = []
    for node in ast.walk(ctx.tree):
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id == "open"
            and node.args
        ):
            continue
        mode = _mode_of(node)
        if mode is None or not _CREATE_MODE_RE.match(mode):
            continue
        suffix = _const_suffix(node.args[0])
        if suffix is None:
            continue
        # a '%'/format placeholder in the tail means the literal tail is
        # not the on-disk tail
        tail = suffix.rsplit("}", 1)[-1]
        m = _SERVING_SUFFIX_RE.search(tail)
        if m is None:
            continue
        findings.append(Finding(
            "tmp-visible-name", ctx.rel, node.lineno,
            f"creates `{m.group(0)}` (a serving-discoverable name) "
            "directly — stage under .inp/.cv.*/dot-tmp and rename into "
            "place so readers and crashes never observe a partial file",
        ))
    return findings


_TORN_EXC_NAMES = {"ValueError", "JSONDecodeError", "Exception", "BaseException"}


def _handler_catches_decode(handler: ast.ExceptHandler) -> bool:
    if handler.type is None:  # bare except
        return True
    types = (
        handler.type.elts
        if isinstance(handler.type, ast.Tuple)
        else [handler.type]
    )
    for t in types:
        name = t.attr if isinstance(t, ast.Attribute) else (
            t.id if isinstance(t, ast.Name) else None
        )
        if name in _TORN_EXC_NAMES:
            return True
    return False


def _guarded(ctx: FileContext, node: ast.AST, stop: ast.AST) -> bool:
    """Is `node` inside a try whose handlers catch decode errors, looking
    no further out than `stop` (the enclosing function/module)?"""
    cur = ctx.parent(node)
    while cur is not None and cur is not stop:
        if isinstance(cur, ast.Try) and any(
            _handler_catches_decode(h) for h in cur.handlers
        ):
            return True
        cur = ctx.parent(cur)
    return False


def _names_in(expr: ast.expr) -> set[str]:
    return {n.id for n in ast.walk(expr) if isinstance(n, ast.Name)}


def _loop_target_names(target: ast.expr) -> set[str]:
    return {n.id for n in ast.walk(target) if isinstance(n, ast.Name)}


@per_file_checker
def check_torn_tail_unhandled(ctx: FileContext) -> list[Finding]:
    findings: list[Finding] = []
    for scope in [ctx.tree] + list(_scopes(ctx.tree)):
        for node in _direct_walk(scope):
            if not isinstance(node, ast.For):
                continue
            targets = _loop_target_names(node.target)
            for sub in ast.walk(node):
                if not (
                    isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr == "loads"
                    and isinstance(sub.func.value, ast.Name)
                    and sub.func.value.id == "json"
                    and sub.args
                ):
                    continue
                if not (_names_in(sub.args[0]) & targets):
                    continue
                if _guarded(ctx, sub, scope):
                    continue
                findings.append(Finding(
                    "torn-tail-unhandled", ctx.rel, sub.lineno,
                    "json.loads on a journal line with no "
                    "ValueError/JSONDecodeError guard — a torn tail (the "
                    "one crash artifact JSON-lines journals are allowed "
                    "to have) would raise instead of ending the read",
                ))
    return findings
