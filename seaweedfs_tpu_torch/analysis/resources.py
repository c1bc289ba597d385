"""resource-safety checkers.

open-no-ctx: a bare `open()` whose handle is not scoped by a `with`
(or handed to an ExitStack via `enter_context`) leaks the descriptor on
any exception between open and close. Long-lived handles that are
genuinely owned by an object (EcVolume's serving shard handles) are the
intentional exception — suppressed inline with a reason, which is
exactly what the suppression policy is for.

tmpfile-no-unlink: `NamedTemporaryFile(delete=False)` hands YOU the
unlink obligation; a function that creates one and never unlinks,
removes, or os.replace()s it litters the spool directory on every
failure — the drain+unlink discipline the streaming encode/rebuild
paths follow.
"""

from __future__ import annotations

import ast

from seaweedfs_tpu_torch.analysis import FileContext, Finding, per_file_checker


def _is_with_context(ctx: FileContext, call: ast.Call) -> bool:
    parent = ctx.parent(call)
    return isinstance(parent, ast.withitem) and parent.context_expr is call


def _is_enter_context_arg(ctx: FileContext, call: ast.Call) -> bool:
    parent = ctx.parent(call)
    return (
        isinstance(parent, ast.Call)
        and isinstance(parent.func, ast.Attribute)
        and parent.func.attr in ("enter_context", "push", "callback")
        and call in parent.args
    )


@per_file_checker
def check_open_no_ctx(ctx: FileContext) -> list[Finding]:
    findings: list[Finding] = []
    for node in ast.walk(ctx.tree):
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id == "open"
        ):
            continue
        if _is_with_context(ctx, node) or _is_enter_context_arg(ctx, node):
            continue
        findings.append(Finding(
            "open-no-ctx", ctx.rel, node.lineno,
            "open() outside a with/ExitStack — the handle leaks on any "
            "exception before close()",
        ))
    return findings


def _has_delete_false(call: ast.Call) -> bool:
    return any(
        kw.arg == "delete"
        and isinstance(kw.value, ast.Constant)
        and kw.value.value is False
        for kw in call.keywords
    )


_CONSUMERS = {"unlink", "remove", "replace", "rename"}


@per_file_checker
def check_tmpfile_no_unlink(ctx: FileContext) -> list[Finding]:
    findings: list[Finding] = []
    for fdef in ast.walk(ctx.tree):
        if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        tmp_sites = []
        consumed = False
        for node in ast.walk(fdef):
            if isinstance(node, ast.Call):
                f = node.func
                callee = f.attr if isinstance(f, ast.Attribute) else (
                    f.id if isinstance(f, ast.Name) else None
                )
                if callee == "NamedTemporaryFile" and _has_delete_false(node):
                    tmp_sites.append(node.lineno)
                if callee in _CONSUMERS:
                    consumed = True
        if not consumed:
            for line in tmp_sites:
                findings.append(Finding(
                    "tmpfile-no-unlink", ctx.rel, line,
                    f"NamedTemporaryFile(delete=False) in `{fdef.name}` "
                    "with no unlink/remove/replace in the same function — "
                    "the temp file outlives every failure path",
                ))
    return findings
