"""dispatch/donation safety checkers.

jit-host-sync (per-file): a function compiled by `jax.jit` runs as one
async device dispatch; host work inside it — numpy materialization,
file I/O, `.block_until_ready()`, print — either breaks tracing or
silently serializes the pipeline the streaming paths spent three PRs
overlapping. Flag it at the call site.

donated-buffer-read (per-file): `jax.jit(..., donate_argnums=...)`
transfers ownership of the donated argument's buffer to XLA — the
caller's array is DEAD after the dispatch (the `_StagingRing` reuse
contract from the streaming pipeline). Reading a name again after
passing it at a donated position is use-after-free that happens to work
on CPU and corrupts on device. The checker tracks names bound to
donated jits file-locally and flags any later read of a donated
argument in the same function unless it is re-bound first.

Both rules see THROUGH `shard_map` wrappers (the mesh backend's shape:
`jax.jit(shard_map(f, ...), donate_argnums=...)` bindings and
`@functools.partial(jax.jit, donate_argnums=...)` stacked over
`@functools.partial(shard_map, ...)` defs): the mapped body is traced
exactly like a jitted one, so host work inside it is flagged, and a
name passed at a donated position of the wrapped callable follows the
same dead-until-rebound rule.
"""

from __future__ import annotations

import ast
from typing import Optional

from seaweedfs_tpu_torch.analysis import FileContext, Finding, per_file_checker

_HOST_SYNC_NP = {"asarray", "array", "frombuffer", "copyto", "save", "load"}
_HOST_SYNC_METHODS = {"block_until_ready", "tobytes", "item", "tolist"}


def _is_jit_call(node: ast.AST) -> bool:
    """`jax.jit(...)` / `jit(...)` / `functools.partial(jax.jit, ...)`."""
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr == "jit":
        return True
    if isinstance(f, ast.Name) and f.id == "jit":
        return True
    if isinstance(f, ast.Attribute) and f.attr == "partial" or (
        isinstance(f, ast.Name) and f.id == "partial"
    ):
        return bool(node.args) and _is_jit_ref(node.args[0])
    return False


def _is_jit_ref(node: ast.AST) -> bool:
    return (isinstance(node, ast.Attribute) and node.attr == "jit") or (
        isinstance(node, ast.Name) and node.id == "jit"
    )


def _is_shard_map_ref(node: ast.AST) -> bool:
    return (isinstance(node, ast.Attribute) and node.attr == "shard_map") or (
        isinstance(node, ast.Name) and node.id == "shard_map"
    )


def _is_shard_map_call(node: ast.AST) -> bool:
    """`shard_map(f, ...)` / `functools.partial(shard_map, mesh=...)` —
    the mapped body is traced like a jitted one, so both checkers must
    see through the wrapper."""
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if _is_shard_map_ref(f):
        return True
    if isinstance(f, ast.Attribute) and f.attr == "partial" or (
        isinstance(f, ast.Name) and f.id == "partial"
    ):
        return bool(node.args) and _is_shard_map_ref(node.args[0])
    return False


def _jitted_function_defs(tree: ast.AST) -> list[ast.FunctionDef]:
    """Defs that run traced: decorated with jit/partial(jit) or
    shard_map/partial(shard_map), or passed by name to a `jax.jit(f, ...)`
    or `shard_map(f, ...)` call anywhere in the file."""
    jitted_names: set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if _is_jit_call(node) or _is_shard_map_call(node):
            args = node.args
            # first positional arg is the wrapped callable — but in the
            # partial(jit/shard_map, ...) spelling it is the wrapper
            # itself, not a user function
            if (
                args
                and isinstance(args[0], ast.Name)
                and not _is_jit_ref(args[0])
                and not _is_shard_map_ref(args[0])
            ):
                jitted_names.add(args[0].id)
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if node.name in jitted_names or any(
            _is_jit_call(d)
            or _is_jit_ref(d)
            or _is_shard_map_call(d)
            or _is_shard_map_ref(d)
            for d in node.decorator_list
        ):
            out.append(node)
    return out


@per_file_checker
def check_jit_host_sync(ctx: FileContext) -> list[Finding]:
    findings: list[Finding] = []
    for fdef in _jitted_function_defs(ctx.tree):
        for node in ast.walk(fdef):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Name) and f.id in ("open", "print"):
                findings.append(Finding(
                    "jit-host-sync", ctx.rel, node.lineno,
                    f"`{f.id}(...)` inside jitted `{fdef.name}` — host I/O "
                    "does not belong in a traced dispatch",
                ))
            elif isinstance(f, ast.Attribute):
                if (
                    isinstance(f.value, ast.Name)
                    and f.value.id in ("np", "numpy")
                    and f.attr in _HOST_SYNC_NP
                ):
                    findings.append(Finding(
                        "jit-host-sync", ctx.rel, node.lineno,
                        f"`np.{f.attr}(...)` inside jitted `{fdef.name}` — "
                        "materializes on host mid-dispatch (use jnp)",
                    ))
                elif f.attr in _HOST_SYNC_METHODS:
                    findings.append(Finding(
                        "jit-host-sync", ctx.rel, node.lineno,
                        f"`.{f.attr}()` inside jitted `{fdef.name}` — "
                        "forces a device sync inside the traced region",
                    ))
    return findings


def _donated_positions(call: ast.Call) -> Optional[list[int]]:
    """The static donate_argnums of a jit(...) call, or None."""
    for kw in call.keywords:
        if kw.arg != "donate_argnums":
            continue
        v = kw.value
        if isinstance(v, ast.Constant) and isinstance(v.value, int):
            return [v.value]
        if isinstance(v, (ast.Tuple, ast.List)):
            out = []
            for elt in v.elts:
                if isinstance(elt, ast.Constant) and isinstance(elt.value, int):
                    out.append(elt.value)
            return out
    return None


def _donating_names(tree: ast.AST) -> dict[str, list[int]]:
    """name -> donated positions, for `g = jax.jit(f, donate_argnums=...)`
    bindings anywhere in the file (module or function scope; `f` may be a
    `shard_map(...)` wrapper — the binding is what donates), and for defs
    decorated with a donating jit (`@functools.partial(jax.jit,
    donate_argnums=...)`, typically stacked over a shard_map partial)."""
    out: dict[str, list[int]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            if not (isinstance(node.value, ast.Call) and _is_jit_call(node.value)):
                continue
            pos = _donated_positions(node.value)
            if not pos:
                continue
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = pos
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for d in node.decorator_list:
                if isinstance(d, ast.Call) and _is_jit_call(d):
                    pos = _donated_positions(d)
                    if pos:
                        out[node.name] = pos
    return out


@per_file_checker
def check_donated_buffer_read(ctx: FileContext) -> list[Finding]:
    donating = _donating_names(ctx.tree)
    if not donating:
        return []
    findings: list[Finding] = []
    for fdef in ast.walk(ctx.tree):
        if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        # (donated name, donation line) pairs within this function
        donated: list[tuple[str, int]] = []
        rebinds: dict[str, list[int]] = {}
        reads: list[tuple[str, int]] = []
        for node in ast.walk(fdef):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
                pos = donating.get(node.func.id)
                if pos:
                    for p in pos:
                        if p < len(node.args) and isinstance(node.args[p], ast.Name):
                            donated.append((node.args[p].id, node.lineno))
            if isinstance(node, ast.Name):
                if isinstance(node.ctx, ast.Store):
                    rebinds.setdefault(node.id, []).append(node.lineno)
                elif isinstance(node.ctx, ast.Load):
                    reads.append((node.id, node.lineno))
        for name, dline in donated:
            for rname, rline in reads:
                if rname != name or rline <= dline:
                    continue
                # a re-bind between donation and read revives the name
                if any(dline < b <= rline for b in rebinds.get(name, ())):
                    continue
                findings.append(Finding(
                    "donated-buffer-read", ctx.rel, rline,
                    f"`{name}` read after being donated on line {dline} — "
                    "the buffer belongs to XLA now (stage a fresh array, "
                    "or drop the donation)",
                ))
    return findings
