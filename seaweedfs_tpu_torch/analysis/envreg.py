"""env-var registry checkers.

env-raw-read: every configuration read must go through the typed
registry in utils/config.py (config.env) — raw
`os.environ[...]` / `os.environ.get(...)` / `os.getenv(...)` reads
scattered across modules are how defaults drift apart (the pipeline
depth was clamped in one place and not another before the registry).
Writes (`os.environ[k] = v`) and whole-environment passthrough
(`dict(os.environ)` for subprocess envs) are NOT flagged — they are
process plumbing, not configuration reads. utils/config.py itself is
exempt: it IS the registry.

env-unregistered: `config.env("NAME")` with a static name missing from
ENV_REGISTRY — a typo'd knob must fail in CI, not read as a silent
default forever (the runtime raises too; this catches it before any
test exercises the path).
"""

from __future__ import annotations

import ast

from seaweedfs_tpu_torch.analysis import FileContext, Finding, per_file_checker

_EXEMPT_SUFFIX = ("utils/config.py",)


def _is_os_environ(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Attribute)
        and node.attr == "environ"
        and isinstance(node.value, ast.Name)
        and node.value.id == "os"
    )


@per_file_checker
def check_env_raw_read(ctx: FileContext) -> list[Finding]:
    if ctx.rel.replace("\\", "/").endswith(_EXEMPT_SUFFIX):
        return []
    findings: list[Finding] = []
    for node in ast.walk(ctx.tree):
        # os.getenv(...)
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "getenv"
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "os"
        ):
            findings.append(Finding(
                "env-raw-read", ctx.rel, node.lineno,
                "os.getenv() — read through the utils/config.py registry "
                "(config.env) instead",
            ))
        # os.environ.get(...) / os.environ.setdefault(...)
        elif (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in ("get", "setdefault")
            and _is_os_environ(node.func.value)
        ):
            findings.append(Finding(
                "env-raw-read", ctx.rel, node.lineno,
                f"os.environ.{node.func.attr}() — read through the "
                "utils/config.py registry (config.env) instead",
            ))
        # os.environ[...] in Load position (subscript writes/deletes are
        # plumbing: benches and tests set the environment on purpose)
        elif (
            isinstance(node, ast.Subscript)
            and _is_os_environ(node.value)
            and isinstance(node.ctx, ast.Load)
        ):
            findings.append(Finding(
                "env-raw-read", ctx.rel, node.lineno,
                "os.environ[...] read — go through the utils/config.py "
                "registry (config.env) instead",
            ))
    return findings


@per_file_checker
def check_env_unregistered(ctx: FileContext) -> list[Finding]:
    # the registry itself is import-light (no jax, no package deps), so
    # the checker can consult the live catalog
    from seaweedfs_tpu_torch.utils.config import ENV_REGISTRY

    findings: list[Finding] = []
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call) and node.args):
            continue
        f = node.func
        is_env_call = (
            isinstance(f, ast.Attribute)
            and f.attr == "env"
            and isinstance(f.value, ast.Name)
            and f.value.id == "config"
        ) or (isinstance(f, ast.Name) and f.id == "env")
        if not is_env_call:
            continue
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            name = arg.value
            if name.startswith("WEEDTPU_") and name not in ENV_REGISTRY:
                findings.append(Finding(
                    "env-unregistered", ctx.rel, node.lineno,
                    f"config.env({name!r}) — not in ENV_REGISTRY; register "
                    "it in utils/config.py (name, type, default, doc)",
                ))
    return findings
