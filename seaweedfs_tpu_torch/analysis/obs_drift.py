"""obs-drift checker family (project-wide).

The observability layer has two closed catalogs that dashboards, the
weedload scraper, `ec.status`, and the tail-attribution artifact all key
on by STRING — so they rot silently:

  1. metric names: every `weedtpu_*` metric must be declared ONCE in
     `stats/__init__.py` (REGISTRY.counter/gauge/histogram). A scrape
     list or shell summary referencing an undeclared name reads zeros
     forever; a declared metric nobody increments or scrapes is dead
     weight that LOOKS like telemetry.
  2. span names: every `span("...")`/`start("...")`/`ensure("...")`
     call site must name a stage registered in `obs/trace.py`'s
     SPAN_NAMES, and every registered stage must have a call site —
     the attribution artifact's stage keys are these strings verbatim.

Rules:
  obs-metric-undeclared  a metric-shaped string literal (suffix _total/
                         _seconds/_count/_sum/_bucket/_inflight) not in
                         the stats registry. Plain `weedtpu_*` strings
                         WITHOUT a metric suffix are ignored — native C
                         symbol names and ContextVar labels share the
                         prefix.
  obs-metric-unused      a registry declaration whose binding name and
                         metric string appear nowhere else in the tree.
  obs-span-undeclared    a trace call site naming a stage missing from
                         SPAN_NAMES.
  obs-span-unused        a SPAN_NAMES entry no call site uses.

Like wire-drift, the declaration sources resolve RELATIVE TO THE
SCANNED ROOT (`<root>/stats/__init__.py`, `<root>/obs/trace.py`), so the
planted-violation fixture tree exercises the checker end to end without
touching the real catalogs.
"""

from __future__ import annotations

import ast
import os
import re

from seaweedfs_tpu_torch.analysis import (
    REPO_ROOT,
    FileContext,
    Finding,
    project_checker,
)

_METRIC_LITERAL = re.compile(r"^weedtpu_[a-z0-9_]+$")
_METRIC_SUFFIX = re.compile(
    r"^weedtpu_[a-z0-9_]+_(total|seconds|count|sum|bucket|inflight)$"
)
#: exposition-format suffixes a histogram's scraped series carry on top
#: of its declared name
_SERIES_SUFFIXES = ("_count", "_sum", "_bucket")
#: trace call spellings the package uses: module-qualified (any alias
#: containing "trace") or the bare contextmanager name
_SPAN_FNS = ("span", "start", "ensure", "continue_trace", "traced")


def _parse_metric_decls(path: str):
    """{metric_name: (binding, line)} from a stats registry module:
    `Binding = REGISTRY.counter("weedtpu_...", ...)` shapes."""
    out: dict[str, tuple[str, int]] = {}
    if not os.path.exists(path):
        return out
    with open(path, "r", encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        tgt, val = node.targets[0], node.value
        if not (
            isinstance(tgt, ast.Name)
            and isinstance(val, ast.Call)
            and isinstance(val.func, ast.Attribute)
            and val.func.attr in ("counter", "gauge", "histogram")
            and val.args
            and isinstance(val.args[0], ast.Constant)
            and isinstance(val.args[0].value, str)
        ):
            continue
        out[val.args[0].value] = (tgt.id, node.lineno)
    return out


def _parse_span_catalog(path: str):
    """{span_name: line} from SPAN_NAMES = {...} in obs/trace.py."""
    out: dict[str, int] = {}
    if not os.path.exists(path):
        return out
    with open(path, "r", encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        targets = []
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        else:
            continue
        for tgt in targets:
            if (
                isinstance(tgt, ast.Name)
                and tgt.id == "SPAN_NAMES"
                and isinstance(value, ast.Dict)
            ):
                for key in value.keys:
                    if isinstance(key, ast.Constant) and isinstance(key.value, str):
                        out[key.value] = key.lineno
    return out


def _is_span_call(node: ast.Call) -> bool:
    f = node.func
    if isinstance(f, ast.Name):
        return f.id in _SPAN_FNS
    if isinstance(f, ast.Attribute) and f.attr in _SPAN_FNS:
        base = f.value
        return isinstance(base, ast.Name) and "trace" in base.id.lower()
    return False


@project_checker
def check_obs_drift(ctxs: list[FileContext], root: str) -> list[Finding]:
    stats_path = os.path.join(root, "stats", "__init__.py")
    catalog_path = os.path.join(root, "obs", "trace.py")
    metrics = _parse_metric_decls(stats_path)
    spans = _parse_span_catalog(catalog_path)
    if not metrics and not spans:
        return []  # tree without an obs layer (other fixture pkgs)
    stats_rel = os.path.relpath(stats_path, REPO_ROOT)
    catalog_rel = os.path.relpath(catalog_path, REPO_ROOT)

    findings: list[Finding] = []
    used_metrics: set[str] = set()
    used_spans: set[str] = set()
    for ctx in ctxs:
        is_decl_file = ctx.rel in (stats_rel, catalog_rel)
        for node in ast.walk(ctx.tree):
            # referenced binding names (stats.ScrubRepairs / imported name)
            if isinstance(node, ast.Attribute):
                names = {node.attr}
            elif isinstance(node, ast.Name):
                names = {node.id}
            else:
                names = ()
            for name in names:
                for metric, (binding, _) in metrics.items():
                    if name == binding and not is_decl_file:
                        used_metrics.add(metric)
            # metric-shaped string literals (scrape lists, ec.status)
            if (
                not is_decl_file
                and isinstance(node, ast.Constant)
                and isinstance(node.value, str)
                and _METRIC_LITERAL.match(node.value)
            ):
                lit = node.value
                base = lit
                for suffix in _SERIES_SUFFIXES:
                    if lit.endswith(suffix) and lit[: -len(suffix)] in metrics:
                        base = lit[: -len(suffix)]
                        break
                if base in metrics:
                    used_metrics.add(base)
                elif _METRIC_SUFFIX.match(lit):
                    findings.append(Finding(
                        "obs-metric-undeclared", ctx.rel, node.lineno,
                        f"metric {lit!r} is not declared in "
                        "stats/__init__.py — scrapes of it read zeros "
                        "forever; declare it (or fix the name)",
                    ))
            # span call sites
            if (
                not is_decl_file
                and isinstance(node, ast.Call)
                and _is_span_call(node)
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
            ):
                name = node.args[0].value
                if name in spans:
                    used_spans.add(name)
                else:
                    findings.append(Finding(
                        "obs-span-undeclared", ctx.rel, node.lineno,
                        f"span name {name!r} is not in the SPAN_NAMES "
                        "catalog (obs/trace.py) — the attribution "
                        "artifact and ec.trace key on registered stage "
                        "names; register it (or fix the typo)",
                    ))
    for metric, (binding, line) in sorted(metrics.items()):
        if metric not in used_metrics:
            findings.append(Finding(
                "obs-metric-unused", stats_rel, line,
                f"metric {metric!r} ({binding}) is declared but neither "
                "its binding nor its name is referenced anywhere — dead "
                "telemetry; wire it up or delete it",
            ))
    for name, line in sorted(spans.items()):
        if name not in used_spans:
            findings.append(Finding(
                "obs-span-unused", catalog_rel, line,
                f"span name {name!r} is registered in SPAN_NAMES but no "
                "call site records it — stale catalog entry",
            ))
    return findings
