"""weedlint — project-specific static analysis for seaweedfs_tpu_torch.

The codebase's correctness rests on invariants no general-purpose linter
knows about: lock acquisition order across the EC/cluster hot paths,
the donation contract of jitted dispatches (a donated buffer is DEAD
after the call), the WEEDTPU_* env registry in utils/config.py, the
context-managed-open discipline of streaming paths, and the three-way
agreement between contracts.proto, the committed descriptor artifact,
and the dict-shaped RPC handlers. These rot silently and resurface as
heisenbugs in chaos_soak.py rather than test failures — so they are
machine-checked here, by the tests, on every run. The scan covers the
whole package, its scripts/ included. The two donation rules are the
JAX dispatch contract; the package has no jitted code, so they find
nothing in it and stand for the shared fixtures.

Usage:
    python -m seaweedfs_tpu_torch.analysis [--strict] [--changed-only] [paths]

Checker families (rule ids in brackets):
  lock-discipline   [lock-order-cycle, unlocked-global-write]
  donation-safety   [jit-host-sync, donated-buffer-read]
  env-registry      [env-raw-read, env-unregistered]
  resource-safety   [open-no-ctx, tmpfile-no-unlink]
  wire-drift        [wire-drift]
  obs-drift         [obs-metric-undeclared, obs-metric-unused,
                     obs-span-undeclared, obs-span-unused]
  durability        [fsync-missing-before-rename, record-before-fsync,
                     tmp-visible-name, torn-tail-unhandled]

Suppression: a finding is intentional iff the offending line (or the
line above it) carries a comment of the form "weedlint: ignore" plus
the bracketed rule id and a free-text reason. The reason is
REQUIRED — an ignore without one is itself a finding
(bad-suppression), and an ignore that suppresses nothing is flagged in
--strict runs (unused-suppression) so stale pragmas cannot accumulate.

The dynamic half of the lock-discipline family lives in
`analysis.lockrec`: an instrumented-lock mode that records ACTUAL
acquisition orders while real code runs, so that a test can fail on a
cycle in the observed graph (`lockrec.install()` before the package's
modules are imported, so that their module-level locks are observed).
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Callable, Iterable, Optional

PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(PKG_ROOT)

#: every rule a checker may emit (suppression comments are validated
#: against this set so a typo'd rule name cannot silently ignore-all)
RULES = {
    "lock-order-cycle": "two code paths acquire the same locks in opposite orders",
    "unlocked-global-write": "module-level mutable state written from an executor/thread callback outside any lock",
    "jit-host-sync": "host synchronization (np.*, open, print, .block_until_ready) inside a jitted function",
    "donated-buffer-read": "a buffer read after being passed at a donate_argnums position",
    "env-raw-read": "raw os.environ/os.getenv read outside the utils/config.py registry",
    "env-unregistered": "config.env() called with a name missing from ENV_REGISTRY",
    "open-no-ctx": "open() outside a with/ExitStack context",
    "tmpfile-no-unlink": "NamedTemporaryFile(delete=False) with no unlink/replace in the same function",
    "wire-drift": "contracts.proto, contracts.desc and handler field usage disagree",
    "obs-metric-undeclared": "a weedtpu_* metric name used in code is not declared in stats/__init__.py",
    "obs-metric-unused": "a metric declared in stats/__init__.py is never referenced (dead telemetry)",
    "obs-span-undeclared": "a trace span name used at a call site is missing from obs/trace.py SPAN_NAMES",
    "obs-span-unused": "a SPAN_NAMES catalog entry has no recording call site",
    "fsync-missing-before-rename": "a path opened for writing is renamed into place with no fsync in between",
    "record-before-fsync": "a journal record that vouches for data bytes is appended before the data fsync",
    "tmp-visible-name": "staged output created under a serving-discoverable name instead of .inp/.cv.*/dot-tmp",
    "torn-tail-unhandled": "a JSON-lines journal reader lacking the torn-tail truncate/ignore guard",
    "bad-suppression": "weedlint: ignore[...] without a reason, or naming an unknown rule",
    "unused-suppression": "weedlint: ignore[...] that suppresses no finding",
    "parse-error": "source file the analysis (and CI) cannot parse",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # repo-relative
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


_SUPPRESS_RE = re.compile(r"#\s*weedlint:\s*ignore\[([^\]]*)\]\s*(.*)")


@dataclasses.dataclass
class Suppression:
    line: int
    rules: tuple[str, ...]
    reason: str
    used: bool = False


class FileContext:
    """One parsed source file: tree, parent links, and suppressions."""

    def __init__(self, path: str, src: str):
        self.path = path
        self.rel = os.path.relpath(path, REPO_ROOT)
        self.src = src
        self.tree = ast.parse(src, filename=path)
        self.parents: dict[int, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[id(child)] = node
        self.suppressions: list[Suppression] = []
        for lineno, text in enumerate(src.splitlines(), start=1):
            m = _SUPPRESS_RE.search(text)
            if m:
                rules = tuple(
                    r.strip() for r in m.group(1).split(",") if r.strip()
                )
                self.suppressions.append(
                    Suppression(lineno, rules, m.group(2).strip())
                )

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self.parents.get(id(node))

    def suppression_findings(self) -> list[Finding]:
        out = []
        for s in self.suppressions:
            unknown = [r for r in s.rules if r != "*" and r not in RULES]
            if unknown:
                out.append(Finding(
                    "bad-suppression", self.rel, s.line,
                    f"ignore names unknown rule(s) {unknown}",
                ))
            if not s.reason:
                out.append(Finding(
                    "bad-suppression", self.rel, s.line,
                    "suppression has no reason — say why the finding is intentional",
                ))
        return out

    def apply_suppressions(self, findings: list[Finding]) -> list[Finding]:
        """Drop findings covered by an ignore on the same line or the line
        above; mark the suppression used."""
        kept = []
        for f in findings:
            hit = None
            for s in self.suppressions:
                if s.line in (f.line, f.line - 1) and (
                    "*" in s.rules or f.rule in s.rules
                ):
                    hit = s
                    break
            if hit is not None:
                hit.used = True
            else:
                kept.append(f)
        return kept

    def unused_suppression_findings(self) -> list[Finding]:
        return [
            Finding(
                "unused-suppression", self.rel, s.line,
                f"ignore[{','.join(s.rules)}] suppresses no finding — remove it",
            )
            for s in self.suppressions
            # unknown-rule pragmas already got bad-suppression; piling an
            # unused report on the same line is noise
            if not s.used and all(r == "*" or r in RULES for r in s.rules)
        ]


# checker registries — modules below self-register at import time
PerFileChecker = Callable[[FileContext], list[Finding]]
ProjectChecker = Callable[[list[FileContext], str], list[Finding]]
PER_FILE_CHECKERS: list[PerFileChecker] = []
PROJECT_CHECKERS: list[ProjectChecker] = []


def per_file_checker(fn: PerFileChecker) -> PerFileChecker:
    PER_FILE_CHECKERS.append(fn)
    return fn


def project_checker(fn: ProjectChecker) -> ProjectChecker:
    PROJECT_CHECKERS.append(fn)
    return fn


def iter_source_files(root: str) -> Iterable[str]:
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [
            d for d in dirnames if d != "__pycache__" and not d.startswith(".")
        ]
        for name in sorted(filenames):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


# Parse cache shared across runs (and across checker families, which all
# consume the same FileContext): keyed by absolute path, validated by
# (mtime_ns, size). Parsing + parent-linking dominates a full-tree run, and
# the CLI gate + tests parse the same ~200 files repeatedly — the cache
# keeps the strict clean-tree gate inside its 30 s tier-1 budget as the
# tree grows. FileContext carries one piece of per-run mutable state
# (Suppression.used), reset on every cache hit.
_PARSE_CACHE: dict[str, tuple[tuple[int, int], "FileContext"]] = {}


def load_files(paths: Iterable[str]) -> tuple[list[FileContext], list[Finding]]:
    ctxs, errors = [], []
    for path in paths:
        apath = os.path.abspath(path)
        try:
            st = os.stat(apath)
            sig = (st.st_mtime_ns, st.st_size)
        except OSError:
            sig = None
        if sig is not None:
            hit = _PARSE_CACHE.get(apath)
            if hit is not None and hit[0] == sig:
                ctx = hit[1]
                for s in ctx.suppressions:
                    s.used = False
                ctxs.append(ctx)
                continue
        with open(path, "r", encoding="utf-8") as f:
            src = f.read()
        try:
            ctx = FileContext(path, src)
        except SyntaxError as e:  # a file the CI can't even parse IS a finding
            errors.append(Finding(
                "parse-error", os.path.relpath(path, REPO_ROOT),
                e.lineno or 1, f"unparseable source: {e.msg}",
            ))
            continue
        ctxs.append(ctx)
        if sig is not None:
            _PARSE_CACHE[apath] = (sig, ctx)
    return ctxs, errors


def run(
    paths: Optional[list[str]] = None,
    root: str = PKG_ROOT,
    strict: bool = False,
    changed_only_files: Optional[set[str]] = None,
) -> list[Finding]:
    """Run every checker. `paths` overrides the scanned file set (tests
    point this at fixture trees); `changed_only_files` narrows PER-FILE
    checkers to a subset while project checkers (lock graph, wire drift)
    still see the whole tree — their invariants are global."""
    if paths is None:
        paths = list(iter_source_files(root))
    ctxs, findings = load_files(paths)
    for ctx in ctxs:
        scan_this = (
            changed_only_files is None
            or os.path.abspath(ctx.path) in changed_only_files
        )
        file_findings: list[Finding] = []
        if scan_this:
            for chk in PER_FILE_CHECKERS:
                file_findings.extend(chk(ctx))
        file_findings = ctx.apply_suppressions(file_findings)
        if scan_this:
            file_findings.extend(ctx.suppression_findings())
        findings.extend(file_findings)
    for chk in PROJECT_CHECKERS:
        project = chk(ctxs, root)
        # project findings honor per-file suppressions too
        by_rel: dict[str, list[Finding]] = {}
        for f in project:
            by_rel.setdefault(f.path, []).append(f)
        for ctx in ctxs:
            if ctx.rel in by_rel:
                by_rel[ctx.rel] = ctx.apply_suppressions(by_rel[ctx.rel])
        for rel, fs in by_rel.items():
            findings.extend(fs)
    if strict:
        for ctx in ctxs:
            if (
                changed_only_files is None
                or os.path.abspath(ctx.path) in changed_only_files
            ):
                findings.extend(ctx.unused_suppression_findings())
    # dedupe: a site inside nested defs can be visited once per enclosing
    # scope (e.g. tmpfile-no-unlink); one report per (rule, site, message)
    findings = sorted(set(findings), key=lambda f: (f.path, f.line, f.rule))
    return findings


# register the checker families (import order = report grouping only)
from seaweedfs_tpu_torch.analysis import donation  # noqa: E402,F401
from seaweedfs_tpu_torch.analysis import durability  # noqa: E402,F401
from seaweedfs_tpu_torch.analysis import envreg  # noqa: E402,F401
from seaweedfs_tpu_torch.analysis import lock_order  # noqa: E402,F401
from seaweedfs_tpu_torch.analysis import obs_drift  # noqa: E402,F401
from seaweedfs_tpu_torch.analysis import resources  # noqa: E402,F401
from seaweedfs_tpu_torch.analysis import wire_drift  # noqa: E402,F401
