"""lock-discipline checkers.

lock-order-cycle (project-wide): every `with <lock>:` nesting in the
package contributes an acquisition-order edge (outer -> inner) to one
global digraph; a cycle means two code paths can interleave into a
deadlock that only chaos_soak would ever catch. Lock identity is
canonical across files: `self._x_lock` inside class C is `C._x_lock`
(every instance shares the ordering discipline), a module-level lock is
`<module>:<name>`.

unlocked-global-write (per-file): module-level mutable containers
mutated from a function that is handed to an executor/thread
(`submit(f)`, `Thread(target=f)`, `add_done_callback(f)`) without a
`with <lock>:` around the mutation — the classic torn-update heisenbug.
"""

from __future__ import annotations

import ast
import re
from typing import Optional

from seaweedfs_tpu_torch.analysis import (
    FileContext,
    Finding,
    graph,
    per_file_checker,
    project_checker,
)

#: what counts as a lock object in a `with` item. The codebase's locks all
#: carry "lock" in their name (_lock, _suspect_lock, _shard_locs_lock ...);
#: condition variables guard with their own lock so they count too.
_LOCK_NAME_RE = re.compile(r"(^|_)(lock|mutex|cond|condition)s?($|_)|lock$", re.I)

_MUTATORS = {
    "append", "appendleft", "add", "update", "setdefault", "extend",
    "insert", "pop", "popleft", "popitem", "remove", "discard", "clear",
}


def _lock_name_of(expr: ast.AST) -> Optional[str]:
    """The bare name a with-item acquires, when it looks like a lock."""
    if isinstance(expr, ast.Name) and _LOCK_NAME_RE.search(expr.id):
        return expr.id
    if isinstance(expr, ast.Attribute) and _LOCK_NAME_RE.search(expr.attr):
        return expr.attr
    return None


def _canonical(ctx: FileContext, expr: ast.AST, class_name: Optional[str]) -> Optional[str]:
    name = _lock_name_of(expr)
    if name is None:
        return None
    if (
        isinstance(expr, ast.Attribute)
        and isinstance(expr.value, ast.Name)
        and expr.value.id in ("self", "cls")
        and class_name
    ):
        return f"{class_name}.{name}"
    if isinstance(expr, ast.Name):
        return f"{ctx.rel}:{name}"
    # foreign attribute chain (other.lock): scope by source text
    return f"{ctx.rel}:{ast.unparse(expr)}"


class _LockNestingVisitor(ast.NodeVisitor):
    """Collects (outer, inner, site) acquisition edges from lexical
    `with` nesting. The held-stack resets inside nested function defs —
    their bodies run later, not under the enclosing with."""

    def __init__(self, ctx: FileContext):
        self.ctx = ctx
        self.class_stack: list[str] = []
        self.held: list[str] = []
        self.edges: list[tuple[str, str, int]] = []
        self.sites: dict[str, int] = {}  # lock -> first acquisition line

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.class_stack.append(node.name)
        self.generic_visit(node)
        self.class_stack.pop()

    def _visit_function(self, node) -> None:
        saved, self.held = self.held, []
        self.generic_visit(node)
        self.held = saved

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function
    visit_Lambda = _visit_function

    def visit_With(self, node: ast.With) -> None:
        acquired = []
        cls = self.class_stack[-1] if self.class_stack else None
        for item in node.items:
            lock = _canonical(self.ctx, item.context_expr, cls)
            if lock is not None:
                self.sites.setdefault(lock, item.context_expr.lineno)
                for outer in self.held:
                    if outer != lock:
                        self.edges.append((outer, lock, item.context_expr.lineno))
                self.held.append(lock)
                acquired.append(lock)
        for stmt in node.body:
            self.visit(stmt)
        for _ in acquired:
            self.held.pop()

    visit_AsyncWith = visit_With


@project_checker
def check_lock_order(ctxs: list[FileContext], root: str) -> list[Finding]:
    edge_sites: dict[tuple[str, str], tuple[str, int]] = {}
    for ctx in ctxs:
        v = _LockNestingVisitor(ctx)
        v.visit(ctx.tree)
        for outer, inner, line in v.edges:
            edge_sites.setdefault((outer, inner), (ctx.rel, line))
    edges = graph.edges_from_pairs(edge_sites)
    findings = []
    for cycle in graph.cyclic_components(edges):
        members = set(cycle)
        for (outer, inner), (rel, line) in sorted(edge_sites.items()):
            if outer in members and inner in members:
                findings.append(Finding(
                    "lock-order-cycle", rel, line,
                    f"acquires {inner} while holding {outer}, inside the "
                    f"ordering cycle {{{', '.join(cycle)}}} — pick one "
                    "global order for these locks",
                ))
    return findings


def _callback_names(tree: ast.AST) -> set[str]:
    """Function names handed to executors/threads in this file. Both bare
    functions (`submit(f)`) and bound methods (`submit(self._f)`,
    `Thread(target=self._loop)`) count — the package's real entry points
    are almost all bound methods, and a checker that only saw bare names
    would have zero recall on the code it guards."""
    names: set[str] = set()

    def _name_of(arg: ast.AST) -> Optional[str]:
        if isinstance(arg, ast.Name):
            return arg.id
        if isinstance(arg, ast.Attribute):
            return arg.attr
        return None

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        attr = func.attr if isinstance(func, ast.Attribute) else (
            func.id if isinstance(func, ast.Name) else None
        )
        if attr in ("submit", "add_done_callback", "map"):
            for arg in node.args[:1]:
                n = _name_of(arg)
                if n:
                    names.add(n)
        if attr in ("Thread", "Timer"):
            for kw in node.keywords:
                if kw.arg == "target":
                    n = _name_of(kw.value)
                    if n:
                        names.add(n)
    return names


def _module_mutables(tree: ast.Module) -> set[str]:
    out: set[str] = set()
    mutable_calls = {"dict", "list", "set", "deque", "defaultdict", "OrderedDict", "Counter"}
    for stmt in tree.body:
        targets = []
        if isinstance(stmt, ast.Assign):
            targets = stmt.targets
            value = stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets = [stmt.target]
            value = stmt.value
        else:
            continue
        is_mutable = isinstance(value, (ast.Dict, ast.List, ast.Set, ast.ListComp, ast.DictComp, ast.SetComp))
        if isinstance(value, ast.Call):
            f = value.func
            callee = f.id if isinstance(f, ast.Name) else (
                f.attr if isinstance(f, ast.Attribute) else None
            )
            is_mutable = is_mutable or callee in mutable_calls
        if not is_mutable:
            continue
        for t in targets:
            if isinstance(t, ast.Name):
                out.add(t.id)
    return out


class _CallbackBodyVisitor(ast.NodeVisitor):
    """Inside one callback function: flag mutations of module-level
    mutables that are not under any `with <lock>:`."""

    def __init__(self, ctx: FileContext, mutables: set[str]):
        self.ctx = ctx
        self.mutables = mutables
        self.lock_depth = 0
        self.findings: list[Finding] = []

    def visit_With(self, node: ast.With) -> None:
        locked = any(_lock_name_of(i.context_expr) for i in node.items)
        if locked:
            self.lock_depth += 1
        self.generic_visit(node)
        if locked:
            self.lock_depth -= 1

    visit_AsyncWith = visit_With

    def _flag(self, node: ast.AST, name: str, how: str) -> None:
        if self.lock_depth == 0:
            self.findings.append(Finding(
                "unlocked-global-write", self.ctx.rel, node.lineno,
                f"{how} of module-level `{name}` from an executor/thread "
                "callback without a held lock",
            ))

    def _target_global(self, target: ast.AST) -> Optional[str]:
        if isinstance(target, ast.Subscript) and isinstance(target.value, ast.Name):
            if target.value.id in self.mutables:
                return target.value.id
        return None

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            name = self._target_global(t)
            if name:
                self._flag(node, name, "subscript write")
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        name = self._target_global(node.target)
        if name:
            self._flag(node, name, "augmented write")
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            name = self._target_global(t)
            if name:
                self._flag(node, name, "subscript delete")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if (
            isinstance(f, ast.Attribute)
            and f.attr in _MUTATORS
            and isinstance(f.value, ast.Name)
            and f.value.id in self.mutables
        ):
            self._flag(node, f.value.id, f".{f.attr}()")
        self.generic_visit(node)


@per_file_checker
def check_unlocked_global_writes(ctx: FileContext) -> list[Finding]:
    if not isinstance(ctx.tree, ast.Module):
        return []
    mutables = _module_mutables(ctx.tree)
    if not mutables:
        return []
    callbacks = _callback_names(ctx.tree)
    if not callbacks:
        return []
    findings: list[Finding] = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and node.name in callbacks:
            v = _CallbackBodyVisitor(ctx, mutables)
            for stmt in node.body:
                v.visit(stmt)
            findings.extend(v.findings)
    return findings
