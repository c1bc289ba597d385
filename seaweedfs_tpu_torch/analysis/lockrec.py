"""Dynamic lock-order recorder — the runtime half of the lock-discipline
family.

The static checker sees LEXICAL `with` nesting; real acquisition orders
also flow through call chains, executor callbacks, and the rebuild /
degraded-read concurrency. This module instruments
`threading.Lock`/`RLock` (opt-in: `install()`, before the package's
modules are imported) so every lock carries its creation site, each
thread tracks the stack of sites it currently holds, and acquiring B
while holding A records the edge A -> B. The observed graph restricted
to the package's own locks (`cycles(only_containing=PACKAGE)`) must be
acyclic — a cycle is a lock-order race that WILL deadlock under the
right interleaving, found without waiting for chaos_soak to hang.

A second recorder may already be installed in the process (another
package's): this one then wraps the wrapped factories, and each sees
the same creation sites, since both skip every `lockrec.py` frame.

The recorder's own bookkeeping uses a raw `_thread.allocate_lock` (the
primitive the wrappers delegate to), so instrumentation can never
recurse into itself.
"""

from __future__ import annotations

import _thread
import json
import threading
import traceback
from typing import Optional

from seaweedfs_tpu_torch.analysis import graph

_HERE = __file__

#: the substring of every creation site of this package's own locks: the
#: filter a test's gate passes to `cycles`/`report` (path names carry it)
PACKAGE = "seaweedfs_tpu_torch"


class LockOrderRecorder:
    def __init__(self) -> None:
        self._raw = _thread.allocate_lock()
        self._edges: dict[tuple[str, str], int] = {}  # (a, b) -> count
        self._tls = threading.local()

    # -- per-thread held stack -----------------------------------------------

    def _held(self) -> list[str]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def on_acquire(self, site: str) -> None:
        held = self._held()
        if site not in held:  # reentrant re-acquire orders nothing new
            new_edges = [(h, site) for h in held if h != site]
            if new_edges:
                with self._raw:
                    for e in new_edges:
                        self._edges[e] = self._edges.get(e, 0) + 1
        held.append(site)

    def on_release(self, site: str) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] == site:
                del held[i]
                return

    # -- results --------------------------------------------------------------

    def edges(self) -> dict[tuple[str, str], int]:
        with self._raw:
            return dict(self._edges)

    def cycles(self, only_containing: Optional[str] = None) -> list[list[str]]:
        """Cycles in the observed graph. `only_containing` restricts the
        graph to edges whose BOTH endpoints mention the substring — the
        gate asserts on the package's locks (`PACKAGE`), not on whatever
        ordering the standard library's internals exhibit."""
        pairs = self.edges().keys()
        if only_containing is not None:
            pairs = [
                (a, b) for a, b in pairs
                if only_containing in a and only_containing in b
            ]
        return graph.cyclic_components(graph.edges_from_pairs(pairs))

    def report(self, only_containing: Optional[str] = None) -> str:
        cycles = self.cycles(only_containing)
        lines = [
            f"lock-order recorder: {len(self.edges())} distinct edges, "
            f"{len(cycles)} cycle(s)"
        ]
        for cyc in cycles:
            lines.append("  CYCLE: " + " -> ".join(cyc + [cyc[0]]))
        return "\n".join(lines)

    def dump(self, path: str) -> None:
        payload = {
            "edges": [
                {"from": a, "to": b, "count": n}
                for (a, b), n in sorted(self.edges().items())
            ],
            "cycles": self.cycles(),
        }
        with open(path, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=2, sort_keys=True)

    def reset(self) -> None:
        with self._raw:
            self._edges.clear()


def _creation_site() -> str:
    """file:line of the Lock()/RLock() call — the lock's identity in the
    graph (every instance from one site shares ordering discipline, the
    same canonicalization the static checker uses for classes)."""
    for frame in reversed(traceback.extract_stack()):
        fn = frame.filename
        if fn == _HERE or fn.endswith(("threading.py", "lockrec.py")):
            continue
        return f"{fn}:{frame.lineno}"
    return "<unknown>"


class _ObservedLock:
    """Wrapper around a raw lock/RLock that reports acquire/release to the
    recorder. Implements the full lock protocol (including the
    _release_save/_acquire_restore/_is_owned trio Condition variables use
    on RLocks, forwarded so waits stay correct — a Condition wait's
    release/reacquire is deliberately NOT recorded as fresh ordering)."""

    def __init__(self, inner, site: str, rec: LockOrderRecorder):
        self._inner = inner
        self._site = site
        self._rec = rec

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._rec.on_acquire(self._site)
        return ok

    def release(self) -> None:
        self._inner.release()
        self._rec.on_release(self._site)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return f"<observed {self._inner!r} from {self._site}>"

    # Condition-variable protocol, forwarded ONLY when the inner lock has
    # it (RLock): Condition binds these at construction under try/except
    # AttributeError, and a plain Lock must keep raising so Condition
    # falls back to its acquire/release defaults. A Condition wait's
    # release/reacquire through these is deliberately NOT recorded as
    # fresh ordering — the thread still owns its ordering position, it
    # just parked the lock. `_recursion_count` (an RLock's, since Python
    # 3.12) is read by multiprocessing's resource tracker.
    def __getattr__(self, name: str):
        if name in ("_release_save", "_acquire_restore", "_is_owned", "_at_fork_reinit",
                    "_recursion_count"):
            return getattr(self._inner, name)
        raise AttributeError(name)


_installed: Optional[tuple] = None
GLOBAL_RECORDER = LockOrderRecorder()


def install(recorder: Optional[LockOrderRecorder] = None) -> LockOrderRecorder:
    """Monkeypatch threading.Lock/RLock with observed factories. Idempotent;
    returns the active recorder. Must run before the package's modules are
    imported for module-level locks to be observed (a fresh process that
    installs first, then imports)."""
    global _installed
    rec = recorder or GLOBAL_RECORDER
    if _installed is not None:
        return _installed[2]
    orig_lock, orig_rlock = threading.Lock, threading.RLock

    def make_lock():
        return _ObservedLock(orig_lock(), _creation_site(), rec)

    def make_rlock():
        return _ObservedLock(orig_rlock(), _creation_site(), rec)

    threading.Lock = make_lock  # type: ignore[misc]
    threading.RLock = make_rlock  # type: ignore[misc]
    _installed = (orig_lock, orig_rlock, rec)
    return rec


def uninstall() -> None:
    global _installed
    if _installed is None:
        return
    threading.Lock, threading.RLock = _installed[0], _installed[1]
    _installed = None


def active_recorder() -> Optional[LockOrderRecorder]:
    return _installed[2] if _installed is not None else None
