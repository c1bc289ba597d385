"""Filesystem-op recorder + crash-prefix replayer — the dynamic half of
the durability family (weedsafe).

The static checkers in `analysis.durability` see LEXICAL fsync/rename
ordering; the actual crash contracts (the `.ecp` ingest journal, the
`.ecc` convert journal, the scrub cursor, the kernel_sweep JSONL) are
cross-function protocols whose safety lives in the ORDER of write /
fsync / rename ops at runtime. This module records that order and then
asks the only question that matters: for EVERY prefix of the real op
trace, if the process had died right there, does the real resume
entrypoint land in a documented state?

Recording (modeled on `analysis.lockrec`): `install(root)` interposes
shims over `builtins.open` (write-capable modes under `root` return a
recording proxy), `os.write`, `os.fsync`, `os.replace`, `os.rename`,
`os.unlink`/`os.remove`, and `os.truncate`. Each op carries the path
(root-relative), absolute byte offsets, payload bytes, and its creation
site (file:line of the caller, lockrec-style identity). Opt-in: replay
tests install it directly around a scoped workload.

Crash model (what a prefix materializes to): ops are applied in order
against the install-time snapshot. Data writes are PENDING until an
fsync on that file promotes them to durable; metadata ops (create,
rename/replace, unlink, truncate-at-open) follow ordered-journaling
semantics — applied in recorded order, never reordered past each other.
At the crash point each file's pending tail is resolved per variant:

  clean — every pending write hit the disk before power loss
  torn  — all but the last pending write applied; the last applied only
          through its first half (a torn sector/page tail)
  lost  — no pending write since the last fsync survived

A protocol is crash-safe iff for every prefix x variant the resume
entrypoint either resumes to a byte-identical result or refuses and
falls back to the warm path — never serves or commits corrupt bytes.
The prefix count is bounded by WEEDTPU_FSREPLAY_MAX_PREFIXES (evenly
sampled, endpoints always included) so the tier-1 gate stays inside its
time budget.
"""

from __future__ import annotations

import _thread
import builtins
import dataclasses
import io
import json
import os
import traceback
from typing import Optional

_HERE = __file__

_WRITE_MODE_CHARS = ("w", "a", "x", "+")


@dataclasses.dataclass(frozen=True)
class FsOp:
    """One recorded filesystem operation. `path`/`dst` are root-relative.

    kinds: create (open w/x or a on a missing file), write (data at
    offset), flush (no durability effect; kept for trace fidelity),
    fsync, replace (path -> dst), unlink, truncate (to size `offset`).
    """

    kind: str
    path: str
    offset: int = 0
    data: bytes = b""
    dst: str = ""
    site: str = ""

    def sig(self) -> tuple:
        """Identity without the creation site — what determinism means."""
        return (self.kind, self.path, self.offset, self.data, self.dst)


@dataclasses.dataclass
class FsTrace:
    root: str
    initial: dict[str, bytes]  # rel path -> snapshot bytes at install
    ops: list[FsOp]

    def dump(self, path: str) -> None:
        payload = {
            "root": self.root,
            "initial": {p: data.hex() for p, data in sorted(self.initial.items())},
            "ops": [
                {
                    "kind": op.kind, "path": op.path, "offset": op.offset,
                    "data": op.data.hex(), "dst": op.dst, "site": op.site,
                }
                for op in self.ops
            ],
        }
        with open(path, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=1)


def _creation_site() -> str:
    for frame in reversed(traceback.extract_stack()):
        fn = frame.filename
        if fn == _HERE or fn.endswith("fsrec.py"):
            continue
        return f"{fn}:{frame.lineno}"
    return "<unknown>"


class _RecordingFile:
    """Write-capable file proxy: forwards everything to the real handle,
    reporting writes (with absolute offsets), flushes, truncates, and
    close to the recorder. Text-mode positions are tracked by encoded
    byte count (journal writers never seek in text mode; binary handles
    use the real tell())."""

    def __init__(self, inner, rel: str, rec: "FsRecorder", text: bool):
        self._inner = inner
        self._rel = rel
        self._rec = rec
        self._text = text
        self._pos = 0 if not text else self._text_start()
        rec._register_fd(inner.fileno(), rel)

    def _text_start(self) -> int:
        try:
            return os.fstat(self._inner.fileno()).st_size if "a" in self._inner.mode else 0
        except (OSError, ValueError):
            return 0

    def write(self, data):
        n = self._inner.write(data)
        raw = data.encode("utf-8") if self._text else bytes(data)
        if self._text:
            off = self._pos
            self._pos += len(raw)
        else:
            off = self._inner.tell() - len(raw)
        self._rec._record(FsOp("write", self._rel, off, raw, site=_creation_site()))
        return n

    def flush(self):
        self._inner.flush()
        self._rec._record(FsOp("flush", self._rel, site=_creation_site()))

    def truncate(self, size=None):
        r = self._inner.truncate(size)
        eff = self._inner.tell() if size is None else size
        self._rec._record(FsOp("truncate", self._rel, eff, site=_creation_site()))
        return r

    def seek(self, *a, **k):
        r = self._inner.seek(*a, **k)
        if not self._text:
            pass  # binary offsets read from tell() at write time
        return r

    def close(self):
        try:
            fd = self._inner.fileno()
        except (OSError, ValueError):
            fd = None
        self._inner.close()
        if fd is not None:
            self._rec._unregister_fd(fd)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __iter__(self):
        return iter(self._inner)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class FsRecorder:
    """Records every durability-relevant fs op under `root`. One recorder
    may be installed at a time (module-level patch, like lockrec)."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self._raw = _thread.allocate_lock()
        self._ops: list[FsOp] = []
        self._fd_paths: dict[int, str] = {}
        self.initial = self._snapshot()

    def _snapshot(self) -> dict[str, bytes]:
        snap: dict[str, bytes] = {}
        for dirpath, _dirnames, filenames in os.walk(self.root):
            for name in filenames:
                p = os.path.join(dirpath, name)
                try:
                    with io.open(p, "rb") as f:
                        snap[os.path.relpath(p, self.root)] = f.read()
                except OSError:
                    continue
        return snap

    def _rel(self, path) -> Optional[str]:
        try:
            apath = os.path.abspath(os.fspath(path))
        except TypeError:  # fd-relative or int path: not ours
            return None
        if apath == self.root or apath.startswith(self.root + os.sep):
            return os.path.relpath(apath, self.root)
        return None

    def _record(self, op: FsOp) -> None:
        with self._raw:
            self._ops.append(op)

    def _register_fd(self, fd: int, rel: str) -> None:
        with self._raw:
            self._fd_paths[fd] = rel

    def _unregister_fd(self, fd: int) -> None:
        with self._raw:
            self._fd_paths.pop(fd, None)

    def fd_rel(self, fd: int) -> Optional[str]:
        with self._raw:
            return self._fd_paths.get(fd)

    def trace(self) -> FsTrace:
        with self._raw:
            return FsTrace(self.root, dict(self.initial), list(self._ops))

    def reset(self) -> None:
        with self._raw:
            self._ops.clear()
        self.initial = self._snapshot()


_installed: Optional[tuple] = None


def install(root: str) -> FsRecorder:
    """Interpose the recording shims for paths under `root`. Idempotent —
    a second install with the SAME root returns the active recorder; a
    different root is a programming error (raise, don't silently record
    the wrong tree)."""
    global _installed
    if _installed is not None:
        rec = _installed[0]
        if rec.root != os.path.abspath(root):
            raise RuntimeError(
                f"fsrec already installed for {rec.root!r}, asked for {root!r}"
            )
        return rec
    rec = FsRecorder(root)
    orig_open = builtins.open
    orig = {
        "write": os.write, "fsync": os.fsync, "replace": os.replace,
        "rename": os.rename, "unlink": os.unlink, "remove": os.remove,
        "truncate": os.truncate,
    }

    def rec_open(file, mode="r", *args, **kwargs):
        rel = rec._rel(file) if isinstance(file, (str, bytes, os.PathLike)) else None
        writable = any(c in str(mode) for c in _WRITE_MODE_CHARS)
        if rel is None or not writable:
            return orig_open(file, mode, *args, **kwargs)
        existed = os.path.exists(file)
        inner = orig_open(file, mode, *args, **kwargs)
        m = str(mode)
        if not existed or "w" in m or "x" in m:
            rec._record(FsOp("create", rel, site=_creation_site()))
        return _RecordingFile(inner, rel, rec, text="b" not in m)

    def rec_os_write(fd, data, *a, **k):
        rel = rec.fd_rel(fd)
        off = os.lseek(fd, 0, os.SEEK_CUR) if rel is not None else 0
        n = orig["write"](fd, data, *a, **k)
        if rel is not None:
            rec._record(FsOp("write", rel, off, bytes(data[:n]), site=_creation_site()))
        return n

    def rec_fsync(fd):
        orig["fsync"](fd)
        rel = rec.fd_rel(fd)
        if rel is not None:
            rec._record(FsOp("fsync", rel, site=_creation_site()))

    def _rename_like(name):
        def patched(src, dst, *a, **k):
            orig[name](src, dst, *a, **k)
            rel_src, rel_dst = rec._rel(src), rec._rel(dst)
            if rel_src is not None and rel_dst is not None:
                rec._record(FsOp(
                    "replace", rel_src, dst=rel_dst, site=_creation_site()
                ))
        return patched

    def _unlink_like(name):
        def patched(path, *a, **k):
            orig[name](path, *a, **k)
            rel = rec._rel(path)
            if rel is not None:
                rec._record(FsOp("unlink", rel, site=_creation_site()))
        return patched

    def rec_truncate(path, length):
        orig["truncate"](path, length)
        rel = rec._rel(path) if isinstance(path, (str, bytes, os.PathLike)) else None
        if rel is not None:
            rec._record(FsOp("truncate", rel, length, site=_creation_site()))

    builtins.open = rec_open
    os.write = rec_os_write
    os.fsync = rec_fsync
    os.replace = _rename_like("replace")
    os.rename = _rename_like("rename")
    os.unlink = _unlink_like("unlink")
    os.remove = _unlink_like("remove")
    os.truncate = rec_truncate
    _installed = (rec, orig_open, orig)
    return rec


def uninstall() -> None:
    global _installed
    if _installed is None:
        return
    _rec, orig_open, orig = _installed
    builtins.open = orig_open
    os.write = orig["write"]
    os.fsync = orig["fsync"]
    os.replace = orig["replace"]
    os.rename = orig["rename"]
    os.unlink = orig["unlink"]
    os.remove = orig["remove"]
    os.truncate = orig["truncate"]
    _installed = None


def active_recorder() -> Optional[FsRecorder]:
    return _installed[0] if _installed is not None else None


# ---------------------------------------------------------------------------
# Crash-prefix replay
# ---------------------------------------------------------------------------

VARIANTS = ("clean", "torn", "lost")


class _SimFile:
    __slots__ = ("durable", "pending")

    def __init__(self, durable: bytes = b""):
        self.durable = bytearray(durable)
        self.pending: list[FsOp] = []


def _apply_data_op(buf: bytearray, op: FsOp, data: Optional[bytes] = None) -> None:
    if op.kind == "write":
        payload = op.data if data is None else data
        end = op.offset + len(payload)
        if len(buf) < end:
            buf.extend(b"\0" * (end - len(buf)))
        buf[op.offset:end] = payload
    elif op.kind == "truncate":
        if op.offset <= len(buf):
            del buf[op.offset:]
        else:
            buf.extend(b"\0" * (op.offset - len(buf)))


def _settle(f: _SimFile, variant: str) -> bytes:
    """Resolve a file's pending tail at the crash point per variant."""
    buf = bytearray(f.durable)
    pending = f.pending
    if variant == "lost" or not pending:
        return bytes(buf)
    if variant == "clean":
        for op in pending:
            _apply_data_op(buf, op)
        return bytes(buf)
    # torn: all but the last applied; a trailing write lands half its bytes
    for op in pending[:-1]:
        _apply_data_op(buf, op)
    last = pending[-1]
    if last.kind == "write" and len(last.data) > 1:
        _apply_data_op(buf, last, data=last.data[: len(last.data) // 2])
    elif last.kind != "write":
        _apply_data_op(buf, last)
    return bytes(buf)


def simulate_prefix(
    trace: FsTrace, n_ops: int, variant: str = "clean"
) -> dict[str, bytes]:
    """Post-crash file contents (rel path -> bytes) after applying the
    first `n_ops` recorded ops to the install-time snapshot, with the
    pending tails resolved per `variant`."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    files: dict[str, _SimFile] = {
        rel: _SimFile(data) for rel, data in trace.initial.items()
    }
    for op in trace.ops[:n_ops]:
        if op.kind == "create":
            files[op.path] = _SimFile()
        elif op.kind in ("write", "truncate"):
            files.setdefault(op.path, _SimFile()).pending.append(op)
        elif op.kind == "fsync":
            f = files.setdefault(op.path, _SimFile())
            for p in f.pending:
                _apply_data_op(f.durable, p)
            f.pending = []
        elif op.kind == "replace":
            if op.path in files:
                files[op.dst] = files.pop(op.path)
        elif op.kind == "unlink":
            files.pop(op.path, None)
        elif op.kind == "flush":
            pass  # page cache only — no durability effect
        else:  # pragma: no cover — future op kinds must be handled here
            raise ValueError(f"unknown op kind {op.kind!r}")
    return {rel: _settle(f, variant) for rel, f in files.items()}


def materialize_prefix(
    trace: FsTrace, n_ops: int, dest: str, variant: str = "clean"
) -> dict[str, bytes]:
    """Write the post-crash state for a prefix into `dest` (created empty
    — caller owns clearing between prefixes) and return it."""
    state = simulate_prefix(trace, n_ops, variant)
    for rel, data in state.items():
        p = os.path.join(dest, rel)
        os.makedirs(os.path.dirname(p) or dest, exist_ok=True)
        with io.open(p, "wb") as f:
            f.write(data)
    return state


def prefix_schedule(n_ops: int, max_prefixes: int) -> list[int]:
    """Which prefixes to replay: every one when the budget allows, else an
    even sample that always keeps both endpoints (0 = nothing happened,
    n_ops = the crash was after the last op)."""
    total = n_ops + 1
    if max_prefixes <= 0 or total <= max_prefixes:
        return list(range(total))
    if max_prefixes == 1:
        return [n_ops]
    step = (total - 1) / (max_prefixes - 1)
    picks = {round(i * step) for i in range(max_prefixes)}
    picks.update((0, n_ops))
    return sorted(picks)
