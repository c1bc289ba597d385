"""Scrub: continuous shard integrity scanning.

The per-shard CRC32s that the streaming encode records in `.eci` (and that
rebuilds verify on write) are worth something only if something READS
them before a second failure makes a corrupt shard unrecoverable. A
`Scrubber` walks every mounted EC shard in bounded chunks, folds CRC32 as
it goes and compares the result with the `.eci` record: bit rot, torn
writes, truncated files and vanished shard files surface as typed findings
long before a rebuild would stream the bad bytes. The quarantined shards
are then rebuilt by the stripe engine's rebuilds on the card.

Design constraints, in order:

  1. **Never starve serving.** Every chunk read first takes a token from
     the caller's admission hook, and the scan rate is capped
     (`rate_mb`): a scrub is repair traffic.
  2. **Survive restarts.** Progress lives in an fsync'd cursor file
     (volume, shard, offset, running CRC: CRC32 is resumable, so a restart
     continues mid-shard), with the quarantine entries whose repairs were
     still pending. The file carries no backend: either package loads the
     other's.
  3. **Report, don't act.** The scrubber only CLASSIFIES
     (ok/corrupt/truncated/missing) and hands findings to the injected
     callback; quarantine and repair belong to the caller, which owns the
     serving handles (`EcVolume.quarantine_shard`) and the rebuilds.

Shard files are immutable once mounted (delta updates touch only pre-seal
`.inp` partials; rebuilds write fresh files, then mount), so an
incremental scan with a persisted mid-shard cursor never races a
legitimate writer: any mismatch is damage, not churn.
"""

from __future__ import annotations

import json
import os
import threading
import time
import zlib
from typing import Callable, Iterable, Optional

from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.ec import stripe
from seaweedfs_tpu_torch.obs import trace as trace_mod


#: finding classes — the detection taxonomy the counters/quarantine use
OK = "ok"
CORRUPT = "corrupt"          # bytes present, CRC32 disagrees with .eci
TRUNCATED = "truncated"      # file shorter than the stripe geometry demands
MISSING = "missing"          # mounted shard whose file vanished underneath
UNVERIFIABLE = "unverifiable"  # volume predates CRC recording (no .eci CRCs)

FINDING_CLASSES = (CORRUPT, TRUNCATED, MISSING)


def expected_shard_size(info: dict) -> int:
    """Byte length every shard file of this volume must have, from the
    recorded `.eci` geometry: the ONE stripe-layout definition
    (stripe.stripe_layout) decides large/small row counts, so scrub,
    encode, and rebuild can never disagree about where EOF belongs."""
    n_large, n_small = stripe.stripe_layout(
        int(info["dat_size"]),
        int(info["large_block_size"]),
        int(info["small_block_size"]),
        stripe.geometry_from_info(info).data_shards,
    )
    return n_large * int(info["large_block_size"]) + n_small * int(
        info["small_block_size"]
    )


def scan_shard_file(
    path: str,
    want_crc: int,
    want_size: int,
    chunk_bytes: int = 4 * 1024 * 1024,
    offset: int = 0,
    crc: int = 0,
    budget: Optional[Callable[[int], None]] = None,
) -> str:
    """One full (or cursor-resumed) CRC pass over a shard file -> verdict.
    `budget(n)` is called before each chunk read with the chunk size about
    to be read — the rate limiter / admission hook; it may block. Size is
    checked FIRST so truncation classifies as truncation, not as the CRC
    mismatch it would also cause."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return MISSING
    if size < want_size:
        return TRUNCATED
    if size > want_size:
        # longer than the geometry allows: bytes were appended or the
        # .eci lies — either way the shard cannot be vouched for
        return CORRUPT
    try:
        with open(path, "rb") as f:
            f.seek(offset)
            pos = offset
            while pos < want_size:
                n = min(chunk_bytes, want_size - pos)
                if budget is not None:
                    budget(n)
                chunk = f.read(n)
                if len(chunk) != n:
                    return TRUNCATED  # shrank mid-scan
                crc = zlib.crc32(chunk, crc)
                pos += n
    except OSError:
        return MISSING
    return OK if crc == (want_crc & 0xFFFFFFFF) else CORRUPT


class ScrubCursor:
    """Fsync'd scrub progress + pending-quarantine persistence.

    One JSON file: {"vid", "shard", "offset", "crc", "cycles",
    "quarantine": [{"vid", "shard", "reason"}, ...]}. The (offset, crc)
    pair makes mid-shard resume exact — CRC32 is a running fold, so the
    restart continues from byte `offset` with the saved accumulator
    instead of rescanning the prefix. Torn/garbage files load as a fresh
    cursor (scrub restarts from the top; never worse than no cursor)."""

    def __init__(self, path: str):
        self.path = path
        self.vid = 0
        self.shard = 0
        self.offset = 0
        self.crc = 0
        self.cycles = 0
        #: quarantine entries whose repair had not completed at save time —
        #: a restarted server re-enqueues these instead of forgetting that
        #: a shard it no longer mounts is sitting corrupt on its disk
        self.quarantine: list[dict] = []
        self._dirty = False
        self.load()

    def load(self) -> None:
        try:
            with open(self.path, encoding="utf-8") as f:
                d = json.load(f)
            self.vid = int(d.get("vid", 0))
            self.shard = int(d.get("shard", 0))
            self.offset = int(d.get("offset", 0))
            self.crc = int(d.get("crc", 0))
            self.cycles = int(d.get("cycles", 0))
            self.quarantine = [
                {
                    "vid": int(q["vid"]),
                    "shard": int(q["shard"]),
                    "reason": str(q.get("reason", CORRUPT)),
                }
                for q in d.get("quarantine", [])
                if isinstance(q, dict) and "vid" in q and "shard" in q
            ]
        except (OSError, ValueError, KeyError, TypeError, AttributeError):
            # AttributeError: valid JSON that is not an object
            self.vid = self.shard = self.offset = self.crc = self.cycles = 0
            self.quarantine = []

    def save(self) -> None:
        tmp = self.path + ".tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(
                    {
                        "vid": self.vid,
                        "shard": self.shard,
                        "offset": self.offset,
                        "crc": self.crc,
                        "cycles": self.cycles,
                        "quarantine": self.quarantine,
                    },
                    f,
                )
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        except OSError:
            # cursor persistence is best-effort: a failed save costs a
            # rescan after restart, never correctness
            try:
                os.unlink(tmp)
            except OSError:
                pass
        self._dirty = False

    def point(self, vid: int, shard: int, offset: int, crc: int) -> None:
        self.vid, self.shard, self.offset, self.crc = vid, shard, offset, crc
        self._dirty = True

    def add_quarantine(self, vid: int, shard: int, reason: str) -> None:
        ent = {"vid": int(vid), "shard": int(shard), "reason": str(reason)}
        if not any(
            q["vid"] == ent["vid"] and q["shard"] == ent["shard"]
            for q in self.quarantine
        ):
            self.quarantine.append(ent)
        self.save()  # quarantine entries are load-bearing: persist NOW

    def remove_quarantine(self, vid: int, shard: int) -> None:
        before = len(self.quarantine)
        self.quarantine = [
            q
            for q in self.quarantine
            if not (q["vid"] == int(vid) and q["shard"] == int(shard))
        ]
        if len(self.quarantine) != before:
            self.save()


class RepairPolicy:
    """Capped, backed-off repair scheduling for quarantined shards.

    `due(key)` answers whether a repair attempt may run now;
    `failed(key)` doubles that key's backoff (decorrelated by attempt
    count, capped at `max_backoff`); `succeeded(key)` forgets it. The
    CONCURRENCY cap lives in the caller's semaphore — this class only
    owns the per-shard retry clock, so it stays trivially testable."""

    def __init__(self, base: float = 5.0, max_backoff: float = 60.0,
                 time_fn: Callable[[], float] = time.monotonic):
        self.base = float(base)
        self.max_backoff = float(max_backoff)
        self._time = time_fn
        self._state: dict[tuple, tuple[int, float]] = {}  # key -> (attempts, next_ok)
        self._lock = threading.Lock()

    def due(self, key: tuple) -> bool:
        with self._lock:
            st = self._state.get(key)
            return st is None or self._time() >= st[1]

    def delay(self, key: tuple) -> float:
        """Seconds until `key` is due again (0 when due now)."""
        with self._lock:
            st = self._state.get(key)
            if st is None:
                return 0.0
            return max(0.0, st[1] - self._time())

    def failed(self, key: tuple) -> float:
        with self._lock:
            attempts = self._state.get(key, (0, 0.0))[0] + 1
            backoff = min(self.max_backoff, self.base * (2 ** (attempts - 1)))
            self._state[key] = (attempts, self._time() + backoff)
            return backoff

    def succeeded(self, key: tuple) -> None:
        with self._lock:
            self._state.pop(key, None)


class Scrubber:
    """The background integrity scanner for one volume server.

    `volumes()` must return a {vid: EcVolume} snapshot of currently-mounted
    EC volumes; `on_finding(vid, shard, verdict)` is called (from the
    scrub thread) for every non-ok shard — quarantine/repair policy is the
    caller's. `admit()` is the shared-lane hook: called before each chunk
    read, returns True to proceed or False to yield (the scrubber then
    sleeps briefly and retries — foreground traffic owns the lane)."""

    def __init__(
        self,
        volumes: Callable[[], dict],
        on_finding: Callable[[int, int, str], None],
        cursor_path: str,
        rate_mb: float = 64.0,
        chunk_bytes: int = 4 * 1024 * 1024,
        interval: float = 30.0,
        admit: Optional[Callable[[], bool]] = None,
        cursor_flush_bytes: int = 256 * 1024 * 1024,
        cursor: Optional[ScrubCursor] = None,
    ):
        self._volumes = volumes
        self._on_finding = on_finding
        # the caller may share a cursor it already owns (the volume server
        # keeps ONE quarantine ledger whether or not the scan thread runs)
        self.cursor = cursor if cursor is not None else ScrubCursor(cursor_path)
        self.rate_mb = float(rate_mb)
        self.chunk_bytes = max(64 * 1024, int(chunk_bytes))
        self.interval = float(interval)
        self._admit = admit
        self._cursor_flush = max(self.chunk_bytes, int(cursor_flush_bytes))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: scan-session pacing state for the rate cap
        self._window_t0 = time.monotonic()
        self._window_bytes = 0

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="ec-scrub"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
        if self.cursor._dirty:
            self.cursor.save()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.run_cycle()
            except Exception:  # noqa: BLE001 — scrubbing must never crash serving
                pass
            self._stop.wait(self.interval)

    # -- pacing --------------------------------------------------------------

    def _budget(self, n: int) -> None:
        """Admission + rate cap, applied before each chunk read. Admission
        first (a token refused means foreground traffic owns the lane —
        yield immediately, don't burn the rate window waiting); then the
        byte-rate cap over a rolling 1 s window."""
        while not self._stop.is_set():
            if self._admit is None or self._admit():
                break
            time.sleep(0.05)
        if self.rate_mb <= 0:
            return
        cap = self.rate_mb * 1024 * 1024
        now = time.monotonic()
        if now - self._window_t0 >= 1.0:
            self._window_t0, self._window_bytes = now, 0
        self._window_bytes += n
        over = self._window_bytes - cap * (now - self._window_t0)
        if over > 0:
            time.sleep(min(1.0, over / cap))

    # -- the scan ------------------------------------------------------------

    def _scan_order(self, vols: dict) -> Iterable[tuple[int, object]]:
        """Volumes in vid order, rotated so the cursor's vid comes first —
        a cycle interrupted by restart resumes where it stopped instead of
        re-paying the prefix volumes every time."""
        vids = sorted(vols)
        if self.cursor.vid in vols:
            i = vids.index(self.cursor.vid)
            vids = vids[i:] + vids[:i]
        for vid in vids:
            yield vid, vols[vid]

    def run_cycle(self) -> dict:
        """One pass over every mounted EC volume's local shards. Returns
        {"scanned_bytes", "shards_ok", "findings": [(vid, shard, verdict)],
        "unverifiable"} — the findings were already delivered to the
        callback one by one, as found (repair should not wait for the
        cycle to finish)."""
        with trace_mod.start("scrub.cycle", klass="scrub") as sp:
            out = self._run_cycle_inner()
            if sp is not None:
                sp.annotate(
                    scanned_bytes=out["scanned_bytes"],
                    shards_ok=out["shards_ok"],
                    findings=len(out["findings"]),
                )
            return out

    def _run_cycle_inner(self) -> dict:
        out = {
            "scanned_bytes": 0,
            "shards_ok": 0,
            "findings": [],
            "unverifiable": 0,
        }
        for vid, ev in self._scan_order(self._volumes()):
            if self._stop.is_set():
                break
            info = stripe.read_ec_info(ev.base)
            recorded = (info or {}).get("shard_crc32")
            if (
                not isinstance(recorded, list)
                or len(recorded) != stripe.geometry_from_info(info).total_shards
            ):
                # pre-CRC volume: nothing to verify against; counted so
                # operators can see coverage, not silently skipped
                out["unverifiable"] += 1
                continue
            want_size = expected_shard_size(info)
            # mid-cycle resume: the cursor names the first unfinished
            # shard of its volume (offset > 0 = resume mid-file with the
            # saved CRC accumulator; offset 0 = that shard from the top)
            resume_shard, resume_off, resume_crc = -1, 0, 0
            if vid == self.cursor.vid:
                resume_shard = self.cursor.shard
                resume_off, resume_crc = self.cursor.offset, self.cursor.crc
            for shard in sorted(ev.shard_ids):
                if self._stop.is_set():
                    break
                if shard in getattr(ev, "quarantined", {}):
                    continue  # already out of serving, repair owns it
                if shard < resume_shard:
                    continue  # scanned before the restart
                off = resume_off if shard == resume_shard else 0
                crc0 = resume_crc if shard == resume_shard else 0
                verdict = self._scan_one(
                    vid, ev, shard, want_size, recorded[shard], off, crc0
                )
                if verdict is None:
                    continue  # unmounted mid-scan (racing delete): skip
                if verdict == OK:
                    out["shards_ok"] += 1
                    out["scanned_bytes"] += want_size - off
                else:
                    out["findings"].append((vid, shard, verdict))
                    stats.ScrubCorruptionsFound.labels(verdict).inc()
                    try:
                        self._on_finding(vid, shard, verdict)
                    except Exception:  # noqa: BLE001 — policy failures must
                        pass  # not stop the scan of the remaining shards
        if self._stop.is_set():
            # interrupted cycle: _scan_one already persisted the exact
            # mid-shard resume point — resetting the cursor here would
            # clobber it and make the next generation rescan everything
            return out
        self.cursor.cycles += 1
        self.cursor.point(0, 0, 0, 0)
        self.cursor.save()
        stats.ScrubCycles.inc()
        return out

    def _scan_one(
        self,
        vid: int,
        ev,
        shard: int,
        want_size: int,
        want_crc: int,
        offset: int,
        crc: int,
    ) -> Optional[str]:
        """Scan one shard with periodic cursor persistence. None when the
        shard was unmounted while we were getting to it."""
        if shard not in ev._shard_files:
            return None
        path = stripe.shard_file_name(ev.base, shard)
        scanned = 0
        last_flush = 0
        state = {"crc": crc, "pos": offset}
        # chunked inline so the cursor can record mid-shard progress; the
        # plain scan_shard_file stays the simple reusable form (ec.verify)
        try:
            size = os.path.getsize(path)
        except OSError:
            return MISSING
        if size < want_size:
            return TRUNCATED
        if size > want_size:
            return CORRUPT
        try:
            with open(path, "rb") as f:
                f.seek(state["pos"])
                while state["pos"] < want_size:
                    if self._stop.is_set():
                        # persist exact progress; next cycle resumes here
                        self.cursor.point(vid, shard, state["pos"], state["crc"])
                        self.cursor.save()
                        return None
                    n = min(self.chunk_bytes, want_size - state["pos"])
                    self._budget(n)
                    chunk = f.read(n)
                    if len(chunk) != n:
                        return TRUNCATED
                    state["crc"] = zlib.crc32(chunk, state["crc"])
                    state["pos"] += n
                    scanned += n
                    stats.ScrubBytesScanned.inc(n)
                    if scanned - last_flush >= self._cursor_flush:
                        self.cursor.point(vid, shard, state["pos"], state["crc"])
                        self.cursor.save()
                        last_flush = scanned
        except OSError:
            return MISSING
        # shard complete: advance the cursor past it (offset 0 = the next
        # shard starts fresh); persisted so a restart resumes at the
        # shard boundary instead of re-paying this file
        self.cursor.point(vid, shard + 1, 0, 0)
        self.cursor.save()
        return OK if state["crc"] == (want_crc & 0xFFFFFFFF) else CORRUPT


def verify_ec_volume(
    ev,
    chunk_bytes: int = 4 * 1024 * 1024,
    budget: Optional[Callable[[int], None]] = None,
) -> tuple[dict[int, str], bool]:
    """Operator-facing full verification of one mounted EC volume's local
    shards -> ({shard: verdict}, has_crcs). The RPC/shell surface of the
    same math the background scrubber runs; quarantined shards report
    their quarantine reason without rescanning (the serving handle is
    gone — the verdict that put them there stands)."""
    info = stripe.read_ec_info(ev.base)
    recorded = (info or {}).get("shard_crc32")
    quarantined = dict(getattr(ev, "quarantined", {}) or {})
    if not isinstance(recorded, list) or len(recorded) != stripe.geometry_from_info(info).total_shards:
        verdicts = {s: UNVERIFIABLE for s in ev.shard_ids}
        verdicts.update({s: str(r) for s, r in quarantined.items()})
        return verdicts, False
    want_size = expected_shard_size(info)
    verdicts: dict[int, str] = {}
    for s, reason in quarantined.items():
        verdicts[s] = str(reason)
    for s in ev.shard_ids:
        verdicts[s] = scan_shard_file(
            stripe.shard_file_name(ev.base, s),
            recorded[s],
            want_size,
            chunk_bytes=chunk_bytes,
            budget=budget,
        )
    return verdicts, True
