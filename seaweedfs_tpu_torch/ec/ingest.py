"""Inline-EC ingest: encode-on-write stripe building and GF-linear delta
parity updates.

An `InlineStripeBuilder` keeps stripe state for one OPEN volume and
encodes each large row through the warm path's `_encode_rows` staging-ring
pipeline as soon as the append-only .dat has grown past it (row k is a
large row of the final layout once the file strictly exceeds row k + 1;
the layout rule is monotone in file size). A volume that reaches its seal
is thus born EC'd: `seal()` encodes only the rows not yet covered and the
small-row tail, and writes `.ec00-.ec13` + `.eci` byte-identical to what
`write_ec_files` makes of the sealed volume. On a card encoder every row
batch and every delta is one launch of the encoder's kernel.

Overwrites inside already-encoded rows are folded in as DELTA parity
updates: parity is linear in each data shard, so parity' = parity ^
G_col * (old ^ new) on just the touched columns (`Encoder.parity_delta`,
golden `gf8.gf_delta_parity`), a rank-1 update of O(changed) bytes.

Crash safety: progress is journaled in a `<base>.ecp` sidecar (JSON lines,
flush + fsync per record; a torn tail line is ignored on read). Shard
bytes live in `<base>.ecNN.inp` partials that shard discovery never sees.
Row bytes are fsync'd BEFORE their `rows` watermark record, so resume can
truncate the partials back to the watermark; an overwrite journals an `ow`
intent (old + new bytes) before the .dat changes, then one absolute-bytes
`delta` record per patched segment, then `ow-done`, so replay is
idempotent and a crash at any point resolves from the .dat against the
intent. A state the journal cannot vouch for (geometry drift, truncated
partials, an unresolvable intent) makes `resume` return None and the seal
falls back to the warm encode. The journal and partials carry no backend:
either package resumes the other's.
"""

from __future__ import annotations

import base64
import json
import os
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np

from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.ec import read_planner as read_planner_mod
from seaweedfs_tpu_torch.ec import stripe
from seaweedfs_tpu_torch.ec.constants import (
    DATA_SHARDS_COUNT,
    EC_BUFFER_SIZE,
    TOTAL_SHARDS_COUNT,
)
from seaweedfs_tpu_torch.obs import trace as trace_mod
from seaweedfs_tpu_torch.utils import config

#: journal (stripe-progress sidecar) and in-progress shard-partial suffixes.
#: Neither matches the `.ecNN`/`.ecx` discovery globs, so a crashed inline
#: encode can never be mistaken for a complete shard set.
JOURNAL_EXT = ".ecp"
PART_SUFFIX = ".inp"

_JOURNAL_VERSION = 1

#: "no spread decision made yet" sentinel for IngestManager._spreads —
#: distinct from None, which latches "factory declined/failed: stay local"
_SPREAD_UNSET = object()


def journal_path(base_file_name: str) -> str:
    return base_file_name + JOURNAL_EXT


def part_path(base_file_name: str, shard_id: int) -> str:
    return stripe.shard_file_name(base_file_name, shard_id) + PART_SUFFIX


def _append_record(f, record: dict) -> None:
    """One JSON line, flush+fsync'd as it lands (kernel_sweep --out
    discipline): a kill leaves at worst a torn tail, never a half-trusted
    record."""
    f.write((json.dumps(record, separators=(",", ":")) + "\n").encode())
    f.flush()
    os.fsync(f.fileno())


def read_journal(base_file_name: str) -> list[dict]:
    """Every parseable record in order. A torn tail (crash mid-append)
    terminates the read — the partial line and anything after it is not
    evidence."""
    return _read_journal_prefix(base_file_name)[0]


def _read_journal_prefix(base_file_name: str) -> tuple[list[dict], int]:
    """(records, valid_bytes): the parseable record prefix and how many
    bytes of the file it spans. A resume MUST truncate the journal to
    `valid_bytes` before appending — records written after a torn
    fragment would be concatenated onto it and become invisible to every
    later recovery."""
    try:
        with open(journal_path(base_file_name), "rb") as f:
            raw = f.read()
    except OSError:
        return [], 0
    records: list[dict] = []
    valid = 0
    pos = 0
    for line in raw.split(b"\n"):
        end = pos + len(line) + 1  # +1: the split-off newline
        if end > len(raw):
            break  # no trailing newline = torn by definition, even if it
            # happens to parse — records and truncation point must agree
        if line.strip():
            try:
                rec = json.loads(line)
            except ValueError:
                break  # torn tail: ignore it and stop trusting what follows
            if isinstance(rec, dict):
                records.append(rec)
        valid = end
        pos = end
    return records, valid


def _b64(b) -> str:
    return base64.b64encode(bytes(b)).decode()


def _fsync_all(handles) -> None:
    """flush + fsync a set of shard handles CONCURRENTLY: a watermark
    flush syncs all 14 partials, and on latency-bound storage serial
    fsync pays 14 round-trips where parallel pays ~one. Ordering is
    unchanged — every fsync still completes before the caller journals
    the watermark record."""
    handles = list(handles)
    if not handles:
        return
    if len(handles) == 1:
        handles[0].flush()
        os.fsync(handles[0].fileno())
        return
    def sync(h):
        h.flush()
        os.fsync(h.fileno())

    with ThreadPoolExecutor(
        max_workers=min(8, len(handles)), thread_name_prefix="inline-ec-fsync"
    ) as ex:
        for fut in [ex.submit(sync, h) for h in handles]:
            fut.result()


def _dat_revision(base_file_name: str) -> Optional[int]:
    """The volume superblock's compact_revision (bytes 4:6 of the .dat),
    or None when unreadable. Compaction bumps it while rewriting every
    needle offset — a journal pinned to the old revision must NEVER
    resume over the compacted file (the partials encode deleted bytes).
    The superblock's replica-placement byte is NOT part of this pin: the
    configure-replication delta path legitimately rewrites it in place."""
    try:
        with open(base_file_name + ".dat", "rb") as f:
            raw = f.read(6)
    except OSError:
        return None
    if len(raw) < 6:
        return None
    return int.from_bytes(raw[4:6], "big")


class InlineStripeBuilder:
    """Incremental encode-on-write stripe state for ONE open volume.

    `poll()` encodes newly-completed large rows (cheap no-op otherwise),
    `overwrite()` folds an in-place .dat change into the encoded rows as
    a journaled delta parity update, `seal()` finalizes the byte-exact
    warm-equivalent shard set, `abort()` drops the partials. All public
    methods are serialized by one lock; any failure marks the builder
    `broken` so the seal path falls back to the warm conversion instead
    of trusting half-updated parity."""

    def __init__(
        self,
        base_file_name: str,
        encoder,
        large_block_size: int,
        small_block_size: int,
        buffer_size: int = EC_BUFFER_SIZE,
        max_batch_bytes: int = 64 * 1024 * 1024,
        pipeline_depth: Optional[int] = None,
        delta_enabled: Optional[bool] = None,
        _resume: bool = False,
    ):
        self.base = base_file_name
        self._enc = encoder
        self.large = int(large_block_size)
        self.small = int(small_block_size)
        self._buffer = int(buffer_size)
        self._max_batch = int(max_batch_bytes)
        self._depth = pipeline_depth
        self._delta_enabled = (
            config.env("WEEDTPU_INLINE_EC_DELTA")
            if delta_enabled is None
            else bool(delta_enabled)
        )
        self.rows_done = 0
        #: rows covered by the last fsync'd watermark record — durability is
        #: BATCHED: polls encode eagerly but fsync the partials + journal
        #: the watermark only every `_durable_batch` bytes of rows (per-row
        #: fsync of 15 files would dominate small-row amortized cost; a
        #: crash merely re-encodes the undurable tail from the .dat, which
        #: is the durable source of truth either way)
        self._durable_rows = 0
        self._durable_batch = 64 * 1024 * 1024
        self.crcs = [0] * TOTAL_SHARDS_COUNT
        self.crc_valid = True
        self.broken = False
        self.closed = False
        self.resumed = _resume
        self.delta_stats = {"updates": 0, "changed_bytes": 0, "accounted_bytes": 0}
        self._lock = threading.RLock()
        #: serializes journal appends across the poll/overwrite threads and
        #: the async watermark flusher (lock order: _lock before
        #: _journal_lock, everywhere)
        self._journal_lock = threading.Lock()
        self._parts: list = []
        self._journal = None
        #: per-poll overhead: the staging ring persists ACROSS polls
        #: (stripe._encode_rows reuses it via ring_cache instead of pinning
        #: fresh host buffers every poll), the .dat read handle
        #: stays open for the builder's life (the file is append-only;
        #: compaction discards the whole builder), and watermark fsyncs
        #: run on a flusher thread so durability batching never stalls
        #: the encode lane
        self._ring_cache: dict = {}
        self._dat = None
        self._flusher = None  # lazy single-worker executor
        #: optional parity-spread hook (shard_id, pos, length), set by the
        #: IngestManager from its spread session, so a delta patch below
        #: the shipped watermark marks the target range dirty
        self.on_parity_patch = None
        #: rows already handed to the flusher — the threshold check must
        #: not re-submit a job per poll while one is still fsyncing (each
        #: stale job would re-fsync all 14 partials before noticing)
        self._flush_submitted_rows = 0
        if not _resume:
            try:
                self._parts = [
                    open(part_path(base_file_name, s), "w+b")  # weedlint: ignore[open-no-ctx] builder-lifetime partials, closed in abort()/seal()
                    for s in range(TOTAL_SHARDS_COUNT)
                ]
                # weedlint: ignore[open-no-ctx] builder-lifetime journal handle, closed in abort()/seal()
                self._journal = open(journal_path(base_file_name), "wb")
                self._journal_append(self._begin_record())
            except BaseException:
                self._close_handles()
                raise

    def _begin_record(self) -> dict:
        return {
            "kind": "begin",
            "version": _JOURNAL_VERSION,
            "large": self.large,
            "small": self.small,
            "data_shards": self._enc.data_shards,
            "parity_shards": self._enc.parity_shards,
            "matrix_kind": self._enc.matrix_kind,
            # pins this journal to THIS generation of the .dat: compaction
            # bumps the revision, so a stale journal surviving a restart
            # can never resume over the offset-shifted rewrite
            "dat_rev": _dat_revision(self.base),
        }

    # -- geometry ------------------------------------------------------------

    @property
    def _large_row(self) -> int:
        return self.large * DATA_SHARDS_COUNT

    def encoded_limit(self) -> int:
        """First .dat byte NOT covered by an encoded row — overwrites below
        this need a delta update, appends above it just wait for poll."""
        return self.rows_done * self._large_row

    def _layout(self, dat_size: int) -> tuple[int, int]:
        """(n_large, n_small) — delegated to `stripe.stripe_layout`, the
        ONE layout definition the byte-identity contract hangs on."""
        return stripe.stripe_layout(dat_size, self.large, self.small)

    def _available_rows(self, dat_size: int) -> int:
        """Large rows of the FINAL layout already fully determined: row k is
        large iff dat_size > (k+1) rows — and file growth only ever adds
        rows, so once a row qualifies it stays qualified (monotone)."""
        return max(0, -(-dat_size // self._large_row) - 1)

    # -- incremental encode ---------------------------------------------------

    def poll(self) -> int:
        """Encode any newly-completed large rows through the staging-ring
        pipeline; returns rows encoded (0 = nothing new, the per-PUT fast
        path: one getsize and out)."""
        with self._lock:
            if self.broken or self.closed:
                return 0
            try:
                dat_size = os.path.getsize(self.base + ".dat")
            except OSError:
                return 0
            n_new = self._available_rows(dat_size) - self.rows_done
            if n_new <= 0:
                return 0
            try:
                self._encode_large(n_new)
            except BaseException:
                self.broken = True
                raise
            return n_new

    def _dat_handle(self):
        """The builder-lifetime .dat read handle: the file is append-only
        for the builder's life (compaction/delete discard the builder),
        so one open amortizes over every poll instead of paying an
        open/close per poll."""
        if self._dat is None:
            # weedlint: ignore[open-no-ctx] builder-lifetime read handle, closed in abort()/seal()
            self._dat = open(self.base + ".dat", "rb")
        return self._dat

    def _encode_large(self, n_rows: int) -> None:
        """Encode `n_rows` large rows starting at the progress cursor.
        Durability is batched: shard bytes are fsync'd BEFORE their
        watermark record whenever a flush happens (resume truncates the
        partials back to the last durable watermark), but the flush
        itself fires only per `_durable_batch` bytes — a crash costs
        re-encoding the undurable tail, never trusting unfsync'd bytes."""
        f = self._dat_handle()
        for h in self._parts:
            h.seek(self.rows_done * self.large)
        with trace_mod.start("ingest.encode", klass="ingest") as sp:
            if sp is not None:
                sp.annotate(rows=n_rows, row_start=self.rows_done)
            self._encode_large_rows(f, n_rows)
        self.rows_done += n_rows
        undurable = self.rows_done - max(self._durable_rows, self._flush_submitted_rows)
        if undurable * self._large_row >= self._durable_batch:
            # async: the encode lane keeps rolling while the flusher
            # thread makes the batch durable (fsync-before-record
            # ordering preserved inside the job)
            self._flush_watermark(wait=False)
        stats.InlineEcRows.inc(n_rows)
        stats.InlineEcBytes.inc(n_rows * self._large_row)

    def _encode_large_rows(self, f, n_rows: int) -> None:
        stripe._encode_rows(
            f,
            self._enc,
            self._parts,
            self.rows_done * self._large_row,
            self.large,
            n_rows,
            self._buffer,
            # right-size the staging ring to the work actually available:
            # an ingest poll usually encodes ONE row (so steady-state polls
            # hit the SAME cached ring geometry every time), and allocating
            # the warm path's full batch budget per poll would dominate the
            # amortized cost with dead buffer churn
            min(self._max_batch, max(self._buffer * DATA_SHARDS_COUNT,
                                     n_rows * self._large_row)),
            self._depth,
            self.crcs,
            ring_cache=self._ring_cache,
        )

    def _journal_append(self, record: dict) -> None:
        with self._journal_lock:
            _append_record(self._journal, record)

    def _flush_watermark(self, wait: bool = True) -> None:
        """fsync every partial, THEN journal the watermark: a durable
        `rows` record always describes bytes that are already on disk.

        wait=False hands the whole job (fsync + record) to the builder's
        flusher thread — the poll path's durability batching then
        overlaps the next rows' encode instead of stalling it. The
        ordering contract is unchanged: the job fsyncs before it
        journals, and a job whose snapshot fell behind a newer durable
        watermark (a later sync flush won the race) appends nothing."""
        if self._durable_rows == self.rows_done:
            return
        rows = self.rows_done
        crcs = [int(c) for c in self.crcs] if self.crc_valid else None
        if wait:
            _fsync_all(self._parts)
            self._journal_append({"kind": "rows", "rows": rows, "crcs": crcs})
            self._durable_rows = rows
            self._flush_submitted_rows = max(self._flush_submitted_rows, rows)
            return
        if self._flusher is None:
            self._flusher = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="inline-ec-flush"
            )
        self._flush_submitted_rows = rows
        self._flusher.submit(self._flush_job, list(self._parts), rows, crcs)

    def _flush_job(self, parts: list, rows: int, crcs) -> None:
        """One async watermark: fsync the snapshot's handles (outside the
        builder lock — encodes keep rolling), then journal the record iff
        the builder is still live and this watermark is still the newest.
        A seal/abort racing the fsync just makes it a no-op: their own
        fsync covers the bytes, and closed handles raise harmlessly."""
        try:
            _fsync_all(parts)
        except Exception:  # noqa: BLE001 — closed mid-seal/abort: skip
            return
        with self._lock:
            if self.closed or self.broken or self._journal is None:
                return
            if rows <= self._durable_rows:
                return  # a newer sync flush already covered these rows
            try:
                self._journal_append({"kind": "rows", "rows": rows, "crcs": crcs})
            except Exception:  # noqa: BLE001 — a missed watermark only
                # costs resume re-encoding from the previous one
                return
            self._durable_rows = rows

    # -- delta parity updates -------------------------------------------------

    def overwrite(
        self,
        offset: int,
        old,
        new,
        mutate: Optional[Callable[[], None]] = None,
    ) -> int:
        """Fold an in-place .dat overwrite [offset, offset+len) into the
        stripe. `mutate` (when given) performs the actual .dat write and
        runs AFTER the intent record is durable, so a crash at any point
        is resolvable from the journal (see module docstring). Returns
        bytes patched inside already-encoded rows (0 = nothing encoded
        was touched, or deltas are disabled — in which case a touched
        encoded range marks the builder broken → warm fallback)."""
        old_b = bytes(old)
        new_b = bytes(new)
        if len(old_b) != len(new_b):
            raise ValueError(
                f"old/new overwrite blocks disagree on length: "
                f"{len(old_b)} vs {len(new_b)}"
            )
        with self._lock:
            if self.closed:
                # a seal closed this builder between the caller's lookup and
                # now: the caller's mutation must STILL land — refusing here
                # would silently drop e.g. a replication-configure rewrite
                if mutate is not None:
                    mutate()
                return 0
            touches = (
                not self.broken
                and offset < self.encoded_limit()
                and old_b != new_b
            )

            def run_mutate() -> None:
                """The caller's .dat write. When it fails with encoded rows
                at stake, the .dat may be PARTIALLY rewritten — the builder
                can no longer vouch for its parity, so break it before
                letting the caller's error propagate (their RPC must fail
                exactly like the non-inline path's would)."""
                if mutate is None:
                    return
                try:
                    mutate()
                except BaseException:
                    if touches:
                        self.broken = True
                    raise

            if not touches:
                run_mutate()
                return 0
            if not self._delta_enabled:
                # parity for the touched rows goes stale and deltas are
                # off: the only honest option is the warm re-encode
                self.broken = True
                run_mutate()
                return 0
            try:
                # deltas must land ABOVE a durable watermark: resume replays
                # them against rows it can actually truncate back to
                self._flush_watermark()
                self._journal_append(
                    {"kind": "ow", "off": int(offset), "old": _b64(old_b), "new": _b64(new_b)},
                )
            except BaseException:
                # journaling failed: the CALLER's mutation must still land
                # (it was promised); the builder just can't vouch for its
                # parity anymore
                self.broken = True
                run_mutate()
                return 0
            run_mutate()
            try:
                patched = self._update_encoded(
                    offset,
                    np.frombuffer(old_b, dtype=np.uint8),
                    np.frombuffer(new_b, dtype=np.uint8),
                )
                self._journal_append({"kind": "ow-done"})
            except BaseException:  # noqa: BLE001 — the mutation LANDED and
                # the intent record preserves it; a failed delta just means
                # this builder can no longer vouch for parity (warm
                # fallback at seal). The caller's operation succeeded, so
                # nothing propagates.
                self.broken = True
                return 0
            return patched

    def _update_encoded(
        self,
        offset: int,
        old: np.ndarray,
        new: np.ndarray,
        skip: Optional[set] = None,
    ) -> int:
        """Apply delta parity updates for the encoded part of the range,
        segment by (row, data shard) block. `skip` lists (pos, shard)
        segments already restored by journal replay (their absolute bytes
        are on disk; re-deriving a delta for them would double-apply)."""
        limit = self.encoded_limit()
        end = min(offset + old.size, limit)
        patched = 0
        p = offset
        while p < end:
            row, q = divmod(p, self._large_row)
            d, col = divmod(q, self.large)
            seg = min(self.large - col, end - p)
            o = old[p - offset : p - offset + seg]
            n = new[p - offset : p - offset + seg]
            pos = row * self.large + col
            if (skip is None or (pos, d) not in skip) and not np.array_equal(o, n):
                self._apply_delta(pos, d, o, n)
                patched += seg
            p += seg
        if patched:
            self.crc_valid = False
            # an overwrite changed encoded bytes for this base: decoded
            # intervals cached before the delta describe the OLD contents
            # and must never serve another read
            read_planner_mod.CACHE.invalidate_volume(self.base)
            self.delta_stats["updates"] += 1
            self.delta_stats["changed_bytes"] += patched
            # accounting for the small-write gate: old+new data bytes in,
            # one data-range write, and a read-modify-write per parity
            # shard — the bytes a delta computes/moves, vs a full stripe
            # re-encode's dat_size + parity writes
            accounted = patched * (2 + 2 * self._enc.parity_shards)
            self.delta_stats["accounted_bytes"] += accounted
            stats.InlineEcDeltaUpdates.inc()
            stats.InlineEcDeltaBytes.inc(accounted)
        return patched

    def _apply_delta(self, pos: int, d: int, old_seg: np.ndarray, new_seg: np.ndarray) -> None:
        """One (row, data shard) segment: journal the absolute post-state
        bytes (idempotent redo), then rewrite the data range and XOR the
        GF delta into each parity shard's touched range."""
        dp = self._enc.parity_delta(d, old_seg, new_seg)  # (P, seg)
        writes: dict[int, bytes] = {d: new_seg.tobytes()}
        seg = old_seg.size
        for pi in range(self._enc.parity_shards):
            h = self._parts[DATA_SHARDS_COUNT + pi]
            h.seek(pos)
            cur = h.read(seg)
            if len(cur) != seg:
                raise IOError(
                    f"{self.base}: parity partial {DATA_SHARDS_COUNT + pi} "
                    f"truncated at {pos}+{seg}"
                )
            writes[DATA_SHARDS_COUNT + pi] = (
                np.frombuffer(cur, dtype=np.uint8) ^ dp[pi]
            ).tobytes()
        self._journal_append(
            {
                "kind": "delta",
                "pos": int(pos),
                "d": int(d),
                "writes": {str(s): _b64(b) for s, b in writes.items()},
            },
        )
        for s, b in writes.items():
            h = self._parts[s]
            h.seek(pos)
            h.write(b)
            h.flush()
            os.fsync(h.fileno())
        if self.on_parity_patch is not None:
            for s, b in writes.items():
                if s >= DATA_SHARDS_COUNT:
                    try:
                        self.on_parity_patch(s, pos, len(b))
                    except Exception:  # noqa: BLE001 — spread is best-effort
                        pass

    # -- seal / abort ---------------------------------------------------------

    def seal(self) -> dict:
        """Finalize `.ec00-.ec13` + `.eci` byte-identical to warm
        `write_ec_files` on the same sealed .dat: encode the remaining
        large rows and the small-row tail, recompute shard CRCs when a
        delta invalidated the streamed ones, fsync, and rename the
        partials into place. Returns the amortization accounting."""
        with trace_mod.ensure("ingest.seal", klass="ingest"), self._lock:
            trace_mod.annotate(rows_inline=self.rows_done)
            if self.broken or self.closed:
                raise IOError(f"{self.base}: inline stripe state unusable")
            dat_size = os.path.getsize(self.base + ".dat")
            n_large, n_small = self._layout(dat_size)
            rows_inline = self.rows_done
            if self.rows_done > n_large:
                raise IOError(
                    f"{self.base}: encoded {self.rows_done} large rows but the "
                    f"final layout has {n_large} — .dat shrank?"
                )
            try:
                if n_large > self.rows_done:
                    self._encode_large(n_large - self.rows_done)
                if n_small:
                    f = self._dat_handle()
                    for h in self._parts:
                        h.seek(0, os.SEEK_END)
                    stripe._encode_rows(
                        f,
                        self._enc,
                        self._parts,
                        n_large * self._large_row,
                        self.small,
                        n_small,
                        min(self._buffer, self.small),
                        self._max_batch,
                        self._depth,
                        self.crcs,
                        ring_cache=self._ring_cache,
                    )
                if not self.crc_valid:
                    self._recompute_crcs()
                _fsync_all(self._parts)
                for h in self._parts:
                    h.close()
                self._parts = []
                for s in range(TOTAL_SHARDS_COUNT):
                    os.replace(
                        part_path(self.base, s), stripe.shard_file_name(self.base, s)
                    )
                stripe.write_ec_info(
                    self.base, self.large, self.small, dat_size, shard_crcs=self.crcs
                )
            except BaseException:
                self.broken = True
                raise
            if self._journal is not None:
                self._journal.close()
                self._journal = None
            if self._dat is not None:
                self._dat.close()
                self._dat = None
            if self._flusher is not None:
                self._flusher.shutdown(wait=False)
                self._flusher = None
            self._ring_cache.clear()
            try:
                os.unlink(journal_path(self.base))
            except OSError:
                pass
            self.closed = True
            return {
                "rows_inline": rows_inline,
                "rows_total": n_large,
                "small_rows": n_small,
                "delta_updates": self.delta_stats["updates"],
                "delta_bytes": self.delta_stats["accounted_bytes"],
            }

    def _recompute_crcs(self) -> None:
        """Delta patches mutate shard bytes in place; CRC32 of a stream is
        not patchable, so after any delta the per-shard CRCs are recomputed
        in one pass over the finalized partials — the .eci then records the
        same values a warm encode of the final .dat would."""
        for s, h in enumerate(self._parts):
            h.flush()
            h.seek(0)
            crc = 0
            while True:
                chunk = h.read(4 * 1024 * 1024)
                if not chunk:
                    break
                crc = zlib.crc32(chunk, crc)
            self.crcs[s] = crc
        self.crc_valid = True

    def _close_handles(self) -> None:
        for h in self._parts:
            try:
                h.close()
            except OSError:
                pass
        self._parts = []
        if self._journal is not None:
            try:
                self._journal.close()
            except OSError:
                pass
            self._journal = None
        if self._dat is not None:
            try:
                self._dat.close()
            except OSError:
                pass
            self._dat = None
        if self._flusher is not None:
            self._flusher.shutdown(wait=False)
            self._flusher = None
        self._ring_cache.clear()

    def abort(self) -> None:
        """Drop the in-progress state: close handles, unlink partials and
        the journal. The .dat is untouched — a later warm conversion (or a
        fresh builder) rebuilds everything from it."""
        with self._lock:
            self.closed = True
            self._close_handles()
            for s in range(TOTAL_SHARDS_COUNT):
                try:
                    os.unlink(part_path(self.base, s))
                except OSError:
                    pass
            try:
                os.unlink(journal_path(self.base))
            except OSError:
                pass

    # -- crash recovery -------------------------------------------------------

    @classmethod
    def resume(
        cls,
        base_file_name: str,
        encoder,
        large_block_size: int,
        small_block_size: int,
        **kwargs,
    ) -> Optional["InlineStripeBuilder"]:
        """Rebuild a builder from the journaled sidecar after a crash.
        Returns None whenever the on-disk state cannot be vouched for
        (missing/foreign journal, geometry or codec drift, truncated
        partials, unresolvable overwrite intent) — the caller then aborts
        the partials and the seal falls back to the warm conversion."""
        records, journal_valid = _read_journal_prefix(base_file_name)
        if not records or records[0].get("kind") != "begin":
            return None
        head = records[0]
        if head.get("version") != _JOURNAL_VERSION:
            return None
        if (
            int(head.get("large", -1)) != int(large_block_size)
            or int(head.get("small", -1)) != int(small_block_size)
            or int(head.get("data_shards", -1)) != encoder.data_shards
            or int(head.get("parity_shards", -1)) != encoder.parity_shards
            or head.get("matrix_kind") != encoder.matrix_kind
        ):
            return None
        if head.get("dat_rev") != _dat_revision(base_file_name):
            # the .dat was compacted (or replaced) since the journal began:
            # every encoded row maps to the OLD offsets — not resumable
            return None
        rows, crcs, any_delta = 0, [0] * TOTAL_SHARDS_COUNT, False
        deltas: list[dict] = []
        pending: Optional[dict] = None
        pending_deltas: list[dict] = []
        for rec in records[1:]:
            kind = rec.get("kind")
            if kind == "rows":
                rows = int(rec.get("rows", 0))
                rc = rec.get("crcs")
                if isinstance(rc, list) and len(rc) == TOTAL_SHARDS_COUNT:
                    crcs = [int(c) for c in rc]
                else:
                    any_delta = True  # crcs went stale before this record
            elif kind == "delta":
                any_delta = True
                deltas.append(rec)
                if pending is not None:
                    pending_deltas.append(rec)
            elif kind == "ow":
                any_delta = True
                pending = rec
                pending_deltas = []
            elif kind == "ow-done":
                pending = None
                pending_deltas = []
        expected = rows * int(large_block_size)
        for s in range(TOTAL_SHARDS_COUNT):
            try:
                size = os.path.getsize(part_path(base_file_name, s))
            except OSError:
                return None  # a partial vanished: the set is not trustworthy
            if size < expected:
                return None  # journal ahead of the files: fsync contract broken
        b = cls(
            base_file_name,
            encoder,
            large_block_size,
            small_block_size,
            _resume=True,
            **kwargs,
        )
        try:
            b._parts = [
                open(part_path(base_file_name, s), "r+b")  # weedlint: ignore[open-no-ctx] builder-lifetime partials, closed in abort()/seal()
                for s in range(TOTAL_SHARDS_COUNT)
            ]
            b.rows_done = rows
            b._durable_rows = rows
            b.crcs = crcs
            # CRC provenance contract: the watermark's streamed CRCs are
            # exact ONLY when nothing mutated shard bytes in place since
            # they were recorded. Any delta record, any pending overwrite
            # intent (its resolution below may patch further segments),
            # or a watermark that dropped its crcs (crc_valid was already
            # False at record time — folded into any_delta above) forces
            # seal() to RECOMPUTE the .eci CRCs from the finalized
            # partials: the sealed record must describe the bytes on
            # disk, never a stale stream fold that a later fsck/scrub
            # would flag as corruption on a perfectly healthy volume.
            b.crc_valid = not any_delta and pending is None
            for h in b._parts:
                h.truncate(expected)  # drop rows past the durable watermark
            # redo: delta records carry absolute post-state bytes, so
            # replay is idempotent whatever subset already hit the disk
            for rec in deltas:
                pos = int(rec.get("pos", -1))
                for s_str, b64v in (rec.get("writes") or {}).items():
                    s = int(s_str)
                    data = base64.b64decode(b64v)
                    if 0 <= s < TOTAL_SHARDS_COUNT and 0 <= pos and pos + len(data) <= expected:
                        h = b._parts[s]
                        h.seek(pos)
                        h.write(data)
            # drop any torn tail BEFORE appending: records written after a
            # torn fragment would concatenate onto it and become invisible
            # to every later recovery
            with open(journal_path(base_file_name), "r+b") as jf:
                jf.truncate(journal_valid)
            # journal reopens BEFORE intent resolution: resolving may append
            # fresh delta records for segments the crash never reached
            # weedlint: ignore[open-no-ctx] builder-lifetime journal handle, closed in abort()/seal()
            b._journal = open(journal_path(base_file_name), "ab")
            if pending is not None:
                if not b._resolve_pending(pending, pending_deltas):
                    b._close_handles()
                    return None
                b._journal_append({"kind": "ow-done"})
            _fsync_all(b._parts)
        except BaseException:
            b._close_handles()
            raise
        return b

    def _resolve_pending(self, pending: dict, replayed: list[dict]) -> bool:
        """A crash mid-overwrite left an intent without its `ow-done`.
        Compare the .dat against the recorded old/new bytes to learn how
        far the mutation got, then finish the delta for exactly the
        segments no replayed record already restored. False = the .dat
        matches neither state — someone else mutated it; not recoverable."""
        try:
            off = int(pending["off"])
            old = base64.b64decode(pending["old"])
            new = base64.b64decode(pending["new"])
        except (KeyError, ValueError):
            return False
        try:
            with open(self.base + ".dat", "rb") as f:
                f.seek(off)
                cur = f.read(len(new))
        except OSError:
            return False
        if cur == old:
            return True  # crash before the mutate: nothing to fold in
        if cur != new:
            return False  # unknown mutation: the intent cannot vouch for it
        covered = {
            (int(rec.get("pos", -1)), int(rec.get("d", -1))) for rec in replayed
        }
        self._update_encoded(
            off,
            np.frombuffer(old, dtype=np.uint8),
            np.frombuffer(new, dtype=np.uint8),
            skip=covered,
        )
        return True


class IngestManager:
    """Per-server inline-EC policy + builder registry.

    `on_write(vid)` is the write-path hook (cheap when no new row is
    complete); `overwrite(vid, ...)` routes in-place .dat mutations
    through the journaled delta path; `seal_volume(vid, base)` finalizes
    inline state (resuming a crashed builder from its journal first) and
    falls back to the warm `write_ec_files` whenever the inline state
    cannot be vouched for; `discard(vid)` invalidates state a compaction
    or volume delete made stale."""

    def __init__(
        self,
        store,
        seal_bytes: Optional[int] = None,
        delta_enabled: Optional[bool] = None,
        large_block_size: Optional[int] = None,
        small_block_size: Optional[int] = None,
        buffer_size: int = EC_BUFFER_SIZE,
        max_batch_bytes: int = 64 * 1024 * 1024,
        seal_trigger: Optional[Callable[[int], None]] = None,
        spread_factory: Optional[Callable] = None,
    ):
        self.store = store
        #: `spread_factory(vid, base) -> session | None`, supplied by the
        #: caller (a volume server spreading parity); a session tees each
        #: parity shard's encoded rows to its eventual holder, so a seal
        #: ships only the tail
        self._spread_factory = spread_factory
        self._spreads: dict[int, object] = {}
        self.seal_bytes = (
            config.env("WEEDTPU_INLINE_EC_SEAL_BYTES")
            if seal_bytes is None
            else int(seal_bytes)
        )
        self.delta_enabled = (
            config.env("WEEDTPU_INLINE_EC_DELTA")
            if delta_enabled is None
            else bool(delta_enabled)
        )
        self.large = (
            config.env("WEEDTPU_INLINE_EC_LARGE_BLOCK")
            if large_block_size is None
            else int(large_block_size)
        )
        self.small = (
            config.env("WEEDTPU_INLINE_EC_SMALL_BLOCK")
            if small_block_size is None
            else int(small_block_size)
        )
        self._buffer = buffer_size
        self._max_batch = max_batch_bytes
        self._seal_trigger = seal_trigger
        self._builders: dict[int, InlineStripeBuilder] = {}
        self._sealing: set[int] = set()
        self._lock = threading.Lock()
        # encode runs OFF the write-ack path: on_write only marks the
        # volume dirty (plus the cheap threshold check); one worker thread
        # drains dirty volumes and polls their builders. A PUT must never
        # pay a stripe row's encode — at production geometry one large row
        # is 10 GiB, and even a fresh builder over an existing volume
        # (whole-backlog encode) just keeps the worker busy, not a client.
        self._dirty: set[int] = set()
        self._cv = threading.Condition(self._lock)
        self._stopped = False
        self._worker = threading.Thread(
            target=self._poll_loop, daemon=True, name="inline-ec-encoder"
        )
        self._worker.start()

    def _builder_kwargs(self) -> dict:
        return {
            "buffer_size": self._buffer,
            "max_batch_bytes": self._max_batch,
            "delta_enabled": self.delta_enabled,
        }

    def builder_for(self, vid: int, base: str) -> Optional[InlineStripeBuilder]:
        """The volume's live builder, resuming a journaled one (crash
        recovery) before starting fresh. None while a seal owns the
        volume's stripe state — the fence is re-checked HERE, under the
        same lock seal_volume raises it with, so a racing write can never
        resume/create a builder over partials being finalized."""
        with self._lock:
            if vid in self._sealing:
                return None
            b = self._builders.get(vid)
            if b is not None and not b.closed:
                return b
            if os.path.exists(journal_path(base)):
                b = InlineStripeBuilder.resume(
                    base, self.store.encoder, self.large, self.small,
                    **self._builder_kwargs(),
                )
                if b is None:
                    # un-vouchable leftovers: clear them before starting over
                    _cleanup_partials(base)
            else:
                b = None
            if b is None:
                b = InlineStripeBuilder(
                    base, self.store.encoder, self.large, self.small,
                    **self._builder_kwargs(),
                )
            self._builders[vid] = b
            return b

    def on_write(self, vid: int) -> None:
        """Post-append hook: ensure the volume has a builder, mark it dirty
        for the encoder worker, and trigger the auto-seal when the .dat
        crossed the threshold. O(handful of syscalls) — the actual row
        encode happens on the worker thread, never in the write ack.
        Never raises into the write path — a failed poll marks the
        builder broken and the seal will fall back to warm."""
        v = self.store.get_volume(vid)
        if v is None or v.read_only or getattr(v, "tiered", False):
            return
        try:
            b = self.builder_for(vid, v.base_path)
        except Exception:  # noqa: BLE001 — inline EC must not fail ingest
            b = None
        if b is not None:
            with self._cv:
                self._dirty.add(vid)
                self._cv.notify()
        if self.seal_bytes and self._seal_trigger is not None:
            try:
                size = os.path.getsize(v.dat_path)
            except OSError:
                return
            if size >= self.seal_bytes:
                with self._lock:
                    if vid in self._sealing:
                        return
                    self._sealing.add(vid)
                threading.Thread(
                    target=self._seal_trigger, args=(vid,), daemon=True,
                    name=f"inline-ec-seal-{vid}",
                ).start()

    def _poll_loop(self) -> None:
        """The encoder worker: drain dirty volumes, poll their builders.
        Per-volume failures mark that builder broken (warm fallback at
        seal) and never stop the loop."""
        while True:
            with self._cv:
                while not self._dirty and not self._stopped:
                    self._cv.wait()
                if self._stopped:
                    return
                vid = self._dirty.pop()
                b = self._builders.get(vid)
            if b is None or b.closed:
                continue
            try:
                b.poll()
            except Exception:  # noqa: BLE001 — builder marked broken
                continue
            self._spread_poll(vid, b)

    def _spread_poll(self, vid: int, b: InlineStripeBuilder) -> None:
        """Tee newly-encoded parity rows to the volume's spread session
        (created lazily from the factory; a failed creation latches off
        for this volume — spreading must never become a retry storm on
        the encoder worker)."""
        if self._spread_factory is None or b.broken:
            return
        with self._lock:
            session = self._spreads.get(vid, _SPREAD_UNSET)
        if session is _SPREAD_UNSET:
            try:
                session = self._spread_factory(vid, b.base)
            except Exception:  # noqa: BLE001 — no plan, no spread
                session = None
            with self._lock:
                self._spreads[vid] = session
            if session is not None:
                b.on_parity_patch = session.note_patch
        if session is None:
            return
        try:
            session.poll(b.rows_done)
        except Exception:  # noqa: BLE001 — session marks itself broken
            pass

    def take_spread(self, vid: int):
        """Hand the volume's spread session to the seal path (and stop
        polling it). None when spreading never started for this volume."""
        with self._lock:
            session = self._spreads.pop(vid, None)
        return None if session is _SPREAD_UNSET else session

    def close(self) -> None:
        """Stop the encoder worker (server shutdown). Builders keep their
        journaled state on disk — the next process resumes or falls back."""
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        self._worker.join(timeout=5.0)

    def seal_failed(self, vid: int) -> None:
        """Re-arm the auto-seal trigger after a failed attempt."""
        with self._lock:
            self._sealing.discard(vid)

    def overwrite(
        self,
        vid: int,
        offset: int,
        old,
        new,
        mutate: Optional[Callable[[], None]] = None,
    ) -> int:
        """In-place .dat mutation hook (e.g. the superblock rewrite):
        journal + delta-update through the volume's builder when one is
        live OR journaled on disk (a restart must not let a mutation slip
        past the stripe state it left behind — builder_for resumes it
        first), plain mutate otherwise."""
        v = self.store.get_volume(vid)
        with self._lock:
            b = self._builders.get(vid)
        if (
            (b is None or b.closed)
            and v is not None
            and os.path.exists(journal_path(v.base_path))
        ):
            try:  # journaled state from before a restart: resume it or the
                # mutation would slip past the partials it left behind
                b = self.builder_for(vid, v.base_path)
            except Exception:  # noqa: BLE001 — unusable state: plain mutate
                b = None
        if b is None or b.closed:
            if mutate is not None:
                mutate()
            return 0
        # no catch here: the builder swallows its OWN failures (marking
        # itself broken for the warm fallback) and lets only the caller's
        # mutate errors propagate — an RPC whose .dat write failed must
        # fail exactly like it would without inline EC
        return b.overwrite(offset, old, new, mutate=mutate)

    def seal_volume(self, vid: int, base: str, **encode_kwargs) -> dict:
        """Finalize the volume's shard set: inline state when usable
        (resumed from the journal after a crash), warm `write_ec_files`
        otherwise. Returns {"mode": inline|resumed|warm, ...accounting}."""
        with self._lock:
            # fence out concurrent write-path polling for the whole seal:
            # a fresh builder spawned mid-seal would truncate the partials
            # being renamed into place (builder_for re-checks this set
            # under the same lock)
            self._sealing.add(vid)
            b = self._builders.pop(vid, None)
        try:
            if (b is None or b.closed) and os.path.exists(journal_path(base)):
                try:
                    b = InlineStripeBuilder.resume(
                        base, self.store.encoder, self.large, self.small,
                        **self._builder_kwargs(),
                    )
                except Exception:  # noqa: BLE001 — unreadable state: warm path
                    b = None
            info: dict = {"mode": "warm"}
            if b is not None and not b.closed:
                if not b.broken:
                    try:
                        b.poll()  # rows completed since the last write
                        info.update(b.seal())
                        info["mode"] = "resumed" if b.resumed else "inline"
                    except Exception:  # noqa: BLE001 — fall back to warm
                        b.abort()
                        info = {"mode": "warm"}
                else:
                    b.abort()
            if info["mode"] == "warm":
                _cleanup_partials(base)
                stripe.write_ec_files(
                    base,
                    large_block_size=encode_kwargs.pop("large_block_size", self.large),
                    small_block_size=encode_kwargs.pop("small_block_size", self.small),
                    encoder=self.store.encoder,
                    **encode_kwargs,
                )
        finally:
            # the fence exists only for the seal's duration — leaving it up
            # after a FAILED seal would silently disable inline polling and
            # auto-seal for this volume forever (successful seals leave the
            # volume read-only, which gates on_write by itself)
            with self._lock:
                self._sealing.discard(vid)
        stats.InlineEcSeals.labels(info["mode"]).inc()
        return info

    def discard(self, vid: int, base: Optional[str] = None) -> None:
        """Invalidate inline state whose source .dat is being rewritten or
        removed (compaction, volume delete, tier move). `base` (when the
        caller still knows it) also scrubs the ON-DISK journal/partials —
        a server restart empties the builder dict, but a stale journal
        left on disk would otherwise wait to be resumed over the rewritten
        file (the dat_rev pin refuses it, but dead files must not linger)."""
        with self._lock:
            b = self._builders.pop(vid, None)
            self._sealing.discard(vid)
            session = self._spreads.pop(vid, None)
        if session is not None and session is not _SPREAD_UNSET:
            try:
                session.abort()  # scrub the remote partials too
            except Exception:  # noqa: BLE001 — dead peers keep only .inp litter
                pass
        if b is not None:
            b.abort()
        if base is None and b is not None:
            base = b.base
        if base is not None:
            _cleanup_partials(base)


def _cleanup_partials(base: str) -> None:
    for s in range(TOTAL_SHARDS_COUNT):
        try:
            os.unlink(part_path(base, s))
        except OSError:
            pass
    try:
        os.unlink(journal_path(base))
    except OSError:
        pass
