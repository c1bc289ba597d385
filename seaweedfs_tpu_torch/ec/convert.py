"""Geometry conversion (`ec.convert`): re-encode an EC volume into another
registered code family without materializing the .dat or paying a
decode -> re-encode round trip.

Conversion is a matrix applied to EXISTING shards:

  * data shards PASS THROUGH: a systematic code's data shards are ranges
    of the .dat laid out row-major, so the target's data shards are a block
    REGROUP of the source's (for k-preserving pairs the identity);
  * new parity is a GF(2^8) PROJECTION of surviving shards: target parity
    row j = G_tgt[k_t + j] . data, and when a source data shard is missing
    the decode matrix folds in (`conversion_matrix`).

It runs on the warm encoder's streaming machinery: a `_VirtualDat` shim
maps .dat-space reads onto the source shard files (reconstructing a
missing data shard per run from survivors, one (1, k) launch of the
encoder's kernel on a card), and `stripe._encode_rows` runs its staging-
ring pipeline over it: one (m_t, k_t) launch per batch, each shard's CRC32
folded in as bytes stream out. Progress is journaled to an fsync'd `.ecc`
sidecar (JSON lines, torn tail ignored), so a kill mid-conversion resumes
from the last watermark. The staged target lives at `<base>.cv.*` and the
source keeps serving until `cutover` retires it. The output is
byte-identical to the decode -> re-encode oracle (`write_dat_file` +
`write_ec_files` at the target geometry), and the journal carries no
backend: either package resumes the other's.

Bytes accounting: `bytes_written` is the target bytes the conversion
materializes; the oracle's cost is its whole I/O (read the data shards,
write the .dat, read it again, write the target set,
`reencode_oracle_bytes`).
"""

from __future__ import annotations

import json
import os
import time as _time
import zlib
from contextlib import ExitStack
from typing import Optional

import numpy as np

from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.ec import locate
from seaweedfs_tpu_torch.ec import stripe
from seaweedfs_tpu_torch.obs import trace as trace_mod
from seaweedfs_tpu_torch.ops import gf8
from seaweedfs_tpu_torch.ops.rs_codec import (
    CodeGeometry,
    Encoder,
    geometry_for,
)
from seaweedfs_tpu_torch.utils import config

JOURNAL_EXT = ".ecc"
#: staged-target base path suffix: the converted shard set is built at
#: `<base>.cv.ec00..` + `<base>.cv.eci` and only `cutover` moves it onto
#: the serving names — the old geometry serves reads the whole time.
STAGE_SUFFIX = ".cv"


class ConversionError(Exception):
    """Conversion could not run (bad source state, unknown family,
    un-resumable journal contradiction)."""


def stage_base(base: str) -> str:
    return base + STAGE_SUFFIX


def journal_path(base: str) -> str:
    return base + JOURNAL_EXT


# -- the conversion-matrix planner -------------------------------------------


def conversion_matrix(
    src: Encoder, tgt: Encoder, survivors: Optional[list] = None
) -> np.ndarray:
    """The (tgt_total x k) GF(2^8) matrix mapping `survivors` source shard
    columns to the FULL target shard set, for geometry pairs sharing a
    data-shard count: target rows = G_tgt · Dec where Dec inverts the
    source generator restricted to the survivor rows (identity when the
    survivors are exactly the data shards — data passes through, parity
    is a pure projection).

    For k-changing pairs (12+3, the 10+4 → 20+4 stripe merge) the SAME
    algebra applies per regrouped block column — data coefficients stay
    unit vectors over the regrouped blocks and parity rows are
    G_tgt[k_t:] — but there is no single whole-shard matrix because the
    block interleave period changes; the streaming converter IS that
    block-wise application (see `_VirtualDat`), so this planner raises
    rather than hand back a matrix that would mis-map columns."""
    if src.data_shards != tgt.data_shards:
        raise ConversionError(
            f"no whole-shard conversion matrix between k={src.data_shards} "
            f"and k={tgt.data_shards}: k-changing conversions apply the "
            "same coefficients per regrouped block (the streaming path)"
        )
    k = src.data_shards
    if survivors is None:
        survivors = list(range(k))
    survivors = [int(s) for s in survivors]
    if len(survivors) != k or len(set(survivors)) != k:
        raise ConversionError(
            f"need exactly {k} distinct survivor shard ids, got {survivors}"
        )
    sub = src.gen_matrix[survivors, :]  # (k, k)
    dec = gf8.gf_mat_inv(sub)  # survivors -> data
    out = gf8.gf_mat_mul(tgt.gen_matrix, dec).astype(np.uint8)
    out.setflags(write=False)
    return out


# -- virtual dat: the pass-through/projection read seam ----------------------


class _VirtualDat:
    """File-shim presenting the source shard set AS its .dat byte stream.

    `seek`/`readinto` are exactly what `stripe.read_padded_into` consumes,
    so the conversion pipeline is `stripe._encode_rows` UNCHANGED reading
    from here instead of a real .dat. Reads map dat offsets to source
    (shard, offset) runs via the source layout rule; bytes past `dat_size`
    are the layout's zero padding and never touch disk. A missing source
    data shard reconstructs per-run from the first k present shards
    (parity included) through the cached decode matrix — the ONLY GF
    decode work a conversion ever does, and only on degraded sources."""

    def __init__(self, base: str, info: dict, encoder: Encoder):
        self._base = base
        self._enc = encoder
        self.k = encoder.data_shards
        self.total = encoder.total_shards
        self.dat_size = int(info["dat_size"])
        self.large = int(info["large_block_size"])
        self.small = int(info["small_block_size"])
        self.bytes_read = 0
        self.reconstructed_bytes = 0
        self._pos = 0
        present = stripe.find_local_shards(base, self.total)
        missing_data = [d for d in range(self.k) if d not in present]
        if missing_data and len(present) < self.k:
            raise ConversionError(
                f"{base}: cannot read source data — {len(present)} shards "
                f"present, need {self.k} to reconstruct {missing_data}"
            )
        self._files = {}
        try:
            for s in present:
                # weedlint: ignore[open-no-ctx] handles owned by the shim, closed in close()
                self._files[s] = open(stripe.shard_file_name(base, s), "rb")
        except BaseException:
            self.close()
            raise
        self.missing_data = missing_data
        #: deterministic survivor pick for degraded reads: first k present
        self._survivors = present[: self.k]

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def seek(self, pos: int) -> None:
        self._pos = int(pos)

    def _map(self, pos: int) -> tuple[int, int, int]:
        """dat offset -> (source shard id, shard offset, contiguous run),
        through THE layout rule in locate.py (geometry-parameterized) —
        never a second inline copy of the block/row arithmetic."""
        block_index, is_large, n_large_rows, inner = locate.locate_offset(
            self.large, self.small, self.dat_size, pos, self.k
        )
        block_len = self.large if is_large else self.small
        sid, off = locate.Interval(
            block_index=block_index,
            inner_block_offset=inner,
            size=block_len - inner,
            is_large_block=is_large,
            large_block_rows_count=n_large_rows,
            data_shards=self.k,
        ).to_shard_id_and_offset(self.large, self.small)
        return sid, off, block_len - inner

    def _read_shard(self, sid: int, off: int, out: np.ndarray) -> None:
        f = self._files.get(sid)
        if f is not None:
            stripe.read_padded_into(f, off, out)
            self.bytes_read += out.size
            return
        # degraded source: decode this run from the survivor columns —
        # the conversion-matrix coefficients folded through the same
        # cached GF elimination every rebuild uses
        n = out.size
        shards: list[Optional[np.ndarray]] = [None] * self.total
        for s in self._survivors:
            buf = np.empty(n, dtype=np.uint8)
            stripe.read_padded_into(self._files[s], off, buf)
            shards[s] = buf
        rec = self._enc.reconstruct(shards, wanted=[sid])
        out[:] = rec[sid]
        self.bytes_read += n * len(self._survivors)
        self.reconstructed_bytes += n

    def readinto(self, mv) -> int:
        out = np.frombuffer(mv, dtype=np.uint8)
        n = out.size
        take = max(0, min(n, self.dat_size - self._pos))
        filled = 0
        while filled < take:
            sid, off, run = self._map(self._pos + filled)
            run = min(run, take - filled)
            self._read_shard(sid, off, out[filled : filled + run])
            filled += run
        self._pos += n
        return take  # short past dat EOF: caller zero-fills, like a file


# -- .ecc journal ------------------------------------------------------------


def read_prefix(path: str) -> tuple[list[dict], int]:
    """Records of the journal's valid prefix and its byte length. A torn
    tail (a crash mid-append) is excluded, including a parseable last
    record with no terminating newline, which a later append would glue
    into garbage; dropping it costs at most one chunk's re-encode. Resume
    truncates the file to the returned length before it appends again."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return [], 0
    out: list[dict] = []
    pos = valid = 0
    for line in raw.split(b"\n"):
        end = pos + len(line) + 1  # + the newline split() removed
        if end > len(raw):
            break  # unterminated tail: never append after it
        if line.strip():
            try:
                rec = json.loads(line)
            except ValueError:
                break
            if isinstance(rec, dict):
                out.append(rec)
        pos = valid = end
    return out, valid


class _Journal:
    """Fsync'd JSON-lines conversion journal (the `.ecp` discipline):
    every record lands flush+fsync so an acked watermark survives a power
    cut; a torn tail record is ignored on read, costing at most one
    chunk's re-encode."""

    def __init__(self, path: str):
        self.path = path
        self._f = None

    def append(self, rec: dict) -> None:
        if self._f is None:
            # weedlint: ignore[open-no-ctx] journal handle owned for the conversion's life, closed in close()
            self._f = open(self.path, "ab")
        self._f.write(json.dumps(rec).encode() + b"\n")
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    @staticmethod
    def read(path: str) -> list[dict]:
        return read_prefix(path)[0]


def _begin_record(
    info: dict, src_geom: CodeGeometry, tgt_geom: CodeGeometry
) -> dict:
    """The journal header a resume validates against: a conversion may
    only continue over the EXACT source state it started from (the src
    .eci CRC list is the cheap whole-set fingerprint)."""
    return {
        "type": "begin",
        "src_family": src_geom.family,
        "tgt_family": tgt_geom.family,
        "src_total": src_geom.total_shards,
        "tgt_total": tgt_geom.total_shards,
        "dat_size": int(info["dat_size"]),
        "large_block_size": int(info["large_block_size"]),
        "small_block_size": int(info["small_block_size"]),
        "src_crc32": list(info.get("shard_crc32") or []),
    }


# -- the converter -----------------------------------------------------------


def _count_bytes(direction: str, n: int) -> None:
    if n:
        stats.EcConvertBytes.labels(direction).inc(n)


def convert_ec_files(
    base_file_name: str,
    target_family: str,
    encoder: Optional[Encoder] = None,
    buffer_size: int = 1024 * 1024,
    max_batch_bytes: Optional[int] = None,
    journal_bytes: Optional[int] = None,
    pipeline_depth: Optional[int] = None,
    verify: Optional[bool] = None,
) -> dict:
    """Convert `<base>.ec*` from its recorded geometry to `target_family`,
    staging the result at `<base>.cv.ec*` + `<base>.cv.eci` (the source
    set keeps serving untouched). Crash-resumable via the `.ecc` journal;
    call `cutover` to atomically retire the old geometry afterwards.

    Returns accounting: {mode, src_family, target_family, bytes_read,
    bytes_written, reconstructed_bytes, shard_ids, seconds}."""
    t0 = _time.monotonic()
    jpath = journal_path(base_file_name)
    if pending_cutover(base_file_name):
        # a previous conversion COMPLETED and died mid-swap. This must be
        # decided BEFORE any geometry comparison: the swap renames `.eci`
        # first, so the live sidecar may already record the TARGET
        # geometry — the noop early-return below would strand the volume
        # un-mountable forever, and a different-family request would
        # mistake the journal for drift and discard the staged shards
        # (possibly the only complete copy). Finish the swap instead.
        out = finish_cutover(base_file_name)
        out["seconds"] = _time.monotonic() - t0
        return out
    info = stripe.read_ec_info(base_file_name)
    if info is None:
        raise ConversionError(
            f"{base_file_name}: no .eci sidecar — conversion needs the "
            "recorded dat size/geometry (re-encode legacy sets warm first)"
        )
    src_geom = stripe.geometry_from_info(info)
    tgt_geom = geometry_for(target_family)
    if (src_geom.data_shards, src_geom.parity_shards, src_geom.matrix_kind) == (
        tgt_geom.data_shards,
        tgt_geom.parity_shards,
        tgt_geom.matrix_kind,
    ):
        return {
            "mode": "noop",
            "src_family": src_geom.family,
            "target_family": tgt_geom.family,
            "bytes_read": 0,
            "bytes_written": 0,
            "reconstructed_bytes": 0,
            "shard_ids": list(range(tgt_geom.total_shards)),
            "seconds": 0.0,
        }
    enc_src = stripe.encoder_for_info(info, encoder)
    # same-device target sibling: the conversion runs the kernel variant and
    # tile the factory chose, as encode and rebuild do
    tgt_info = {
        "data_shards": tgt_geom.data_shards,
        "parity_shards": tgt_geom.parity_shards,
        "matrix_kind": tgt_geom.matrix_kind,
        "family": tgt_geom.family,
    }
    enc_tgt = stripe.encoder_for_info(dict(info, **tgt_info), encoder)

    dat_size = int(info["dat_size"])
    large = int(info["large_block_size"])
    small = int(info["small_block_size"])
    k_t = tgt_geom.data_shards
    total_t = tgt_geom.total_shards
    n_large, n_small = stripe.stripe_layout(dat_size, large, small, k_t)
    shard_len = n_large * large + n_small * small
    staged = stage_base(base_file_name)
    batch = int(
        config.env("WEEDTPU_CONVERT_BATCH")
        if max_batch_bytes is None
        else max_batch_bytes
    )
    jbytes = int(
        config.env("WEEDTPU_CONVERT_JOURNAL_MB") * 1024 * 1024
        if journal_bytes is None
        else journal_bytes
    )
    do_verify = (
        bool(config.env("WEEDTPU_CONVERT_VERIFY")) if verify is None else verify
    )

    # -- resume decision ------------------------------------------------------
    begin = _begin_record(info, src_geom, tgt_geom)
    records, journal_valid_bytes = read_prefix(jpath)
    resumed = False
    done_large = done_small = 0
    crcs = [0] * total_t
    carried_read = carried_written = carried_reconstructed = 0
    if records and records[0] == begin:
        # (a journaled cut-over intent was already handled at entry —
        # records here describe an in-flight, pre-cutover conversion)
        marks = [r for r in records if r.get("type") == "watermark"]
        if marks:
            m = marks[-1]
            sizes = [int(v) for v in m["sizes"]]
            ok = len(sizes) == total_t
            for s in range(total_t):
                p = stripe.shard_file_name(staged, s)
                if not ok:
                    break
                try:
                    if os.path.getsize(p) < sizes[s]:
                        ok = False  # file lost bytes the journal vouched for
                except OSError:
                    ok = False
            if ok:
                for s in range(total_t):
                    p = stripe.shard_file_name(staged, s)
                    with open(p, "r+b") as f:
                        f.truncate(sizes[s])
                done_large = int(m["rows_large"])
                done_small = int(m["rows_small"])
                crcs = [int(c) for c in m["crcs"]]
                carried_read = int(m.get("bytes_read", 0))
                carried_written = int(m.get("bytes_written", 0))
                carried_reconstructed = int(m.get("reconstructed", 0))
                resumed = True
    if not resumed:
        # fresh start: scrub any stale staged output + journal
        discard_staged(base_file_name, keep_journal=False)
        records = []
    else:
        # the crash that made this a resume may have left a torn tail
        # after the last valid record; _Journal.append reopens in 'ab',
        # so drop the fragment first or the next record glues onto it and
        # hides every later record (verified/cutover) from readers
        try:
            if os.path.getsize(jpath) > journal_valid_bytes:
                with open(jpath, "r+b") as jf:
                    jf.truncate(journal_valid_bytes)
        except OSError:
            pass

    journal = _Journal(jpath)
    written_since_mark = 0
    # one staging ring reused across every journal chunk of both row
    # tiers — without it each _encode_rows call reallocates the multi-
    # slot pinned ring (degenerate at small journal_bytes: one ring per
    # chunk)
    ring_cache: dict = {}
    try:
        if not resumed:
            journal.append(begin)

        with ExitStack() as stack:
            vdat = stack.enter_context(_VirtualDat(base_file_name, info, enc_src))
            outputs = [
                stack.enter_context(
                    open(stripe.shard_file_name(staged, s), "ab")
                )
                for s in range(total_t)
            ]

            def mark(rows_large: int, rows_small: int) -> None:
                # durability order: shard bytes reach disk BEFORE the
                # watermark vouches for them (fsync-then-record, the
                # inline-ingest discipline) — a crash can lose work, never
                # invent it
                for f in outputs:
                    f.flush()
                    os.fsync(f.fileno())
                journal.append(
                    {
                        "type": "watermark",
                        "rows_large": rows_large,
                        "rows_small": rows_small,
                        "sizes": [f.tell() for f in outputs],
                        "crcs": [int(c) for c in crcs],
                        "bytes_read": vdat.bytes_read + carried_read,
                        # f.tell() is the CUMULATIVE staged size (resume
                        # truncates then reopens append) — adding the
                        # carried count again would double-book pre-crash
                        # bytes in every post-resume watermark
                        "bytes_written": sum(f.tell() for f in outputs),
                        "reconstructed": vdat.reconstructed_bytes
                        + carried_reconstructed,
                    }
                )

            def run_phase(
                block: int,
                n_rows: int,
                done: int,
                region_start: int,
                is_large: bool,
            ) -> None:
                """Stream one row tier (large/small) through the staging-
                ring pipeline in journal-sized chunks of rows."""
                nonlocal written_since_mark
                row_bytes = (block * total_t) or 1
                rows_per_chunk = max(1, jbytes // row_bytes)
                row = done
                while row < n_rows:
                    n = min(rows_per_chunk, n_rows - row)
                    with trace_mod.span(
                        "convert.chunk",
                        tier="large" if is_large else "small",
                        row=row,
                        rows=n,
                    ):
                        stripe._encode_rows(
                            vdat,
                            enc_tgt,
                            outputs,
                            region_start + row * block * k_t,
                            block,
                            n,
                            min(buffer_size, block),
                            batch,
                            pipeline_depth,
                            crcs,
                            ring_cache=ring_cache,
                        )
                        row += n
                        written_since_mark += n * row_bytes
                        if written_since_mark >= jbytes or row >= n_rows:
                            mark(*((row, 0) if is_large else (n_large, row)))
                            written_since_mark = 0

            if done_small == 0:
                run_phase(large, n_large, done_large, 0, True)
            run_phase(
                small, n_small, done_small, n_large * large * k_t, False
            )

        bytes_written = total_t * shard_len
        # scrub-grade pre-cutover gate: what the NEW geometry will serve
        # is the bytes ON DISK — re-read them against the streamed CRCs
        # before the old geometry is retired
        if do_verify:
            try:
                for s in range(total_t):
                    p = stripe.shard_file_name(staged, s)
                    crc = 0
                    with open(p, "rb") as f:
                        if os.path.getsize(p) != shard_len:
                            raise ConversionError(
                                f"{p}: staged shard is {os.path.getsize(p)} "
                                f"bytes, layout wants {shard_len}"
                            )
                        while True:
                            chunk = f.read(1 << 20)
                            if not chunk:
                                break
                            crc = zlib.crc32(chunk, crc)
                    if crc != crcs[s]:
                        raise ConversionError(
                            f"{p}: on-disk CRC {crc} != streamed {crcs[s]} — "
                            "refusing cut-over over unvouched bytes"
                        )
            except ConversionError:
                # bad bytes BELOW the watermark (torn write, bit rot): a
                # journaled resume would trust the watermark, re-encode
                # nothing, and re-fail this verify on every re-issue —
                # scrub the staged state so the next attempt restarts
                # clean instead of wedging the volume unconvertible
                journal.close()
                discard_staged(base_file_name, keep_journal=False)
                raise
        stripe.write_ec_info(
            staged, large, small, dat_size, shard_crcs=crcs, geometry=tgt_geom
        )
        journal.append({"type": "verified" if do_verify else "staged"})
        total_read = vdat.bytes_read + carried_read
        total_reconstructed = vdat.reconstructed_bytes + carried_reconstructed
        # dispatch-seam counters book THIS RUN's delta only — a resume
        # after 99% must not re-book the pre-crash bytes the earlier run
        # already counted (the returned totals stay whole-conversion)
        _count_bytes("read", vdat.bytes_read)
        _count_bytes("written", max(0, bytes_written - carried_written))
        return {
            "mode": "resumed" if resumed else "converted",
            "src_family": src_geom.family,
            "target_family": tgt_geom.family,
            "bytes_read": total_read,
            "bytes_written": bytes_written,
            "reconstructed_bytes": total_reconstructed,
            "shard_ids": list(range(total_t)),
            "seconds": _time.monotonic() - t0,
        }
    finally:
        journal.close()


def discard_staged(base_file_name: str, keep_journal: bool = True) -> None:
    """Remove staged conversion output (and optionally the journal) —
    the fresh-start scrub and the operator abort path."""
    staged = stage_base(base_file_name)
    for s in range(stripe.MAX_SHARD_COUNT):
        try:
            os.unlink(stripe.shard_file_name(staged, s))
        except OSError:
            pass
    for ext in (".eci", ".eci.tmp"):
        try:
            os.unlink(staged + ext)
        except OSError:
            pass
    if not keep_journal:
        try:
            os.unlink(journal_path(base_file_name))
        except OSError:
            pass


def _journal_state(base_file_name: str) -> list[dict]:
    return read_prefix(journal_path(base_file_name))[0]


def pending_cutover(base_file_name: str) -> bool:
    """True while a journaled cut-over intent is UNFINISHED — the window
    between `cutover`'s intent record and `finish_cutover`'s final journal
    unlink, where `.eci` and the shard files may describe different
    geometries. A mount in this window must refuse (EcVolume consults
    this) and `convert_ec_files` resumes by finishing the swap."""
    return any(
        r.get("type") == "cutover" for r in _journal_state(base_file_name)
    )


def cutover(base_file_name: str) -> dict:
    """Atomically retire the source geometry: verify the staged set is
    complete, journal the cut-over intent, then swap `.eci` FIRST (the
    single source of truth — a crash mid-swap leaves a volume that
    REFUSES to mount with typed EcGeometryError rather than one that
    silently misreads) and the shard files after, dropping stale
    source-only shard ids. Idempotent: `finish_cutover` completes a
    crashed swap from the journal."""
    records = _journal_state(base_file_name)
    if not records or records[0].get("type") != "begin":
        raise ConversionError(
            f"{base_file_name}: no conversion journal — nothing to cut over"
        )
    if not any(r.get("type") in ("verified", "staged") for r in records):
        raise ConversionError(
            f"{base_file_name}: conversion has not completed verification"
        )
    staged = stage_base(base_file_name)
    begin = records[0]
    total_t = int(begin["tgt_total"])
    for s in range(total_t):
        if not os.path.exists(stripe.shard_file_name(staged, s)):
            raise ConversionError(
                f"{base_file_name}: staged shard {s} missing — cannot cut over"
            )
    if not os.path.exists(staged + ".eci"):
        raise ConversionError(
            f"{base_file_name}: staged .eci missing — cannot cut over"
        )
    j = _Journal(journal_path(base_file_name))
    try:
        j.append({"type": "cutover"})
    finally:
        j.close()
    return finish_cutover(base_file_name)


def finish_cutover(base_file_name: str) -> dict:
    """Complete (or re-complete after a crash) the file swap the journal's
    `cutover` record promised. Every step is idempotent: replace staged
    files that still exist, keep already-swapped ones, drop stale
    source-only shards, then drop the journal LAST (its presence is what
    makes a half-swapped volume recoverable)."""
    records = _journal_state(base_file_name)
    begin = records[0] if records else None
    if begin is None or not any(r.get("type") == "cutover" for r in records):
        raise ConversionError(
            f"{base_file_name}: journal carries no cut-over intent"
        )
    staged = stage_base(base_file_name)
    total_t = int(begin["tgt_total"])
    src_total = int(begin.get("src_total") or 0)
    # .eci first: the sidecar IS the geometry truth — after this rename
    # the volume is a target-geometry volume whose shard files are being
    # filled in (a mount in the gap refuses loudly, never misreads)
    if os.path.exists(staged + ".eci"):
        os.replace(staged + ".eci", base_file_name + ".eci")
    for s in range(total_t):
        sp = stripe.shard_file_name(staged, s)
        if os.path.exists(sp):
            os.replace(sp, stripe.shard_file_name(base_file_name, s))
        elif not os.path.exists(stripe.shard_file_name(base_file_name, s)):
            raise ConversionError(
                f"{base_file_name}: shard {s} lost mid-cutover (neither "
                "staged nor live file exists)"
            )
    for s in range(total_t, max(src_total, total_t)):
        try:
            os.unlink(stripe.shard_file_name(base_file_name, s))
        except OSError:
            pass
    try:
        os.unlink(journal_path(base_file_name))
    except OSError:
        pass
    return {
        "mode": "cutover",
        "src_family": str(begin.get("src_family", "")),
        "target_family": str(begin.get("tgt_family", "")),
        "bytes_read": 0,
        "bytes_written": 0,
        "reconstructed_bytes": 0,
        "shard_ids": list(range(total_t)),
    }


def reencode_oracle_bytes(base_file_name: str, target_family: str) -> dict:
    """The decode -> re-encode round trip's I/O for this volume, from the
    recorded geometry (no oracle run needed): read the source data shards
    (= dat bytes), write the .dat, read it again, write the whole target
    shard set."""
    info = stripe.read_ec_info(base_file_name)
    if info is None:
        raise ConversionError(f"{base_file_name}: no .eci sidecar")
    tgt = geometry_for(target_family)
    dat = int(info["dat_size"])
    large = int(info["large_block_size"])
    small = int(info["small_block_size"])
    n_large, n_small = stripe.stripe_layout(dat, large, small, tgt.data_shards)
    tgt_bytes = tgt.total_shards * (n_large * large + n_small * small)
    return {
        "decode_read": dat,
        "decode_written": dat,
        "encode_read": dat,
        "encode_written": tgt_bytes,
        "total": 3 * dat + tgt_bytes,
    }
