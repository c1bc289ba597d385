"""Stripe engine: file-level EC encode, rebuild and decode with the layout of
upstream's weed/storage/erasure_coding ec_encoder.go / ec_decoder.go.

Layout: a volume .dat is processed as block rows. While more than one full
large row (k x large_block) remains, rows are large; the tail is encoded
as small rows, the last one zero-padded past EOF. Shard s's .ecNN file is
the concatenation of its column across rows.

Segments are laid out flat in a reused (shards, width) host staging ring
and dispatched as ONE wide matrix application per batch (GF matmul is
column-independent, so this is byte-identical to any per-segment order).
A depth-N pipeline keeps batch K on the card while batches K+1.. read from
disk. On a CUDA encoder the ring is pinned host memory: the copy to the
card is asynchronous and ordered before the kernel on one stream, and a
slot is refilled only after the batch that used it has been drained (the
pipeline drains to < depth before every take, and the ring has depth + 1
slots). Each shard's CRC32 is folded in as its bytes stream out.
"""

from __future__ import annotations

import json
import os
import zlib
from collections import deque
from contextlib import ExitStack
from typing import Optional, Sequence

import numpy as np
import torch

from seaweedfs_tpu_torch.ec.constants import (
    DATA_SHARDS_COUNT,
    EC_BUFFER_SIZE,
    ERASURE_CODING_LARGE_BLOCK_SIZE,
    ERASURE_CODING_SMALL_BLOCK_SIZE,
    MAX_SHARD_COUNT,
)
from seaweedfs_tpu_torch.obs import trace as trace_mod
from seaweedfs_tpu_torch.ops.rs_codec import (
    DEFAULT_FAMILY,
    CodeGeometry,
    Encoder,
    family_of,
    geometry_for,
    new_encoder,
)
from seaweedfs_tpu_torch.storage import idx as idx_mod
from seaweedfs_tpu_torch.storage import types
from seaweedfs_tpu_torch.storage.needle_map import MemDb
from seaweedfs_tpu_torch.utils import config

#: inflight depth of the streaming encode/rebuild pipelines
DEFAULT_PIPELINE_DEPTH = config.env("WEEDTPU_PIPELINE_DEPTH")

#: batches ahead of the reading cursor the rebuild asks sources to prefetch
DEFAULT_PREFETCH_BATCHES = config.env("WEEDTPU_REBUILD_PREFETCH_BATCHES")


def to_ext(shard_id: int) -> str:
    return f".ec{shard_id:02d}"


def shard_file_name(base_file_name: str, shard_id: int) -> str:
    return base_file_name + to_ext(shard_id)


def read_padded(f, offset: int, length: int) -> np.ndarray:
    """Read `length` bytes at `offset`, zero-padding past EOF."""
    buf = np.zeros(length, dtype=np.uint8)
    read_padded_into(f, offset, buf)
    return buf


def read_padded_into(f, offset: int, out: np.ndarray) -> None:
    """Read `out.size` bytes at `offset` straight into a contiguous uint8
    view, zero-filling past EOF."""
    f.seek(offset)
    got = f.readinto(memoryview(out)) or 0
    if got < out.size:
        out[got:] = 0


class _StagingRing:
    """`slots` reused host staging buffers for a depth-N pipeline; pinned
    when the encoder is on the card, so the host-to-device copy of a slot is
    asynchronous. With slots = depth + 1 and a drain to < depth before every
    take, a slot is never refilled while its batch is in flight."""

    def __init__(self, slots: int, shape: tuple, pinned: bool = False):
        self._tensors = [
            torch.empty(shape, dtype=torch.uint8, pin_memory=pinned) for _ in range(slots)
        ]
        self._bufs = [t.numpy() for t in self._tensors]
        self._next = 0

    def take(self) -> np.ndarray:
        buf = self._bufs[self._next]
        self._next = (self._next + 1) % len(self._bufs)
        return buf


def _ring(enc: Encoder, slots: int, shape: tuple) -> _StagingRing:
    return _StagingRing(slots, shape, pinned=enc.device.type == "cuda")


def _aligned(width: int, align: int) -> int:
    """Round a staged width up to the encoder's dispatch alignment."""
    return -(-width // align) * align


def _abandon_future(fut) -> None:
    """Cancel an abandoned fetch future; if it already runs, observe and
    drop its outcome when it ends, so a late error never surfaces from a
    thread nobody waits on."""
    if not fut.cancel():
        fut.add_done_callback(_observe_and_drop)


def _observe_and_drop(fut) -> None:
    try:
        fut.result()
    except Exception:  # noqa: BLE001 — abandoned by design
        pass


def _discard_inflight(inflight: deque) -> None:
    """Failure path: wait for every pending dispatch and drop its result, so
    teardown never races device work still reading a staging buffer. Errors
    are suppressed: the original failure propagates from the caller."""
    while inflight:
        handle = inflight.popleft()[0]
        try:
            np.asarray(handle)
        except Exception:  # noqa: BLE001 — discarding, not reporting
            pass


def _encode_rows(
    f,
    enc: Encoder,
    outputs: Sequence,
    start_offset: int,
    block_size: int,
    n_rows: int,
    buffer_size: int,
    max_batch_bytes: int,
    pipeline_depth: Optional[int] = None,
    crcs: Optional[list] = None,
) -> None:
    """Encode `n_rows` rows of `block_size` blocks as a stream of flat
    (k, width) dispatches over the staging ring; outputs receive bytes in
    row-major order. Data shards stream to disk at fill time; parity is
    written FIFO as each batch drains (`np.asarray`, the sync point)."""
    if n_rows <= 0:
        return
    if buffer_size > block_size:
        buffer_size = block_size
    if block_size % buffer_size:
        raise ValueError(f"block size {block_size} not a multiple of buffer {buffer_size}")
    depth = DEFAULT_PIPELINE_DEPTH if pipeline_depth is None else max(1, int(pipeline_depth))
    align = enc.width_align
    k = enc.data_shards
    segs_per_row = block_size // buffer_size
    batch_cap = max(1, max_batch_bytes // (k * buffer_size))
    span = _aligned(batch_cap * buffer_size, align)
    ring = _ring(enc, depth + 1, (k, span))
    inflight: deque = deque()  # FIFO of (parity_handle, width)

    def drain_one() -> None:
        parity, width = inflight.popleft()
        with trace_mod.span("encode.drain", width=width):
            parity_np = np.asarray(parity)  # sync point
        if k + parity_np.shape[0] != len(outputs):
            raise ValueError(
                f"encoder produced {parity_np.shape[0]} parity shards; "
                f"layout wants {len(outputs) - k}"
            )
        for p in range(parity_np.shape[0]):
            row = np.ascontiguousarray(parity_np[p, :width])
            outputs[k + p].write(row)
            if crcs is not None:
                crcs[k + p] = zlib.crc32(row, crcs[k + p])

    def flush(batch: list) -> None:
        if not batch:
            return
        width = len(batch) * buffer_size
        while len(inflight) >= depth:
            drain_one()
        with trace_mod.span("encode.stage", width=width):
            staging = ring.take()
            # runs of consecutive segments read as one slab per shard
            i = 0
            while i < len(batch):
                row, seg0 = batch[i]
                j = i
                while j + 1 < len(batch) and batch[j + 1] == (row, batch[j][1] + 1):
                    j += 1
                row_start = start_offset + row * block_size * k
                for d in range(k):
                    read_padded_into(
                        f,
                        row_start + d * block_size + seg0 * buffer_size,
                        staging[d, i * buffer_size : (j + 1) * buffer_size],
                    )
                i = j + 1
            view = staging[:, :width]
            for d in range(k):
                outputs[d].write(view[d])
                if crcs is not None:
                    crcs[d] = zlib.crc32(view[d], crcs[d])
            aw = _aligned(width, align)
            if aw > width:
                staging[:, width:aw] = 0  # pad columns encode to zeros
        # staging[:, :aw] is a strided view when aw < span: the codec's
        # host-to-device copy takes it row by row, never as if contiguous
        inflight.append((enc.encode_parity_lazy(staging[:, :aw], donate=True), width))

    try:
        pending: list = []  # (row, seg), global order
        for row in range(n_rows):
            for seg in range(segs_per_row):
                pending.append((row, seg))
                if len(pending) >= batch_cap:
                    flush(pending)
                    pending = []
        flush(pending)
        while inflight:
            drain_one()
    except BaseException:
        _discard_inflight(inflight)
        raise


def stripe_layout(
    dat_size: int,
    large_block_size: int,
    small_block_size: int,
    data_shards: int = DATA_SHARDS_COUNT,
) -> tuple[int, int]:
    """(n_large, n_small) rows for a .dat of `dat_size` bytes: while strictly
    more than one full large row remains, rows are large; the tail becomes
    small rows, the last one zero-padded past EOF."""
    large_row = large_block_size * data_shards
    small_row = small_block_size * data_shards
    n_large = 0
    remaining = dat_size
    while remaining > large_row:
        n_large += 1
        remaining -= large_row
    n_small = -(-remaining // small_row) if remaining > 0 else 0
    return n_large, n_small


def write_ec_files(
    base_file_name: str,
    large_block_size: int = ERASURE_CODING_LARGE_BLOCK_SIZE,
    small_block_size: int = ERASURE_CODING_SMALL_BLOCK_SIZE,
    buffer_size: int = EC_BUFFER_SIZE,
    encoder: Optional[Encoder] = None,
    max_batch_bytes: int = 64 * 1024 * 1024,
    pipeline_depth: Optional[int] = None,
) -> None:
    """<base>.dat -> <base>.ec00 .. (WriteEcFiles semantics), with each
    shard's CRC32 recorded in the .eci sidecar. A mid-stream failure drains
    inflight work and unlinks every partial shard file."""
    enc = encoder or new_encoder()
    dat_path = base_file_name + ".dat"
    dat_size = os.path.getsize(dat_path)
    large_row = large_block_size * enc.data_shards
    n_large, n_small = stripe_layout(
        dat_size, large_block_size, small_block_size, enc.data_shards
    )
    crcs = [0] * enc.total_shards
    try:
        with ExitStack() as stack:
            f = stack.enter_context(open(dat_path, "rb"))
            outputs = [
                stack.enter_context(open(shard_file_name(base_file_name, s), "wb"))
                for s in range(enc.total_shards)
            ]
            _encode_rows(
                f, enc, outputs, 0, large_block_size, n_large, buffer_size,
                max_batch_bytes, pipeline_depth, crcs,
            )
            _encode_rows(
                f, enc, outputs, n_large * large_row, small_block_size, n_small,
                min(buffer_size, small_block_size), max_batch_bytes,
                pipeline_depth, crcs,
            )
    except BaseException:
        for s in range(enc.total_shards):
            try:
                os.unlink(shard_file_name(base_file_name, s))
            except OSError:
                pass
        raise
    write_ec_info(
        base_file_name, large_block_size, small_block_size, dat_size,
        shard_crcs=crcs, geometry=geometry_of(enc),
    )


def geometry_of(enc: Encoder) -> CodeGeometry:
    fam = enc.family or f"custom_{enc.data_shards}_{enc.parity_shards}"
    return CodeGeometry(fam, enc.data_shards, enc.parity_shards, enc.matrix_kind)


_LEGACY_GEOMETRY = geometry_for(DEFAULT_FAMILY)


def geometry_from_info(info: Optional[dict]) -> CodeGeometry:
    """The geometry an .eci records; the legacy 10+4 Vandermonde when the
    sidecar is absent or predates geometry recording."""
    if not info or "data_shards" not in info:
        return _LEGACY_GEOMETRY
    k = int(info["data_shards"])
    m = int(info["parity_shards"])
    kind = str(info.get("matrix_kind", "vandermonde"))
    if k <= 0 or m <= 0 or k + m > MAX_SHARD_COUNT:
        raise ValueError(
            f".eci records an unusable geometry: {k}+{m} (max total {MAX_SHARD_COUNT})"
        )
    fam = str(info.get("family") or family_of(k, m, kind) or f"custom_{k}_{m}")
    return CodeGeometry(fam, k, m, kind)


def encoder_for_info(info: Optional[dict], default: Optional[Encoder] = None) -> Encoder:
    """An encoder for the .eci-recorded geometry: `default` when it matches,
    else a sibling on the same device (hence the same backend) running the
    same kernel variant and tile, so every geometry rides the kernel the
    factory chose."""
    geom = geometry_from_info(info)
    if default is None:
        return new_encoder(geom.data_shards, geom.parity_shards, geom.matrix_kind)
    if (default.data_shards, default.parity_shards, default.matrix_kind) == (
        geom.data_shards, geom.parity_shards, geom.matrix_kind,
    ):
        return default
    enc = Encoder(
        geom.data_shards, geom.parity_shards, matrix_kind=geom.matrix_kind,
        device=default.device, variant=default.variant, tile=default.tile,
    )
    enc.selection = dict(default.selection, geometry=geom.family, source="geometry-sibling")
    return enc


def encoder_for_base(base_file_name: str, default: Optional[Encoder] = None) -> Encoder:
    return encoder_for_info(read_ec_info(base_file_name), default)


def write_ec_info(
    base_file_name: str,
    large_block_size: int,
    small_block_size: int,
    dat_size: int,
    shard_crcs: Optional[Sequence[int]] = None,
    geometry: Optional[CodeGeometry] = None,
) -> None:
    """Record the stripe geometry, true .dat size and shard CRC32s in the
    .eci sidecar. The legacy geometry stays implicit, so default sidecars
    are byte-identical across writers."""
    info = {
        "large_block_size": large_block_size,
        "small_block_size": small_block_size,
        "dat_size": dat_size,
    }
    legacy = (_LEGACY_GEOMETRY.data_shards, _LEGACY_GEOMETRY.parity_shards,
              _LEGACY_GEOMETRY.matrix_kind)
    if geometry is not None and (
        geometry.data_shards, geometry.parity_shards, geometry.matrix_kind
    ) != legacy:
        info.update(
            data_shards=geometry.data_shards,
            parity_shards=geometry.parity_shards,
            matrix_kind=geometry.matrix_kind,
            family=geometry.family,
        )
    if shard_crcs is not None:
        info["shard_crc32"] = [int(c) for c in shard_crcs]
    tmp = base_file_name + ".eci.tmp"
    with open(tmp, "w") as f:
        json.dump(info, f)
        f.flush()
        os.fsync(f.fileno())  # the .eci is load-bearing: geometry + dat_size
    os.replace(tmp, base_file_name + ".eci")


_ECI_KEYS = ("large_block_size", "small_block_size", "dat_size")


def read_ec_info(base_file_name: str) -> Optional[dict]:
    try:
        with open(base_file_name + ".eci") as f:
            info = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(info, dict) or not all(isinstance(info.get(k), int) for k in _ECI_KEYS):
        return None
    return info


def write_sorted_file_from_idx(base_file_name: str, ext: str = ".ecx") -> None:
    """<base>.idx -> <base>.ecx: replay the log, write entries sorted by id."""
    db = MemDb()
    db.load_from_idx(base_file_name + ".idx")
    db.save_to_idx(base_file_name + ext)


def generate_ec_files(base_file_name: str, **kwargs) -> None:
    """Shards plus the sorted index (VolumeEcShardsGenerate's work)."""
    write_ec_files(base_file_name, **kwargs)
    write_sorted_file_from_idx(base_file_name)


def find_local_shards(base_file_name: str, total: Optional[int] = None) -> list[int]:
    """Shard ids with a local .ecNN file, scanning up to MAX_SHARD_COUNT
    unless `total` pins the geometry."""
    return [
        s
        for s in range(total if total is not None else MAX_SHARD_COUNT)
        if os.path.exists(shard_file_name(base_file_name, s))
    ]


def _check_rebuild_geometry(base_file_name: str, enc: Encoder) -> tuple[list[int], list[int], int]:
    """-> (present, missing, shard_size). Raises when fewer than k shards
    survive or survivors disagree on length."""
    present = find_local_shards(base_file_name, enc.total_shards)
    missing = [s for s in range(enc.total_shards) if s not in present]
    if not missing:
        return present, missing, 0
    if len(present) < enc.data_shards:
        raise ValueError(
            f"cannot rebuild: only {len(present)} shards present, need {enc.data_shards}"
        )
    sizes = {s: os.path.getsize(shard_file_name(base_file_name, s)) for s in present}
    if len(set(sizes.values())) != 1:
        raise IOError(f"surviving shards disagree on length: {sizes} — truncated shard?")
    return present, missing, sizes[present[0]]


class SlabSource:
    """One survivor shard's bytes for the rebuild pipeline: `prefetch` is a
    hint for windows wanted soon; `read_into` lands bytes in a staging view,
    zero-filling past the shard's end."""

    def prefetch(self, offset: int, length: int) -> None:  # noqa: B027 — hint
        pass

    def read_into(self, offset: int, out: np.ndarray) -> None:
        raise NotImplementedError

    def close(self) -> None:  # noqa: B027 — optional teardown
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class LocalSlabSource(SlabSource):
    """`readinto` straight from a local shard file."""

    def __init__(self, path: str):
        self._f = open(path, "rb")  # owned by the source, closed in close()

    def read_into(self, offset: int, out: np.ndarray) -> None:
        read_padded_into(self._f, offset, out)

    def close(self) -> None:
        self._f.close()


def rebuild_ec_files_from_sources(
    base_file_name: str,
    sources: dict[int, SlabSource],
    shard_size: int,
    encoder: Optional[Encoder] = None,
    missing: Optional[Sequence[int]] = None,
    buffer_size: int = 4 * 1024 * 1024,
    max_batch_bytes: int = 64 * 1024 * 1024,
    pipeline_depth: Optional[int] = None,
    prefetch_batches: Optional[int] = None,
) -> list[int]:
    """The rebuild pipeline over any slab sources. Survivors are the first
    k sorted present ids (the serial oracle's rule); each batch is one
    (k, width) slab decoded by one fused survivors->missing matrix in one
    dispatch, drained FIFO. Rebuilt shards' CRC32s are checked against the
    .eci record; any failure drains inflight work and unlinks the partial
    outputs. Returns the rebuilt shard ids."""
    enc = encoder or encoder_for_base(base_file_name)
    present = sorted(sources)
    if missing is None:
        missing = [s for s in range(enc.total_shards) if s not in sources]
    missing = sorted(missing)
    if not missing:
        return []
    if len(present) < enc.data_shards:
        raise ValueError(
            f"cannot rebuild: only {len(present)} shards present, need {enc.data_shards}"
        )
    depth = DEFAULT_PIPELINE_DEPTH if pipeline_depth is None else max(1, int(pipeline_depth))
    ahead = (
        DEFAULT_PREFETCH_BATCHES if prefetch_batches is None else max(1, int(prefetch_batches))
    )
    survivors = present[: enc.data_shards]
    align = enc.width_align
    chunks_per_batch = max(1, max_batch_bytes // (enc.data_shards * buffer_size))
    span = _aligned(chunks_per_batch * buffer_size, align)
    ring = _ring(enc, depth + 1, (enc.data_shards, span))
    crcs = {s: 0 for s in missing}
    batches = []  # (offset, valid_bytes, staged_width)
    off = 0
    while off < shard_size:
        valid = min(span, shard_size - off)
        batches.append((off, valid, -(-valid // buffer_size) * buffer_size))
        off += span
    try:
        with ExitStack() as stack:
            outs = {
                s: stack.enter_context(open(shard_file_name(base_file_name, s), "wb"))
                for s in missing
            }
            inflight: deque = deque()  # FIFO of (decoded_handle, valid_bytes)

            def drain_one() -> None:
                lazy, valid = inflight.popleft()
                with trace_mod.span("rebuild.drain", width=valid):
                    out = np.asarray(lazy)  # sync point
                    for k, s in enumerate(missing):
                        row = out[k, :valid]
                        outs[s].write(row)
                        crcs[s] = zlib.crc32(row, crcs[s])

            def issue_prefetch(bi: int) -> None:
                if bi < len(batches):
                    o, _, wd = batches[bi]
                    for s in survivors:
                        sources[s].prefetch(o, wd)

            try:
                for j in range(min(ahead, len(batches))):
                    issue_prefetch(j)
                for bi, (off, valid, width) in enumerate(batches):
                    issue_prefetch(bi + ahead)
                    while len(inflight) >= depth:
                        drain_one()
                    with trace_mod.span("rebuild.stage", batch=bi, width=width):
                        staging = ring.take()
                        for i, s in enumerate(survivors):
                            sources[s].read_into(off, staging[i, :width])
                        aw = _aligned(width, align)
                        if aw > width:
                            staging[:, width:aw] = 0
                    decoded = enc.reconstruct_lazy(
                        staging[:, :aw], survivors, missing, donate=True
                    )
                    inflight.append((decoded, valid))
                while inflight:
                    drain_one()
            except BaseException:
                _discard_inflight(inflight)
                raise
        _verify_rebuilt_crcs(base_file_name, crcs)
    except BaseException:
        for s in missing:
            try:
                os.unlink(shard_file_name(base_file_name, s))
            except OSError:
                pass
        raise
    return missing


def rebuild_ec_files(
    base_file_name: str,
    encoder: Optional[Encoder] = None,
    buffer_size: int = 4 * 1024 * 1024,
    max_batch_bytes: int = 64 * 1024 * 1024,
    pipeline_depth: Optional[int] = None,
) -> list[int]:
    """Reconstruct missing .ecNN files from >= k local survivors
    (RebuildEcFiles), byte-identical to `rebuild_ec_files_serial`.
    Returns the rebuilt shard ids."""
    enc = encoder or encoder_for_base(base_file_name)
    present, missing, shard_size = _check_rebuild_geometry(base_file_name, enc)
    if not missing:
        return []
    with ExitStack() as stack:
        sources = {
            s: stack.enter_context(LocalSlabSource(shard_file_name(base_file_name, s)))
            for s in present
        }
        return rebuild_ec_files_from_sources(
            base_file_name, sources, shard_size, encoder=enc, missing=missing,
            buffer_size=buffer_size, max_batch_bytes=max_batch_bytes,
            pipeline_depth=pipeline_depth,
        )


def _verify_rebuilt_crcs(base_file_name: str, crcs: dict) -> None:
    """A rebuilt shard whose streaming CRC disagrees with the .eci record
    means a corrupt survivor or a decode fault: fail the rebuild."""
    info = read_ec_info(base_file_name)
    recorded = (info or {}).get("shard_crc32")
    if not isinstance(recorded, list) or len(recorded) != geometry_from_info(info).total_shards:
        return
    bad = {s: (c, recorded[s]) for s, c in crcs.items() if c != recorded[s]}
    if bad:
        raise IOError(
            f"rebuilt shard CRC mismatch vs .eci record: {{shard: (got, want)}} = "
            f"{bad} — corrupt survivor?"
        )


def rebuild_ec_files_serial(
    base_file_name: str,
    encoder: Optional[Encoder] = None,
    buffer_size: int = 4 * 1024 * 1024,
) -> list[int]:
    """One blocking reconstruct per chunk: the correctness oracle."""
    enc = encoder or encoder_for_base(base_file_name)
    present, missing, shard_size = _check_rebuild_geometry(base_file_name, enc)
    if not missing:
        return []
    with ExitStack() as stack:
        ins = {
            s: stack.enter_context(open(shard_file_name(base_file_name, s), "rb"))
            for s in present
        }
        outs = {
            s: stack.enter_context(open(shard_file_name(base_file_name, s), "wb"))
            for s in missing
        }
        for off in range(0, shard_size, buffer_size):
            n = min(buffer_size, shard_size - off)
            shards: list[Optional[np.ndarray]] = [None] * enc.total_shards
            for s in present:
                shards[s] = read_padded(ins[s], off, n)
            rec = enc.reconstruct(shards, wanted=missing)
            for s in missing:
                outs[s].write(np.ascontiguousarray(rec[s]))
    return missing


def write_dat_file(
    base_file_name: str,
    dat_file_size: Optional[int] = None,
    large_block_size: int = ERASURE_CODING_LARGE_BLOCK_SIZE,
    small_block_size: int = ERASURE_CODING_SMALL_BLOCK_SIZE,
) -> None:
    """Data shards -> <base>.dat (WriteDatFile / ec.decode semantics). The
    .eci-recorded geometry overrides the arguments. Staged under a tmp name
    and published with a rename, so a crash never leaves a torn .dat."""
    info = read_ec_info(base_file_name)
    if info is not None:
        large_block_size = info["large_block_size"]
        small_block_size = info["small_block_size"]
        if dat_file_size is None:
            dat_file_size = info["dat_size"]
    if dat_file_size is None:
        raise ValueError("dat_file_size required when no .eci sidecar exists")
    data_shards = geometry_from_info(info).data_shards
    n_large, _ = stripe_layout(dat_file_size, large_block_size, small_block_size, data_shards)
    tmp_dat = base_file_name + ".dat.tmp"
    with ExitStack() as stack:
        stack.callback(lambda: os.path.exists(tmp_dat) and os.remove(tmp_dat))
        ins = [
            stack.enter_context(open(shard_file_name(base_file_name, s), "rb"))
            for s in range(data_shards)
        ]
        out = stack.enter_context(open(tmp_dat, "wb"))
        written = 0
        for row in range(n_large):
            for d in range(data_shards):
                ins[d].seek(row * large_block_size)
                out.write(ins[d].read(large_block_size))
                written += large_block_size
        small_start = n_large * large_block_size
        row = 0
        while written < dat_file_size:
            row_progress = 0
            for d in range(data_shards):
                if written >= dat_file_size:
                    break
                ins[d].seek(small_start + row * small_block_size)
                chunk = ins[d].read(small_block_size)
                take = min(len(chunk), dat_file_size - written)
                out.write(chunk[:take])
                written += take
                row_progress += take
            if row_progress == 0:
                raise IOError(
                    f"shards exhausted at {written} bytes but dat_file_size says "
                    f"{dat_file_size} — truncated shards or stale size"
                )
            row += 1
        out.flush()
        os.fsync(out.fileno())
        os.replace(tmp_dat, base_file_name + ".dat")


def read_ecj(base_file_name: str) -> list[int]:
    """Needle ids of the .ecj deletion journal; a torn tail record is dropped."""
    path = base_file_name + ".ecj"
    if not os.path.exists(path):
        return []
    with open(path, "rb") as f:
        buf = f.read()
    n = len(buf) // types.NEEDLE_ID_SIZE
    return [int.from_bytes(buf[i * 8 : i * 8 + 8], "big") for i in range(n)]


def append_ecj(base_file_name: str, needle_id: int) -> None:
    """Journal one EC deletion, fsync'd: an acknowledged delete survives a
    power cut. A torn tail record from a crash mid-append is dropped by
    `read_ecj`, costing at most the unacknowledged delete."""
    with open(base_file_name + ".ecj", "ab") as f:
        f.write(needle_id.to_bytes(types.NEEDLE_ID_SIZE, "big"))
        f.flush()
        os.fsync(f.fileno())


def compact_ecj(base_file_name: str) -> int:
    """Fold the deletion journal into the index: tombstone every journaled
    id in .ecx, then drop .ecj. Crash-safe order: write .ecx.cpt, fsync,
    rename over .ecx, unlink .ecj; a crash after the rename leaves a stale
    .ecj whose replay only tombstones dead entries again. Returns the
    number of journal entries folded."""
    deleted = set(read_ecj(base_file_name))
    if not deleted:
        return 0
    ecx = base_file_name + ".ecx"
    with open(ecx, "rb") as f:
        buf = f.read()
    tmp = ecx + ".cpt"
    with open(tmp, "wb") as out:
        for key, off, size in idx_mod.walk_index_buffer(buf):
            if key in deleted and not types.is_deleted(size):
                size = types.TOMBSTONE_FILE_SIZE
            out.write(types.pack_index_entry(key, off, size))
        out.flush()
        os.fsync(out.fileno())
    os.replace(tmp, ecx)
    try:
        os.remove(base_file_name + ".ecj")
    except FileNotFoundError:
        pass
    return len(deleted)


def write_idx_file_from_ec_index(base_file_name: str) -> None:
    """<base>.ecx + <base>.ecj -> <base>.idx (WriteIdxFileFromEcIndex): the
    sorted entries, tombstones normalised to (key, 0, -1), then one
    tombstone per journaled deletion."""
    with open(base_file_name + ".ecx", "rb") as f:
        ecx = f.read()
    tmp_idx = base_file_name + ".idx.tmp"
    with open(tmp_idx, "wb") as out:
        for key, off, size in idx_mod.walk_index_buffer(ecx):
            if types.is_deleted(size):
                out.write(types.pack_index_entry(key, 0, types.TOMBSTONE_FILE_SIZE))
            else:
                out.write(types.pack_index_entry(key, off, size))
        for key in read_ecj(base_file_name):
            out.write(types.pack_index_entry(key, 0, types.TOMBSTONE_FILE_SIZE))
        out.flush()
        os.fsync(out.fileno())
    os.replace(tmp_idx, base_file_name + ".idx")
