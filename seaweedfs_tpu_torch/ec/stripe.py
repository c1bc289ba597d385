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

Rebuilds read survivors through `SlabSource`s: local files, remote holders
(`RemoteSlabSource`, with failover), or holder groups that ship the
projection of their survivors through the decode matrix
(`TraceSlabSource`, `LocalProjectionSource`), combined by one launch per
batch. `rebuild_ec_files_batch` runs many volumes of mixed geometry and
loss pattern through one pipeline of block-diagonal decodes.
"""

from __future__ import annotations

import json
import os
import threading
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from contextlib import ExitStack
from typing import Callable, Optional, Sequence

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

#: sub-range size of the parallel range-fetches within one remote slab
#: window, so a window costs about one holder round trip, not a serial stream
DEFAULT_SLAB_STRIPE_BYTES = 4 * 1024 * 1024

#: concurrent sub-range fetches per remote source (slab or projection),
#: spread across a shard's holders
DEFAULT_SLAB_FANOUT = config.env("WEEDTPU_SLAB_FANOUT")


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


def _ring_for(cache: Optional[dict], enc: Encoder, slots: int, shape: tuple) -> _StagingRing:
    """A staging ring of the requested geometry, kept across calls in the
    caller's `cache` dict where one is given (an ingest builder's polls, a
    conversion's chunks), so a poll does not pay a fresh pinned allocation.
    The cache holds two geometries and evicts the oldest. Reuse is safe
    because every `_encode_rows` call drains its batches before it returns."""
    pinned = enc.device.type == "cuda"
    if cache is None:
        return _StagingRing(slots, shape, pinned=pinned)
    key = (slots, shape, pinned)
    ring = cache.get(key)
    if ring is None:
        while len(cache) >= 2:
            cache.pop(next(iter(cache)))
        ring = cache[key] = _StagingRing(slots, shape, pinned=pinned)
    return ring


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
    ring_cache: Optional[dict] = None,
) -> None:
    """Encode `n_rows` rows of `block_size` blocks as a stream of flat
    (k, width) dispatches over the staging ring; outputs receive bytes in
    row-major order. Data shards stream to disk at fill time; parity is
    written FIFO as each batch drains (`np.asarray`, the sync point).
    `ring_cache` (a caller-owned dict) keeps the ring across calls."""
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
    ring = _ring_for(ring_cache, enc, depth + 1, (k, span))
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
        _unlink_shards(base_file_name, range(enc.total_shards))
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
    else a sibling on the same device and backend running the same kernel
    variant and tile (and, on the mesh backend, the same mesh shape and
    rebuild formulation), so every geometry rides what the factory chose."""
    geom = geometry_from_info(info)
    if default is None:
        return new_encoder(geom.data_shards, geom.parity_shards, geom.matrix_kind)
    if (default.data_shards, default.parity_shards, default.matrix_kind) == (
        geom.data_shards, geom.parity_shards, geom.matrix_kind,
    ):
        return default
    enc = Encoder(
        geom.data_shards, geom.parity_shards, matrix_kind=geom.matrix_kind,
        backend=default.backend, device=default.device, variant=default.variant,
        tile=default.tile, mesh_shape=default.mesh_shape, mesh_rebuild=default.mesh_rebuild,
        mesh_devices=default.mesh_devices,
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


class RemoteSlabSource(SlabSource):
    """One shard's bytes, fetched in parallel sub-ranges from its holders.

    `fetch(addr, offset, size) -> bytes` is the injected transport: it may
    return short at the shard's end and raises on any failure. A prefetched
    window is split into `stripe_bytes` sub-ranges run on the executor.

    Failover is per holder and mid-rebuild: a failed fetch marks its holder
    dead (recorded in `failovers`) and retries the range on the next live
    one, after a re-lookup through `refresh_holders` (at most two) when all
    known holders are dead; other ranges in flight are left alone, so the
    pipeline never restarts. IOError when no holder can serve a range.

    Up to `fanout` sub-ranges run at once, each on the live holder with the
    fewest fetches in flight (ties broken by a rotation per sub-range), so
    a replicated shard's windows draw on every holder."""

    def __init__(
        self,
        shard_id: int,
        holders: Sequence[str],
        fetch: Callable[[str, int, int], bytes],
        executor: Optional[ThreadPoolExecutor] = None,
        stripe_bytes: int = DEFAULT_SLAB_STRIPE_BYTES,
        refresh_holders: Optional[Callable[[], Sequence[str]]] = None,
        fetch_deadline: float = 120.0,
        fanout: Optional[int] = None,
    ):
        self.shard_id = shard_id
        self.failovers: list[str] = []
        #: payload bytes pulled over the network (moved, not repaired, bytes)
        self.bytes_fetched = 0
        self._holders = [str(h) for h in holders]
        self._dead: set[str] = set()
        self._fetch = fetch
        self._refresh = refresh_holders
        # bounded, not one-shot: a transient error may kill the only known
        # holder more than once in a long rebuild, and the bound still ends
        # the rebuild against a cluster that is really gone
        self._refreshes_left = 2
        self._stripe = max(64 * 1024, int(stripe_bytes))
        self._deadline = fetch_deadline
        self._lock = threading.Lock()
        # fetches run on pool threads, which do not inherit context
        # variables: they attach the rebuild's span captured here
        self._trace_parent = trace_mod.current()
        self._fanout = DEFAULT_SLAB_FANOUT if fanout is None else max(1, int(fanout))
        #: holder -> fetches running against it
        self._inflight: dict[str, int] = {}
        self._own_executor = executor is None
        self._ex = executor or ThreadPoolExecutor(
            max_workers=self._fanout, thread_name_prefix=f"slab-fetch-{shard_id}"
        )
        #: offset -> (length, [(rel_offset, size, Future[bytes]), ...])
        self._pending: dict[int, tuple[int, list]] = {}

    def _live_holders(self) -> list[str]:
        with self._lock:
            live = [h for h in self._holders if h not in self._dead]
            if live or self._refresh is None or self._refreshes_left <= 0:
                return live
            self._refreshes_left -= 1
        try:
            fresh = list(self._refresh() or ())
        except Exception:  # noqa: BLE001 — a failed lookup is "no holders"
            fresh = []
        with self._lock:
            for h in fresh:
                if str(h) not in self._holders:
                    self._holders.append(str(h))
                self._dead.discard(str(h))
            return [h for h in self._holders if h not in self._dead]

    def _pick_holder(self, live: list[str], offset: int) -> str:
        """The live holder with the fewest fetches in flight; a rotation by
        sub-range breaks ties, so an idle source still spreads consecutive
        sub-ranges across holders."""
        with self._lock:
            rot = (offset // self._stripe) % len(live)
            order = live[rot:] + live[:rot]
            addr = min(order, key=lambda h: self._inflight.get(h, 0))
            self._inflight[addr] = self._inflight.get(addr, 0) + 1
            return addr

    def _fetch_range(self, offset: int, size: int) -> bytes:
        with trace_mod.attach(self._trace_parent):
            return self._fetch_range_inner(offset, size)

    def _fetch_range_inner(self, offset: int, size: int) -> bytes:
        while True:
            live = self._live_holders()
            if not live:
                raise IOError(
                    f"shard {self.shard_id}: no reachable holder for "
                    f"[{offset}, {offset + size}) — tried {self._holders}"
                )
            addr = self._pick_holder(live, offset)
            try:
                data = self._fetch(addr, offset, size)
            except Exception:  # noqa: BLE001 — holder down: fail over
                with self._lock:
                    self._inflight[addr] = max(0, self._inflight.get(addr, 1) - 1)
                    if addr not in self._dead:
                        self._dead.add(addr)
                        self.failovers.append(addr)
                continue
            with self._lock:
                self._inflight[addr] = max(0, self._inflight.get(addr, 1) - 1)
                self.bytes_fetched += len(data)
            if len(data) > size:
                raise IOError(
                    f"shard {self.shard_id}: holder {addr} over-answered "
                    f"({len(data)} > {size} bytes)"
                )
            return data

    def prefetch(self, offset: int, length: int) -> None:
        if length <= 0 or offset in self._pending:
            return
        futs = []
        for off in range(offset, offset + length, self._stripe):
            n = min(self._stripe, offset + length - off)
            futs.append((off - offset, n, self._ex.submit(self._fetch_range, off, n)))
        self._pending[offset] = (length, futs)

    def read_into(self, offset: int, out: np.ndarray) -> None:
        entry = self._pending.pop(offset, None)
        if entry is not None and entry[0] != out.size:
            for _, _, fut in entry[1]:  # a window of another shape: fetch again
                _abandon_future(fut)
            entry = None
        if entry is None:
            self.prefetch(offset, out.size)
            entry = self._pending.pop(offset)
        _, futs = entry
        # a holder that hangs costs one full deadline before its worker
        # tries the next: budget one deadline per holder, plus the refresh
        with self._lock:
            wait_budget = self._deadline * (len(self._holders) + 1)
        try:
            for rel, n, fut in futs:
                data = fut.result(timeout=wait_budget)
                got = len(data)
                if got:
                    out[rel : rel + got] = np.frombuffer(data, dtype=np.uint8)
                if got < n:  # the shard ends inside the window: zero-fill
                    out[rel + got : rel + n] = 0
        except BaseException:
            for _, _, fut in futs:
                _abandon_future(fut)
            raise

    def close(self) -> None:
        for _, futs in self._pending.values():
            for _, _, fut in futs:
                _abandon_future(fut)
        self._pending.clear()
        if self._own_executor:
            self._ex.shutdown(wait=False, cancel_futures=True)


# -- trace-repair projection sources ------------------------------------------
#
# A holder of several survivor shards ships the GF(2^8) projection of its
# local group through the decode matrix (len(missing) rows) in place of one
# full slab per survivor. The XOR of the holders' projections is the fused
# decode, so the rebuilt bytes equal the slab path's, while the wire moves
# holders x repaired bytes instead of survivors x shard bytes.


class TraceSlabSource(SlabSource):
    """One holder group's projections.

    `fetch(offset, size) -> bytes` is the injected transport, bound to the
    holder and its projection terms: it returns the row-major (rows,
    actual) projected block of the window, actual = min(size, shard_len -
    offset), short at the shard's end (the client zero-fills: the
    projection of zero columns is zero). Windows are split into
    `chunk_bytes` sub-ranges fetched in parallel (the projection is per
    byte column, so sub-ranges concatenate exactly).

    No failover inside the source: the group's shards live on this holder,
    so a failed fetch propagates and the caller falls back to slabs."""

    def __init__(
        self,
        holder: str,
        shard_ids: Sequence[int],
        rows: int,
        fetch: Callable[[int, int], bytes],
        executor: Optional[ThreadPoolExecutor] = None,
        chunk_bytes: Optional[int] = None,
        fanout: Optional[int] = None,
    ):
        if rows <= 0:
            raise ValueError("projection rows must be positive")
        self.holder = str(holder)
        self.shard_ids = [int(s) for s in shard_ids]
        self.rows = int(rows)
        self.bytes_fetched = 0
        self._fetch = fetch
        self._chunk = max(
            64 * 1024,
            int(config.env("WEEDTPU_TRACE_CHUNK") if chunk_bytes is None else chunk_bytes),
        )
        self._lock = threading.Lock()
        self._trace_parent = trace_mod.current()  # as RemoteSlabSource's
        self._own_executor = executor is None
        workers = DEFAULT_SLAB_FANOUT if fanout is None else max(1, int(fanout))
        self._ex = executor or ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix=f"trace-fetch-{self.holder}"
        )
        #: window offset -> (width, [(rel, size, Future), ...])
        self._pending: dict[int, tuple[int, list]] = {}

    def _fetch_counted(self, offset: int, size: int) -> bytes:
        with trace_mod.attach(self._trace_parent):
            data = self._fetch(offset, size)
        if len(data) % self.rows:
            raise IOError(
                f"trace group {self.holder}: projected stream length "
                f"{len(data)} is not a multiple of {self.rows} rows"
            )
        if len(data) > size * self.rows:
            raise IOError(
                f"trace group {self.holder}: over-answered "
                f"({len(data)} > {size * self.rows} bytes)"
            )
        with self._lock:
            self.bytes_fetched += len(data)
        return data

    def prefetch(self, offset: int, length: int) -> None:
        if length <= 0 or offset in self._pending:
            return
        futs = []
        for off in range(offset, offset + length, self._chunk):
            n = min(self._chunk, offset + length - off)
            futs.append((off - offset, n, self._ex.submit(self._fetch_counted, off, n)))
        self._pending[offset] = (length, futs)

    def read_into(self, offset: int, out: np.ndarray) -> None:
        """Fill a flat (rows * width,) staging view with the window's
        projected block, row-major (rows, width), zero-filled past the end."""
        if out.size % self.rows:
            raise ValueError(f"staging view of {out.size} bytes is not {self.rows} rows")
        width = out.size // self.rows
        entry = self._pending.pop(offset, None)
        if entry is not None and entry[0] != width:
            for _, _, fut in entry[1]:  # a window of another shape: fetch again
                _abandon_future(fut)
            entry = None
        if entry is None:
            self.prefetch(offset, width)
            entry = self._pending.pop(offset)
        _, futs = entry
        out2d = out.reshape(self.rows, width)
        try:
            for rel, n, fut in futs:
                data = fut.result()
                sub = len(data) // self.rows
                if sub:
                    out2d[:, rel : rel + sub] = np.frombuffer(data, dtype=np.uint8).reshape(
                        self.rows, sub
                    )
                if sub < n:  # the shard ends inside the window: zero-fill
                    out2d[:, rel + sub : rel + n] = 0
        except BaseException:
            for _, _, fut in futs:
                _abandon_future(fut)
            raise

    def close(self) -> None:
        for _, futs in self._pending.values():
            for _, _, fut in futs:
                _abandon_future(fut)
        self._pending.clear()
        if self._own_executor:
            self._ex.shutdown(wait=False, cancel_futures=True)


class LocalProjectionSource(SlabSource):
    """The rebuild target's own survivors as one projection group: reads
    their windows and projects them through the group's coefficients with
    `Encoder.project` (one launch per window on the card), the math a
    remote holder runs, at no wire cost."""

    def __init__(self, paths: Sequence[str], coeffs: np.ndarray, encoder: Encoder):
        coeffs = np.asarray(coeffs, dtype=np.uint8)
        if coeffs.ndim != 2 or coeffs.shape[1] != len(paths):
            raise ValueError(f"want (rows, {len(paths)}) coeffs, got {coeffs.shape}")
        self.holder = "local"
        self.rows = coeffs.shape[0]
        self.bytes_fetched = 0
        self._coeffs = coeffs
        self._enc = encoder
        self._files = []  # owned by the source, closed in close()
        try:
            for p in paths:
                self._files.append(open(p, "rb"))
        except BaseException:
            self.close()
            raise

    def read_into(self, offset: int, out: np.ndarray) -> None:
        if out.size % self.rows:
            raise ValueError(f"staging view of {out.size} bytes is not {self.rows} rows")
        width = out.size // self.rows
        stack = np.empty((len(self._files), width), dtype=np.uint8)
        for i, f in enumerate(self._files):
            read_padded_into(f, offset, stack[i])
        out.reshape(self.rows, width)[:] = self._enc.project(self._coeffs, stack)

    def close(self) -> None:
        for f in self._files:
            f.close()


def _unlink_shards(base_file_name: str, shard_ids) -> None:
    """Remove the named .ecNN files where present: a failed run's partials."""
    for s in shard_ids:
        try:
            os.unlink(shard_file_name(base_file_name, s))
        except OSError:
            pass


def _batch_windows(shard_size: int, span: int, buffer_size: int) -> list[tuple[int, int, int]]:
    """(offset, valid bytes, staged width) of each batch of a one-volume
    rebuild: spans of `span` bytes, the last one's width rounded up to
    whole `buffer_size` chunks."""
    out = []
    off = 0
    while off < shard_size:
        valid = min(span, shard_size - off)
        out.append((off, valid, -(-valid // buffer_size) * buffer_size))
        off += span
    return out


def rebuild_ec_files_from_projections(
    base_file_name: str,
    groups: Sequence[SlabSource],
    shard_size: int,
    missing: Sequence[int],
    encoder: Optional[Encoder] = None,
    buffer_size: int = 4 * 1024 * 1024,
    max_batch_bytes: int = 64 * 1024 * 1024,
    pipeline_depth: Optional[int] = None,
    prefetch_batches: Optional[int] = None,
) -> list[int]:
    """The trace-repair rebuild: each batch reads one (rows, width)
    projected block per holder group into a (groups, rows * width) staging
    slot and combines them with one launch, the all-ones (1 x groups) GF
    matrix (the XOR of the projections). Output equals
    `rebuild_ec_files_serial` on the same survivor set, since the
    projection coefficients are the fused decode matrix split by columns.
    CRC32s are folded in as bytes stream out and checked against the .eci;
    any failure drains inflight work and unlinks the partial outputs.
    Returns the rebuilt shard ids."""
    enc = encoder or encoder_for_base(base_file_name)
    missing = sorted(int(s) for s in missing)
    if not missing:
        return []
    if not groups:
        raise ValueError("trace rebuild needs at least one projection group")
    rows = len(missing)
    for g in groups:
        if getattr(g, "rows", None) != rows:
            raise ValueError(
                f"group {getattr(g, 'holder', g)!r} projects "
                f"{getattr(g, 'rows', None)} rows, want {rows}"
            )
    depth = DEFAULT_PIPELINE_DEPTH if pipeline_depth is None else max(1, int(pipeline_depth))
    ahead = (
        DEFAULT_PREFETCH_BATCHES if prefetch_batches is None else max(1, int(prefetch_batches))
    )
    chunks_per_batch = max(1, max_batch_bytes // (enc.data_shards * buffer_size))
    span = chunks_per_batch * buffer_size
    combine = np.ones((1, len(groups)), dtype=np.uint8)  # GF sum == XOR
    ring = _ring_for(None, enc, depth + 1, (len(groups), rows * span))
    crcs = {s: 0 for s in missing}
    batches = _batch_windows(shard_size, span, buffer_size)
    try:
        with ExitStack() as stack:
            outs = {
                s: stack.enter_context(open(shard_file_name(base_file_name, s), "wb"))
                for s in missing
            }
            inflight: deque = deque()  # FIFO of (combined_handle, valid, width)

            def drain_one() -> None:
                lazy, valid, width = inflight.popleft()
                with trace_mod.span("rebuild.drain", width=width):
                    out = np.asarray(lazy).reshape(rows, width)  # sync point
                    for k, s in enumerate(missing):
                        row = np.ascontiguousarray(out[k, :valid])
                        outs[s].write(row)
                        crcs[s] = zlib.crc32(row, crcs[s])

            def issue_prefetch(bi: int) -> None:
                if bi < len(batches):
                    o, _, wd = batches[bi]
                    for g in groups:
                        g.prefetch(o, wd)

            try:
                for j in range(min(ahead, len(batches))):
                    issue_prefetch(j)
                for bi, (off, valid, width) in enumerate(batches):
                    issue_prefetch(bi + ahead)
                    while len(inflight) >= depth:
                        drain_one()
                    with trace_mod.span("rebuild.stage", batch=bi, width=width):
                        staging = ring.take()
                        for i, g in enumerate(groups):
                            g.read_into(off, staging[i, : rows * width])
                    # a strided view when the last batch is short: it goes
                    # to the card row by row, and the handle holds the slot
                    combined = enc.project_lazy(combine, staging[:, : rows * width], donate=True)
                    inflight.append((combined, valid, width))
                while inflight:
                    drain_one()
            except BaseException:
                _discard_inflight(inflight)
                raise
        _verify_rebuilt_crcs(base_file_name, crcs)
    except BaseException:
        _unlink_shards(base_file_name, missing)
        raise
    return missing


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
    ring = _ring_for(None, enc, depth + 1, (enc.data_shards, span))
    crcs = {s: 0 for s in missing}
    batches = _batch_windows(shard_size, span, buffer_size)
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
        _unlink_shards(base_file_name, missing)
        raise
    return missing


def rebuild_ec_files_batch(
    jobs: list[dict],
    encoder: Optional[Encoder] = None,
    buffer_size: int = 4 * 1024 * 1024,
    max_batch_bytes: int = 64 * 1024 * 1024,
    pipeline_depth: Optional[int] = None,
    prefetch_batches: Optional[int] = None,
    fuse: Optional[bool] = None,
) -> dict:
    """Many volumes' rebuilds through shared launches: the fleet-repair
    batch engine.

    Each job is {"base", "sources" ({shard id: SlabSource}), "shard_size",
    "missing" (optional), "encoder" (optional)}. Jobs whose signature
    (survivor set, missing set, geometry) matches share one decode matrix,
    and their batches are packed across volume boundaries (the GF product
    is column-independent; which volume a column came from matters only
    when it is written out).

    With `fuse` (default WEEDTPU_REBUILD_FUSE), different signatures fuse
    too: each group is a block of a block-diagonal decode
    (`Encoder.reconstruct_block`) and the whole cohort runs through one
    staging pipeline, dispatch_groups == 1. Groups keep insertion order, so
    the caller's job order is the block order. fuse=False runs one
    pipeline per signature group.

    Failures are scoped to a group either way: its members' partial outputs
    are unlinked and the error recorded per job, and the other groups run
    on. Returns {"rebuilt": {base: [shard ids]}, "errors": {base: str},
    "dispatch_groups": int, "signature_groups": int, "volumes_fused": int,
    "block_order": [base, ...]}."""
    groups: dict[tuple, list[dict]] = {}
    out: dict = {
        "rebuilt": {},
        "errors": {},
        "dispatch_groups": 0,
        "signature_groups": 0,
        "volumes_fused": 0,
        "block_order": [],
    }
    for job in jobs:
        enc = job.get("encoder") or encoder or encoder_for_base(job["base"])
        present = sorted(job["sources"])
        missing = job.get("missing")
        if missing is None:  # an explicit [] means "nothing to rebuild"
            missing = [s for s in range(enc.total_shards) if s not in job["sources"]]
        missing = sorted(missing)
        if not missing:
            out["rebuilt"][job["base"]] = []
            continue
        if len(present) < enc.data_shards:
            out["errors"][job["base"]] = (
                f"only {len(present)} shards present, need {enc.data_shards}"
            )
            continue
        survivors = tuple(present[: enc.data_shards])
        sig = (survivors, tuple(missing), enc.data_shards, enc.total_shards, enc.matrix_kind)
        groups.setdefault(sig, []).append(
            {**job, "encoder": enc, "missing": missing, "survivors": survivors}
        )
    depth = DEFAULT_PIPELINE_DEPTH if pipeline_depth is None else max(1, int(pipeline_depth))
    ahead = (
        DEFAULT_PREFETCH_BATCHES if prefetch_batches is None else max(1, int(prefetch_batches))
    )
    out["signature_groups"] = len(groups)
    out["block_order"] = [job["base"] for members in groups.values() for job in members]
    out["volumes_fused"] = len(out["block_order"])
    if fuse is None:
        fuse = config.env("WEEDTPU_REBUILD_FUSE") == "on"

    def fail(members: list[dict], e: BaseException) -> None:
        for job in members:
            _unlink_shards(job["base"], job["missing"])
            out["errors"][job["base"]] = f"{type(e).__name__}: {e}"[:300]
        if not isinstance(e, Exception):
            raise e  # an interrupt propagates once the partials are gone

    if fuse and groups:
        out["dispatch_groups"] = 1
        glist = list(groups.values())
        try:
            rebuilt, errors = _rebuild_fused(glist, depth, ahead, buffer_size, max_batch_bytes)
        except BaseException as e:
            fail([job for members in glist for job in members], e)
        else:
            out["rebuilt"].update(rebuilt)
            out["errors"].update(errors)
        return out
    for members in groups.values():
        out["dispatch_groups"] += 1
        try:
            _rebuild_group(members, depth, ahead, buffer_size, max_batch_bytes)
        except BaseException as e:
            fail(members, e)
        else:
            for job in members:
                out["rebuilt"][job["base"]] = list(job["missing"])
    return out


def _pack_segments(sizes: Sequence[int], span: int) -> list[list[tuple[int, int, int]]]:
    """Batches of (job index, shard offset, length) segments that fill
    `span` columns each, packed across job boundaries in job order (so a
    job's segments stay consecutive within a batch)."""
    batches: list[list[tuple[int, int, int]]] = []
    cur: list[tuple[int, int, int]] = []
    room = span
    for ji, size in enumerate(sizes):
        off = 0
        while off < size:
            take = min(room, size - off)
            cur.append((ji, off, take))
            off += take
            room -= take
            if room == 0:
                batches.append(cur)
                cur, room = [], span
    if cur:
        batches.append(cur)
    return batches


def _rebuild_fused(
    groups: list[list[dict]], depth: int, ahead: int, buffer_size: int, max_batch_bytes: int,
) -> tuple[dict, dict]:
    """The heterogeneous cohort as one pipeline: each signature group is a
    block of a block-diagonal decode, and each staging batch packs blocks'
    survivor columns side by side (a group's segments stay consecutive, so
    each block is one column range and the composite's zero blocks never
    exist). Same depth-N inflight deque, per-volume CRC fold and prefetch
    as `_rebuild_group`.

    A survivor-read failure fails only its group: its later segments stop
    staging, its drains stop writing, its partials are unlinked and its
    members get the error, while the other blocks keep flowing. A decode or
    drain failure raises to the caller, which unlinks everything.
    Returns ({base: [rebuilt shard ids]}, {base: error})."""
    encs = [members[0]["encoder"] for members in groups]
    max_k = max(e.data_shards for e in encs)
    align = max(e.width_align for e in encs)
    chunks_per_batch = max(1, max_batch_bytes // (max_k * buffer_size))
    span = _aligned(chunks_per_batch * buffer_size, align)
    ring = _ring_for(None, encs[0], depth + 1, (max_k, span))
    flat = [(gi, job) for gi, members in enumerate(groups) for job in members]
    crcs = [{s: 0 for s in job["missing"]} for _, job in flat]
    failed: dict[int, str] = {}  # group index -> error
    batches = _pack_segments([int(job["shard_size"]) for _, job in flat], span)
    with ExitStack() as stack:
        outs = [
            {
                s: stack.enter_context(open(shard_file_name(job["base"], s), "wb"))
                for s in job["missing"]
            }
            for _, job in flat
        ]
        inflight: deque = deque()  # FIFO of (handle, segments)

        def drain_one() -> None:
            lazy, segs = inflight.popleft()
            width = sum(t for _, _, t in segs)
            with trace_mod.span("rebuild.drain", width=width):
                dec = np.asarray(lazy)  # (max_m, span): the sync point
                col = 0
                for mi, off, length in segs:
                    job = flat[mi][1]
                    if flat[mi][0] not in failed:
                        for k, s in enumerate(job["missing"]):
                            row = dec[k, col : col + length]
                            outs[mi][s].write(row)
                            crcs[mi][s] = zlib.crc32(row, crcs[mi][s])
                    col += length

        def issue_prefetch(bi: int) -> None:
            if bi < len(batches):
                for mi, off, length in batches[bi]:
                    gi, job = flat[mi]
                    if gi not in failed:
                        for s in job["survivors"]:
                            job["sources"][s].prefetch(off, length)

        try:
            for j in range(min(ahead, len(batches))):
                issue_prefetch(j)
            for bi, segs in enumerate(batches):
                issue_prefetch(bi + ahead)
                while len(inflight) >= depth:
                    drain_one()
                width = sum(t for _, _, t in segs)
                blocks: list[dict] = []
                with trace_mod.span("rebuild.stage", batch=bi, width=width):
                    staging = ring.take()
                    col = 0
                    for mi, off, length in segs:
                        gi, job = flat[mi]
                        if gi not in failed:
                            try:
                                for i, s in enumerate(job["survivors"]):
                                    job["sources"][s].read_into(
                                        off, staging[i, col : col + length]
                                    )
                            except Exception as e:  # noqa: BLE001 — fails its group only
                                failed[gi] = f"{type(e).__name__}: {e}"[:300]
                        if gi not in failed:
                            if blocks and blocks[-1]["_gi"] == gi:
                                blocks[-1]["width"] += length
                            else:
                                blocks.append({
                                    "_gi": gi, "encoder": encs[gi],
                                    "survivors": job["survivors"], "wanted": job["missing"],
                                    "col_start": col, "width": length,
                                })
                        col += length
                # a read may fail after its group's block opened in this batch
                blocks = [b for b in blocks if b["_gi"] not in failed]
                if blocks:
                    inflight.append((encs[0].reconstruct_block(staging, blocks), segs))
            while inflight:
                drain_one()
        except BaseException:
            _discard_inflight(inflight)
            raise
    rebuilt: dict = {}
    errors: dict = {}
    for mi, (gi, job) in enumerate(flat):
        if gi in failed:
            _unlink_shards(job["base"], job["missing"])
            errors[job["base"]] = failed[gi]
            continue
        try:
            _verify_rebuilt_crcs(job["base"], crcs[mi])
        except Exception as e:  # noqa: BLE001 — fails this volume only
            _unlink_shards(job["base"], job["missing"])
            errors[job["base"]] = f"{type(e).__name__}: {e}"[:300]
            continue
        rebuilt[job["base"]] = list(job["missing"])
    return rebuilt, errors


def _rebuild_group(
    members: list[dict], depth: int, ahead: int, buffer_size: int, max_batch_bytes: int,
) -> None:
    """One same-signature group: a single depth-N pipeline whose batches
    pack columns from consecutive volumes (see rebuild_ec_files_batch)."""
    enc = members[0]["encoder"]
    survivors = list(members[0]["survivors"])
    missing = list(members[0]["missing"])
    chunks_per_batch = max(1, max_batch_bytes // (enc.data_shards * buffer_size))
    span = _aligned(chunks_per_batch * buffer_size, enc.width_align)
    ring = _ring_for(None, enc, depth + 1, (enc.data_shards, span))
    crcs = [{s: 0 for s in missing} for _ in members]
    batches = _pack_segments([int(job["shard_size"]) for job in members], span)
    with ExitStack() as stack:
        outs = [
            {s: stack.enter_context(open(shard_file_name(job["base"], s), "wb")) for s in missing}
            for job in members
        ]
        inflight: deque = deque()  # FIFO of (handle, segments, width)

        def drain_one() -> None:
            lazy, segs, width = inflight.popleft()
            with trace_mod.span("rebuild.drain", width=width):
                dec = np.asarray(lazy)  # (len(missing), width): the sync point
                col = 0
                for ji, off, length in segs:
                    for k, s in enumerate(missing):
                        row = dec[k, col : col + length]
                        outs[ji][s].write(row)
                        crcs[ji][s] = zlib.crc32(row, crcs[ji][s])
                    col += length

        def issue_prefetch(bi: int) -> None:
            if bi < len(batches):
                for ji, off, length in batches[bi]:
                    for s in survivors:
                        members[ji]["sources"][s].prefetch(off, length)

        try:
            for j in range(min(ahead, len(batches))):
                issue_prefetch(j)
            for bi, segs in enumerate(batches):
                issue_prefetch(bi + ahead)
                while len(inflight) >= depth:
                    drain_one()
                width = sum(length for _, _, length in segs)
                with trace_mod.span("rebuild.stage", batch=bi, width=width):
                    staging = ring.take()
                    col = 0
                    for ji, off, length in segs:
                        for i, s in enumerate(survivors):
                            members[ji]["sources"][s].read_into(off, staging[i, col : col + length])
                        col += length
                    aw = _aligned(width, enc.width_align)
                    if aw > width:
                        staging[:, width:aw] = 0  # pad columns decode to zeros
                decoded = enc.reconstruct_lazy(staging[:, :aw], survivors, missing, donate=True)
                inflight.append((decoded, segs, width))
            while inflight:
                drain_one()
        except BaseException:
            _discard_inflight(inflight)
            raise
    for ji, job in enumerate(members):
        _verify_rebuilt_crcs(job["base"], crcs[ji])


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
