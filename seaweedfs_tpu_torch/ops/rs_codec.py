"""Reed-Solomon codec facade: the `reedsolomon.Encoder`-shaped seam.

Five backends:

  * "cuda":  the hand-written kernels (`rs_cuda`); the backend of an
    encoder on a CUDA device, and the default (`new_encoder()` runs on the
    card and raises when there is none).
  * "torch": the plain PyTorch versions (`rs_torch`), only with device="cpu".
  * "native": the host codec of the reference's CPU floor, the AVX2
    split-table GF(2^8) multiply-accumulate (`csrc/gf_host.cc` through
    `utils.native`, all cores); always on the CPU, and it raises where the
    library cannot be built.
  * "xorsched": the compiled XOR-schedule host codec (`ops.xorsched`): each
    matrix lowered once to a bit-plane XOR program (a bounded LRU) and
    replayed by the native executor (GFNI/AVX-512, AVX2 or scalar), or by
    the numpy interpreter where the library cannot be built
    (`selection["xor_simd"]` says "unavailable" then); always on the CPU.
  * "mesh":  every card of the host driven from this process
    (`parallel.backend.MeshDispatch`: dp x sp sharded applies, the ring or
    all_to_all rebuild), each card's step the "cuda" backend's kernel; with
    device="cpu" the CPU named dp x sp times runs the plain version.
    `new_encoder()` promotes a multi-card host to it only on committed
    on-chip mesh evidence (`pick_mesh_backend`).

A card encoder carries a kernel variant (`FUSED_VARIANTS`) and a tile, the
counterparts of the reference's `pallas_mxu`/`pallas_tile`; `new_encoder`
on a card picks them from committed on-chip evidence
(`pick_device_backend`), int8 with its own tile when there is none. The
host codecs serve only when asked for (`backend=`, `WEEDTPU_BACKEND`, or
"auto" on the CPU, where `pick_cpu_backend` applies the reference's
same-host CPU bench rule).

Per-loss-pattern decode matrices are built on the host by GF Gaussian
elimination and kept in an LRU cache, the role of klauspost's inversion
tree.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import json
import os
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from seaweedfs_tpu_torch.ops import gf8, rs_cuda, xorsched
from seaweedfs_tpu_torch.parallel import sharded
from seaweedfs_tpu_torch.utils import config, native

#: committed on-chip measurement evidence older than this many days no
#: longer moves the kernel choice away from int8: the kernels under
#: measurement keep changing, so an old number says little of today's
EVIDENCE_MAX_AGE_DAYS = config.env("WEEDTPU_EVIDENCE_MAX_AGE_DAYS")

#: the kernel variants, the reference's `pallas_mxu` values in its order;
#: `rs_cuda.KERNELS` must match
FUSED_VARIANTS = ("int8", "bf16", "u8", "mplane", "dma")

assert tuple(rs_cuda.KERNELS) == FUSED_VARIANTS, (
    f"kernel table {tuple(rs_cuda.KERNELS)} drifted from FUSED_VARIANTS {FUSED_VARIANTS}"
)

#: the backends an Encoder takes; the two host codecs run on the CPU
HOST_CODECS = ("native", "xorsched")
_BACKENDS = ("cuda", "torch") + HOST_CODECS + ("mesh",)


@dataclasses.dataclass(frozen=True)
class CodeGeometry:
    """One registered erasure-code geometry."""

    family: str
    data_shards: int
    parity_shards: int
    matrix_kind: str  # gf8.generator_matrix dispatch: vandermonde | cauchy

    @property
    def total_shards(self) -> int:
        return self.data_shards + self.parity_shards

    @property
    def overhead(self) -> float:
        return self.total_shards / self.data_shards


#: `rs_10_4` is the legacy wire default (klauspost-compatible Vandermonde);
#: `cauchy_12_3` the cold-tier code; `merge_20_4` the 10+4 -> 20+4 merge.
CODE_FAMILIES: dict[str, CodeGeometry] = {
    g.family: g
    for g in (
        CodeGeometry("rs_10_4", 10, 4, "vandermonde"),
        CodeGeometry("cauchy_12_3", 12, 3, "cauchy"),
        CodeGeometry("merge_20_4", 20, 4, "cauchy"),
    )
}

DEFAULT_FAMILY = "rs_10_4"


def geometry_for(family: str) -> CodeGeometry:
    geom = CODE_FAMILIES.get(str(family))
    if geom is None:
        raise ValueError(
            f"unknown code family {family!r} (registered: {sorted(CODE_FAMILIES)})"
        )
    return geom


def family_of(data_shards: int, parity_shards: int, matrix_kind: str) -> Optional[str]:
    """The registered family name of a geometry triple, or None."""
    for name, g in CODE_FAMILIES.items():
        if (g.data_shards, g.parity_shards, g.matrix_kind) == (
            int(data_shards), int(parity_shards), str(matrix_kind),
        ):
            return name
    return None


#: LRU cap on cached decode matrices: churning loss patterns must evict
DECODE_MATRIX_CACHE_SIZE = config.env("WEEDTPU_DECODE_MATRIX_CACHE")


@functools.lru_cache(maxsize=max(16, DECODE_MATRIX_CACHE_SIZE))
def _reconstruction_matrix(
    kind: str, data_shards: int, parity_shards: int, survivors: tuple, wanted: tuple
) -> np.ndarray:
    """(len(wanted) x data_shards) matrix mapping survivor shards to wanted
    shards; `survivors` are exactly `data_shards` present shard ids."""
    gen = gf8.generator_matrix(kind, data_shards, data_shards + parity_shards)
    inv = gf8.gf_mat_inv(gen[list(survivors), :])  # survivors -> data
    rows = [
        inv[w] if w < data_shards else gf8.gf_mat_mul(gen[w : w + 1], inv)[0]
        for w in wanted
    ]
    out = np.stack(rows).astype(np.uint8)
    out.setflags(write=False)
    return out


def decode_matrix_cache_info():
    """The decode-matrix cache's (hits, misses, maxsize, currsize): it must
    stay bounded under loss-pattern churn."""
    return _reconstruction_matrix.cache_info()


def clear_decode_matrix_cache() -> None:
    _reconstruction_matrix.cache_clear()


class LazyResult:
    """A dispatched GF application whose bytes stay on the device until
    `np.asarray(result)`, the one synchronisation point. Holds the host
    source until then, so a pinned buffer outlives its asynchronous copy."""

    def __init__(self, out: torch.Tensor, source: Optional[torch.Tensor] = None):
        self._out = out
        self._source = source
        self.shape = tuple(out.shape)

    def __array__(self, dtype=None, copy=None):
        arr = self._out.cpu().numpy()
        self._source = None
        if dtype is not None and np.dtype(dtype) != arr.dtype:
            return arr.astype(dtype)
        return arr


class _HostBlocks:
    """The lazy (max_m, W) result of a mesh encoder's `reconstruct_block`:
    one mesh dispatch per block, each block's rows gathered into its
    columns at `np.asarray`. `parts` lists each block's (rows, col_start,
    width), as `_FusedBlocks` does."""

    def __init__(self, shape: tuple, handles: list):
        self.shape = tuple(shape)
        self._handles = handles
        self.parts = [(rows, c0, w) for rows, c0, w, _ in handles]

    def __array__(self, dtype=None, copy=None):  # noqa: ARG002 — numpy 2.x kw
        out = np.zeros(self.shape, dtype=np.uint8)
        for rows, c0, w, h in self._handles:
            out[:rows, c0 : c0 + w] = np.asarray(h)
        if dtype is not None and np.dtype(dtype) != out.dtype:
            return out.astype(dtype)
        return out


class _FusedBlocks(LazyResult):
    """The lazy (max_m, W) result of `Encoder.reconstruct_block`: one launch
    per block has written its decoded rows into one device buffer, read
    back by one copy at `np.asarray`. Rows past a block's own wanted count
    inside its columns, and columns no block covers, are unspecified.
    `parts` lists each block's (rows, col_start, width)."""

    def __init__(self, out: torch.Tensor, source: Optional[torch.Tensor], parts: list):
        super().__init__(out, source)
        self.parts = parts


def _host_stack(shards, width: Optional[int] = None) -> np.ndarray:
    """A uint8 host stack of `shards`, `width` columns wide with zeros past
    N when given (a bucketed reconstruct)."""
    host = np.asarray(shards, dtype=np.uint8)
    if width is not None and width != host.shape[-1]:
        wide = np.zeros(host.shape[:-1] + (width,), dtype=np.uint8)
        wide[..., : host.shape[-1]] = host
        host = wide
    return host


def _host_tensor(a) -> torch.Tensor:
    """A uint8 CPU tensor over `a` without copying where numpy allows it
    (a strided view stays strided; a read-only array is copied)."""
    arr = np.asarray(a, dtype=np.uint8)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr)


class Encoder:
    """RS(d+p) encoder/reconstructor over GF(2^8) on one torch device.

    `variant` and `tile` choose the kernel every dispatch runs
    (`rs_cuda.apply_matrix`): the reference's `pallas_mxu` and
    `pallas_tile`. On the CPU they choose the variant's plain version.
    backend="mesh" spreads every dispatch over a dp x sp mesh
    (`mesh_shape`, default `WEEDTPU_MESH_SHAPE`, committed evidence or
    the all-cards rule) over `mesh_devices` (default: every card, or the
    CPU), with the `mesh_rebuild` formulation ("ring" or "alltoall",
    default `WEEDTPU_MESH_REBUILD`) for `reconstruct_lazy`.
    backend="native" or "xorsched" runs a host codec on the CPU (device
    None or "cpu"; another device raises), computing synchronously: its
    "lazy" results are ndarrays already. All shards in one call share a
    length; striping and padding live a layer up in `ec.stripe`."""

    #: shard-length buckets of the serving path's reconstructs (needle
    #: intervals: KiBs up to one 1 MiB small block). On the card a
    #: reconstruct pads to one, so each (B, R, bucket) launch shape repeats
    #: and a CUDA graph could replay it; zero columns decode to zero
    RECONSTRUCT_BUCKETS = (4 << 10, 64 << 10, 1 << 20)

    def __init__(
        self,
        data_shards: int = 10,
        parity_shards: int = 4,
        matrix_kind: str = "vandermonde",
        backend: Optional[str] = None,
        device=None,
        variant: str = "int8",
        tile: Optional[int] = None,
        mesh_shape: Optional[Sequence[int]] = None,
        mesh_rebuild: Optional[str] = None,
        mesh_devices: Optional[Sequence] = None,
    ):
        if data_shards <= 0 or parity_shards <= 0:
            raise ValueError("shard counts must be positive")
        if data_shards + parity_shards > 256:
            raise ValueError("GF(2^8) supports at most 256 total shards")
        if backend in HOST_CODECS:
            if device is not None and torch.device(device).type != "cpu":
                raise ValueError(
                    f"backend {backend!r} is a host codec: it runs on the cpu, not {device}"
                )
            device = "cpu"
            if backend == "native" and native.load_gf() is None:
                raise RuntimeError(
                    "backend 'native' needs csrc/gf_host.cc built by the host C++ "
                    "compiler, and it cannot be built here"
                )
        self.device = torch.device("cuda" if device is None else device)
        want = "cuda" if self.device.type == "cuda" else "torch"
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        if backend == "mesh" or backend in HOST_CODECS:
            want = backend
        elif backend is not None and backend != want:
            raise ValueError(
                f"backend {backend!r} does not run on {self.device} (want {want!r} or 'mesh')"
            )
        if variant not in FUSED_VARIANTS:
            raise ValueError(f"unknown variant {variant!r} (want one of {FUSED_VARIANTS})")
        if self.device.type == "cuda":  # every matrix dispatched has C = data_shards
            rs_cuda.check_shape(parity_shards, data_shards)
        rs_cuda.resolve_tile(variant, tile, data_shards, parity_shards)  # raises on a bad tile
        self.backend = want
        self.variant = variant
        self.tile = tile
        self.data_shards = data_shards
        self.parity_shards = parity_shards
        self.total_shards = data_shards + parity_shards
        self.matrix_kind = matrix_kind
        self.family = family_of(data_shards, parity_shards, matrix_kind)
        self.selection: dict = {
            "backend": want, "device": str(self.device), "variant": variant,
            "tile": tile, "source": "explicit",
        }
        if want == "xorsched":  # the interpreter serves where this is "unavailable"
            self.selection["xor_simd"] = xorsched.native_level()
        self.gen_matrix = gf8.generator_matrix(matrix_kind, data_shards, self.total_shards)
        self.parity_matrix = np.ascontiguousarray(self.gen_matrix[data_shards:])
        # mesh backend config: dp x sp shape and rebuild formulation (None =
        # resolve from the knobs, evidence or the default at first dispatch)
        self.mesh_shape = tuple(int(v) for v in mesh_shape) if mesh_shape else None
        self.mesh_rebuild = mesh_rebuild
        self.mesh_devices = list(mesh_devices) if mesh_devices is not None else None
        self._mesh_obj = None

    # -- kernel dispatch ----------------------------------------------------

    def _mesh_dispatch(self):
        """The lazily built mesh state (builds the mesh and sets the
        weedtpu_ec_mesh_devices gauge on first use). Its devices are
        `mesh_devices` when given (a list may name one device several
        times), else every card of the host on a card, and on the CPU the
        CPU once per position, dp x sp resolved over as many positions as
        cores."""
        if self._mesh_obj is None:
            from seaweedfs_tpu_torch.parallel import backend as mesh_backend

            shape, devices = self.mesh_shape, self.mesh_devices
            if devices is None and self.device.type == "cpu":
                shape = mesh_backend.resolve_shape(os.cpu_count() or 1, shape)
                devices = [self.device] * (shape[0] * shape[1])
            self._mesh_obj = mesh_backend.MeshDispatch(
                shape=shape, rebuild=self.mesh_rebuild, devices=devices,
                variant=self.variant, tile=self.tile,
            )
        return self._mesh_obj

    @property
    def width_align(self) -> int:
        """Staging-width multiple the streaming pipelines round their spans
        to, so every steady-state batch dispatches with no pad (1 on one
        device; dp*sp on the mesh backend)."""
        if self.backend != "mesh":
            return 1
        return self._mesh_dispatch().width_align

    def _count_dispatch(self) -> None:
        from seaweedfs_tpu_torch import stats

        stats.EcDispatchTotal.labels(self.backend).inc()

    def _apply_lazy(self, m: np.ndarray, shards, donate: bool = False,
                    width: Optional[int] = None) -> LazyResult:
        """Apply GF matrix m to a (C, N) or (B, C, N) stack without waiting
        for the result: the ONE dispatch point. Host input is copied to the
        device asynchronously on the current stream (asynchronous only from
        pinned memory), so the copy and the kernel are ordered on one
        stream. `width` > N launches at that width over zero columns past
        N (a bucketed reconstruct). `donate` is accepted for the
        reference's signature and has no effect: the device copy is freed
        with the result. The mesh backend spreads the columns over its
        devices (`MeshDispatch.apply`)."""
        self._count_dispatch()
        if self.backend == "native":
            return self._apply_native(m, _host_stack(shards, width))
        if self.backend == "xorsched":
            return self._apply_xorsched(m, _host_stack(shards, width))
        if self.backend == "mesh":
            return self._mesh_dispatch().apply(m, _host_stack(shards, width))
        dev, src = self._to_device(shards, width)
        return LazyResult(rs_cuda.apply_matrix(m, dev, self.tile, self.variant), source=src)

    @staticmethod
    def _apply_native(m: np.ndarray, shards: np.ndarray) -> np.ndarray:
        """The AVX2 split-table apply of `utils.native` on all cores: one
        library call, per-element slice pointers for a batched stack.
        Raises where the library is unavailable: no other path serves a
        native encoder."""
        shards = np.ascontiguousarray(shards)
        if shards.shape[-1] == 0:
            return np.zeros(shards.shape[:-2] + (m.shape[0], 0), dtype=np.uint8)
        if shards.ndim == 2:
            outs = native.gf_matrix_apply_native(m, list(shards), shards.shape[1], threads=0)
            out = None if outs is None else np.stack(outs)
        else:
            out = native.gf_matrix_apply_batch_native(m, shards, threads=0)
        if out is None:
            raise RuntimeError("the gf_host library is unavailable: the native backend cannot serve")
        return out

    @staticmethod
    def _apply_xorsched(m: np.ndarray, shards: np.ndarray) -> np.ndarray:
        """The compiled XOR-schedule apply (`ops.xorsched`): the matrix
        lowered once to a bit-plane XOR program (LRU keyed by matrix bytes
        and tile geometry) and replayed over the shard widths by the native
        executor, or by the numpy interpreter where the library is missing."""
        shards = np.ascontiguousarray(shards)
        if shards.ndim == 2:
            out = np.stack(xorsched.apply_matrix(m, list(shards)))
        else:
            out = np.stack([np.stack(xorsched.apply_matrix(m, list(b))) for b in shards])
        xorsched.export_cache_stats()
        return out

    def _to_device(self, shards, width: Optional[int] = None
                   ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(the shards on the encoder's device, `width` columns wide with
        zeros past N when given, and the host tensor the copy reads, which
        the result must hold until it is read; None on the CPU, where the
        shards are used in place unless padded). On the card the zero
        columns are written there: only the N real ones cross the bus."""
        src = _host_tensor(shards)
        n = src.shape[-1]
        pad = width is not None and width != n
        if self.device.type == "cpu":
            if not pad:
                return src, None
            dev = torch.zeros(src.shape[:-1] + (width,), dtype=torch.uint8)
            dev[..., :n] = src
            return dev, None
        if pad:
            full = torch.zeros(src.shape[:-1] + (width,), dtype=torch.uint8, device=self.device)
            dev = full[..., :n]
        else:
            full = dev = torch.empty(src.shape, dtype=torch.uint8, device=self.device)
        sharded.copy_host(dev, src)  # a pinned slot's column slice row by row
        return full, src

    def _apply(self, m: np.ndarray, shards) -> np.ndarray:
        return np.asarray(self._apply_lazy(m, shards))

    # -- public API (reedsolomon.Encoder parity) ----------------------------

    def encode(self, shards: Sequence[np.ndarray]) -> list[np.ndarray]:
        """Data shards -> all `total_shards` arrays (data passed through)."""
        data = np.stack([np.asarray(s, dtype=np.uint8) for s in shards[: self.data_shards]])
        parity = self._apply(self.parity_matrix, data)
        return [data[i] for i in range(self.data_shards)] + [
            parity[i] for i in range(self.parity_shards)
        ]

    def encode_batch(self, data: np.ndarray) -> np.ndarray:
        """(B, data_shards, N) -> (B, total_shards, N), one dispatch."""
        return np.concatenate(
            [np.asarray(data, dtype=np.uint8), np.asarray(self.encode_parity_lazy(data))],
            axis=1,
        )

    def encode_parity_lazy(self, data, donate: bool = False) -> LazyResult:
        """(data_shards, N) -> (parity_shards, N), or the batched (B, ...)
        form, as a lazy result."""
        shape = tuple(data.shape)
        if len(shape) == 2:
            if shape[0] != self.data_shards:
                raise ValueError(f"want ({self.data_shards}, N), got {shape}")
        elif len(shape) != 3 or shape[1] != self.data_shards:
            raise ValueError(f"want (B, {self.data_shards}, N), got {shape}")
        return self._apply_lazy(self.parity_matrix, data, donate=donate)

    # -- delta parity (the small-write / inline-ingest seam) ------------------

    def parity_delta(self, shard_index: int, old_block, new_block) -> np.ndarray:
        """The (parity_shards, n) change to XOR into the stored parity
        columns covering a data shard's changed byte range: the generator
        column of `shard_index` applied to old ^ new through the encoder's
        one dispatch point, so a delta runs the encoder's kernel at (P, 1)
        (`gf8.gf_delta_parity` is the host golden)."""
        if not 0 <= int(shard_index) < self.data_shards:
            raise ValueError(
                f"shard_index {shard_index} out of range 0..{self.data_shards - 1}"
            )
        old = np.asarray(old_block, dtype=np.uint8).ravel()
        new = np.asarray(new_block, dtype=np.uint8).ravel()
        if old.shape != new.shape:
            raise ValueError(
                f"old/new blocks disagree on length: {old.shape} vs {new.shape}"
            )
        col = np.ascontiguousarray(
            self.parity_matrix[:, int(shard_index) : int(shard_index) + 1]
        )  # (P, 1)
        return np.asarray(self._apply_lazy(col, (old ^ new)[None, :]))

    def update_parity(self, parity, shard_index: int, old_block, new_block) -> np.ndarray:
        """The parity of the stripe once data shard `shard_index`'s bytes
        change old -> new, from the stored parity columns `parity`
        ((parity_shards, n), the same byte range as the blocks): byte-exact
        against a re-encode, at O(changed bytes)."""
        parity = np.asarray(parity, dtype=np.uint8)
        old = np.asarray(old_block, dtype=np.uint8).ravel()
        if parity.ndim != 2 or parity.shape[0] != self.parity_shards:
            raise ValueError(f"want ({self.parity_shards}, n) parity, got {parity.shape}")
        if parity.shape[1] != old.size:
            raise ValueError(
                f"parity covers {parity.shape[1]} bytes but the block changes {old.size}"
            )
        return parity ^ self.parity_delta(shard_index, old, new_block)

    def _pick_survivors(self, shards: Sequence[Optional[np.ndarray]]) -> list[int]:
        present = [i for i, s in enumerate(shards) if s is not None]
        if len(present) < self.data_shards:
            raise ValueError(
                f"too few shards to reconstruct: {len(present)} < {self.data_shards}"
            )
        return present[: self.data_shards]

    def reconstruct(
        self,
        shards: Sequence[Optional[np.ndarray]],
        data_only: bool = False,
        wanted: Optional[Sequence[int]] = None,
    ) -> list[np.ndarray]:
        """Fill every None entry (only data entries when `data_only`, only
        `wanted` ids when given) from the first `data_shards` present."""
        shards = list(shards)
        if len(shards) != self.total_shards:
            raise ValueError(f"expected {self.total_shards} entries, got {len(shards)}")
        if wanted is None:
            limit = self.data_shards if data_only else self.total_shards
            wanted = [i for i in range(limit) if shards[i] is None]
        else:
            for w in wanted:
                if not 0 <= w < self.total_shards:
                    raise ValueError(
                        f"wanted shard id {w} out of range 0..{self.total_shards - 1}"
                    )
            wanted = [i for i in wanted if shards[i] is None]
        if not wanted:
            return shards
        survivors = self._pick_survivors(shards)
        m = self.reconstruction_matrix(survivors, wanted)
        stack = np.stack([np.asarray(shards[i], dtype=np.uint8) for i in survivors])
        out = self._apply_bucketed(m, stack)
        for k, w in enumerate(wanted):
            shards[w] = out[k]
        return shards

    def reconstruction_matrix(
        self, survivors: Sequence[int], wanted: Sequence[int]
    ) -> np.ndarray:
        """The fused (len(wanted) x data_shards) decode matrix for one loss
        pattern; stack rows follow `survivors` order."""
        survivors = tuple(int(s) for s in survivors)
        wanted = tuple(int(w) for w in wanted)
        if len(survivors) != self.data_shards or len(set(survivors)) != len(survivors):
            raise ValueError(
                f"survivors must be {self.data_shards} distinct shard ids, got {survivors}"
            )
        if not wanted:
            raise ValueError("wanted must name at least one shard id")
        for i in survivors + wanted:
            if not 0 <= i < self.total_shards:
                raise ValueError(f"shard id {i} out of range 0..{self.total_shards - 1}")
        return _reconstruction_matrix(
            self.matrix_kind, self.data_shards, self.parity_shards, survivors, wanted
        )

    def reconstruct_lazy(
        self, stack, survivors: Sequence[int], wanted: Sequence[int], donate: bool = False
    ) -> LazyResult:
        """(data_shards, N) or (B, data_shards, N) survivor stack ->
        (len(wanted), N) / (B, len(wanted), N) as a lazy result."""
        shape = tuple(stack.shape)
        if len(shape) == 2:
            if shape[0] != self.data_shards:
                raise ValueError(f"want ({self.data_shards}, N), got {shape}")
        elif len(shape) != 3 or shape[1] != self.data_shards:
            raise ValueError(f"want (B, {self.data_shards}, N), got {shape}")
        if self.backend == "mesh":
            # the bulk-repair path rides the distributed formulations (ring
            # or all_to_all over the mesh), not the column-split apply
            self._count_dispatch()
            return self._mesh_dispatch().reconstruct(
                self.reconstruction_matrix(survivors, wanted), stack, donate=donate
            )
        return self._apply_lazy(
            self.reconstruction_matrix(survivors, wanted), stack, donate=donate
        )

    def repair_projection_plan(
        self, survivors: Sequence[int], wanted: Sequence[int]
    ) -> dict[int, np.ndarray]:
        """Shard id -> its (len(wanted),) column of the fused decode matrix:
        the trace-repair plan. A holder of local survivors L ships
        row w = XOR over s in L of plan[s][w] * shard_s, and the XOR of the
        holders' projections is the fused decode of the whole survivor
        stack (GF addition is XOR; the product splits by columns)."""
        m = self.reconstruction_matrix(survivors, wanted)
        return {int(s): np.ascontiguousarray(m[:, i]) for i, s in enumerate(survivors)}

    def project(self, coeffs, stack) -> np.ndarray:
        """Apply an arbitrary (R, C) coefficient matrix to a (C, N) stack ->
        (R, N) ndarray, through this encoder's kernel: a holder's repair
        projection, where C is its local survivor count, not data_shards.
        `gf8.gf_project` is the host golden it equals."""
        return np.asarray(self.project_lazy(coeffs, stack))

    def project_lazy(self, coeffs, stack, donate: bool = False) -> LazyResult:
        """`project` as a lazy result: the trace rebuild's combine (the XOR
        of holder projections is the all-ones row applied to their stack)."""
        coeffs = np.asarray(coeffs, dtype=np.uint8)
        stack = np.asarray(stack, dtype=np.uint8)
        if coeffs.ndim != 2 or stack.ndim != 2:
            raise ValueError(
                f"want (R, C) coeffs and (C, N) stack, got {coeffs.shape} and {stack.shape}"
            )
        if coeffs.shape[1] != stack.shape[0]:
            raise ValueError(f"coeff cols {coeffs.shape[1]} != stack rows {stack.shape[0]}")
        return self._apply_lazy(coeffs, stack, donate=donate)

    def reconstruct_block(self, staging, blocks: Sequence[dict]):
        """Block-diagonal decode of one (max_k, W) staging batch that packs
        several signature groups' survivor columns side by side.

        Block g is a dict with `survivors` and `wanted` (shard ids),
        `col_start` and `width` (its column range, disjoint from the
        others') and an optional `encoder` (its geometry; default self).
        Its survivor rows are staging[:k_g, col_start:col_start + width] and
        its decoded shards land in the same columns of the (max_m, W)
        result, rows [0, len(wanted_g)); the rest is unspecified. The batch
        goes to the device in one copy; each block is one launch of this
        encoder's kernel on a column view of it (so at any byte offset),
        and the result comes back in one copy when it is read. On the mesh
        backend each block is one mesh dispatch of its host columns, and
        the blocks are gathered when the result is read. The host codecs
        return the (max_m, W) ndarray: xorsched runs every block in one
        `xorsched.apply_blocks` pass, each block its own LRU'd program (the
        composite matrix is never compiled), native one call per block."""
        if len(staging.shape) != 2:
            raise ValueError(f"want a 2-D (max_k, W) staging batch, got {tuple(staging.shape)}")
        if not blocks:
            raise ValueError("blocks must name at least one signature group")
        max_k, width_total = staging.shape
        spans = []
        for g, b in enumerate(blocks):
            enc = b.get("encoder") or self
            c0, w = int(b["col_start"]), int(b["width"])
            if w <= 0 or c0 < 0 or c0 + w > width_total:
                raise ValueError(
                    f"block {g} columns [{c0}, {c0 + w}) outside staging width {width_total}"
                )
            if enc.data_shards > max_k:
                raise ValueError(
                    f"block {g} needs {enc.data_shards} survivor rows, staging has {max_k}"
                )
            spans.append((enc.data_shards, enc.reconstruction_matrix(b["survivors"], b["wanted"]),
                          c0, w))
        by_col = sorted(spans, key=lambda s: s[2])
        for (_, _, a0, aw), (_, _, b0, _) in zip(by_col, by_col[1:]):
            if a0 + aw > b0:
                raise ValueError("block column ranges overlap")
        max_m = max(m.shape[0] for _, m, _, _ in spans)
        if self.backend == "xorsched":
            return self._reconstruct_block_xorsched(staging, spans, max_m)
        if self.backend == "native":
            host = np.asarray(staging, dtype=np.uint8)
            out = np.empty((max_m, width_total), dtype=np.uint8)
            for k, m, c0, w in spans:
                out[: m.shape[0], c0 : c0 + w] = self._apply_lazy(m, host[:k, c0 : c0 + w])
            return out
        if self.backend == "mesh":
            host, md, handles = np.asarray(staging, dtype=np.uint8), self._mesh_dispatch(), []
            for k, m, c0, w in spans:
                self._count_dispatch()
                handles.append((m.shape[0], c0, w, md.apply(m, host[:k, c0 : c0 + w])))
            return _HostBlocks((max_m, width_total), handles)
        end = max(c0 + w for _, _, c0, w in spans)
        dev, src = self._to_device(staging[:, :end])
        out = torch.empty((max_m, width_total), dtype=torch.uint8, device=self.device)
        for k, m, c0, w in spans:
            self._count_dispatch()
            out[: m.shape[0], c0 : c0 + w] = rs_cuda.apply_matrix(
                m, dev[:k, c0 : c0 + w], self.tile, self.variant
            )
        return _FusedBlocks(out, src, [(m.shape[0], c0, w) for _, m, c0, w in spans])

    def _reconstruct_block_xorsched(self, staging, spans: Sequence[tuple], max_m: int
                                    ) -> np.ndarray:
        """The stitched path: one native (or interpreter) pass over the flat
        (block, width-tile) task list, each block writing its row slices of
        the fused output in place."""
        self._count_dispatch()
        staging = np.ascontiguousarray(np.asarray(staging, dtype=np.uint8))
        out = np.empty((max_m, staging.shape[1]), dtype=np.uint8)
        progs, ins, outs = [], [], []
        for k, m, c0, w in spans:
            progs.append(xorsched.get_schedule(m))
            ins.append([staging[r, c0 : c0 + w] for r in range(k)])
            outs.append([out[r, c0 : c0 + w] for r in range(m.shape[0])])
        xorsched.apply_blocks(progs, ins, outputs_per_block=outs)
        xorsched.export_cache_stats()
        return out

    def reconstruct_batch(
        self, stack, survivors: Sequence[int], wanted: Sequence[int], bucketed: bool = False
    ) -> np.ndarray:
        """(B, data_shards, N) survivor stack -> (B, len(wanted), N) ndarray.
        `bucketed` pads N to the next of RECONSTRUCT_BUCKETS on the card
        (`_bucket_for`), so degraded reads of odd interval sizes launch a
        few fixed shapes; the pad is sliced off."""
        if len(stack.shape) != 3 or stack.shape[1] != self.data_shards:
            raise ValueError(f"want (B, {self.data_shards}, N), got {tuple(stack.shape)}")
        if bucketed:
            return self._apply_bucketed(self.reconstruction_matrix(survivors, wanted), stack)
        return np.asarray(self.reconstruct_lazy(stack, survivors, wanted))

    def _bucket_for(self, n: int) -> Optional[int]:
        """The bucket an N-column reconstruct pads to: None on the CPU
        (the plain version and the host codecs have no shapes to repeat,
        and padding only adds columns), for N = 0, and past the largest
        bucket."""
        if self.backend in ("torch",) + HOST_CODECS or n == 0:
            return None
        for b in self.RECONSTRUCT_BUCKETS:
            if n <= b:
                return b
        return None

    def _apply_bucketed(self, m: np.ndarray, stack) -> np.ndarray:
        stack = np.asarray(stack, dtype=np.uint8)
        n = stack.shape[-1]
        b = self._bucket_for(n)
        if b is None or b == n:
            return self._apply(m, stack)
        return np.asarray(self._apply_lazy(m, stack, width=b))[..., :n]

    def warm_reconstruct(
        self, wanted_counts: Sequence[int] = (1,), buckets: Optional[Sequence[int]] = None
    ) -> int:
        """Launch each bucketed reconstruct shape once, so the first
        degraded read finds the kernel library loaded and the operand
        cache filled (any matrix of the right shape will do). Returns the
        shapes launched: 0 on the CPU, where there is nothing to warm (an
        xorsched program is compiled at its first dispatch)."""
        if self.backend in ("torch",) + HOST_CODECS:
            return 0
        count = 0
        for rows in wanted_counts:
            m = self.gen_matrix[: max(1, rows), : self.data_shards]
            for b in buckets or self.RECONSTRUCT_BUCKETS:
                self._apply(m, np.zeros((self.data_shards, b), dtype=np.uint8))
                count += 1
        return count

    def warm_decode_matrices(self, local_shards: Sequence[int] = ()) -> int:
        """Build the decode matrices of the serving path's usual loss
        pattern: one shard lost, every other one reachable (survivors are
        picked in id order, so the pattern per lost shard is fixed). Shards
        held locally never need one. Returns the patterns built."""
        count = 0
        for lost in range(self.total_shards):
            if lost in local_shards:
                continue
            survivors = [s for s in range(self.total_shards) if s != lost]
            _reconstruction_matrix(
                self.matrix_kind, self.data_shards, self.parity_shards,
                tuple(survivors[: self.data_shards]), (lost,),
            )
            count += 1
        return count

    def reconstruct_data(self, shards: Sequence[Optional[np.ndarray]]) -> list[np.ndarray]:
        """reedsolomon.ReconstructData: repair only the data shards."""
        return self.reconstruct(shards, data_only=True)

    def verify(self, shards: Sequence[np.ndarray]) -> bool:
        """True iff parity shards match the data shards."""
        if len(shards) != self.total_shards:
            raise ValueError(f"expected {self.total_shards} shards")
        data = np.stack([np.asarray(s, dtype=np.uint8) for s in shards[: self.data_shards]])
        parity = self._apply(self.parity_matrix, data)
        return all(
            np.array_equal(parity[i], np.asarray(shards[self.data_shards + i]))
            for i in range(self.parity_shards)
        )

    def split(self, data) -> list[np.ndarray]:
        """A byte blob as data_shards equal arrays, zero-padded. Empty input
        raises (klauspost's ErrShortData)."""
        if isinstance(data, (bytes, bytearray)):
            buf = np.frombuffer(bytes(data), dtype=np.uint8)
        else:
            buf = np.asarray(data, dtype=np.uint8)
        if len(buf) == 0:
            raise ValueError("short data: cannot split an empty blob")
        per = -(-len(buf) // self.data_shards)
        padded = np.zeros(per * self.data_shards, dtype=np.uint8)
        padded[: len(buf)] = buf
        return list(padded.reshape(self.data_shards, per))

    def join(self, shards: Sequence[np.ndarray], out_size: int) -> bytes:
        return np.concatenate(
            [np.asarray(s, dtype=np.uint8) for s in shards[: self.data_shards]]
        ).tobytes()[:out_size]


# -- on-chip measurement evidence (the kernel-choice input) -------------------


def _artifacts_dir() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "artifacts",
    )


def load_device_evidence(art_dir: Optional[str] = None) -> Optional[dict]:
    """Newest `GPU_MEASUREMENT_r*.json` (lexically latest round), with
    `_file` recording its provenance. None when no readable measurement
    exists; an unreadable newest file does not hide older ones."""
    art_dir = art_dir or _artifacts_dir()
    try:
        names = sorted(
            f for f in os.listdir(art_dir)
            if f.startswith("GPU_MEASUREMENT_") and f.endswith(".json")
        )
    except OSError:
        return None
    for name in reversed(names):
        try:
            with open(os.path.join(art_dir, name), encoding="utf-8") as f:
                ev = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(ev, dict):
            ev["_file"] = name
            return ev
    return None


def _evidence_age_days(ev: dict) -> Optional[float]:
    """Days since the measurement's `when` stamp; None when unparseable."""
    when = str(ev.get("when", ""))
    for fmt in ("%Y-%m-%dT%H:%M:%SZ", "%Y-%m-%dT%H:%MZ", "%Y-%m-%d"):
        try:
            t = datetime.datetime.strptime(when, fmt).replace(tzinfo=datetime.timezone.utc)
        except ValueError:
            continue
        return (datetime.datetime.now(datetime.timezone.utc) - t).total_seconds() / 86400.0
    return None


def parse_fused_variant(label: str) -> tuple[str, Optional[int]]:
    """Map a measurement key / sweep config name to (variant, tile), the
    reference's grammar with `cuda` in the place of `pallas`:
    'cuda-bf16-16384' -> ('bf16', 16384), 'cuda_tile8192_steady_gbps' ->
    ('int8', 8192), 'cuda-auto' / 'cuda_steady_gbps' -> ('int8', None),
    'rebuild-cuda-dma-65536' -> ('dma', 65536)."""
    s = label.replace("_steady_gbps", "").replace("_", "-")
    variant, tile = "int8", None
    for tok in s.split("-"):
        if not tok or tok in ("cuda", "rebuild", "auto"):
            continue
        if tok in FUSED_VARIANTS:
            variant = tok
        else:
            digits = tok[4:] if tok.startswith("tile") else tok
            if digits.isdigit():
                tile = int(digits)
    return variant, tile


def _encode_numbers(ev: dict) -> dict:
    """label -> steady GB/s of every encode-shape number in a measurement:
    the `cuda*_steady_gbps` keys and the assembled sweep table
    (`sweep.encode`). Rebuild-shape numbers never pick the encoder."""
    out = {}
    for k, v in ev.items():
        if k.startswith("cuda") and k.endswith("_steady_gbps") and isinstance(v, (int, float)):
            out[k] = float(v)
    for k, v in ((ev.get("sweep") or {}).get("encode") or {}).items():
        if str(k).startswith("cuda") and isinstance(v, (int, float)):
            out[str(k)] = float(v)
    return out


def _best_fused(ev: dict, c: int, rows: int) -> tuple[Optional[str], float, dict]:
    """Best encode number of any configuration other than the default
    (int8 with its own tile) that an (R x C) encoder can run, its label,
    and {label: why} for the labels naming a tile their kernel does not
    take (`rs_cuda.resolve_tile`), which are skipped."""
    best_label, best, skipped = None, 0.0, {}
    for k, v in _encode_numbers(ev).items():
        variant, tile = parse_fused_variant(k)
        if (variant, tile) == ("int8", None):
            continue
        try:
            rs_cuda.resolve_tile(variant, tile, c, rows)
        except ValueError as e:
            skipped[k] = str(e)
            continue
        if v > best:
            best_label, best = k, v
    return best_label, best, skipped


def _int8_anchor(ev: dict) -> float:
    """The file's own number for the default configuration (int8, tile
    None): what a variant has to beat."""
    nums = [v for k, v in _encode_numbers(ev).items() if parse_fused_variant(k) == ("int8", None)]
    return max(nums, default=0.0)


def pick_device_backend(
    art_dir: Optional[str] = None, data_shards: int = 10, parity_shards: int = 4
) -> tuple[str, dict]:
    """The kernel choice on a card for a (data_shards + parity_shards)
    encoder: (variant, decision).

    The reference flips from XLA to a fused Pallas variant when committed
    on-chip evidence shows the variant beating XLA. The port has no XLA
    path, and its plain version never serves on the card, so the anchor is
    int8 with its own tile, the default: another configuration is chosen
    only when its number in a fresh GPU measurement beats that file's own
    int8 number. A file that is not a GPU measurement naming its card
    (`platform` "gpu", `card` the nvidia-smi name and power limit), whose
    `when` is unparseable or older than EVIDENCE_MAX_AGE_DAYS, or that
    lacks an int8 number, keeps int8. A label whose tile its kernel does
    not take is skipped, as the reference leaves the default in place for
    evidence it cannot use. The decision dict names the file, both
    numbers, the skipped labels and the reason."""
    ev = load_device_evidence(art_dir)
    if ev is None:
        return "int8", {"variant": "int8", "tile": None,
                        "reason": "no committed on-chip measurement evidence"}
    anchor = _int8_anchor(ev)
    label, fused, skipped = _best_fused(ev, data_shards, parity_shards)
    decision: dict = {
        "evidence_file": ev.get("_file"), "variant": "int8", "tile": None,
        "int8_steady_gbps": anchor or None, "fused_steady_gbps": fused or None,
        "fused_variant": label, "card": ev.get("card"),
    }
    if skipped:
        decision["skipped"] = skipped
    age = _evidence_age_days(ev)
    if str(ev.get("platform", "")).lower() != "gpu" or not ev.get("card"):
        decision["reason"] = "evidence is not an on-chip measurement naming its card"
    elif age is None:
        decision["reason"] = f"evidence age unparseable (when={ev.get('when')!r}): treated as stale"
    elif age > EVIDENCE_MAX_AGE_DAYS:
        decision["reason"] = f"evidence stale ({age:.0f}d > {EVIDENCE_MAX_AGE_DAYS:.0f}d)"
    elif not anchor:
        decision["reason"] = "evidence lacks an int8 number to beat"
    elif label is not None and fused > anchor:
        variant, tile = parse_fused_variant(label)
        decision.update(variant=variant, tile=tile,
                        reason=f"committed on-chip {label}={fused} beats int8={anchor}")
        return variant, decision
    else:
        decision["reason"] = f"no variant beats int8={anchor}"
        if skipped:
            decision["reason"] += "; skipped, a tile its kernel does not take: " + ", ".join(sorted(skipped))
    return "int8", decision


# -- committed mesh evidence (the multi-card promotion input) ------------------


def _multichip_dir() -> str:
    """`GPU_MULTICHIP_r*.json` lives beside `GPU_MEASUREMENT_r*.json`."""
    return _artifacts_dir()


def load_mesh_evidence(art_dir: Optional[str] = None) -> Optional[dict]:
    """Newest `GPU_MULTICHIP_r*.json` (lexically latest round), with `_file`
    recording its provenance. None when no readable file exists; an
    unreadable newest file does not hide older ones."""
    art_dir = art_dir or _multichip_dir()
    try:
        names = sorted(
            f for f in os.listdir(art_dir)
            if f.startswith("GPU_MULTICHIP_r") and f.endswith(".json")
        )
    except OSError:
        return None
    for name in reversed(names):
        try:
            with open(os.path.join(art_dir, name), encoding="utf-8") as f:
                ev = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(ev, dict):
            ev["_file"] = name
            return ev
    return None


def _evidence_round(ev: dict) -> Optional[int]:
    r = ev.get("round")
    if isinstance(r, int):
        return r
    digits = "".join(c for c in str(ev.get("_file", "")) if c.isdigit())
    return int(digits) if digits else None


def pick_mesh_backend(n_devices: int, art_dir: Optional[str] = None) -> tuple[bool, dict]:
    """The multi-card promotion decision: a host with more than one card
    moves to the mesh backend ONLY when the newest committed
    `GPU_MULTICHIP_r*.json` is a fresh GPU measurement naming its card
    (`platform` "gpu", `card` the nvidia-smi name and power limit) in which
    an achievable dp x sp shape, byte-verified (`match` true), encodes
    faster than the single-card number beside it. Absent, stale, off-card or
    losing evidence keeps the single-card encoder. The decision names the
    file, its round, the winning shape, its rebuild formulation (ring unless
    all_to_all measured faster) and both numbers."""
    ev = load_mesh_evidence(art_dir)
    if ev is None:
        return False, {"reason": "no committed mesh evidence (GPU_MULTICHIP_r*.json)"}
    decision: dict = {"evidence_file": ev.get("_file"), "evidence_round": _evidence_round(ev)}
    shapes = ev.get("shapes")
    if not isinstance(shapes, dict) or not shapes:
        decision["reason"] = "evidence has no per-mesh-shape measurements"
        return False, decision
    if str(ev.get("platform", "")).lower() != "gpu" or not ev.get("card"):
        decision["reason"] = "mesh evidence is not an on-chip measurement naming its card"
        return False, decision
    age = _evidence_age_days(ev)
    if age is None:
        decision["reason"] = f"mesh evidence age unparseable (when={ev.get('when')!r}): treated as stale"
        return False, decision
    if age > EVIDENCE_MAX_AGE_DAYS:
        decision["reason"] = f"mesh evidence stale ({age:.0f}d > {EVIDENCE_MAX_AGE_DAYS:.0f}d)"
        return False, decision
    single = (ev.get("single_device") or {}).get("encode_gbps")
    single = float(single) if isinstance(single, (int, float)) else 0.0
    best_label, best = None, 0.0
    for label, rec in shapes.items():
        if not isinstance(rec, dict):
            continue
        parts = str(label).lower().split("x")
        if len(parts) != 2 or not all(p.isdigit() and int(p) > 0 for p in parts):
            continue
        if int(parts[0]) * int(parts[1]) > int(n_devices):
            continue  # not achievable on this host
        if rec.get("match") is not True or rec.get("error"):
            continue  # only a shape that completed byte verification counts
        gbps = rec.get("encode_gbps")
        if not isinstance(gbps, (int, float)) or gbps <= 0:
            continue
        if single and gbps <= single:
            continue  # the mesh number must beat the single-card one
        if gbps > best:
            best_label, best = str(label), float(gbps)
    if best_label is None:
        decision["reason"] = (
            "no achievable mesh shape beats the single-device number" if single
            else "no achievable mesh shape with a usable encode measurement"
        )
        return False, decision
    rec = shapes[best_label]
    ring, a2a = rec.get("rebuild_ring_gbps"), rec.get("rebuild_alltoall_gbps")
    variant = "ring"
    if isinstance(a2a, (int, float)) and (not isinstance(ring, (int, float)) or a2a > ring):
        variant = "alltoall"
    decision.update(
        mesh_shape=best_label, mesh_rebuild=variant, encode_gbps=best,
        single_device_gbps=single or None,
        reason=f"committed on-chip mesh evidence: {best_label} encode={best} beats "
               f"single-device {single}",
    )
    return True, decision


# -- committed CPU bench evidence (the xorsched promotion input) ----------------


def _cpu_backend() -> str:
    """Best CPU path: the host codec library ("native") when it builds and
    loads, else the plain version ("torch")."""
    return "native" if native.load_gf() is not None else "torch"


def _host_fingerprint() -> dict:
    """Identity of THIS host for same-host evidence matching: cpu model
    string + logical core count. Hostnames are ephemeral in the fleet;
    the model+cores pair is what decides whether a committed BENCH number
    was measured on silicon equivalent to the one now selecting."""
    model = ""
    try:
        with open("/proc/cpuinfo", encoding="utf-8") as f:
            for line in f:
                if line.lower().startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    if not model:
        import platform

        model = platform.processor() or platform.machine() or ""
    return {"cpu": model, "cores": int(os.cpu_count() or 0)}


def load_cpu_bench_evidence(art_dir: Optional[str] = None) -> Optional[dict]:
    """Newest `BENCH_r*.json` in the port's evidence directory (`art_dir`,
    default `artifacts/`) whose payload carries an `xor` section, unwrapped
    from the round wrapper ({"n", "cmd", "rc", "tail", "parsed"}) when
    present, with `_file` recording provenance. Rounds without an xor
    section are skipped rather than treated as de-promoting evidence. None
    when no readable file carries one; an unreadable newest file does not
    hide older ones."""
    art_dir = art_dir or _artifacts_dir()
    try:
        names = sorted(
            f for f in os.listdir(art_dir) if f.startswith("BENCH_r") and f.endswith(".json")
        )
    except OSError:
        return None
    for name in reversed(names):
        try:
            with open(os.path.join(art_dir, name), encoding="utf-8") as f:
                ev = json.load(f)
        except (OSError, ValueError):
            continue
        if not isinstance(ev, dict):
            continue
        if isinstance(ev.get("parsed"), dict):
            ev = dict(ev["parsed"], n=ev.get("n"))
        if isinstance(ev.get("xor"), dict):
            ev["_file"] = name
            return ev
    return None


def pick_cpu_backend(art_dir: Optional[str] = None) -> tuple[str, dict]:
    """The CPU-floor decision of `backend="auto"` on the CPU: the compiled
    XOR-schedule backend ONLY when a committed `BENCH_r*.json` carries a
    fresh SAME-HOST byte-verified measurement in which xorsched's encode
    beats the native number recorded in the SAME run (both numbers move
    with a shared box's noise together, so the committed ratio is the
    evidence). Absent, stale, other-host, unverified or losing evidence
    keeps `_cpu_backend()`'s pick, and so does a host whose native executor
    cannot be built: the interpreter cannot beat AVX2. The decision dict
    names the evidence file and round, both numbers and the reason; its
    reason strings are the reference's."""
    base = _cpu_backend()
    ev = load_cpu_bench_evidence(art_dir)
    if ev is None:
        return base, {
            "backend": base,
            "reason": "no committed CPU bench evidence with an xor section",
        }
    xor = ev["xor"]
    decision: dict = {"evidence_file": ev.get("_file"), "evidence_round": _evidence_round(ev)}
    age = _evidence_age_days(xor)
    if age is None:
        decision.update(
            backend=base,
            reason=f"xor evidence age unparseable (when={xor.get('when')!r}): treated as stale",
        )
        return base, decision
    if age > EVIDENCE_MAX_AGE_DAYS:
        decision.update(
            backend=base,
            reason=f"xor evidence stale ({age:.0f}d > {EVIDENCE_MAX_AGE_DAYS:.0f}d)",
        )
        return base, decision
    host = xor.get("host") or {}
    here = _host_fingerprint()
    if str(host.get("cpu", "")) != here["cpu"] or int(host.get("cores") or 0) != here["cores"]:
        decision.update(
            backend=base,
            reason=(
                f"evidence measured on a different host "
                f"({host.get('cpu')!r} x{host.get('cores')}): not transferable"
            ),
        )
        return base, decision
    if xor.get("match") is not True:
        # only a run that completed byte verification is evidence: a
        # fast-but-wrong executor must not promote
        decision.update(backend=base, reason="xor evidence did not complete byte-verification")
        return base, decision
    enc = xor.get("encode") or {}
    xs, nat = enc.get("xorsched_gbps"), enc.get("native_gbps")
    decision["xorsched_gbps"] = float(xs) if isinstance(xs, (int, float)) else None
    decision["native_gbps"] = float(nat) if isinstance(nat, (int, float)) else None
    if not isinstance(xs, (int, float)) or not isinstance(nat, (int, float)) or nat <= 0:
        decision.update(
            backend=base, reason="xor evidence lacks a same-run xorsched/native encode pair"
        )
        return base, decision
    if xs <= nat:
        decision.update(
            backend=base,
            reason=f"committed xorsched encode {xs} does not beat same-run native {nat}",
        )
        return base, decision
    if not xorsched.native_available():
        # the reference's reason word for word (the decision dicts compare equal)
        decision.update(
            backend=base,
            reason=(
                "libweedtpu.so lacks weedtpu_xor_schedule_apply "
                "(stale binary: run make -C native): library path keeps serving"
            ),
        )
        return base, decision
    decision.update(
        backend="xorsched",
        reason=f"committed same-host bench: xorsched encode {xs} beats same-run native {nat}",
    )
    return "xorsched", decision


def _card_count() -> int:
    return torch.cuda.device_count()


def new_encoder(
    data_shards: int = 10,
    parity_shards: int = 4,
    matrix_kind: str = "vandermonde",
    family: Optional[str] = None,
    device=None,
    backend: Optional[str] = None,
) -> Encoder:
    """Encoder factory. `family` names a registered geometry and overrides
    the shard counts and matrix kind. `device` defaults to the card: with no
    CUDA device and no explicit device="cpu" this raises rather than carry
    on on the CPU. On a card the kernel variant and tile come from
    `pick_device_backend`; with no evidence they stay int8 with its own
    tile. On a host with more than one card, `pick_mesh_backend` moves the
    encoder to the mesh backend (its shape and rebuild formulation from the
    evidence) when committed GPU_MULTICHIP evidence qualifies; its decision
    is recorded either way. backend="mesh" forces the mesh backend
    (`WEEDTPU_MESH_SHAPE`/`WEEDTPU_MESH_REBUILD`, evidence or the default
    rule); a mesh encoder's mesh is built here, so one that cannot be built
    raises now.

    backend="native" or "xorsched" builds that host codec on the CPU,
    whatever `device` says ("native" raises where its library cannot be
    built). backend="auto" on the CPU (device="cpu", or no device and no
    card) is the reference's CPU-host rule, `pick_cpu_backend`; on a card it
    is the default above. `WEEDTPU_BACKEND`, when set and not empty,
    overrides a caller that names no backend (source
    "env:WEEDTPU_BACKEND"); unlike the reference's, an unset knob keeps the
    port's default, not "auto". No other path reaches a host codec. The
    decision and an audit line land on `enc.selection`."""
    if family is not None:
        geom = geometry_for(family)
        data_shards, parity_shards = geom.data_shards, geom.parity_shards
        matrix_kind = geom.matrix_kind
    source: Optional[str] = None
    if backend is None:
        env = config.env("WEEDTPU_BACKEND").strip().lower()
        if env:
            if env not in ("auto",) + _BACKENDS:
                raise ValueError(f"WEEDTPU_BACKEND={env!r} is not one of {('auto',) + _BACKENDS}")
            backend = env
            source = None if env == "auto" else "env:WEEDTPU_BACKEND"
    if backend in HOST_CODECS or (backend == "torch" and device is None):
        dev = torch.device("cpu")
    elif backend == "auto" and device is None:
        dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    else:
        dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's encoder runs on the card; pass "
            "device='cpu' for the plain version"
        )
    if source is None:
        source = "default" if device is None and backend in (None, "auto") else "explicit"
    decision: dict = {}
    if backend == "auto":
        if dev.type == "cpu":
            backend, decision = pick_cpu_backend()
            source = "cpu-bench-evidence" if decision.get("evidence_file") else "platform"
        else:
            backend = None  # the card's default
    variant, tile = "int8", None
    mesh_dec: Optional[dict] = None
    mesh_kwargs: dict = {}
    if dev.type == "cuda":
        variant, decision = pick_device_backend(data_shards=data_shards, parity_shards=parity_shards)
        tile = decision.get("tile")
        if decision.get("evidence_file"):
            source = "on-chip-evidence"
        n_dev = _card_count()
        if n_dev > 1 and backend is None:
            ok, mesh_dec = pick_mesh_backend(n_dev)
            if ok:
                mesh_kwargs = {
                    "mesh_shape": tuple(int(p) for p in mesh_dec["mesh_shape"].split("x")),
                    "mesh_rebuild": mesh_dec["mesh_rebuild"],
                }
    enc = Encoder(data_shards, parity_shards, matrix_kind=matrix_kind,
                  backend="mesh" if mesh_kwargs else backend, device=dev,
                  variant=variant, tile=tile, **mesh_kwargs)
    selection = dict(decision, **enc.selection)
    selection["source"] = source
    if mesh_dec is not None:
        selection["mesh"] = mesh_dec
        if mesh_kwargs:
            selection.update(source="mesh-evidence", reason=mesh_dec["reason"])
    if enc.backend == "mesh":
        md = enc._mesh_dispatch()
        selection.setdefault("mesh_shape", md.shape_str())
        selection.setdefault("mesh_rebuild", md.rebuild_variant)
        selection["mesh_devices"] = md.n_devices
        selection["audit"] = (
            f"mesh {md.shape_str()} ({md.n_devices} devices, rebuild={md.rebuild_variant}, "
            f"evidence=r{(mesh_dec or {}).get('evidence_round', '-')})"
        )
    enc.selection = selection
    _export_selection(enc.selection)
    return enc


def _export_selection(selection: dict) -> None:
    """Mirror the factory's decision into `weedtpu_ec_backend_selected`:
    the previously selected labels drop to 0, so a scrape shows one
    current backend (under a lock: concurrent factories must not leave two
    label sets at 1)."""
    from seaweedfs_tpu_torch import stats

    global _last_selection_labels
    labels = (str(selection.get("backend", "")), str(selection.get("source", "")))
    with _selection_lock:
        if _last_selection_labels not in (None, labels):
            stats.EcBackendSelected.labels(*_last_selection_labels).set(0)
        stats.EcBackendSelected.labels(*labels).set(1)
        _last_selection_labels = labels


_last_selection_labels: Optional[tuple] = None
_selection_lock = threading.Lock()


def encoder_from_arrays(gen_matrix: np.ndarray, data_shards: int, device=None) -> Encoder:
    """An encoder for the geometry a reference `Encoder.gen_matrix` (as a
    (total, data) uint8 array) describes. The port builds its own matrices;
    this checks they are the reference's, which is the state a codec
    carries across, and raises on any difference."""
    gen = np.asarray(gen_matrix, dtype=np.uint8)
    total = gen.shape[0]
    if gen.ndim != 2 or gen.shape[1] != data_shards or total <= data_shards:
        raise ValueError(f"want a (total, {data_shards}) generator, got {gen.shape}")
    for kind in ("vandermonde", "cauchy"):
        if np.array_equal(gf8.generator_matrix(kind, data_shards, total), gen):
            return new_encoder(data_shards, total - data_shards, kind, device=device)
    raise ValueError("generator matrix matches no construction this port builds")
