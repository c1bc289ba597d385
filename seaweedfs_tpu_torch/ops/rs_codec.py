"""Reed-Solomon codec facade: the `reedsolomon.Encoder`-shaped seam.

Two backends, fixed by the device the encoder lives on:

  * "cuda":  the hand-written kernels (`rs_cuda`); the only backend of an
    encoder on a CUDA device, and the default (`new_encoder()` runs on the
    card and raises when there is none).
  * "torch": the plain PyTorch versions (`rs_torch`), only with device="cpu".

Either way an encoder carries a kernel variant (`FUSED_VARIANTS`) and a
tile, the counterparts of the reference's `pallas_mxu`/`pallas_tile`;
`new_encoder` on a card picks them from committed on-chip evidence
(`pick_device_backend`), int8 with its own tile when there is none.

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

from seaweedfs_tpu_torch.ops import gf8, rs_cuda
from seaweedfs_tpu_torch.utils import config

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


class _FusedBlocks(LazyResult):
    """The lazy (max_m, W) result of `Encoder.reconstruct_block`: one launch
    per block has written its decoded rows into one device buffer, read
    back by one copy at `np.asarray`. Rows past a block's own wanted count
    inside its columns, and columns no block covers, are unspecified.
    `parts` lists each block's (rows, col_start, width)."""

    def __init__(self, out: torch.Tensor, source: Optional[torch.Tensor], parts: list):
        super().__init__(out, source)
        self.parts = parts


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
    All shards in one call share a length; striping and padding live a
    layer up in `ec.stripe`."""

    #: staging-width multiple the streaming pipelines round spans to
    width_align = 1

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
        device="cuda",
        variant: str = "int8",
        tile: Optional[int] = None,
    ):
        if data_shards <= 0 or parity_shards <= 0:
            raise ValueError("shard counts must be positive")
        if data_shards + parity_shards > 256:
            raise ValueError("GF(2^8) supports at most 256 total shards")
        self.device = torch.device(device)
        want = "cuda" if self.device.type == "cuda" else "torch"
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        if backend is not None and backend != want:
            raise ValueError(
                f"backend {backend!r} does not run on {self.device} (want {want!r})"
            )
        if variant not in FUSED_VARIANTS:
            raise ValueError(f"unknown variant {variant!r} (want one of {FUSED_VARIANTS})")
        if want == "cuda":  # every matrix dispatched has C = data_shards
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
        self.gen_matrix = gf8.generator_matrix(matrix_kind, data_shards, self.total_shards)
        self.parity_matrix = np.ascontiguousarray(self.gen_matrix[data_shards:])

    # -- kernel dispatch ----------------------------------------------------

    def _apply_lazy(self, m: np.ndarray, shards, donate: bool = False,
                    width: Optional[int] = None) -> LazyResult:
        """Apply GF matrix m to a (C, N) or (B, C, N) stack without waiting
        for the result: the ONE dispatch point. Host input is copied to the
        device asynchronously on the current stream (asynchronous only from
        pinned memory), so the copy and the kernel are ordered on one
        stream. `width` > N launches at that width over zero columns past
        N (a bucketed reconstruct). `donate` is accepted for the
        reference's signature and has no effect: the device copy is freed
        with the result."""
        dev, src = self._to_device(shards, width)
        return LazyResult(rs_cuda.apply_matrix(m, dev, self.tile, self.variant), source=src)

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
        if src.ndim == 2 and not src.is_contiguous() and src.stride(1) == 1:
            # a column slice of a staging slot: row by row, each row a
            # contiguous run of the (pinned) slot, so every copy stays
            # asynchronous; as one copy it would go through a pageable
            # temporary, which waits for the stream
            for i in range(src.shape[0]):
                dev[i].copy_(src[i], non_blocking=True)
        else:
            dev.copy_(src, non_blocking=True)
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

    def reconstruct_block(self, staging, blocks: Sequence[dict]) -> _FusedBlocks:
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
        and the result comes back in one copy when it is read."""
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
        end = max(c0 + w for _, _, c0, w in spans)
        dev, src = self._to_device(staging[:, :end])
        out = torch.empty((max_m, width_total), dtype=torch.uint8, device=self.device)
        for k, m, c0, w in spans:
            out[: m.shape[0], c0 : c0 + w] = rs_cuda.apply_matrix(
                m, dev[:k, c0 : c0 + w], self.tile, self.variant
            )
        return _FusedBlocks(out, src, [(m.shape[0], c0, w) for _, m, c0, w in spans])

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
        (the plain version has no shapes to repeat, and padding only adds
        columns), for N = 0, and past the largest bucket."""
        if self.backend == "torch" or n == 0:
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
        shapes launched: 0 on the CPU, where there is nothing to warm."""
        if self.backend == "torch":
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


def new_encoder(
    data_shards: int = 10,
    parity_shards: int = 4,
    matrix_kind: str = "vandermonde",
    family: Optional[str] = None,
    device=None,
) -> Encoder:
    """Encoder factory. `family` names a registered geometry and overrides
    the shard counts and matrix kind. `device` defaults to the card: with no
    CUDA device and no explicit device="cpu" this raises rather than carry
    on on the CPU. On a card the kernel variant and tile come from
    `pick_device_backend`; with no evidence they stay int8 with its own
    tile. The decision lands on `enc.selection`."""
    if family is not None:
        geom = geometry_for(family)
        data_shards, parity_shards = geom.data_shards, geom.parity_shards
        matrix_kind = geom.matrix_kind
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's encoder runs on the card; pass "
            "device='cpu' for the plain version"
        )
    decision: dict = {}
    variant, tile = "int8", None
    if dev.type == "cuda":
        variant, decision = pick_device_backend(data_shards=data_shards, parity_shards=parity_shards)
        tile = decision.get("tile")
    enc = Encoder(data_shards, parity_shards, matrix_kind=matrix_kind, device=dev,
                  variant=variant, tile=tile)
    source = "default" if device is None else "explicit"
    if decision.get("evidence_file"):
        source = "on-chip-evidence"
    enc.selection = dict(decision, backend=enc.backend, device=str(dev), variant=variant,
                         tile=tile, source=source)
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
