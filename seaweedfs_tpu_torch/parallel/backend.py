"""Mesh dispatch: the adapter between the flat (shards, width) forms the
streaming pipelines in `ec/stripe` dispatch and the dp x sp formulations
in `parallel/sharded` and `parallel/ring` (the counterpart of the
reference's `seaweedfs_tpu/parallel/backend.py`).

The pipelines stage every batch as ONE wide (shards, W) host slab; the GF
apply is column-independent, so W is the batch axis laid out flat.
`MeshDispatch` shards it:

  * encode / generic apply: `sharded.make_matrix_apply_fn`: W splits over
    the FULL device set (no communication), so each card receives its
    column tile of the staging batch and runs one launch on it;
  * distributed rebuild: the flat (S, W) survivor stack is viewed as dp
    column-slice "volumes" of width W/dp, placed SHARD-major and rebuilt
    by `ring.make_ring_rebuild_fn` or `sharded.make_distributed_rebuild_fn`
    (one all_to_all flip), chosen by `WEEDTPU_MESH_REBUILD`.

A column partition never changes an output byte (zero pad columns map to
zero columns and are cut off before the host sees them), so every mesh
path is byte-identical to the single-device encoder. One dispatch over k
mesh positions launches k kernels (the ring: k x sp); `rs_cuda` counts
each launch, by device too.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from seaweedfs_tpu_torch.parallel import mesh as mesh_mod
from seaweedfs_tpu_torch.parallel import ring as ring_mod
from seaweedfs_tpu_torch.parallel import sharded
from seaweedfs_tpu_torch.utils import config

REBUILD_VARIANTS = ("ring", "alltoall")

#: cap on cached dispatch functions per MeshDispatch: decode matrices churn
#: with loss patterns on a long-lived server, so the cache evicts
_COMPILED_CACHE_CAP = 64


def parse_mesh_shape(raw: str) -> Optional[Tuple[int, int]]:
    """`"4x2"` -> (4, 2); empty/`auto` -> None (resolve elsewhere).
    Malformed values raise: a typo'd shape must fail loudly, not fall back
    to a different mesh than the operator asked for."""
    s = str(raw or "").strip().lower()
    if not s or s == "auto":
        return None
    parts = s.split("x")
    if len(parts) != 2 or not all(p.isdigit() and int(p) > 0 for p in parts):
        raise ValueError(
            f"WEEDTPU_MESH_SHAPE must be `DPxSP` (e.g. 4x2) or auto, got {raw!r}"
        )
    return int(parts[0]), int(parts[1])


def default_mesh_shape(n_devices: int) -> Tuple[int, int]:
    """The dry run's rule: (n/2 x 2) dp x sp for n >= 4, else (n x 1); sp=2
    keeps the ring/all_to_all collectives exercised while dp takes the bulk
    of the batch parallelism."""
    n = max(1, int(n_devices))
    if n >= 4:
        return n // 2, 2
    return n, 1


def _evidence_shape(n_devices: int) -> Optional[Tuple[int, int]]:
    """Best achievable mesh shape from committed GPU_MULTICHIP evidence, or
    None (an unreadable file is no preference)."""
    from seaweedfs_tpu_torch.ops import rs_codec

    try:
        ok, dec = rs_codec.pick_mesh_backend(n_devices)
    except (OSError, ValueError, TypeError, KeyError):
        return None
    return parse_mesh_shape(dec["mesh_shape"]) if ok else None


def resolve_shape(n_devices: int, shape: Optional[Sequence[int]] = None) -> Tuple[int, int]:
    """The dp x sp shape a mesh over `n_devices` takes: `shape`, else
    `WEEDTPU_MESH_SHAPE`, else committed evidence, else the default rule."""
    if shape is None:
        shape = parse_mesh_shape(config.env("WEEDTPU_MESH_SHAPE"))
    if shape is None:
        shape = _evidence_shape(n_devices) or default_mesh_shape(n_devices)
    return int(shape[0]), int(shape[1])


class _LazyRestore:
    """An inflight mesh dispatch whose host form differs from the device
    layout: `np.asarray(handle)` (the pipelines' sync point) gathers the
    sharded output and restores the flat column layout."""

    def __init__(self, dev: sharded.ShardedTensor, restore, shape):
        self._dev = dev
        self._restore = restore
        #: host-facing shape (pad cut off): what np.asarray returns
        self.shape = tuple(shape)

    def __array__(self, dtype=None, copy=None):  # noqa: ARG002 — numpy 2.x kw
        out = self._restore(np.asarray(self._dev))
        if dtype is not None and np.dtype(dtype) != out.dtype:
            out = out.astype(dtype)
        return out


class MeshDispatch:
    """One encoder's mesh state: the `Mesh`, the dispatch functions (cached
    per GF matrix), and the padding rules that keep every dispatch
    byte-identical to the single-device path. `devices` defaults to every
    card of the host; a list may name one device several times. Each
    position's launch runs `variant`'s kernel with `tile`."""

    def __init__(
        self,
        shape: Optional[Sequence[int]] = None,
        rebuild: Optional[str] = None,
        devices=None,
        variant: str = "int8",
        tile: Optional[int] = None,
    ):
        devices = [torch.device(d) for d in
                   (devices if devices is not None else mesh_mod.local_devices())]
        n = len(devices)
        dp, sp = resolve_shape(n, shape)
        if dp <= 0 or sp <= 0 or dp * sp > n:
            raise ValueError(f"mesh shape {dp}x{sp} needs {dp * sp} devices, have {n}")
        self.mesh = mesh_mod.device_mesh(("dp", "sp"), shape=(dp, sp), devices=devices)
        self.dp, self.sp = dp, sp
        self.n_devices = dp * sp
        rebuild = rebuild or config.env("WEEDTPU_MESH_REBUILD")
        if rebuild not in REBUILD_VARIANTS:
            raise ValueError(f"mesh rebuild variant {rebuild!r} not in {REBUILD_VARIANTS}")
        self.rebuild_variant = rebuild
        self.variant, self.tile = variant, tile
        #: staging-width alignment: widths that are a multiple of dp*sp shard
        #: with no padding (the streaming pipelines round their spans to it)
        self.width_align = dp * sp
        self._col_spec = (None, ("dp", "sp"))
        self._apply_fns: dict = {}
        self._rebuild_fns: dict = {}
        self._lock = threading.Lock()
        from seaweedfs_tpu_torch import stats

        stats.EcMeshDevices.set(self.n_devices)

    def shape_str(self) -> str:
        return f"{self.dp}x{self.sp}"

    # -- cached dispatch functions --------------------------------------------

    @staticmethod
    def _cache_get(cache: dict, key, build):
        """Bounded memo: hits move to the end, the oldest entry past
        _COMPILED_CACHE_CAP goes. Caller holds the dispatch lock."""
        fn = cache.pop(key, None)
        if fn is None:
            fn = build()
            while len(cache) >= _COMPILED_CACHE_CAP:
                cache.pop(next(iter(cache)))
        cache[key] = fn
        return fn

    def _apply_fn(self, m: np.ndarray):
        key = (m.shape, m.tobytes())
        with self._lock:
            return self._cache_get(
                self._apply_fns, key,
                lambda: sharded.make_matrix_apply_fn(self.mesh, m, variant=self.variant,
                                                     tile=self.tile),
            )

    def _rebuild_fn(self, recon_m: np.ndarray):
        key = (recon_m.shape, recon_m.tobytes(), self.rebuild_variant)
        make = (ring_mod.make_ring_rebuild_fn if self.rebuild_variant == "ring"
                else sharded.make_distributed_rebuild_fn)
        with self._lock:
            return self._cache_get(
                self._rebuild_fns, key,
                lambda: make(self.mesh, recon_m, variant=self.variant, tile=self.tile),
            )

    # -- layout helpers -------------------------------------------------------

    @staticmethod
    def _pad_cols(flat: np.ndarray, align: int) -> tuple[np.ndarray, int]:
        """Zero-pad the column axis to a multiple of `align` (exact; the pad
        is cut off on restore). Aligned inputs pass through untouched: the
        pipelines stage aligned widths, so this is the tail-batch and
        serving-path case only."""
        w = flat.shape[-1]
        pad = -w % align
        if pad == 0:
            return flat, w
        out = np.zeros(flat.shape[:-1] + (w + pad,), dtype=np.uint8)
        out[..., :w] = flat
        return out, w

    @staticmethod
    def _flatten_batch(shards: np.ndarray) -> tuple[np.ndarray, tuple]:
        """(B, C, N) -> (C, B*N): per-batch products ARE the column-wise
        concatenation, so the batched apply is the flat apply."""
        b, c, n = shards.shape
        return np.ascontiguousarray(np.moveaxis(shards, 0, 1)).reshape(c, b * n), (b, n)

    # -- dispatches -----------------------------------------------------------

    def apply(self, m: np.ndarray, shards, donate: bool = False):  # noqa: ARG002
        """Generic mesh apply: (C, W) -> lazy (R, W), or (B, C, N) -> lazy
        (B, R, N). Columns split over the full device set, so every card
        receives its slice of the host slab and computes its own tile.
        `donate` is accepted for the reference's signature."""
        m = np.ascontiguousarray(np.asarray(m, dtype=np.uint8))
        shards = np.asarray(shards, dtype=np.uint8)
        batched = shards.ndim == 3
        if batched:
            flat, (b, n) = self._flatten_batch(shards)
        else:
            flat = shards
        padded, w = self._pad_cols(flat, self.width_align)
        out = self._apply_fn(m)(sharded.place(self.mesh, padded, self._col_spec))
        r = m.shape[0]
        if batched:
            def restore(a, r=r, b=b, n=n):
                return np.ascontiguousarray(np.moveaxis(a[:, : b * n].reshape(r, b, n), 1, 0))

            shape = (b, r, n)
        else:
            def restore(a, w=w):
                return a[:, :w]

            shape = (r, w)
        return _LazyRestore(out, restore, shape)

    def reconstruct(self, recon_m: np.ndarray, stack, donate: bool = False):  # noqa: ARG002
        """Distributed rebuild of a flat survivor stack: (S, W) -> lazy
        (L, W) (or (B, S, N) -> lazy (B, L, N)) through the selected ring or
        all_to_all formulation. The byte axis is viewed as dp column-slice
        volumes of width W/dp placed SHARD-major (each card holds whole
        survivor rows of its slice); the collective does the layout work and
        the output comes back byte-split over sp."""
        recon_m = np.ascontiguousarray(np.asarray(recon_m, dtype=np.uint8))
        stack = np.asarray(stack, dtype=np.uint8)
        batched = stack.ndim == 3
        if batched:
            flat, (b, n) = self._flatten_batch(stack)
        else:
            flat = stack
        # W/dp must itself divide over sp, so align the flat width to dp*sp
        padded, w = self._pad_cols(flat, self.dp * self.sp)
        s, wp = padded.shape
        wd = wp // self.dp
        # (S, dp, wd) -> (dp, S, wd): volume k holds byte columns
        # [k*wd, (k+1)*wd) of every survivor, a pure column partition
        surv = padded.reshape(s, self.dp, wd).transpose(1, 0, 2)
        out = self._rebuild_fn(recon_m)(surv)  # (dp, L, wd) on the mesh
        rows = recon_m.shape[0]
        if batched:
            def restore(a, rows=rows, wp=wp, b=b, n=n):
                flat_out = a.transpose(1, 0, 2).reshape(rows, wp)[:, : b * n]
                return np.ascontiguousarray(np.moveaxis(flat_out.reshape(rows, b, n), 1, 0))

            shape = (b, rows, n)
        else:
            def restore(a, rows=rows, wp=wp, w=w):
                return np.ascontiguousarray(a.transpose(1, 0, 2).reshape(rows, wp)[:, :w])

            shape = (rows, w)
        return _LazyRestore(out, restore, shape)
