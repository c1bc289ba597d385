"""GF(2^8) matrix application through the hand-written CUDA kernels in
`csrc/`, one per variant of the reference's fused Pallas family
(`rs_pallas.VARIANTS`):

  int8    `gf_bitplane.cu`  AND-popc MMA, transposed: bits x lift (`_kernel`)
  bf16    `gf_bf16.cu`      bf16 MMA, transposed: bits x lift (`_kernel_bf16`)
  u8      `gf_mma.cu`       int8 MMA, transposed, over the plane-major 0/1 stack (`_kernel_u8`)
  mplane  `gf_mma.cu`       int8 MMA, transposed, one K step per plane (`_kernel_mplane`)
  dma     `gf_dma.cu`       int8 arithmetic fed by a cp.async ring (`_make_dma_kernel`)

`apply_matrix(m, shards, tile, variant)` takes a CPU tensor to the
variant's plain version (`rs_torch`) and a CUDA tensor to its kernel;
nothing else. `tile` is the byte columns one block covers (the
reference's `pallas_tile`), walked by a loop inside the block.

Operand layout. The reference feeds its kernel the plane-major lift
(`plane_major_matrix`): input bit j of byte-row ci at column j*C + ci,
output bit i of row r at row i*R + r. The popc kernel (dma) reads each
column's bits in byte order (bit 8*ci + j is bit j of row ci, the order
in which the bytes of one column pack into uint32 words), so the wrapper
re-packs the plane-major lift into per-output-bit masks (`kernel_masks`).
The int8 kernel takes the same masks as the 1-bit B operand of its
transposed tensor-core product, in fragment order (`lift_fragments`); the
bf16 kernel takes them as bf16 1.0/0.0 B fragments of its transposed
product (`bf16_fragments`); u8 and mplane take it as 0/1 int8 B fragments
of their transposed products (`s8_fragments`). Each is uploaded once per
matrix and device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from seaweedfs_tpu_torch.ops import _build, gf8, rs_torch

#: the kernels' limits on the matrix shape (R x C)
MAX_ROWS = 32
MAX_COLS = 32
#: most batch elements one launch covers (grid y)
MAX_BATCH = 65535

#: byte columns one block of 128 threads covers per trip of its loop
SPAN = 2048
#: shared memory one block may use on an H100 (bytes)
SMEM_PER_SM = 232448
#: snap grid for tiles, the reference's (`rs_pallas._TILE_STEPS`)
_TILE_STEPS = (65536, 49152, 32768, 24576, 16384, 8192, 4096, 2048, 1024, 512, 256, 128)
#: most byte columns of one stage of the dma variant's ring
DMA_CHUNK = 2048

#: kernel launches made by `apply_matrix` in this process, in all and by
#: variant; a run sets them to 0 and reads them back to show which path
#: its work went through
launches = 0
launches_by_variant: dict[str, int] = {}


def _dma_chunk(tile: int) -> int:
    """Largest chunk <= DMA_CHUNK dividing the tile (tiles are multiples
    of 128, so 128 is the floor), as the reference's `_dma_chunk`."""
    for ch in (DMA_CHUNK, 1024, 512, 256, 128):
        if ch <= tile and tile % ch == 0:
            return ch
    return 128


def s8_steps(variant: str, c: int) -> int:
    """K steps of 32 of the u8 (the stack, ceil(C/4)) and mplane (one per
    plane, 8) products."""
    return -(-c // 4) if variant == "u8" else 8


def smem_bytes(variant: str, c: int, rows: int) -> int:
    """Shared memory one block of `variant` uses for an (R x C) matrix."""
    nw = -(-c // 4)
    if variant == "dma":
        return 32 * rows * nw + 2 * c * DMA_CHUNK
    tiles = nw * (SPAN + 8) * 4 + rows * (SPAN + 16)  # column words, output tile
    padded = -(-rows // 4) * 4  # whole groups of 4 output rows
    if variant == "int8":  # lift fragments unless in registers (R <= 4)
        return tiles + (0 if rows <= 4 else 256 * padded)
    if variant == "bf16":  # B image on wgmma (R <= 4)
        return tiles + (2 * nw * rows * 256 if rows <= 4 else 0)
    # u8, mplane: B fragments unless in registers (R <= 4)
    return tiles + (0 if rows <= 4 else 256 * s8_steps(variant, c) * padded)


def auto_tile(c: int, rows: int, variant: str = "int8") -> int:
    """The tile of `tile=None`, re-derived from the shared memory each
    variant's block uses (the reference plans against its VMEM budget).

    The tensor-core kernels (int8, bf16, u8, mplane) cover SPAN columns per
    block (one trip): their only per-block staging is the lift fragments
    (in registers on the main path; bf16: the B image, a few KB), and many
    small blocks keep the card fuller than few long ones (`PERF.md` §6:
    bf16, u8 and mplane timed at 2048 and 8192). dma stages its masks and
    ring in shared memory: a block walks as many DMA_CHUNK trips as blocks
    of its size fit one SM, at least two for the ring to overlap, so that
    staging is amortised; snapped down to `_TILE_STEPS`."""
    if variant != "dma":
        return SPAN
    per_sm = max(1, min(8, SMEM_PER_SM // smem_bytes(variant, c, rows)))
    cap = DMA_CHUNK * max(per_sm, 2)
    for t in _TILE_STEPS:
        if t <= cap and t % DMA_CHUNK == 0:
            return t
    return DMA_CHUNK


def _plane_major_columns(b_bits: np.ndarray) -> np.ndarray:
    """Permute a byte-major lift's columns (ci*8 + j) to plane-major
    (j*C + ci), and its rows (r*8 + i) to plane-major (i*R + r)."""
    rows8, cols8 = b_bits.shape
    c = cols8 // 8
    r = rows8 // 8
    col_perm = [(k % c) * 8 + (k // c) for k in range(cols8)]
    row_perm = [(k % r) * 8 + (k // r) for k in range(rows8)]
    return np.asarray(b_bits)[np.ix_(row_perm, col_perm)]


@functools.lru_cache(maxsize=256)
def _plane_major(key: tuple) -> torch.Tensor:
    rows, cols, flat = key
    m = np.frombuffer(flat, dtype=np.uint8).reshape(rows, cols)
    return lift_from_reference(gf8.gf_matrix_to_bits(m))


def _key(m: np.ndarray) -> tuple:
    a = np.ascontiguousarray(m, dtype=np.uint8)
    return (a.shape[0], a.shape[1], a.tobytes())


def plane_major_matrix(m: np.ndarray) -> torch.Tensor:
    """The (8R, 8C) int8 plane-major lift of a GF(2^8) matrix (CPU), cached
    by value."""
    return _plane_major(_key(m))


def lift_from_reference(b_bits: np.ndarray) -> torch.Tensor:
    """The reference's byte-major lift (`rs_jax.lifted_matrix(m)` as numpy,
    or `gf8.gf_matrix_to_bits(m)`) as the port's plane-major operand."""
    b = np.asarray(b_bits, dtype=np.int8)
    if b.ndim != 2 or b.shape[0] % 8 or b.shape[1] % 8:
        raise ValueError(f"want an (8R, 8C) lift, got shape {b.shape}")
    return torch.from_numpy(np.ascontiguousarray(_plane_major_columns(b)))


def kernel_masks(pm: torch.Tensor) -> np.ndarray:
    """Re-pack a plane-major lift into the kernel's mask operand: uint32
    [(r*8 + i) * NW + w], NW = ceil(C/4), whose bit 8*(ci % 4) + j of word
    w = ci // 4 is set iff lift row i*R + r has a 1 at column j*C + ci."""
    p = pm.numpy().astype(bool)
    rows8, cols8 = p.shape
    r_n, c_n = rows8 // 8, cols8 // 8
    nw = -(-c_n // 4)
    bit = np.zeros((r_n, 8, nw * 32), dtype=bool)  # [r, i, 8*ci + j]
    for r in range(r_n):
        for i in range(8):
            row = p[i * r_n + r].reshape(8, c_n)  # [j, ci]
            bit[r, i, : 8 * c_n] = row.T.reshape(-1)  # [ci, j] -> 8*ci + j
    words = np.packbits(bit.reshape(-1, 8), axis=1, bitorder="little").reshape(-1, 4)
    return words.view("<u4").reshape(-1).astype(np.uint32)


def lift_fragments(pm: torch.Tensor) -> np.ndarray:
    """The int8 kernel's B operand (`gf_bitplane.cu`): the lift as popc
    masks in the fragment order of mma.m16n8k256's 1-bit B, uint32 (R, 32,
    2).

    The kernel computes out^T = bits^T . lift^T with K = the column's
    8C-bit vector in column-word order (word w, bit 8q + p = plane p of
    input row 4w + q, as `kernel_masks`) and n8 tile r = output row r,
    column i = its bit i. Entry [r, lane, h] is B register b_h of lane =
    4g + t: K bits 128h + 32t .. + 31, that is mask word 4h + t of output
    bit (r, i = g) (`kernel_masks`), 0 past NW = ceil(C/4)."""
    r_n = pm.shape[0] // 8
    nw = -(-(pm.shape[1] // 8) // 4)
    words = np.zeros((r_n, 8, 8), dtype=np.uint32)  # [r, i, mask word]
    words[..., :nw] = kernel_masks(pm).reshape(r_n, 8, nw)
    # word 4h + t of bit g  ->  [r, g, t, h]
    return np.ascontiguousarray(words.reshape(r_n, 8, 2, 4).transpose(0, 1, 3, 2)).reshape(r_n, 32, 2)


#: bf16 1.0, the lift's entries in the bf16 kernel's B operand
BF16_ONE = 0x3F80


def bf16_fragments(pm: torch.Tensor) -> np.ndarray:
    """The bf16 kernel's B operand (`gf_bf16.cu`): the lift as bf16 1.0/0.0
    in the fragment order of mma.m16n8k16's B, uint32 (R, 2*NW, 32, 2), NW =
    ceil(C/4).

    The kernel computes out^T = bits^T . lift^T with n8 tile r = output row
    r (column i = its bit i) and K in column-word order with the kernel's
    byte order (`kRowPairs`): word w, bit 8*slot + p = plane p of input row
    4w + (0, 2, 1, 3)[slot]. K values come in pairs: K step s = 2w + h
    holds the 16 bits of word w at pair index b = 8h + 4*reg + t (bits b and
    b + 16: rows 4w + 2h and 4w + 2h + 1). Entry [r, s, lane, reg] is B
    register b_reg of lane = 4g + t: its low half is B[2t + 8*reg][g], the
    lift's entry for word-bit b into output bit (r, i = g); its high half
    B[2t + 8*reg + 1][g] the entry for word-bit b + 16. The A operand the
    kernel builds from a column word puts the same two bits in the same
    halves, as bf16 2.0, by one rotation (14 - b) and an AND with
    0x40004000. Step 2*NW - 1 is all zero when C % 4 is 1 or 2 (rows past
    C), and the kernel skips it."""
    r_n = pm.shape[0] // 8
    nw = -(-(pm.shape[1] // 8) // 4)
    masks = kernel_masks(pm).reshape(r_n, 8, nw)  # [r, i, w], byte q = row 4w + q
    masks = (masks & 0xFF0000FF) | ((masks & 0x0000FF00) << 8) | ((masks & 0x00FF0000) >> 8)
    masks = masks.astype(np.uint64)
    s = np.arange(2 * nw)
    g, t = np.divmod(np.arange(32), 4)
    reg = np.arange(2)
    w, h = s // 2, s % 2
    b = 8 * h[:, None, None] + 4 * reg[None, None, :] + t[None, :, None]  # [s, lane, reg]
    word = masks[:, g[None, :, None], w[:, None, None]]  # [r, s, lane, reg]
    lo = (word >> b.astype(np.uint64)) & 1
    hi = (word >> (b + 16).astype(np.uint64)) & 1
    return ((lo | (hi << 16)) * BF16_ONE).astype(np.uint32)


def s8_fragments(pm: torch.Tensor, variant: str) -> np.ndarray:
    """The u8 and mplane kernels' B operand (`gf_mma.cu`): the lift as 0/1
    bytes in the fragment order of mma.m16n8k32's int8 B, uint32 (R, S, 32,
    2), S = `s8_steps`.

    The kernels compute out^T = bits^T . lift^T with n8 tile r = output row
    r (column i = its bit i) and K in steps of 32 bytes. Entry [r, s, lane,
    h] is B register b_h of lane = 4g + t: K bytes 16h + 4t + e, e = 0..3,
    of step s, each the lift's entry for one input bit into output bit (r,
    i = g). Which input bit K byte 16h + 4t + e of step s is:
      u8      bit j of input row 4w + e, (j, w) = divmod(8s + 4h + t, NW):
              the plane-major stack, each plane padded to 4*NW rows;
      mplane  bit s of input row 16h + 4t + e: one step per plane, K = C
              rows padded to 32.
    Rows past C are zero, so the padding adds nothing to any sum."""
    p = pm.numpy().astype(np.uint32)
    r_n, c_n = p.shape[0] // 8, p.shape[1] // 8
    nw = -(-c_n // 4)
    # lift[r, i, ci, j]: input bit j of row ci into output bit i of row r
    lift = np.zeros((r_n, 8, 32, 8), dtype=np.uint32)
    lift[:, :, :c_n, :] = p.reshape(8, r_n, 8, c_n).transpose(1, 0, 3, 2)
    steps = s8_steps(variant, c_n)
    s, g, t, h, e = np.ix_(np.arange(steps), np.arange(8), np.arange(4), np.arange(2), np.arange(4))
    if variant == "u8":
        j, w = np.divmod(8 * s + 4 * h + t, nw)
        row, plane = 4 * w + e, j
    else:
        row, plane = 16 * h + 4 * t + e, s
    b = lift[:, g, row, plane] << (8 * e).astype(np.uint32)  # [r, s, g, t, h, e]
    return np.ascontiguousarray(b.sum(axis=-1, dtype=np.uint32).reshape(r_n, steps, 32, 2))


#: variant -> (library, C entry point, operand), in FUSED_VARIANTS order
KERNELS = {
    "int8": ("gf_bitplane", "gf_bitplane_apply", "frags"),
    "bf16": ("gf_bf16", "gf_bf16_apply", "bf16"),
    "u8": ("gf_mma", "gf_u8_apply", "s8"),
    "mplane": ("gf_mma", "gf_mplane_apply", "s8"),
    "dma": ("gf_dma", "gf_dma_apply", "masks"),
}


@functools.lru_cache(maxsize=256)
def _device_operand(key: tuple, variant: str, device: str) -> torch.Tensor:
    pm = _plane_major(key)
    kind = KERNELS[variant][2]
    if kind == "masks":
        host = kernel_masks(pm)
    elif kind == "frags":
        host = lift_fragments(pm)
    elif kind == "bf16":
        host = bf16_fragments(pm)
    else:
        host = s8_fragments(pm, variant)
    return torch.from_numpy(np.ascontiguousarray(host)).to(device)


@functools.lru_cache(maxsize=None)
def _kernel_fn(variant: str):
    lib, symbol, _ = KERNELS[variant]
    fn = getattr(_build.load(lib), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,  # data, strides
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,  # out, strides
        ctypes.c_void_p,  # masks or B fragments
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,  # B, C, R, N
        ctypes.c_longlong,  # tile
        *([ctypes.c_int] if variant == "dma" else []),  # chunk
        ctypes.c_void_p,  # stream
    ]
    return fn


def _check(m: np.ndarray, shards: torch.Tensor) -> None:
    if shards.dtype != torch.uint8:
        raise TypeError(f"shards must be uint8, got {shards.dtype}")
    if shards.ndim not in (2, 3):
        raise ValueError(f"shards must be (C, N) or (B, C, N), got {tuple(shards.shape)}")
    if m.ndim != 2 or m.shape[1] != shards.shape[-2]:
        raise ValueError(f"matrix {m.shape} does not apply to shards {tuple(shards.shape)}")


def check_shape(rows: int, cols: int) -> None:
    """Raise ValueError unless the kernels take an (R x C) matrix."""
    if not (1 <= rows <= MAX_ROWS and 1 <= cols <= MAX_COLS):
        raise ValueError(
            f"kernel takes R, C <= {MAX_ROWS}, got matrix ({rows}, {cols}): apply at most "
            f"{MAX_ROWS} rows per call (reconstruct `wanted` in slices), or use device='cpu', "
            "whose plain version takes any shape")


def resolve_tile(variant: str, tile: Optional[int], c: int, rows: int) -> int:
    """The tile a call runs with: `auto_tile` for None, else the caller's,
    which must be a positive multiple of 128 (of SPAN for the bf16 kernel,
    whose warpgroup products cover whole trips of SPAN columns)."""
    if variant not in KERNELS:
        raise ValueError(f"unknown variant {variant!r} (want one of {tuple(KERNELS)})")
    if tile is None:
        return auto_tile(c, rows, variant)
    unit = SPAN if variant == "bf16" else 128
    if int(tile) <= 0 or int(tile) % unit:
        raise ValueError(f"{variant} takes a tile that is a positive multiple of {unit}, got {tile}")
    return int(tile)


def plain_apply(
    m: np.ndarray, shards: torch.Tensor, tile: Optional[int] = None, variant: str = "int8"
) -> torch.Tensor:
    """The variant's plain PyTorch version on the shards' device: the CPU
    path, and what each kernel is held against on the card."""
    m = np.asarray(m, dtype=np.uint8)
    _check(m, shards)
    t = resolve_tile(variant, tile, m.shape[1], m.shape[0])
    if variant == "int8":
        return rs_torch.gf_apply(rs_torch.lifted_matrix(m, shards.device), shards)
    pm = plane_major_matrix(m)
    if variant == "dma":
        return rs_torch.gf_apply_dma(pm, shards, _dma_chunk(t))
    return getattr(rs_torch, f"gf_apply_{variant}")(pm, shards)


def apply_matrix(
    m: np.ndarray, shards: torch.Tensor, tile: Optional[int] = None, variant: str = "int8"
) -> torch.Tensor:
    """(R, C) GF(2^8) matrix applied to (C, N) or (B, C, N) uint8 shards ->
    (R, N) / (B, R, N) uint8 on the shards' device. A CUDA tensor goes to
    the variant's kernel, which launches on the current stream without
    synchronising; a CPU tensor to its plain version. An unknown variant
    or a tile the kernel does not take raises."""
    m = np.asarray(m, dtype=np.uint8)
    _check(m, shards)
    if shards.device.type == "cpu":
        return plain_apply(m, shards, tile, variant)
    if shards.device.type != "cuda":
        raise ValueError(f"no GF kernel for device {shards.device}")
    return _launch(m, shards, tile, variant)


def _launch(m: np.ndarray, shards: torch.Tensor, tile: Optional[int], variant: str) -> torch.Tensor:
    global launches
    r_n, c_n = m.shape
    t = resolve_tile(variant, tile, c_n, r_n)
    check_shape(r_n, c_n)
    squeeze = shards.ndim == 2
    data = shards[None] if squeeze else shards
    batch, _, n = data.shape
    if batch > MAX_BATCH:
        raise ValueError(f"kernel takes at most {MAX_BATCH} batch elements, got {batch}")
    if n and data.stride(2) != 1:
        raise ValueError("shards' last axis must be contiguous")
    out = torch.empty((batch, r_n, n), dtype=torch.uint8, device=data.device)
    if n and batch:
        operand = _device_operand(_key(m), variant, str(data.device))
        # int8 with tile=None keeps the launch of one block per SPAN columns
        kernel_tile = 0 if (variant == "int8" and tile is None) else t
        extra = (_dma_chunk(t),) if variant == "dma" else ()
        with torch.cuda.device(data.device):
            stream = torch.cuda.current_stream(data.device).cuda_stream
            err = _kernel_fn(variant)(
                data.data_ptr(), data.stride(0), data.stride(1),
                out.data_ptr(), out.stride(0), out.stride(1),
                operand.data_ptr(), batch, c_n, r_n, n, kernel_tile, *extra, stream,
            )
        if err != 0:
            raise RuntimeError(f"{KERNELS[variant][1]} launch failed: cudaError {err}")
        launches += 1
        launches_by_variant[variant] = launches_by_variant.get(variant, 0) + 1
    return out[0] if squeeze else out
