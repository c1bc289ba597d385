"""GF(2^8) matrix application through the hand-written CUDA kernels in
`csrc/`, one per variant of the reference's fused Pallas family
(`rs_pallas.VARIANTS`):

  int8    `gf_bitplane.cu`  AND-popc MMA, transposed: bits x lift (`_kernel`)
  bf16    `gf_bf16.cu`      bf16 MMA, transposed: bits x lift (`_kernel_bf16`)
  u8      `gf_mma.cu`       int8 MMA, transposed, over the plane-major 0/1 stack (`_kernel_u8`)
  mplane  `gf_mma.cu`       int8 MMA, transposed, one K step per plane (`_kernel_mplane`)
  dma     `gf_dma.cu`       int8's AND-popc MMA fed by a TMA ring, warp-specialised (`_make_dma_kernel`)

`apply_matrix(m, shards, tile, variant)` takes a CPU tensor to the
variant's plain version (`rs_torch`) and a CUDA tensor to its kernel;
nothing else. `tile` is the byte columns one block covers (the
reference's `pallas_tile`), walked by a loop inside the block; dma's
persistent blocks take it as their work item instead (`dma_schedule`).

Operand layout. The reference feeds its kernel the plane-major lift
(`plane_major_matrix`): input bit j of byte-row ci at column j*C + ci,
output bit i of row r at row i*R + r. The kernels read each column's
bits in byte order (bit 8*ci + j is bit j of row ci, the order in which
the bytes of one column pack into uint32 words), so the wrapper re-packs
the plane-major lift into per-output-bit masks (`kernel_masks`). The
int8 and dma kernels take the masks as the 1-bit B operand of their
transposed tensor-core product, in fragment order (`lift_fragments`); the
bf16 kernel takes them as bf16 1.0/0.0 B fragments of its transposed
product (`bf16_fragments`); u8 and mplane take it as 0/1 int8 B fragments
of their transposed products (`s8_fragments`). Each is uploaded once per
matrix and device.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Optional

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

#: kernel launches made by `apply_matrix` in this process, in all, by
#: variant, by the matrix's (R, C) and by device ("cuda:1"); a run sets them
#: to 0 (`reset_launches`) and reads them back to show which path its work
#: went through. Reader threads launch at once, so they change only under
#: `_launch_lock`
launches = 0
launches_by_variant: dict[str, int] = {}
launches_by_shape: dict[tuple[int, int], int] = {}
launches_by_device: dict[str, int] = {}
_launch_lock = threading.Lock()


def count_launch(variant: str, shape: Optional[tuple[int, int]] = None,
                 device: Optional[str] = None) -> None:
    """Count one launch of `variant`'s kernel with an (R, C) = `shape`
    matrix on `device`, exactly under threads."""
    global launches
    with _launch_lock:
        launches += 1
        launches_by_variant[variant] = launches_by_variant.get(variant, 0) + 1
        if shape is not None:
            launches_by_shape[shape] = launches_by_shape.get(shape, 0) + 1
        if device is not None:
            launches_by_device[device] = launches_by_device.get(device, 0) + 1


def reset_launches() -> None:
    """Set every launch count to 0."""
    global launches
    with _launch_lock:
        launches = 0
        launches_by_variant.clear()
        launches_by_shape.clear()
        launches_by_device.clear()


def _dma_chunk(tile: int) -> int:
    """Largest chunk <= DMA_CHUNK dividing the tile (tiles are multiples
    of 128, so 128 is the floor), as the reference's `_dma_chunk`."""
    for ch in (DMA_CHUNK, 1024, 512, 256, 128):
        if ch <= tile and tile % ch == 0:
            return ch
    return 128


class DmaPlan(NamedTuple):
    """How the dma kernel lays out one block (`gf_dma.cu:plan`)."""

    stages: int  # ring slots of (C, chunk) bytes
    pass_cols: int  # columns the consumer warps take per pass of a stage
    smem: int  # shared memory bytes of one block
    blocks_per_sm: int  # blocks of that size one SM holds, by shared memory and threads only


#: the dma kernel's block: 4 consumer warps and one producer warp
DMA_THREADS = 160
#: an H100 SM's shared memory, of which each resident block reserves 1 KiB
SMEM_SM_TOTAL = 233472
#: consumer pass when 2048-column column words and output tiles do not fit
DMA_NARROW_PASS = 512


def _dma_w_stride(pass_cols: int) -> int:
    """Words per row of the dma kernel's column words W (`gf_dma.cu:
    w_stride`): 20 per 16 columns (16 and 4 of padding against bank
    conflicts), and 8 more."""
    return pass_cols // 16 * 20 + 8


def _dma_fixed_bytes(c: int, rows: int, pass_cols: int) -> int:
    """The dma block's shared memory besides the ring: its 8 mbarriers (128
    bytes), the column words W (NW rows of `_dma_w_stride` words), two
    output tiles (R rows of pass + 16 bytes each), and the lift fragments
    when they are not held in registers (R > 4: whole groups of 4 rows,
    256 bytes each)."""
    nw = -(-c // 4)
    frags = 0 if rows <= 4 else 256 * (-(-rows // 4) * 4)
    return 128 + nw * _dma_w_stride(pass_cols) * 4 + 2 * rows * (pass_cols + 16) + frags


def _dma_blocks(smem: int) -> int:
    return min(2048 // DMA_THREADS, SMEM_SM_TOTAL // (smem + 1024))


def dma_plan(c: int, rows: int, chunk: int = DMA_CHUNK) -> DmaPlan:
    """The dma kernel's ring for an (R x C) matrix and `chunk`-column stages,
    as `gf_dma.cu:plan` derives it: consumers take a stage in passes of
    min(chunk, SPAN) columns, or DMA_NARROW_PASS when two stages do not fit
    beside SPAN-wide column words and output tiles (C and R near 32); then
    the ring gets the most stages, 2 to 4, that keep as many blocks per SM
    as 2 stages do."""
    stage = c * chunk
    pass_cols = min(chunk, SPAN)
    if _dma_fixed_bytes(c, rows, pass_cols) + 2 * stage > SMEM_PER_SM and pass_cols > DMA_NARROW_PASS:
        pass_cols = DMA_NARROW_PASS
    base = _dma_fixed_bytes(c, rows, pass_cols)
    per_sm = _dma_blocks(base + 2 * stage)
    stages = max(s for s in (2, 3, 4)
                 if s == 2 or (base + s * stage <= SMEM_PER_SM and _dma_blocks(base + s * stage) == per_sm))
    smem = base + stages * stage
    return DmaPlan(stages, pass_cols, smem, _dma_blocks(smem))


class DmaStage(NamedTuple):
    """One stage of a dma block's walk: columns [start, stop) of batch
    element `batch`, in ring slot `slot`; the producer waits on the slot's
    empty barrier for `empty_parity`, the consumers on its full barrier
    for `full_parity`."""

    batch: int
    start: int
    stop: int
    slot: int
    empty_parity: int
    full_parity: int


def dma_items(batch: int, n: int, tile: int) -> int:
    """Work items of a dma launch: (batch element, tile) pairs."""
    return batch * -(-n // tile)


def dma_grid(batch: int, n: int, tile: int, blocks_per_sm: int, sms: int) -> int:
    """Persistent blocks of a dma launch: as many as fit the SMs, at most
    one per work item."""
    return min(dma_items(batch, n, tile), blocks_per_sm * sms)


def dma_schedule(batch: int, n: int, tile: int, chunk: int, grid: int, stages: int) -> list[list[DmaStage]]:
    """The dma kernel's ring, block by block, as `gf_dma.cu` walks it: block
    k takes the work items k, k + grid, k + 2*grid, ... (item i is batch
    element i // tiles, columns [(i % tiles) * tile, + tile) cut at N),
    each in `chunk`-column stages; the block's s-th stage uses slot s %
    stages, the producer waits for its empty barrier's phase of parity
    ((s // stages) & 1) ^ 1 (a fresh barrier passes parity 1 at once), the
    consumers for its full barrier's phase of parity (s // stages) & 1."""
    per_batch = -(-n // tile)
    blocks = []
    for k in range(grid):
        walk: list[DmaStage] = []
        for i in range(k, batch * per_batch, grid):
            b, j = divmod(i, per_batch)
            start, lim = j * tile, min(n, (j + 1) * tile)
            for cbase in range(start, lim, chunk):
                rnd, slot = divmod(len(walk), stages)
                walk.append(DmaStage(b, cbase, min(lim, cbase + chunk), slot, (rnd & 1) ^ 1, rnd & 1))
        blocks.append(walk)
    return blocks


def s8_steps(variant: str, c: int) -> int:
    """K steps of 32 of the u8 (the stack, ceil(C/4)) and mplane (one per
    plane, 8) products."""
    return -(-c // 4) if variant == "u8" else 8


def smem_bytes(variant: str, c: int, rows: int) -> int:
    """Shared memory one block of `variant` uses for an (R x C) matrix."""
    nw = -(-c // 4)
    if variant == "dma":  # at its widest stage (`dma_plan`)
        return dma_plan(c, rows).smem
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
    bf16, u8 and mplane timed at 2048 and 8192). dma's blocks are
    persistent and its ring runs across work items, so the tile only sets
    how finely the items share out among the blocks: two DMA_CHUNK stages
    per item, the least that keeps two stages of one item in the ring."""
    return 2 * DMA_CHUNK if variant == "dma" else SPAN


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
    """The int8 and dma kernels' B operand (`gf_bitplane.cu`, `gf_dma.cu`):
    the lift as popc masks in the fragment order of mma.m16n8k256's 1-bit
    B, uint32 (R, 32, 2).

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
    "dma": ("gf_dma", "gf_dma_apply", "frags"),
}


@functools.lru_cache(maxsize=256)
def _device_operand(key: tuple, variant: str, device: str) -> torch.Tensor:
    pm = _plane_major(key)
    kind = KERNELS[variant][2]
    if kind == "frags":
        host = lift_fragments(pm)
    elif kind == "bf16":
        host = bf16_fragments(pm)
    else:
        host = s8_fragments(pm, variant)
    return torch.from_numpy(np.ascontiguousarray(host)).to(device)


def dma_device_plan(c: int, rows: int, chunk: int = DMA_CHUNK) -> dict:
    """The dma kernel's own plan on the current card (`gf_dma_plan`):
    stages, pass_cols and smem as it launches them, blocks_per_sm from the
    occupancy calculator (registers included), and the card's SMs. Builds
    the library; needs a card."""
    fn = _build.load("gf_dma").gf_dma_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * 5)()
    err = fn(c, rows, chunk, out)
    if err != 0:
        raise RuntimeError(f"gf_dma_plan failed: cudaError {err}")
    return dict(zip(("stages", "pass_cols", "smem", "blocks_per_sm", "sms"), out))


@functools.lru_cache(maxsize=None)
def _kernel_fn(variant: str):
    lib, symbol, _ = KERNELS[variant]
    fn = getattr(_build.load(lib), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,  # data, strides
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,  # out, strides
        ctypes.c_void_p,  # B fragments
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
        count_launch(variant, (r_n, c_n), str(data.device))
    return out[0] if squeeze else out
