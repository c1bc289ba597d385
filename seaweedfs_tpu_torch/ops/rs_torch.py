"""Plain PyTorch GF(2^8) matrix application: the bit-plane formulation.

GF(2^8) multiply-by-constant is linear over GF(2), so an (R x C) coding
matrix lifts to an (8R x 8C) binary matrix B (`gf8.gf_matrix_to_bits`).
Unpack the bytes to little-endian bit-planes, then

    out_bits = (B @ in_bits) mod 2

is the exact GF(2^8) product. This module is the path for CPU tensors and
the reference the CUDA kernels (`rs_cuda`) are checked against on the card.

One plain version per kernel variant, each following its kernel's
formulation: `gf_apply` (int8, over the byte-major lift), and over the
plane-major lift (`rs_cuda.plane_major_matrix`: input bit j of row ci at
column j*C + ci, output bit i of row r at row i*R + r) `gf_apply_dma`
(column chunks), `gf_apply_mplane` (8 per-plane products summed),
`gf_apply_u8` (mask-and-compare unpack) and `gf_apply_bf16` (bf16
operands, float32 product).
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from seaweedfs_tpu_torch.ops import gf8

#: columns per plain-version step
CHUNK = 1 << 20


def bytes_to_bits(x: torch.Tensor) -> torch.Tensor:
    """(..., C, N) uint8 -> (..., 8C, N) int8 bit-planes, row ci*8 + j = bit j
    of byte-row ci."""
    *lead, c, n = x.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=x.device).view(8, 1)
    bits = (x.unsqueeze(-2) >> shifts) & 1  # (..., C, 8, N)
    return bits.reshape(*lead, c * 8, n).to(torch.int8)


def bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """(..., 8R, N) 0/1 -> (..., R, N) uint8, row r*8 + i = bit i of byte-row r."""
    *lead, r8, n = bits.shape
    b = bits.reshape(*lead, r8 // 8, 8, n).to(torch.uint8)
    out = b[..., 0, :].clone()
    for i in range(1, 8):
        out |= b[..., i, :] << i
    return out


@contextlib.contextmanager
def exact_float32():
    """float32 matrix products in full float32 (TF32 off) inside the block;
    the caller's TF32 flag is restored after."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def _operand(lift: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """The lift as the product's operand, float32 on every device: every
    partial sum is an integer <= 8C <= 256 < 2^24, which float32 holds
    exactly. (int32 matmul does not run on CUDA, and on the CPU it has no
    BLAS path, so it is far slower there than float32.)"""
    return lift.to(device=data.device, dtype=torch.float32)


def _matmul(b: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Exact integer product of 0/1 operands, as int32."""
    with exact_float32():
        return torch.matmul(b, bits.to(b.dtype)).to(torch.int32)


def _by_chunks(data: torch.Tensor, chunk: int, fn) -> torch.Tensor:
    parts = [fn(data[..., n0 : n0 + chunk]) for n0 in range(0, max(1, data.shape[-1]), chunk)]
    return torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]


def pack_plane_major(acc: torch.Tensor) -> torch.Tensor:
    """(..., 8R, N) 0/1 rows, row i*R + r = bit i of output row r ->
    (..., R, N) uint8 (the reference's `_pack_planes`)."""
    *lead, r8, n = acc.shape
    planes = acc.reshape(*lead, 8, r8 // 8, n).to(torch.uint8)
    out = planes[..., 0, :, :].clone()
    for i in range(1, 8):
        out |= planes[..., i, :, :] << i
    return out


def _shift_planes(x: torch.Tensor) -> torch.Tensor:
    """(..., C, N) uint8 -> (..., 8C, N) 0/1 plane-major by shift and mask,
    row j*C + ci = bit j of row ci (the reference `_kernel`'s unpack)."""
    return torch.cat([(x >> j) & 1 for j in range(8)], dim=-2)


def gf_apply_dma(pm: torch.Tensor, data: torch.Tensor, chunk: int) -> torch.Tensor:
    """The "dma" variant: the int8 formulation over the plane-major lift,
    one `chunk`-column stage at a time (`rs_cuda._dma_chunk(tile)`), as the
    kernel walks its ring."""
    b = _operand(pm, data)
    return _by_chunks(
        data, chunk, lambda d: pack_plane_major(_matmul(b, _shift_planes(d)) & 1)
    )


def gf_apply_mplane(pm: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """The "mplane" variant: 8 per-plane products, plane j with the lift's
    column block [j*C, (j+1)*C), summed into one accumulator, then & 1; the
    (8C, N) stack is never built."""
    b = _operand(pm, data)
    c = data.shape[-2]

    def step(d: torch.Tensor) -> torch.Tensor:
        acc = None
        for j in range(8):
            part = _matmul(b[:, j * c : (j + 1) * c], (d >> j) & 1)
            acc = part if acc is None else acc + part
        return pack_plane_major(acc & 1)

    return _by_chunks(data, CHUNK, step)


def gf_apply_u8(pm: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """The "u8" variant: the plane-major stack unpacked shift-free, bit j as
    (x & (1 << j)) != 0, then one product, & 1 and the pack."""
    b = _operand(pm, data)

    def step(d: torch.Tensor) -> torch.Tensor:
        bits = torch.cat([(d & (1 << j)) != 0 for j in range(8)], dim=-2)
        return pack_plane_major(_matmul(b, bits) & 1)

    return _by_chunks(data, CHUNK, step)


def gf_apply_bf16(pm: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """The "bf16" variant: lift and bits rounded to bf16 (exact for 0/1),
    the product taken in float32 (exact: every sum <= 8C <= 256), its
    integer part & 1, then the pack."""
    b = pm.to(device=data.device, dtype=torch.bfloat16).float()

    def step(d: torch.Tensor) -> torch.Tensor:
        bits = _shift_planes(d).to(torch.bfloat16).float()
        return pack_plane_major(_matmul(b, bits) & 1)

    return _by_chunks(data, CHUNK, step)


def gf_apply(b_bits: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Apply a lifted GF(2^8) matrix to byte shards.

    b_bits: (8R, 8C) int8 binary matrix; data: (C, N) or (B, C, N) uint8.
    Returns (R, N) / (B, R, N) uint8 on data's device.

    The sum over K = 8C bit products must not wrap: K reaches 160 for a
    20-shard decode, past int8. The product is taken in float32, on a card
    with TF32 off for the call only (`exact_float32`): every partial sum is
    an integer <= 160 < 2^24, which float32 holds exactly, so the result is
    bit-exact. Columns go through in chunks of `CHUNK`, bounding the 4- and
    32-fold expansions."""
    b = _operand(b_bits, data)
    return _by_chunks(
        data, CHUNK, lambda d: bits_to_bytes(_matmul(b, bytes_to_bits(d)) & 1)
    )


@functools.lru_cache(maxsize=256)
def _lifted(key: tuple, device: str) -> torch.Tensor:
    rows, cols, flat = key
    m = np.frombuffer(flat, dtype=np.uint8).reshape(rows, cols)
    return torch.from_numpy(gf8.gf_matrix_to_bits(m).astype(np.int8)).to(device)


def lifted_matrix(m: np.ndarray, device="cpu") -> torch.Tensor:
    """The (8R, 8C) int8 byte-major lift of a GF(2^8) matrix, cached by value."""
    a = np.ascontiguousarray(m, dtype=np.uint8)
    return _lifted((a.shape[0], a.shape[1], a.tobytes()), str(torch.device(device)))
