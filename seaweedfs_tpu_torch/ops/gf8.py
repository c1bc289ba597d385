"""GF(2^8) arithmetic core: host-side numpy tables and small matrices.

Field: GF(2^8) with the primitive polynomial x^8 + x^4 + x^3 + x^2 + 1
(0x11D), generator alpha = 2, the field of klauspost/reedsolomon that
upstream SeaweedFS encodes with. Everything here is tiny (tables, 14x14
matrices) and runs on the host; the bulk data path applies the binary lift
from `gf_matrix_to_bits` to byte stacks (`rs_torch` plain, `rs_cuda` kernel).
"""

from __future__ import annotations

import functools

import numpy as np

GF_POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    """exp/log tables for GF(2^8) with generator 2.

    exp is doubled (512 entries) so exp[log[a]+log[b]] needs no mod.
    """
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= GF_POLY
    for i in range(255, 512):
        exp[i] = exp[i - 255]
    log[0] = -1  # log(0) undefined; sentinel
    return exp, log


GF_EXP, GF_LOG = _build_tables()


def _build_mul_table() -> np.ndarray:
    t = np.zeros((256, 256), dtype=np.uint8)
    for a in range(1, 256):
        t[a, 1:] = GF_EXP[GF_LOG[a] + GF_LOG[1:256]]
    return t


#: full 256x256 multiplication table (64 KiB) for host matrices and goldens
GF_MUL_TABLE = _build_mul_table()


def gf_mul(a: int, b: int) -> int:
    return int(GF_MUL_TABLE[a & 0xFF, b & 0xFF])


def gf_div(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError("GF(2^8) division by zero")
    if a == 0:
        return 0
    return int(GF_EXP[(GF_LOG[a] - GF_LOG[b]) % 255])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(2^8) inverse of zero")
    return int(GF_EXP[255 - GF_LOG[a]])


def gf_exp(a: int, n: int) -> int:
    """a raised to the n-th power (klauspost `galExp` semantics)."""
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(GF_EXP[(GF_LOG[a] * n) % 255])


def gf_mat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Matrix product over GF(2^8). a: (m,k), b: (k,n) uint8 -> (m,n) uint8."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    prods = GF_MUL_TABLE[a[:, :, None], b[None, :, :]]  # (m,k,n)
    return np.bitwise_xor.reduce(prods, axis=1)


def gf_mat_vec(a: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Table-driven golden: (m,k) matrix applied to (k, ...) bytes -> (m, ...)."""
    a = np.asarray(a, dtype=np.uint8)
    x = np.asarray(x, dtype=np.uint8)
    out = np.zeros((a.shape[0],) + x.shape[1:], dtype=np.uint8)
    for i in range(a.shape[0]):
        acc = np.zeros(x.shape[1:], dtype=np.uint8)
        for l in range(a.shape[1]):
            c = a[i, l]
            if c:
                acc ^= GF_MUL_TABLE[c][x[l]]
        out[i] = acc
    return out


def gf_mat_inv(m: np.ndarray) -> np.ndarray:
    """Invert a square matrix over GF(2^8) by Gauss-Jordan elimination.
    Raises ValueError if singular."""
    m = np.asarray(m, dtype=np.uint8)
    n = m.shape[0]
    if m.shape != (n, n):
        raise ValueError(f"not square: {m.shape}")
    aug = np.concatenate([m.copy(), np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        pivot = next((r for r in range(col, n) if aug[r, col] != 0), None)
        if pivot is None:
            raise ValueError("singular matrix over GF(2^8)")
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        aug[col] = GF_MUL_TABLE[gf_inv(int(aug[col, col]))][aug[col]]
        for r in range(n):
            if r != col and aug[r, col] != 0:
                aug[r] ^= GF_MUL_TABLE[int(aug[r, col])][aug[col]]
    return aug[:, n:].copy()


# -- generator matrices ------------------------------------------------------


def vandermonde(rows: int, cols: int) -> np.ndarray:
    """vm[r][c] = r^c (klauspost `vandermonde()` semantics)."""
    m = np.zeros((rows, cols), dtype=np.uint8)
    for r in range(rows):
        for c in range(cols):
            m[r, c] = gf_exp(r, c)
    return m


@functools.lru_cache(maxsize=64)
def build_matrix(data_shards: int, total_shards: int) -> np.ndarray:
    """Systematic generator, klauspost's default construction: the
    Vandermonde(total, data) matrix times the inverse of its top square, so
    the top `data` rows are the identity (what `reedsolomon.New(10, 4)`
    builds, hence byte-compatible with stock nodes)."""
    vm = vandermonde(total_shards, data_shards)
    out = gf_mat_mul(vm, gf_mat_inv(vm[:data_shards, :data_shards]))
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=64)
def build_matrix_cauchy(data_shards: int, total_shards: int) -> np.ndarray:
    """Systematic Cauchy matrix (klauspost `WithCauchyMatrix`): identity on
    top, parity rows m[r][c] = 1/(r ^ c)."""
    m = np.zeros((total_shards, data_shards), dtype=np.uint8)
    for r in range(total_shards):
        for c in range(data_shards):
            if r < data_shards:
                m[r, c] = 1 if r == c else 0
            else:
                m[r, c] = gf_inv(r ^ c)
    m.setflags(write=False)
    return m


def generator_matrix(kind: str, data_shards: int, total_shards: int) -> np.ndarray:
    if kind == "vandermonde":
        return build_matrix(data_shards, total_shards)
    if kind == "cauchy":
        return build_matrix_cauchy(data_shards, total_shards)
    raise ValueError(f"unknown matrix kind {kind!r}")


def parity_matrix(data_shards: int, parity_shards: int, kind: str = "vandermonde") -> np.ndarray:
    """The (parity x data) block that maps data shards to parity shards."""
    return generator_matrix(kind, data_shards, data_shards + parity_shards)[data_shards:]


# -- binary (bit-plane) lift ---------------------------------------------------


def gf_const_to_bits(c: int) -> np.ndarray:
    """Multiplication-by-c as its 8x8 GF(2) matrix: A_c[i, j] = bit i of
    (c * 2^j), little-endian bit order."""
    a = np.zeros((8, 8), dtype=np.uint8)
    for j in range(8):
        prod = gf_mul(c, 1 << j)
        for i in range(8):
            a[i, j] = (prod >> i) & 1
    return a


def gf_matrix_to_bits(m: np.ndarray) -> np.ndarray:
    """Lift an (R, C) GF(2^8) matrix to its (8R, 8C) GF(2) block matrix.

    Row r*8+i, col c*8+j: bit i of (m[r,c] * 2^j). With data bytes unpacked
    to little-endian bit-planes, `(B @ in_bits) & 1` is the exact GF(2^8)
    matrix-vector product."""
    m = np.asarray(m, dtype=np.uint8)
    r_n, c_n = m.shape
    out = np.zeros((r_n * 8, c_n * 8), dtype=np.uint8)
    for r in range(r_n):
        for c in range(c_n):
            out[r * 8 : r * 8 + 8, c * 8 : c * 8 + 8] = gf_const_to_bits(int(m[r, c]))
    return out


# -- trace-repair projection (host golden) ---------------------------------------


def gf_project(coeffs: np.ndarray, stack: np.ndarray) -> np.ndarray:
    """Repair projection, host golden: an (R, C) GF(2^8) coefficient matrix
    applied to a (C, N) stack of a holder's local survivors -> (R, N). The
    holder ships these R rows (R = shards being rebuilt) in place of its C
    full slabs."""
    return gf_mat_vec(coeffs, stack)


def gf_project_bits(coeffs: np.ndarray, stack: np.ndarray) -> np.ndarray:
    """`gf_project` through the bit-plane lift: the stack as little-endian
    bit-planes times the (8R, 8C) binary matrix of `gf_matrix_to_bits`,
    reduced mod 2 and repacked; the formulation the kernels run."""
    coeffs = np.asarray(coeffs, dtype=np.uint8)
    stack = np.asarray(stack, dtype=np.uint8)
    r_n, c_n = coeffs.shape
    if stack.shape[0] != c_n:
        raise ValueError(f"stack rows {stack.shape[0]} != coeff cols {c_n}")
    b = gf_matrix_to_bits(coeffs)
    bits = np.unpackbits(stack, axis=0, bitorder="little").reshape(8 * c_n, -1)
    out_bits = (b.astype(np.uint32) @ bits.astype(np.uint32)) & 1
    return np.packbits(
        out_bits.astype(np.uint8).reshape(8 * r_n, -1), axis=0, bitorder="little"
    ).reshape(r_n, -1)


def gf_delta_parity(coeffs: np.ndarray, delta: np.ndarray) -> np.ndarray:
    """Small-write parity maintenance, host golden: the parity rows' change
    when one data shard's bytes change. With generator column
    c = G_parity[:, d] and delta = old ^ new over the touched columns,
    parity' = parity ^ gf_delta_parity(c, delta), byte-exact against a
    re-encode of the stripe (parity is linear in each data shard).
    coeffs: (P,) uint8; delta: (n,) uint8 -> (P, n) uint8."""
    coeffs = np.asarray(coeffs, dtype=np.uint8).ravel()
    delta = np.asarray(delta, dtype=np.uint8).ravel()
    return GF_MUL_TABLE[coeffs[:, None], delta[None, :]]
