"""The plain reference: Reed-Solomon over GF(2^8), written from the field's
definition and nothing else.

The field is GF(2)[x] / (x^8 + x^4 + x^3 + x^2 + 1) (0x11D), the field of
klauspost/reedsolomon, which SeaweedFS and MinIO encode with. The code is
klauspost's `New(k, m)`: the (k+m) x k Vandermonde matrix V[r][c] = r^c
times the inverse of its top k x k block, so the top block is the identity
(systematic) and rows k.. are the parity rows. A lost shard is rebuilt from
the first k shards present: those rows of the generator, inverted, give
the data; a wanted parity row is its generator row times that inverse.

The matrices are tiny and built here in NumPy. The bulk product is plain
PyTorch on whatever device its input lives on: each input row doubled
seven times by `xtime` (multiply by x, reduce by the polynomial), and each
output row the XOR of the doublings that a coefficient's bits select. No
table, lift or kernel of the measured program is used or imported.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

POLY = 0x11D


def gf_mul(a: int, b: int) -> int:
    """a * b in the field, by shift-and-add."""
    out = 0
    a &= 0xFF
    b &= 0xFF
    while b:
        if b & 1:
            out ^= a
        a <<= 1
        if a & 0x100:
            a ^= POLY
        b >>= 1
    return out


def gf_pow(a: int, n: int) -> int:
    """a ** n in the field, with 0 ** 0 = 1 (klauspost's `galExp`)."""
    out = 1
    for _ in range(n):
        out = gf_mul(out, a)
    return out


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("0 has no inverse in GF(2^8)")
    return gf_pow(a, 254)  # a^255 = 1


def mat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(n, m) x (m, p) over the field."""
    out = np.zeros((a.shape[0], b.shape[1]), dtype=np.uint8)
    for i in range(a.shape[0]):
        for j in range(b.shape[1]):
            acc = 0
            for t in range(a.shape[1]):
                acc ^= gf_mul(int(a[i, t]), int(b[t, j]))
            out[i, j] = acc
    return out


def mat_inv(m: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inverse over the field; raises on a singular matrix."""
    n = m.shape[0]
    work = [[int(v) for v in row] + [int(i == r) for i in range(n)] for r, row in enumerate(m)]
    for col in range(n):
        piv = next((r for r in range(col, n) if work[r][col]), None)
        if piv is None:
            raise ValueError("singular matrix")
        work[col], work[piv] = work[piv], work[col]
        s = gf_inv(work[col][col])
        work[col] = [gf_mul(v, s) for v in work[col]]
        for r in range(n):
            f = work[r][col]
            if r != col and f:
                work[r] = [v ^ gf_mul(f, w) for v, w in zip(work[r], work[col])]
    return np.array([row[n:] for row in work], dtype=np.uint8)


def generator(data_shards: int, parity_shards: int) -> np.ndarray:
    """klauspost's Vandermonde-systematic (k+m) x k generator."""
    total = data_shards + parity_shards
    vm = np.array(
        [[gf_pow(r, c) for c in range(data_shards)] for r in range(total)], dtype=np.uint8
    )
    return mat_mul(vm, mat_inv(vm[:data_shards]))


def parity_matrix(data_shards: int, parity_shards: int) -> np.ndarray:
    return generator(data_shards, parity_shards)[data_shards:]


def survivors_of(data_shards: int, parity_shards: int, lost: Sequence[int]) -> list[int]:
    """The first `data_shards` shard ids not lost: the rows a rebuild reads."""
    present = [i for i in range(data_shards + parity_shards) if i not in set(lost)]
    if len(present) < data_shards:
        raise ValueError(f"{len(lost)} shards lost: more than the code can rebuild")
    return present[:data_shards]


def rebuild_matrix(
    data_shards: int, parity_shards: int, survivors: Sequence[int], wanted: Sequence[int]
) -> np.ndarray:
    """(len(wanted), k) matrix taking the survivors' rows to the wanted rows."""
    gen = generator(data_shards, parity_shards)
    inv = mat_inv(gen[list(survivors)])
    rows = [inv[w] if w < data_shards else mat_mul(gen[w : w + 1], inv)[0] for w in wanted]
    return np.stack(rows).astype(np.uint8)


def xtime(x: torch.Tensor) -> torch.Tensor:
    """x * 2 in the field, elementwise on uint8."""
    hi = (x >> 7) & 1
    return (x << 1) ^ (hi * (POLY & 0xFF))


def apply(m: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """(R, C) matrix over the field applied to (C, N) or (B, C, N) uint8
    bytes -> (R, N) / (B, R, N), on `x`'s device."""
    m = np.asarray(m, dtype=np.uint8)
    if x.dtype != torch.uint8 or x.shape[-2] != m.shape[1]:
        raise ValueError(f"matrix {m.shape} does not apply to {tuple(x.shape)} {x.dtype}")
    out = torch.zeros(x.shape[:-2] + (m.shape[0], x.shape[-1]), dtype=torch.uint8,
                      device=x.device)
    for c in range(m.shape[1]):
        plane = x[..., c, :]
        for bit in range(8):
            for r in range(m.shape[0]):
                if (int(m[r, c]) >> bit) & 1:
                    out[..., r, :] ^= plane
            if bit < 7:
                plane = xtime(plane)
    return out
