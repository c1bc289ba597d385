"""The int8 kernel's tensor-core formulation (`csrc/gf_bitplane.cu`),
replayed lane by lane in numpy on the CPU, since the kernel itself runs
only on the card. The lift-fragment operand (`rs_cuda.lift_fragments`),
the A registers the kernel takes from column words, the AND-popc sums of
mma.m16n8k256 (1-bit) placed by the PTX fragment layouts, the int8 pack
product over their parities and the stores must give the GF(2^8) product
byte for byte (tolerance 0: GF arithmetic is exact), against the JAX
package's `gf8.gf_mat_vec` golden and the port's plain version."""

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import gf8 as ref_gf8
from seaweedfs_tpu_torch.ops import gf8, rs_codec, rs_cuda


def _decode_matrix(kind: str, k: int, m: int, lost: tuple) -> np.ndarray:
    enc = rs_codec.Encoder(k, m, kind, device="cpu")
    survivors = [s for s in range(k + m) if s not in lost][:k]
    return enc.reconstruction_matrix(survivors, lost)


#: the matrices of tests/test_torch_cuda.py, and a 5x17
MATRICES = {
    "rs_10_4": lambda: gf8.parity_matrix(10, 4),
    "cauchy_12_3": lambda: gf8.parity_matrix(12, 3, "cauchy"),
    "merge_20_4": lambda: gf8.parity_matrix(20, 4, "cauchy"),
    "decode_4_of_10": lambda: _decode_matrix("vandermonde", 10, 4, (1, 6, 12, 13)),
    "decode_1_lost": lambda: _decode_matrix("vandermonde", 10, 4, (3,)),
    "decode_merge_20_4": lambda: _decode_matrix("cauchy", 20, 4, (0, 1, 22, 23)),
    "random_32x32": lambda: np.random.default_rng(5).integers(0, 256, (32, 32), np.uint8),
    "random_1x1": lambda: np.array([[0x8E]], dtype=np.uint8),
    "random_5x17": lambda: np.random.default_rng(6).integers(0, 256, (5, 17), np.uint8),
}


def _bytes(x: int) -> list:
    return [(int(x) >> (8 * e)) & 0xFF for e in range(4)]


def _column_words(data: np.ndarray) -> np.ndarray:
    """(NW, N) uint32: byte q of word w of a column = its byte of row
    4w + q (zero past C), as `gf::column_words` builds them."""
    c, n = data.shape
    nw = -(-c // 4)
    rows = np.zeros((4 * nw, n), dtype=np.uint8)
    rows[:c] = data
    return np.ascontiguousarray(rows.reshape(nw, 4, n).transpose(0, 2, 1)).view("<u4")[..., 0]


def _pack_b(g: int, t: int) -> tuple:
    """The pack product's B registers of lane (g, t), as the kernel makes them."""
    pack0 = pack1 = 0
    for e in range(4):
        v = 1 << (2 * t + (e & 1))
        if g == (e >> 1):
            pack0 |= v << (8 * e)
        if g == 2 + (e >> 1):
            pack1 |= v << (8 * e)
    return pack0, pack1


def _bits(x: int) -> list:
    return [(int(x) >> k) & 1 for k in range(32)]


def _lane_replay(frags: np.ndarray, data: np.ndarray, r_n: int) -> np.ndarray:
    """gf_bitplane.cu's arithmetic lane by lane: the A fragments of
    mma.m16n8k256 (1-bit, row g / g + 8, K bits 32t.. and 128 + 32t..) are
    the column words, B comes from the fragments, each sum is popc(A & B);
    the pack product's A bytes are the sums' parities, its B holds 2^bit,
    and lanes t < 2 store rows 2t, 2t + 1 of each group of 4."""
    c_n, n = data.shape
    n16 = -(-n // 16) * 16  # the kernel loads zero past the edge
    padded = np.zeros((c_n, n16), dtype=np.uint8)
    padded[:, :n] = data
    words = _column_words(padded)
    nw = words.shape[0]
    out = np.zeros((r_n, n16), dtype=np.uint8)
    for nb in range(0, n16, 16):
        a = np.zeros((16, 256), dtype=np.int64)
        for ln in range(32):
            g, t = ln >> 2, ln & 3
            for h in range(2):  # a0/a1 (word t), a2/a3 (word 4 + t)
                w = 4 * h + t
                for row in (g, g + 8):
                    x = int(words[w, nb + row]) if w < nw else 0
                    a[row, 128 * h + 32 * t:128 * h + 32 * t + 32] = _bits(x)
        for rg in range(0, r_n, 4):
            d = np.zeros((4, 16, 8), dtype=np.int64)
            for nt in range(4):
                if rg + nt >= r_n:
                    continue
                b = np.zeros((256, 8), dtype=np.int64)
                for ln in range(32):
                    g, t = ln >> 2, ln & 3
                    for h in range(2):
                        b[128 * h + 32 * t:128 * h + 32 * t + 32, g] = _bits(frags[rg + nt, ln, h])
                d[nt] = a @ b  # AND, then popc over K
            assert d.max() <= 8 * c_n
            a2 = np.zeros((16, 32), dtype=np.int64)
            b2 = np.zeros((32, 8), dtype=np.int64)
            for ln in range(32):
                g, t = ln >> 2, ln & 3
                for nt0, row, k0 in ((0, g, 4 * t), (0, g + 8, 4 * t),
                                     (2, g, 16 + 4 * t), (2, g + 8, 16 + 4 * t)):
                    a2[row, k0:k0 + 4] = [d[nt0, row, 2 * t] & 1, d[nt0, row, 2 * t + 1] & 1,
                                          d[nt0 + 1, row, 2 * t] & 1, d[nt0 + 1, row, 2 * t + 1] & 1]
                p0, p1 = _pack_b(g, t)
                b2[4 * t:4 * t + 4, g] = _bytes(p0)
                b2[16 + 4 * t:16 + 4 * t + 4, g] = _bytes(p1)
            o = a2 @ b2
            assert o.min() >= 0 and o.max() <= 255
            for ln in range(32):
                g, t = ln >> 2, ln & 3
                if t >= 2:
                    continue
                for h in range(2):  # rows rg + 2t (o[0], o[2]) and rg + 2t + 1
                    if rg + 2 * t + h < r_n:
                        out[rg + 2 * t + h, nb + g] = o[g, 2 * t + h]
                        out[rg + 2 * t + h, nb + g + 8] = o[g + 8, 2 * t + h]
    return out[:, :n]


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_lift_fragments_and_lanes_replay_to_golden(name):
    m = MATRICES[name]()
    frags = rs_cuda.lift_fragments(rs_cuda.plane_major_matrix(m))
    assert frags.dtype == np.uint32 and frags.shape == (m.shape[0], 32, 2)
    data = np.random.default_rng(len(name)).integers(0, 256, (m.shape[1], 37), np.uint8)
    got = _lane_replay(frags, data, m.shape[0])
    assert np.array_equal(got, ref_gf8.gf_mat_vec(m, data))
    assert np.array_equal(got, rs_cuda.plain_apply(m, torch.from_numpy(data)).numpy())


@pytest.mark.parametrize("name", ["rs_10_4", "cauchy_12_3", "random_5x17", "random_32x32"])
def test_lift_fragments_are_the_transposed_lift(name):
    """Unfolded from fragment order, B of tile r is the lift's block:
    B[32w + 8q + p][i] = bit p of input row 4w + q into bit i of output row
    r, with the byte-major lift of the JAX package's `gf8`, 0 past C."""
    m = MATRICES[name]()
    r_n, c_n = m.shape
    frags = rs_cuda.lift_fragments(rs_cuda.plane_major_matrix(m))
    lift = ref_gf8.gf_matrix_to_bits(m)  # row r*8 + i, column ci*8 + p
    for r in range(r_n):
        b = np.zeros((256, 8), dtype=np.uint8)
        for ln in range(32):
            g, t = ln >> 2, ln & 3
            for h in range(2):
                b[128 * h + 32 * t:128 * h + 32 * t + 32, g] = _bits(frags[r, ln, h])
        want = np.zeros((256, 8), dtype=np.uint8)
        want[: 8 * c_n] = lift[r * 8:r * 8 + 8, :].T
        assert np.array_equal(b, want)


@pytest.mark.parametrize("c, rows", [(10, 4), (10, 1), (12, 3), (16, 4), (17, 4), (20, 4),
                                     (10, 5), (32, 32), (1, 1)])
def test_int8_shared_memory_fits_and_follows_where_the_fragments_live(c, rows):
    nw = -(-c // 4)
    base = nw * (rs_cuda.SPAN + 8) * 4 + rows * (rs_cuda.SPAN + 16)
    in_registers = rows <= 4
    padded = -(-rows // 4) * 4  # whole groups of 4 output rows
    assert rs_cuda.smem_bytes("int8", c, rows) == base + (0 if in_registers else 256 * padded)
    assert rs_cuda.smem_bytes("int8", c, rows) <= rs_cuda.SMEM_PER_SM


def _byte_perm(x: int, y: int, sel: int) -> int:
    """__byte_perm: result byte k = byte (sel >> 4k) & 7 of y:x."""
    both = (y << 32) | x
    return sum(((both >> (8 * ((sel >> (4 * k)) & 7))) & 0xFF) << (8 * k) for k in range(4))


def test_parity_bytes_permutes_gather_the_low_bytes():
    """The kernel's `parity_bytes`: bytes 0 of four sums, in order, & 1."""
    rng = np.random.default_rng(2)
    for _ in range(50):
        x = [int(v) for v in rng.integers(0, 257, 4)]
        lo, hi = _byte_perm(x[0], x[1], 0x40), _byte_perm(x[2], x[3], 0x40)
        got = _byte_perm(lo, hi, 0x5410) & 0x01010101
        assert _bytes(got) == [v & 1 for v in x]
