"""The bf16 kernel's tensor-core formulation (`csrc/gf_bf16.cu`), replayed
lane by lane in numpy on the CPU, since the kernel itself runs only on the
card. The B operand (`rs_cuda.bf16_fragments`: the lift as bf16 1.0/0.0
in mma.m16n8k16 fragment order), the A registers the kernel builds from
column words by one rotation and one AND (bf16 2.0/0.0), the float32 sums
placed by the PTX fragment layouts, their parities and the int8 pack
product must give the GF(2^8) product byte for byte (tolerance 0: GF
arithmetic is exact, and every float32 sum is an integer <= 512), against
the JAX package's `gf8.gf_mat_vec` golden, the reference
`rs_pallas.apply_matrix(..., mxu="bf16")` in interpret mode and the port's
plain version. Also pins `measure.bound_ms`, the bound every kernel's
time is held against."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import gf8 as ref_gf8
from seaweedfs_tpu.ops import rs_pallas
from seaweedfs_tpu_torch.ops import gf8, measure, rs_codec, rs_cuda


def _decode_matrix(kind: str, k: int, m: int, lost: tuple) -> np.ndarray:
    enc = rs_codec.Encoder(k, m, kind, device="cpu")
    survivors = [s for s in range(k + m) if s not in lost][:k]
    return enc.reconstruction_matrix(survivors, lost)


MATRICES = {
    "rs_10_4": lambda: gf8.parity_matrix(10, 4),
    "decode_4_of_10": lambda: _decode_matrix("vandermonde", 10, 4, (1, 6, 12, 13)),
    "decode_1_of_10": lambda: _decode_matrix("vandermonde", 10, 4, (3,)),
    "cauchy_12_3": lambda: gf8.parity_matrix(12, 3, "cauchy"),
    "merge_20_4": lambda: gf8.parity_matrix(20, 4, "cauchy"),
    "decode_merge_20_4": lambda: _decode_matrix("cauchy", 20, 4, (0, 1, 22, 23)),
    "random_5x17": lambda: np.random.default_rng(6).integers(0, 256, (5, 17), np.uint8),
    "random_32x32": lambda: np.random.default_rng(5).integers(0, 256, (32, 32), np.uint8),
    "random_1x1": lambda: np.array([[0x8E]], dtype=np.uint8),
}


#: the kernel's column-word byte order (`kRowPairs`): byte slot -> row 4w + ROW_OF_SLOT
ROW_OF_SLOT = (0, 2, 1, 3)


def _column_words(data: np.ndarray) -> np.ndarray:
    """(NW, N) uint32: byte slot q of word w of a column = its byte of row
    4w + ROW_OF_SLOT[q] (zero past C), as `gf::column_words` builds them
    with the bf16 kernel's order 0x5140."""
    c, n = data.shape
    nw = -(-c // 4)
    rows = np.zeros((4 * nw, n), dtype=np.uint8)
    rows[:c] = data
    slots = rows.reshape(nw, 4, n)[:, list(ROW_OF_SLOT)]
    return np.ascontiguousarray(slots.transpose(0, 2, 1)).view("<u4")[..., 0]


def _row_of_bit(bit: int) -> tuple:
    """Word-bit 32w + 8q + p of the K order -> (input row, plane p)."""
    w, rest = divmod(bit, 32)
    q, p = divmod(rest, 8)
    return 4 * w + ROW_OF_SLOT[q], p


def _rotl(x: int, s: int) -> int:
    """__funnelshift_l(x, x, s): x rotated left by s & 31."""
    s &= 31
    return ((x << s) | (x >> (32 - s))) & 0xFFFFFFFF if s else x


def _bf16(bits) -> np.ndarray:
    """bf16 bit patterns (the low 16 bits of each value) as float32."""
    return (np.asarray(bits, dtype=np.uint32) << 16).view(np.float32)


def _a_register(word: int, h: int, reg: int, t: int) -> int:
    """The kernel's A register: rotl(word, 14 - b) & 0x40004000, b = 8h +
    4*reg + t, the lane's fixed shift for K half-step h."""
    return _rotl(word, (14 - 8 * h - 4 * reg - t) & 31) & 0x40004000


def _pack_b(g: int, t: int) -> tuple:
    """The pack product's B registers of lane (g, t) (`gf::pack_operand`)."""
    pack0 = pack1 = 0
    for e in range(4):
        v = 1 << (2 * t + (e & 1))
        if g == (e >> 1):
            pack0 |= v << (8 * e)
        if g == 2 + (e >> 1):
            pack1 |= v << (8 * e)
    return pack0, pack1


def _bytes(x: int) -> list:
    return [(int(x) >> (8 * e)) & 0xFF for e in range(4)]


def _lane_replay(frags: np.ndarray, data: np.ndarray, r_n: int) -> np.ndarray:
    """gf_bf16.cu's arithmetic lane by lane: for each M tile of 16 columns
    and K step s = 2w + h, mma.m16n8k16's A (lane t: a0/a1 = rows g, g + 8
    at k 2t, 2t + 1; a2/a3 at k 2t + 8, 2t + 9) from the column words, B
    from the fragments (b0 = k 2t, 2t + 1 of column g; b1 = k 2t + 8, 2t +
    9), float32 sums over ceil(C/2) steps; fma(sum, 0.5, 2^23) read as an
    int, bit 0 the output bit; the pack product (`gf::pack_group`) per
    group of 4 rows."""
    c_n, n = data.shape
    n16 = -(-n // 16) * 16  # the kernel loads zero past the edge
    padded = np.zeros((c_n, n16), dtype=np.uint8)
    padded[:, :n] = data
    words = _column_words(padded)
    nw = words.shape[0]
    assert frags.shape == (r_n, 2 * nw, 32, 2)
    steps = (c_n + 1) // 2  # one K step per two input rows
    assert not frags[:, steps:].any()  # the step the kernel skips adds nothing
    bmat = np.zeros((r_n, 2 * nw, 16, 8), dtype=np.float32)
    for ln in range(32):
        g, t = ln >> 2, ln & 3
        for reg in range(2):
            x = frags[:, :, ln, reg]
            bmat[:, :, 2 * t + 8 * reg, g] = _bf16(x & 0xFFFF)
            bmat[:, :, 2 * t + 8 * reg + 1, g] = _bf16(x >> 16)
    out = np.zeros((r_n, n16), dtype=np.uint8)
    rt = -(-r_n // 4) * 4
    for nb in range(0, n16, 16):
        amat = np.zeros((steps, 16, 16), dtype=np.float32)
        for s in range(steps):
            w, h = divmod(s, 2)
            for ln in range(32):
                g, t = ln >> 2, ln & 3
                for reg in range(2):
                    for row in (g, g + 8):
                        x = _a_register(int(words[w, nb + row]), h, reg, t)
                        amat[s, row, 2 * t + 8 * reg:2 * t + 8 * reg + 2] = _bf16([x & 0xFFFF, x >> 16])
        d = np.zeros((rt, 16, 8), dtype=np.float32)  # rows past R: B is zero
        for r in range(r_n):
            for s in range(steps):
                d[r] += amat[s] @ bmat[r, s]
        assert d.max() <= 2 * 8 * c_n
        k = (d * np.float32(0.5) + np.float32(8388608.0)).astype(np.float32).view(np.int32)
        for rg in range(0, r_n, 4):
            a2 = np.zeros((16, 32), dtype=np.int64)
            b2 = np.zeros((32, 8), dtype=np.int64)
            for ln in range(32):
                g, t = ln >> 2, ln & 3
                for nt0, row, k0 in ((0, g, 4 * t), (0, g + 8, 4 * t),
                                     (2, g, 16 + 4 * t), (2, g + 8, 16 + 4 * t)):
                    a2[row, k0:k0 + 4] = [k[rg + nt0, row, 2 * t] & 1, k[rg + nt0, row, 2 * t + 1] & 1,
                                          k[rg + nt0 + 1, row, 2 * t] & 1, k[rg + nt0 + 1, row, 2 * t + 1] & 1]
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
def test_bf16_lanes_replay_to_golden_and_reference(name):
    m = MATRICES[name]()
    frags = rs_cuda.bf16_fragments(rs_cuda.plane_major_matrix(m))
    assert frags.dtype == np.uint32
    data = np.random.default_rng(len(name)).integers(0, 256, (m.shape[1], 37), np.uint8)
    got = _lane_replay(frags, data, m.shape[0])
    assert np.array_equal(got, ref_gf8.gf_mat_vec(m, data))
    assert np.array_equal(got, np.asarray(rs_pallas.apply_matrix(m, jnp.asarray(data), mxu="bf16")))
    assert np.array_equal(got, rs_cuda.plain_apply(m, torch.from_numpy(data), variant="bf16").numpy())


@pytest.mark.parametrize("name", ["rs_10_4", "decode_1_of_10", "cauchy_12_3", "merge_20_4",
                                  "random_5x17", "random_32x32", "random_1x1"])
def test_bf16_fragments_are_the_transposed_lift(name):
    """Unfolded from fragment order, B of tile r is the lift's block in bf16:
    B[32w + 8q + p][i] = 1.0 iff bit p of input row 4w + ROW_OF_SLOT[q]
    feeds bit i of output row r (the JAX package's byte-major `gf8` lift),
    0.0 past C."""
    m = MATRICES[name]()
    r_n, c_n = m.shape
    nw = -(-c_n // 4)
    frags = rs_cuda.bf16_fragments(rs_cuda.plane_major_matrix(m))
    assert frags.shape == (r_n, 2 * nw, 32, 2)
    lift = ref_gf8.gf_matrix_to_bits(m)  # row r*8 + i, column ci*8 + p
    for r in range(r_n):
        b = np.full((32 * nw, 8), np.nan, dtype=np.float32)
        for s in range(2 * nw):
            w, h = divmod(s, 2)
            for ln in range(32):
                g, t = ln >> 2, ln & 3
                for reg in range(2):
                    bit = 8 * h + 4 * reg + t
                    x = int(frags[r, s, ln, reg])
                    b[32 * w + bit, g], b[32 * w + bit + 16, g] = _bf16([x & 0xFFFF, x >> 16])
        want = np.zeros((32 * nw, 8), dtype=np.float32)
        for bit in range(32 * nw):
            ci, p = _row_of_bit(bit)
            if ci < c_n:
                want[bit] = lift[r * 8:r * 8 + 8, ci * 8 + p]
        assert np.array_equal(b, want)  # every K position filled exactly once


def _kernel_constant(name: str) -> int:
    """An integer constant of `csrc/gf_bf16.cu`, read from the source."""
    src = open(os.path.join(os.path.dirname(rs_cuda.__file__), "..", "csrc", "gf_bf16.cu")).read()
    return int(re.search(rf"constexpr uint32_t {name} = (\d+);", src).group(1))


@pytest.mark.parametrize("name", ["rs_10_4", "decode_4_of_10", "decode_1_of_10", "cauchy_12_3",
                                  "merge_20_4", "random_2x32"])
def test_bf16_wgmma_b_image_reads_back_the_lift(name):
    """The wgmma path stages the fragments in shared memory as the kernel
    does (fragment [r][s][lane] b0 at s * R * 256 + r * kSbo + 16g + 4t, b1
    kLbo further), and wgmma reads element (n, k) of each K step's B^T at
    (n // 8) * SBO + (k // 8) * LBO + 16 * (n % 8) + 2 * (k % 8) (a K-major
    operand with no swizzle; LBO and SBO are the descriptor's, the
    kernel's kLbo and kSbo): that must give back the lift in K order,
    bf16 1.0 or 0.0, with every byte of the image read once."""
    m = (np.random.default_rng(9).integers(0, 256, (2, 32), np.uint8) if name == "random_2x32"
         else MATRICES[name]())
    r_n, c_n = m.shape
    nw = -(-c_n // 4)
    lbo, sbo = _kernel_constant("kLbo"), _kernel_constant("kSbo")
    step = r_n * 256
    frags = rs_cuda.bf16_fragments(rs_cuda.plane_major_matrix(m))
    image = np.zeros(2 * nw * step, dtype=np.uint8)
    for r in range(r_n):
        for s in range(2 * nw):
            for ln in range(32):
                at = s * step + r * sbo + (ln >> 2) * 16 + (ln & 3) * 4
                image[at:at + 4] = _bytes(frags[r, s, ln, 0])
                image[at + lbo:at + lbo + 4] = _bytes(frags[r, s, ln, 1])
    halves = image.view("<u2")
    lift = ref_gf8.gf_matrix_to_bits(m)  # row r*8 + i, column ci*8 + p
    seen = np.zeros(len(halves), dtype=int)
    for s in range(2 * nw):
        w, h = divmod(s, 2)
        for n in range(8 * r_n):
            for k in range(16):
                at = s * step + (n // 8) * sbo + (k // 8) * lbo + 16 * (n % 8) + 2 * (k % 8)
                seen[at // 2] += 1
                bit = 32 * w + 8 * h + 4 * (k // 8) + (k % 8) // 2 + 16 * (k % 2)  # word-bit of K
                ci, p = _row_of_bit(bit)
                want = lift[n, ci * 8 + p] if ci < c_n else 0
                assert _bf16(halves[at // 2]) == float(want), (s, n, k)
    assert (seen == 1).all()


@pytest.mark.parametrize("bit", range(16))
def test_bf16_rotation_puts_a_bit_pair_in_the_halves(bit):
    """rotl(W, 14 - b) & 0x40004000 is bf16 2.0 or 0.0 in each half: the low
    half from bit b of W, the high half from bit b + 16 (b = 15 rotates
    right by one)."""
    h, rest = divmod(bit, 8)
    reg, t = divmod(rest, 4)
    rng = np.random.default_rng(bit)
    for word in [0, 0xFFFFFFFF, 1 << bit, 1 << (bit + 16)] + [int(x) for x in rng.integers(0, 2**32, 20)]:
        x = _a_register(word, h, reg, t)
        lo, hi = _bf16([x & 0xFFFF, x >> 16])
        assert lo == 2.0 * ((word >> bit) & 1) and hi == 2.0 * ((word >> (bit + 16)) & 1)


def test_bf16_sums_give_their_parity_through_the_float_word():
    """fma(2k, 0.5, 2^23) holds k in its low bits for every sum the kernel
    can make (2k <= 2 * 8C <= 512), so bit 0 of the word is k & 1."""
    k = np.arange(0, 257)
    sums = (2 * k).astype(np.float32)
    words = (sums * np.float32(0.5) + np.float32(8388608.0)).astype(np.float32).view(np.int32)
    assert np.array_equal(words & 0xFF, k & 0xFF)
    assert np.array_equal(words & 1, k & 1)


@pytest.mark.parametrize("c, rows", [(10, 4), (10, 1), (12, 3), (16, 4), (17, 4), (20, 4),
                                     (10, 5), (10, 8), (32, 32)])
def test_bf16_shared_memory_and_tile(c, rows):
    nw = -(-c // 4)
    b_image = 2 * nw * rows * 256 if rows <= 4 else 0  # wgmma's B, 256 bytes per row and K step
    assert rs_cuda.smem_bytes("bf16", c, rows) == (
        nw * (rs_cuda.SPAN + 8) * 4 + rows * (rs_cuda.SPAN + 16) + b_image)
    assert rs_cuda.smem_bytes("bf16", c, rows) <= rs_cuda.SMEM_PER_SM
    tile = rs_cuda.auto_tile(c, rows, "bf16")
    assert tile % rs_cuda.SPAN == 0 and rs_cuda.resolve_tile("bf16", None, c, rows) == tile


@pytest.mark.parametrize("variant, c, r, n, want_ms, want_by", [
    ("bf16", 10, 4, 6_553_600, 0.0339, "operations"),  # encode
    ("bf16", 10, 4, 4_194_304, 0.0217, "operations"),  # 4-lost rebuild
    ("bf16", 10, 1, 4_194_304, 0.0138, "bytes"),       # 1-lost rebuild
    ("int8", 10, 4, 6_553_600, 0.0274, "bytes"),
    ("dma", 10, 4, 6_553_600, 0.0274, "bytes"),
    ("dma", 32, 32, 4_194_304, 0.2778, "operations"),  # the int8 rate of its TPU kernel's product
])
def test_bound_ms_takes_each_variants_own_rate(variant, c, r, n, want_ms, want_by):
    ms, by = measure.bound_ms(variant, c, r, n)
    assert by == want_by and round(ms, 4) == want_ms
    batched, _ = measure.bound_ms(variant, c, r, n, batch=3)
    assert batched == pytest.approx(3 * ms)


def test_bound_ms_rejects_an_unknown_variant():
    with pytest.raises(ValueError, match="no bound"):
        measure.bound_ms("fp8", 10, 4, 1024)
