"""The u8 and mplane kernels' tensor-core formulation (`csrc/gf_mma.cu`),
replayed lane by lane in numpy on the CPU, since the kernels run only on
the card. The B operand (`rs_cuda.s8_fragments`), the A registers the
kernels build from column words, the int32 sums of mma.m16n8k32 (int8;
m16n8k16 for mplane at C <= 16) placed by the PTX fragment layouts, and the int8 pack product over their
parities must give the GF(2^8) product byte for byte (tolerance 0: GF
arithmetic is exact), against the JAX package's `gf8.gf_mat_vec` golden and
the port's plain version of each variant; the shared memory and tiles the
wrapper plans for the kernels follow their layout."""

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import gf8 as ref_gf8
from seaweedfs_tpu_torch.ops import rs_cuda
from test_torch_int8_mma import MATRICES, _bytes, _column_words, _pack_b

VARIANTS = ("u8", "mplane")


def _stack_input(variant: str, c_n: int, k: int) -> tuple:
    """(input row, plane) of K index k of the variant's stack (row >= C is
    padding): u8, k = 4q + e for stack word q = j*NW + w, row 4w + e, plane
    j; mplane, step k // 32 is the plane and k % 32 the row."""
    nw = -(-c_n // 4)
    if variant == "u8":
        j, w = divmod(k // 4, nw)
        return 4 * w + k % 4, j
    return k % 32, k // 32


def _unfold(frags: np.ndarray, r: int) -> np.ndarray:
    """B of output row r as a (32 S, 8) 0/1 matrix: K byte 16h + 4t + e of
    step s is byte e of entry [r, s, 4g + t, h], column g."""
    steps = frags.shape[1]
    b = np.zeros((32 * steps, 8), dtype=np.int64)
    for s in range(steps):
        for ln in range(32):
            g, t = ln >> 2, ln & 3
            for h in range(2):
                b[32 * s + 16 * h + 4 * t:32 * s + 16 * h + 4 * t + 4, g] = _bytes(frags[r, s, ln, h])
    return b


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_s8_fragments_are_the_transposed_lift(variant, name):
    """Unfolded from fragment order, B of tile r is the JAX package's
    byte-major lift of output row r in the variant's K order, 0 for padding
    rows; the product of the 0/1 stack with it, mod 2, is the golden."""
    m = MATRICES[name]()
    r_n, c_n = m.shape
    frags = rs_cuda.s8_fragments(rs_cuda.plane_major_matrix(m), variant)
    steps = rs_cuda.s8_steps(variant, c_n)
    assert frags.dtype == np.uint32 and frags.shape == (r_n, steps, 32, 2)
    lift = ref_gf8.gf_matrix_to_bits(m)  # row r*8 + i, column ci*8 + p
    data = np.random.default_rng(len(name)).integers(0, 256, (c_n, 53), np.uint8)
    stack = np.zeros((32 * steps, data.shape[1]), dtype=np.int64)
    want = np.zeros((32 * steps, 8), dtype=np.int64)
    for k in range(32 * steps):
        row, plane = _stack_input(variant, c_n, k)
        if row < c_n:
            stack[k] = (data[row] >> plane) & 1
    out = np.zeros((r_n, data.shape[1]), dtype=np.uint8)
    for r in range(r_n):
        for k in range(32 * steps):
            row, plane = _stack_input(variant, c_n, k)
            want[k] = lift[r * 8:r * 8 + 8, row * 8 + plane] if row < c_n else 0
        b = _unfold(frags, r)
        assert np.array_equal(b, want)
        sums = stack.T @ b  # [column, bit i]
        assert sums.max() <= 8 * c_n
        out[r] = ((sums & 1) << np.arange(8)).sum(axis=1)
    assert np.array_equal(out, ref_gf8.gf_mat_vec(m, data))


def _a_fragments(variant: str, words: np.ndarray, nb: int, steps: int) -> list:
    """The A operand of each K step of the M tile at column nb, (16, 32),
    as the kernel builds it lane by lane (`a_fragments`): a0/a1 K bytes
    4t..4t+3 of columns g and g + 8, a2/a3 bytes 16 + 4t..; each register
    (W >> j) & 0x01010101 of one column word."""
    nw = words.shape[0]
    a = [np.zeros((16, 32), dtype=np.int64) for _ in range(steps)]
    for ln in range(32):
        g, t = ln >> 2, ln & 3
        for s in range(steps):
            for h in range(2):
                if variant == "u8":
                    j, w = divmod(8 * s + 4 * h + t, nw)
                else:
                    j, w = s, 4 * h + t
                for row in (g, g + 8):
                    x = (int(words[w, nb + row]) >> j) & 0x01010101 if w < nw else 0
                    a[s][row, 16 * h + 4 * t:16 * h + 4 * t + 4] = _bytes(x)
    return a


def _pack(d: np.ndarray) -> np.ndarray:
    """`gf::pack_group` for one M tile and group of 4 output rows: the A
    bytes of the pack product are the sums' parities laid out by their C
    layout (lane t holds bits 2t, 2t + 1 of n-tiles nt), B holds 2^bit;
    returns the (16, 8) product, whose column 2t + h is row 2t + h of the
    group for lanes t < 2."""
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
    return o


def _lane_replay(variant: str, frags: np.ndarray, data: np.ndarray, r_n: int) -> np.ndarray:
    """gf_mma.cu's arithmetic lane by lane: per M tile of 16 columns the A
    fragments of every step, then per group of 4 output rows the products
    d[nt] += A_s . B_s (B unfolded from the lane's fragment registers; for
    mplane at C <= 16 an m16n8k16 on K bytes 0-15, since a2/a3 and b1 are
    zero), the pack, and the stores of lanes t < 2."""
    c_n, n = data.shape
    n16 = -(-n // 16) * 16  # the kernel loads zero past the edge
    padded = np.zeros((c_n, n16), dtype=np.uint8)
    padded[:, :n] = data
    words = _column_words(padded)
    steps = frags.shape[1]
    kk = 16 if variant == "mplane" and words.shape[0] <= 4 else 32
    b = [_unfold(frags, r) for r in range(r_n)]
    out = np.zeros((r_n, n16), dtype=np.uint8)
    for nb in range(0, n16, 16):
        a = _a_fragments(variant, words, nb, steps)
        for rg in range(0, r_n, 4):
            d = np.zeros((4, 16, 8), dtype=np.int64)
            for nt in range(4):
                if rg + nt < r_n:
                    for s in range(steps):
                        bs = b[rg + nt][32 * s:32 * s + 32]
                        assert not a[s][:, kk:].any() and not bs[kk:].any()
                        d[nt] += a[s][:, :kk] @ bs[:kk]
            assert d.max() <= 8 * c_n
            o = _pack(d)
            for t in range(2):
                for h in range(2):  # rows rg + 2t (o[0], o[2]) and rg + 2t + 1
                    if rg + 2 * t + h < r_n:
                        out[rg + 2 * t + h, nb:nb + 8] = o[:8, 2 * t + h]
                        out[rg + 2 * t + h, nb + 8:nb + 16] = o[8:, 2 * t + h]
    return out[:, :n]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", ["rs_10_4", "merge_20_4", "decode_1_lost", "random_5x17"])
def test_s8_lanes_replay_to_golden(variant, name):
    m = MATRICES[name]()
    frags = rs_cuda.s8_fragments(rs_cuda.plane_major_matrix(m), variant)
    data = np.random.default_rng(len(name)).integers(0, 256, (m.shape[1], 37), np.uint8)
    got = _lane_replay(variant, frags, data, m.shape[0])
    assert np.array_equal(got, ref_gf8.gf_mat_vec(m, data))
    assert np.array_equal(got, rs_cuda.plain_apply(m, torch.from_numpy(data), variant=variant).numpy())


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("c, rows", [(10, 4), (10, 1), (12, 3), (20, 4), (17, 5), (32, 32), (1, 1)])
def test_s8_shared_memory_fits_and_follows_where_the_fragments_live(variant, c, rows):
    """Column words, the output tile and, past 4 output rows, the B
    fragments in whole groups of 4 rows (8 bytes per lane per step); the
    auto tile is one trip of SPAN columns."""
    nw = -(-c // 4)
    steps = nw if variant == "u8" else 8
    assert rs_cuda.s8_steps(variant, c) == steps
    base = nw * (rs_cuda.SPAN + 8) * 4 + rows * (rs_cuda.SPAN + 16)
    frags = 0 if rows <= 4 else -(-rows // 4) * 4 * steps * 32 * 8
    assert rs_cuda.smem_bytes(variant, c, rows) == base + frags
    assert rs_cuda.smem_bytes(variant, c, rows) <= rs_cuda.SMEM_PER_SM
    assert rs_cuda.auto_tile(c, rows, variant) == rs_cuda.SPAN
    assert rs_cuda.resolve_tile(variant, None, c, rows) == rs_cuda.SPAN


@pytest.mark.parametrize("variant", VARIANTS)
def test_s8_kernels_take_any_tile_that_is_a_multiple_of_128(variant):
    """The trip loop masks its edge, so u8 and mplane take tiles below and
    off the 2048-column trip, as int8 does; bf16 keeps whole trips."""
    for tile in (128, 1024, 2176, 8192):
        assert rs_cuda.resolve_tile(variant, tile, 10, 4) == tile
    for tile in (0, 100, 2064, -128):
        with pytest.raises(ValueError, match="multiple of 128"):
            rs_cuda.resolve_tile(variant, tile, 10, 4)
    with pytest.raises(ValueError, match="multiple of 2048"):
        rs_cuda.resolve_tile("bf16", 1024, 10, 4)


def test_u8_pair_layout_puts_columns_g_and_g_plus_8_in_one_load():
    """u8 stages its column words in pairs (`gf::stage_words` with kPairs):
    a thread's uint4 store s holds the words of its columns 2s, 2s + 8,
    2s + 1, 2s + 9, so column k of 16 lands at 2 (k % 8) + k // 8 and the
    8-byte load at 2g of an M tile is columns g and g + 8: a0 and a1 (or a2
    and a3) of lane (g, t)."""
    stored = [c for s in range(4) for c in (2 * s, 2 * s + 8, 2 * s + 1, 2 * s + 9)]
    assert sorted(stored) == list(range(16))
    for k in range(16):
        assert stored[2 * (k % 8) + k // 8] == k
    for g in range(8):
        assert stored[2 * g:2 * g + 2] == [g, g + 8]
