"""The port's GF(2^8) core and bit-plane application against the JAX
package: tables, generator matrices and lifts equal the reference's, and
the plain PyTorch path (`rs_torch.gf_apply`, what `rs_cuda.apply_matrix`
runs on CPU tensors) is byte-exact (tolerance 0: GF arithmetic is exact)
against `rs_jax.gf_apply`, the Pallas `_kernel` in interpret mode
(`rs_pallas.apply_matrix(mxu="int8")`) and the `gf8.gf_mat_vec` golden.
The popc arithmetic of the dma kernel (`gf_dma.cu` through
`gf_common.cuh:parity_rows`: mask layout, byte packing, popc parity) is
replayed in numpy here, since the kernel itself runs only on the card; the
int8 kernel's tensor-core arithmetic is replayed in
`tests/test_torch_int8_mma.py`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import gf8 as ref_gf8
from seaweedfs_tpu.ops import rs_jax, rs_pallas
from seaweedfs_tpu.ops import rs_codec as ref_codec
from seaweedfs_tpu_torch.ops import gf8, rs_codec, rs_cuda, rs_torch

FAMILIES = sorted(rs_codec.CODE_FAMILIES)


def _matrix(name: str) -> np.ndarray:
    if name in rs_codec.CODE_FAMILIES:
        g = rs_codec.CODE_FAMILIES[name]
        return gf8.parity_matrix(g.data_shards, g.parity_shards, g.matrix_kind)
    if name == "decode_4_of_10":  # lost 1, 6, 12, 13, as test_rs_pallas
        lost = (1, 6, 12, 13)
        surv = tuple(i for i in range(14) if i not in lost)
        return ref_codec._reconstruction_matrix("vandermonde", 10, 4, surv, lost)
    if name == "decode_1_lost":
        surv = tuple(i for i in range(14) if i != 3)[:10]
        return ref_codec._reconstruction_matrix("vandermonde", 10, 4, surv, (3,))
    raise KeyError(name)


MATRICES = FAMILIES + ["decode_4_of_10", "decode_1_lost"]
SHAPES = [(10, 128), (10, 100), (10, 8192), (2, 10, 8321), (1, 10, 24576)]


def _data(m: np.ndarray, shape: tuple, seed: int = 7) -> np.ndarray:
    shape = shape[:-2] + (m.shape[1], shape[-1])  # C follows the matrix
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def test_tables_equal_reference():
    assert np.array_equal(gf8.GF_EXP, ref_gf8.GF_EXP)
    assert np.array_equal(gf8.GF_LOG, ref_gf8.GF_LOG)
    assert np.array_equal(gf8.GF_MUL_TABLE, ref_gf8.GF_MUL_TABLE)


@pytest.mark.parametrize("family", FAMILIES)
def test_generator_and_lift_equal_reference(family):
    g = rs_codec.CODE_FAMILIES[family]
    mine = gf8.generator_matrix(g.matrix_kind, g.data_shards, g.total_shards)
    ref = ref_gf8.generator_matrix(g.matrix_kind, g.data_shards, g.total_shards)
    assert np.array_equal(mine, ref)
    assert np.array_equal(
        gf8.parity_matrix(g.data_shards, g.parity_shards, g.matrix_kind),
        ref_gf8.parity_matrix(g.data_shards, g.parity_shards, g.matrix_kind),
    )
    assert np.array_equal(gf8.gf_matrix_to_bits(mine), ref_gf8.gf_matrix_to_bits(ref))


@pytest.mark.parametrize("c", [0, 1, 2, 0x1D, 0x80, 0xFF])
def test_const_lift_and_inverse_equal_reference(c):
    assert np.array_equal(gf8.gf_const_to_bits(c), ref_gf8.gf_const_to_bits(c))
    m = gf8.vandermonde(10, 10)
    assert np.array_equal(gf8.gf_mat_inv(m), ref_gf8.gf_mat_inv(m))


@pytest.mark.parametrize("name", MATRICES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_apply_matches_three_references(name, shape):
    m = _matrix(name)
    data = _data(m, shape)
    got = rs_cuda.apply_matrix(m, torch.from_numpy(data)).numpy()
    assert got.dtype == np.uint8
    assert got.shape == data.shape[:-2] + (m.shape[0], data.shape[-1])
    b = rs_jax.lifted_matrix(m)
    assert np.array_equal(got, np.asarray(rs_jax.gf_apply(b, jnp.asarray(data))))
    if data.ndim == 2:
        golden = gf8.gf_mat_vec(m, data)
    else:
        golden = np.stack([gf8.gf_mat_vec(m, d) for d in data])
    assert np.array_equal(got, golden)


@pytest.mark.parametrize("name", MATRICES)
@pytest.mark.parametrize("shape", [(10, 100), (2, 10, 8321), (1, 10, 24576)])
def test_plain_apply_matches_pallas_int8_kernel(name, shape):
    """The reference's `_kernel`, run in Pallas interpret mode off TPU."""
    m = _matrix(name)
    data = _data(m, shape, seed=11)
    got = rs_torch.gf_apply(rs_torch.lifted_matrix(m), torch.from_numpy(data)).numpy()
    want = np.asarray(rs_pallas.apply_matrix(m, jnp.asarray(data), mxu="int8"))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("shape", [(10, 1), (10, 333), (3, 10, 77)])
def test_bit_planes_match_reference(shape):
    data = np.random.default_rng(3).integers(0, 256, size=shape, dtype=np.uint8)
    bits = rs_torch.bytes_to_bits(torch.from_numpy(data)).numpy()
    assert np.array_equal(bits, np.asarray(rs_jax.bytes_to_bits(jnp.asarray(data))))
    assert np.array_equal(rs_torch.bits_to_bytes(torch.from_numpy(bits)).numpy(), data)


@pytest.mark.parametrize("name", MATRICES)
def test_lift_from_reference_is_plane_major_operand(name):
    """The weight carry: the JAX package's byte-major lift turns into the
    port's plane-major operand, which is also the reference kernel's."""
    m = _matrix(name)
    carried = rs_cuda.lift_from_reference(np.asarray(rs_jax.lifted_matrix(m)))
    assert carried.dtype == torch.int8
    assert torch.equal(carried, rs_cuda.plane_major_matrix(m))
    assert np.array_equal(carried.numpy(), np.asarray(rs_pallas.plane_major_matrix(m)))


def _kernel_replay(masks: np.ndarray, m_shape: tuple, data: np.ndarray) -> np.ndarray:
    """numpy replay of what the popc masks mean: a column's bytes of rows
    4w..4w+3 packed little-endian into word w, output bit (r, i) the
    parity of popc(XOR_w mask[(r*8+i)*NW + w] & word[w]). The masks are
    what `lift_fragments` lays out as the 1-bit B operand of the int8 and
    dma kernels (`gf_bitplane.cu`, `gf_dma.cu`)."""
    r_n, c_n = m_shape
    nw = -(-c_n // 4)
    rows = np.zeros((4 * nw, data.shape[1]), dtype=np.uint8)
    rows[:c_n] = data
    words = np.ascontiguousarray(rows.T).view("<u4")  # (N, NW)
    out = np.zeros((r_n, data.shape[1]), dtype=np.uint8)
    for r in range(r_n):
        for i in range(8):
            mk = masks[(r * 8 + i) * nw : (r * 8 + i + 1) * nw]
            x = np.bitwise_xor.reduce(words & mk[None, :], axis=1)
            parity = np.unpackbits(x.view(np.uint8).reshape(-1, 4), axis=1).sum(axis=1) & 1
            out[r] |= parity.astype(np.uint8) << i
    return out


@pytest.mark.parametrize(
    "name", MATRICES + ["random_32x32", "random_1x1", "random_5x17"]
)
def test_kernel_mask_operand_replays_to_golden(name):
    rng = np.random.default_rng(5)
    if name.startswith("random_"):
        r_n, c_n = (int(v) for v in name.split("_")[1].split("x"))
        m = rng.integers(0, 256, size=(r_n, c_n), dtype=np.uint8)
    else:
        m = _matrix(name)
    masks = rs_cuda.kernel_masks(rs_cuda.plane_major_matrix(m))
    assert masks.dtype == np.uint32
    assert masks.size == m.shape[0] * 8 * -(-m.shape[1] // 4)
    data = rng.integers(0, 256, size=(m.shape[1], 257), dtype=np.uint8)
    assert np.array_equal(_kernel_replay(masks, m.shape, data), gf8.gf_mat_vec(m, data))


def test_wrapper_takes_strided_cpu_view_to_plain_version():
    m = _matrix("rs_10_4")
    slot = np.random.default_rng(9).integers(0, 256, size=(10, 4096), dtype=np.uint8)
    before = rs_cuda.launches
    got = rs_cuda.apply_matrix(m, torch.from_numpy(slot)[:, :1000]).numpy()
    assert np.array_equal(got, gf8.gf_mat_vec(m, slot[:, :1000]))
    assert rs_cuda.launches == before  # the CPU path launches no kernel


@pytest.mark.parametrize(
    "shards, matrix_cols, err",
    [
        (torch.zeros((10, 8), dtype=torch.int32), 10, TypeError),
        (torch.zeros((80,), dtype=torch.uint8), 10, ValueError),
        (torch.zeros((12, 8), dtype=torch.uint8), 10, ValueError),
        (torch.zeros((10, 8), dtype=torch.uint8, device="meta"), 10, ValueError),
    ],
)
def test_wrapper_rejects_what_it_does_not_take(shards, matrix_cols, err):
    with pytest.raises(err):
        rs_cuda.apply_matrix(np.ones((4, matrix_cols), dtype=np.uint8), shards)


def test_lifted_matrix_cached_by_value():
    m = _matrix("rs_10_4")
    assert rs_torch.lifted_matrix(m) is rs_torch.lifted_matrix(m.copy())
    assert rs_cuda.plane_major_matrix(m) is rs_cuda.plane_major_matrix(m.copy())


def test_empty_width_applies_to_empty():
    m = _matrix("rs_10_4")
    out = rs_cuda.apply_matrix(m, torch.zeros((10, 0), dtype=torch.uint8))
    assert tuple(out.shape) == (4, 0)
