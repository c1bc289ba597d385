"""The port's kernel variants (dma, mplane, u8, bf16) against the JAX
package's Pallas variants of the same names, on the CPU: the plain version
each variant's wrapper runs on a CPU tensor is byte-exact (tolerance 0:
GF arithmetic is exact) against `rs_pallas.gf_apply_fused(mxu=v)` in
interpret mode, the encoder and stripe engine carrying a variant give the
reference's bytes. The kernels' own layouts are pinned without a card by
lane-level numpy replays: `tests/test_torch_int8_mma.py` (int8),
`test_torch_bf16_mma.py` (bf16) and `test_torch_s8_mma.py` (u8, mplane)."""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seaweedfs_tpu.ec import stripe as ref_stripe
from seaweedfs_tpu.ops import rs_codec as ref_codec
from seaweedfs_tpu.ops import rs_jax, rs_pallas
from seaweedfs_tpu_torch.ec import stripe
from seaweedfs_tpu_torch.ops import gf8, rs_codec, rs_cuda, rs_torch

NEW_VARIANTS = ("dma", "mplane", "u8", "bf16")


def _decode_4_of_10() -> np.ndarray:
    lost = (1, 6, 12, 13)  # as tests/test_rs_pallas.py
    surv = tuple(i for i in range(14) if i not in lost)
    return ref_codec._reconstruction_matrix("vandermonde", 10, 4, surv, lost)


MATRICES = {
    "rs_10_4": lambda: gf8.parity_matrix(10, 4),
    "decode_4_of_10": _decode_4_of_10,
    "cauchy_12_3": lambda: gf8.parity_matrix(12, 3, "cauchy"),
    "merge_20_4": lambda: gf8.parity_matrix(20, 4, "cauchy"),
}
#: the shapes of tests/test_rs_pallas.py (C follows the matrix)
SHAPES = [(10, 128), (10, 100), (10, 8192), (2, 10, 8321), (1, 10, 3 * 8192)]


def _data(m: np.ndarray, shape: tuple, seed: int = 7) -> np.ndarray:
    shape = shape[:-2] + (m.shape[1], shape[-1])
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def _reference(m: np.ndarray, data: np.ndarray, variant: str, tile=None) -> np.ndarray:
    bits = rs_jax.lifted_matrix(m)
    return np.asarray(rs_pallas.gf_apply_fused(bits, jnp.asarray(data), tile=tile, mxu=variant))


@pytest.mark.parametrize("variant", NEW_VARIANTS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_variant_matches_pallas_variant(variant, shape):
    m = MATRICES["rs_10_4"]()
    data = _data(m, shape)
    got = rs_cuda.apply_matrix(m, torch.from_numpy(data), variant=variant).numpy()
    assert got.dtype == np.uint8
    assert np.array_equal(got, _reference(m, data, variant))


@pytest.mark.parametrize("variant", NEW_VARIANTS)
@pytest.mark.parametrize("name", ["decode_4_of_10", "cauchy_12_3", "merge_20_4"])
def test_variant_matches_pallas_variant_other_matrices(variant, name):
    m = MATRICES[name]()
    data = _data(m, (2, 10, 8321) if name != "decode_4_of_10" else (10, 500), seed=8)
    got = rs_cuda.apply_matrix(m, torch.from_numpy(data), variant=variant).numpy()
    assert np.array_equal(got, _reference(m, data, variant))
    golden = gf8.gf_mat_vec(m, data.reshape(-1, *data.shape[-2:])[0])
    assert np.array_equal(got.reshape(-1, *got.shape[-2:])[0], golden)


@pytest.mark.parametrize("variant", NEW_VARIANTS)
def test_variant_explicit_tile_matches_pallas(variant):
    m = MATRICES["rs_10_4"]()
    data = _data(m, (1, 10, 3 * 8192 + 77), seed=9)
    got = rs_cuda.apply_matrix(m, torch.from_numpy(data), tile=8192, variant=variant).numpy()
    assert np.array_equal(got, _reference(m, data, variant, tile=8192))


def test_dma_chunk_and_tile_steps_match_reference():
    assert rs_cuda._TILE_STEPS == rs_pallas._TILE_STEPS
    assert rs_cuda.DMA_CHUNK == rs_pallas.DMA_CHUNK
    for t in rs_pallas._TILE_STEPS + (8448,):
        assert rs_cuda._dma_chunk(t) == rs_pallas._dma_chunk(t), t
        assert t % rs_cuda._dma_chunk(t) == 0


@pytest.mark.parametrize("variant", rs_codec.FUSED_VARIANTS)
@pytest.mark.parametrize("c, rows", [(10, 4), (10, 1), (12, 3), (20, 4), (32, 32), (1, 1)])
def test_auto_tile_fits_the_kernel(variant, c, rows):
    t = rs_cuda.auto_tile(c, rows, variant)
    assert t == rs_cuda.resolve_tile(variant, None, c, rows)
    assert rs_cuda.resolve_tile(variant, t, c, rows) == t  # the kernel takes its own tile
    assert rs_cuda.smem_bytes(variant, c, rows) <= rs_cuda.SMEM_PER_SM
    if variant == "int8":
        assert t == rs_cuda.SPAN
    elif variant == "dma":
        assert t >= 2 * rs_cuda._dma_chunk(t)  # the ring has two stages to overlap


def test_variant_table_and_bad_variant_or_tile():
    assert tuple(rs_cuda.KERNELS) == rs_codec.FUSED_VARIANTS == ref_codec.FUSED_VARIANTS
    m = MATRICES["rs_10_4"]()
    x = torch.zeros((10, 64), dtype=torch.uint8)
    with pytest.raises(ValueError, match="unknown variant"):
        rs_cuda.apply_matrix(m, x, variant="fp8")
    with pytest.raises(ValueError, match="multiple of 2048"):
        rs_cuda.apply_matrix(m, x, tile=1024, variant="bf16")
    for variant in ("u8", "mplane"):  # off the 2048-column trip, as int8
        for tile in (128, 1024):
            assert torch.equal(rs_cuda.apply_matrix(m, x, tile=tile, variant=variant),
                               rs_cuda.plain_apply(m, x, variant=variant))
    with pytest.raises(ValueError, match="multiple of 128"):
        rs_cuda.apply_matrix(m, x, tile=100, variant="dma")
    with pytest.raises(ValueError, match="unknown variant"):
        rs_codec.Encoder(10, 4, device="cpu", variant="xla")


# -- the plain versions' product -----------------------------------------------


def test_plain_product_leaves_the_tf32_flag_as_found():
    m = MATRICES["rs_10_4"]()
    data = torch.from_numpy(_data(m, (10, 300)))
    flag0 = torch.backends.cuda.matmul.allow_tf32
    try:
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = flag
            for variant in rs_codec.FUSED_VARIANTS:
                rs_cuda.apply_matrix(m, data, variant=variant)
            with rs_torch.exact_float32():
                assert torch.backends.cuda.matmul.allow_tf32 is False
            assert torch.backends.cuda.matmul.allow_tf32 == flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag0


# -- the encoder and the stripe engine carrying a variant ----------------------


@pytest.mark.parametrize("variant", NEW_VARIANTS)
def test_encoder_variant_matches_reference_pallas_encoder(variant):
    mine = rs_codec.Encoder(10, 4, device="cpu", variant=variant)
    ref = ref_codec.Encoder(10, 4, backend="pallas", pallas_mxu=variant)
    data = np.random.default_rng(3).integers(0, 256, size=(10, 1000), dtype=np.uint8)
    got, want = mine.encode(list(data)), ref.encode(list(data))
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    lost = [None if i in (0, 5, 10, 13) else s for i, s in enumerate(got)]
    back, ref_back = mine.reconstruct(list(lost)), ref.reconstruct(list(lost))
    assert all(np.array_equal(a, b) for a, b in zip(back, ref_back))
    assert all(np.array_equal(a, b) for a, b in zip(back, got))
    assert mine.selection["variant"] == variant


@pytest.mark.parametrize("variant", NEW_VARIANTS)
def test_write_ec_files_with_variant_identical_to_reference(tmp_path, variant):
    size, large, small = 2 * 10 * 16384 + 4321, 16384, 4096
    blob = np.random.default_rng(4).integers(0, 256, size, dtype=np.uint8).tobytes()
    bases = []
    for sub in ("port", "ref"):
        os.makedirs(tmp_path / sub)
        base = str(tmp_path / sub / "9")
        with open(base + ".dat", "wb") as f:
            f.write(blob)
        bases.append(base)
    kw = dict(large_block_size=large, small_block_size=small, buffer_size=4096,
              max_batch_bytes=10 * 3 * 4096)
    stripe.write_ec_files(bases[0], encoder=rs_codec.Encoder(10, 4, device="cpu", variant=variant), **kw)
    ref_stripe.write_ec_files(
        bases[1], encoder=ref_codec.Encoder(10, 4, backend="pallas", pallas_mxu=variant), **kw)
    for ext in [stripe.to_ext(s) for s in range(14)] + [".eci"]:
        with open(bases[0] + ext, "rb") as a, open(bases[1] + ext, "rb") as b:
            assert a.read() == b.read(), ext


def test_encoder_for_info_sibling_keeps_variant_and_tile(tmp_path):
    base = str(tmp_path / "5")
    stripe.write_ec_info(base, 16384, 4096, 1000,
                         geometry=rs_codec.CODE_FAMILIES["cauchy_12_3"])
    default = rs_codec.Encoder(10, 4, device="cpu", variant="mplane", tile=8192)
    sib = stripe.encoder_for_base(base, default)
    assert (sib.data_shards, sib.parity_shards, sib.matrix_kind) == (12, 3, "cauchy")
    assert (sib.variant, sib.tile, sib.device) == ("mplane", 8192, default.device)
    assert sib.selection["source"] == "geometry-sibling"
    shutil.rmtree(tmp_path)
