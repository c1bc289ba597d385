"""The port's `Encoder(device="cpu")` against the reference
`Encoder(backend="numpy")`: encode, batched encode, reconstruct of data,
parity and mixed losses, the lazy and batched repair forms, verify,
split/join, for all three code families; byte-exact (tolerance 0). Also the
factory's refusal to run without a card, the state carry
(`encoder_from_arrays`), and the port's env registry."""

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import rs_codec as ref_codec
from seaweedfs_tpu_torch.ops import rs_codec
from seaweedfs_tpu_torch.utils import config

FAMILIES = sorted(rs_codec.CODE_FAMILIES)


def _pair(family: str):
    g = rs_codec.CODE_FAMILIES[family]
    mine = rs_codec.new_encoder(family=family, device="cpu")
    ref = ref_codec.Encoder(g.data_shards, g.parity_shards, g.matrix_kind, backend="numpy")
    return mine, ref


def _loss_patterns(k: int, m: int) -> dict:
    return {
        "data": [0, k - 1][: m],
        "parity": list(range(k, k + m)),
        "mixed": [1, k, k + m - 1, k // 2][:m],
    }


def _shards(enc, n: int, seed: int = 1) -> list:
    rng = np.random.default_rng(seed)
    return list(rng.integers(0, 256, size=(enc.data_shards, n), dtype=np.uint8))


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("n", [1, 100, 8193])
def test_encode_matches_reference(family, n):
    mine, ref = _pair(family)
    data = _shards(mine, n)
    got, want = mine.encode(data), ref.encode(data)
    assert len(got) == mine.total_shards
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("family", FAMILIES)
def test_encode_batch_and_lazy_match_reference(family):
    mine, ref = _pair(family)
    rng = np.random.default_rng(2)
    data = rng.integers(0, 256, size=(3, mine.data_shards, 777), dtype=np.uint8)
    assert np.array_equal(mine.encode_batch(data), ref.encode_batch(data))
    lazy = mine.encode_parity_lazy(data[1])
    assert lazy.shape == (mine.parity_shards, 777)
    assert np.array_equal(np.asarray(lazy), np.asarray(ref.encode_parity_lazy(data[1])))
    with pytest.raises(ValueError):
        mine.encode_parity_lazy(data[:, :-1])


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("pattern", ["data", "parity", "mixed"])
def test_reconstruct_matches_reference(family, pattern):
    mine, ref = _pair(family)
    full = ref.encode(_shards(mine, 1000, seed=3))
    lost = _loss_patterns(mine.data_shards, mine.parity_shards)[pattern]
    holes = [None if i in lost else s for i, s in enumerate(full)]
    got = mine.reconstruct(list(holes))
    want = ref.reconstruct(list(holes))
    for i in range(mine.total_shards):
        assert np.array_equal(got[i], want[i]) and np.array_equal(got[i], full[i])
    data_only = mine.reconstruct(list(holes), data_only=True)
    for i in lost:
        assert (data_only[i] is None) == (i >= mine.data_shards)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("pattern", ["data", "parity", "mixed"])
def test_reconstruct_lazy_and_batch_match_reference(family, pattern):
    mine, ref = _pair(family)
    k = mine.data_shards
    lost = _loss_patterns(k, mine.parity_shards)[pattern]
    survivors = [i for i in range(mine.total_shards) if i not in lost][:k]
    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, size=(2, k, 513), dtype=np.uint8)
    full = ref.encode_batch(data)
    stack = full[:, survivors]
    assert np.array_equal(
        mine.reconstruction_matrix(survivors, lost), ref.reconstruction_matrix(survivors, lost)
    )
    flat = np.asarray(mine.reconstruct_lazy(stack[0], survivors, lost))
    assert np.array_equal(flat, np.asarray(ref.reconstruct_lazy(stack[0], survivors, lost)))
    batch = mine.reconstruct_batch(stack, survivors, lost)
    assert np.array_equal(batch, ref.reconstruct_batch(stack, survivors, lost))
    assert np.array_equal(batch, full[:, lost])


@pytest.mark.parametrize("family", FAMILIES)
def test_verify_matches_reference(family):
    mine, ref = _pair(family)
    full = ref.encode(_shards(mine, 300, seed=5))
    assert mine.verify(full) and ref.verify(full)
    bad = [s.copy() for s in full]
    bad[-1][7] ^= 1
    assert not mine.verify(bad) and not ref.verify(bad)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("blob", [b"x", bytes(range(256)) * 3 + b"tail"])
def test_split_join_match_reference(family, blob):
    mine, ref = _pair(family)
    got, want = mine.split(blob), ref.split(blob)
    assert len(got) == mine.data_shards
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    assert mine.join(got, len(blob)) == ref.join(want, len(blob)) == blob
    with pytest.raises(ValueError):
        mine.split(b"")


@pytest.mark.parametrize("family", FAMILIES)
def test_encoder_from_reference_arrays(family):
    """The codec's carried state is its matrices: built from the reference's
    generator, the port encoder is the port's own construction."""
    g = rs_codec.CODE_FAMILIES[family]
    _, ref = _pair(family)
    enc = rs_codec.encoder_from_arrays(ref.gen_matrix, g.data_shards, device="cpu")
    assert (enc.data_shards, enc.parity_shards, enc.matrix_kind) == (
        g.data_shards, g.parity_shards, g.matrix_kind,
    )
    assert enc.family == family
    assert np.array_equal(enc.gen_matrix, ref.gen_matrix)
    assert np.array_equal(enc.parity_matrix, ref.parity_matrix)
    tampered = np.array(ref.gen_matrix)
    tampered[-1, 0] ^= 1
    with pytest.raises(ValueError):
        rs_codec.encoder_from_arrays(tampered, g.data_shards, device="cpu")


def test_attributes_mirror_reference_surface():
    enc = rs_codec.new_encoder(device="cpu")
    assert enc.backend == "torch" and enc.family == "rs_10_4"
    assert enc.width_align == 1
    assert enc.selection["backend"] == "torch" and enc.selection["device"] == "cpu"
    assert enc.gen_matrix.shape == (14, 10) and enc.parity_matrix.shape == (4, 10)
    assert rs_codec.geometry_for("cauchy_12_3").overhead == 1.25
    assert rs_codec.family_of(20, 4, "cauchy") == "merge_20_4"
    assert rs_codec.family_of(6, 3, "vandermonde") is None
    with pytest.raises(ValueError):
        rs_codec.geometry_for("rs_9_9")


def test_new_encoder_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rs_codec.new_encoder()
    with pytest.raises(RuntimeError):
        rs_codec.new_encoder(device="cuda")
    assert rs_codec.new_encoder(device="cpu").backend == "torch"


@pytest.mark.parametrize("backend", ["cuda", "numpy", "pallas"])
def test_cpu_encoder_takes_only_the_plain_backend(backend):
    with pytest.raises(ValueError):
        rs_codec.Encoder(10, 4, backend=backend, device="cpu")


def test_reconstruction_matrix_validates():
    enc = rs_codec.new_encoder(device="cpu")
    with pytest.raises(ValueError):
        enc.reconstruction_matrix(list(range(9)), [13])
    with pytest.raises(ValueError):
        enc.reconstruction_matrix(list(range(10)), [])
    with pytest.raises(ValueError):
        enc.reconstruction_matrix(list(range(10)), [14])
    with pytest.raises(ValueError):
        enc.reconstruct([None] * 5 + [np.zeros(4, np.uint8)] * 9)


def test_env_registry_defaults_clamps_and_unknown_names(monkeypatch):
    for name in config.ENV_REGISTRY:
        monkeypatch.delenv(name, raising=False)
    assert config.env("WEEDTPU_PIPELINE_DEPTH") == 2
    assert config.env("WEEDTPU_DECODE_MATRIX_CACHE") == 512
    monkeypatch.setenv("WEEDTPU_PIPELINE_DEPTH", "0")
    monkeypatch.setenv("WEEDTPU_REBUILD_PREFETCH_BATCHES", "-3")
    assert config.env("WEEDTPU_PIPELINE_DEPTH") == 1
    assert config.env("WEEDTPU_REBUILD_PREFETCH_BATCHES") == 1
    with pytest.raises(KeyError):
        config.env("WEEDTPU_PIPELINE_DEPHT")


@pytest.mark.parametrize("k, m", [(40, 8), (10, 33), (33, 1)])
def test_card_encoder_rejects_at_construction_what_its_kernels_do_not_take(k, m):
    """Every matrix a cuda encoder dispatches has C = data_shards and R <=
    parity_shards (encode) or len(wanted) rows, and the kernels take R, C <=
    32, so the card's encoder raises when it is built, not at its first
    dispatch. The CPU backend keeps the reference's k + m <= 256."""
    with pytest.raises(ValueError, match="R, C <= 32"):
        rs_codec.Encoder(k, m, device="cuda")
    mine = rs_codec.Encoder(k, m, device="cpu")
    ref = ref_codec.Encoder(k, m, backend="numpy")
    data = _shards(mine, 64, seed=k + m)
    assert all(np.array_equal(a, b) for a, b in zip(mine.encode(data), ref.encode(data)))


def test_card_encoder_takes_32_by_32_and_names_the_way_around_the_row_limit(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(rs_codec, "_artifacts_dir", lambda: str(tmp_path))  # no evidence
    enc = rs_codec.new_encoder(32, 32)  # constructs: nothing touches the card yet
    assert enc.backend == "cuda" and (enc.data_shards, enc.parity_shards) == (32, 32)
    with pytest.raises(ValueError, match="R, C <= 32"):
        rs_codec.new_encoder(40, 8)
    # a reconstruct of more than 32 wanted rows still reaches the kernel's
    # check at the call; its message names the limit and the ways around it
    with pytest.raises(ValueError, match=r"at most 32 rows per call.*device='cpu'"):
        rs_codec.rs_cuda.check_shape(40, 32)
    rs_codec.rs_cuda.check_shape(32, 32)


@pytest.mark.parametrize("n, bucket", [(32, 4096), (1000, 4096), (4096, 4096), (5000, 65536),
                                       ((1 << 20) + 1, (1 << 20) + 1)])
def test_single_interval_reconstruct_dispatches_at_a_bucket_on_the_card_rule(monkeypatch, n, bucket):
    """`reconstruct` (the degraded read's one-interval path) pads to the
    next of `RECONSTRUCT_BUCKETS` under the card's rule, as the reference's
    device backends do; a CPU encoder given the card's backend name
    dispatches through the plain version, so the widths show here. The
    bytes equal the reference's `jax` backend and the unpadded decode."""
    from seaweedfs_tpu_torch.ops import rs_cuda

    enc = rs_codec.Encoder(10, 4, device="cpu")
    monkeypatch.setattr(enc, "backend", "cuda")
    shapes = []
    real = rs_cuda.apply_matrix

    def spy(m, shards, tile=None, variant="int8"):
        shapes.append(tuple(shards.shape))
        return real(m, shards, tile, variant)

    monkeypatch.setattr(rs_cuda, "apply_matrix", spy)
    data = list(np.random.default_rng(0).integers(0, 256, (10, n), np.uint8))
    full = rs_codec.Encoder(10, 4, device="cpu").encode(data)
    shapes.clear()
    lost = [None if i == 3 else s for i, s in enumerate(full)]
    got = enc.reconstruct(list(lost), wanted=[3])
    assert shapes == [(10, bucket)]
    assert got[3].shape == (n,) and np.array_equal(got[3], full[3])
    if n <= 5000:
        want = ref_codec.Encoder(10, 4, backend="jax").reconstruct(list(lost), wanted=[3])
        assert np.array_equal(got[3], want[3])


def test_decode_matrix_cache_is_bounded():
    """Churning more loss patterns than the cap (flapping holders, rolling
    repairs on a long-lived server) evicts: the cache never outgrows its
    cap, as the reference's does not."""
    import itertools

    enc = rs_codec.Encoder(10, 4, device="cpu")
    rs_codec.clear_decode_matrix_cache()
    try:
        info = rs_codec.decode_matrix_cache_info()
        assert info.currsize == 0 and info.maxsize == ref_codec.decode_matrix_cache_info().maxsize
        n_patterns = 0
        for survivors in itertools.combinations(range(1, 14), 10):
            for wanted in (w for w in range(14) if w not in survivors):
                enc.reconstruction_matrix(survivors, (wanted,))
                n_patterns += 1
            if n_patterns > info.maxsize + 50:
                break
        assert n_patterns > info.maxsize, "the churn must overflow the cap"
        info = rs_codec.decode_matrix_cache_info()
        assert info.currsize <= info.maxsize and info.maxsize >= 16
        assert info.misses >= n_patterns
    finally:
        rs_codec.clear_decode_matrix_cache()
    assert rs_codec.decode_matrix_cache_info().currsize == 0
