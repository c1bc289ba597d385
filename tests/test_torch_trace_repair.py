"""Trace repair in the port against the JAX package's: `Encoder.project`
and `project_lazy` byte-exact against both packages' `gf8.gf_project` and
the reference's numpy, jax and interpret-mode pallas backends; the repair
plan; XOR-combined holder projections equal to the fused decode; and
`rebuild_ec_files_from_projections` (remote `TraceSlabSource` groups plus a
`LocalProjectionSource`) equal to the reference's pipeline on the same
fetches and to the serial oracle, with its failure and stream checks. All
comparisons byte-exact (tolerance 0)."""

import os
import shutil

import numpy as np
import pytest

from seaweedfs_tpu.ec import stripe as ref_stripe
from seaweedfs_tpu.ops import gf8 as ref_gf8
from seaweedfs_tpu.ops import rs_codec as ref_codec
from seaweedfs_tpu_torch.ec import stripe
from seaweedfs_tpu_torch.obs import trace
from seaweedfs_tpu_torch.ops import gf8, rs_codec

ENC = rs_codec.Encoder(10, 4, device="cpu")
REF = ref_codec.Encoder(10, 4, backend="numpy")
LARGE, SMALL = 16384, 4096

#: (rows, cols, width) of the reference's projection tests
SHAPES = [(1, 3, 1), (2, 5, 127), (4, 10, 8192), (3, 13, 1000), (1, 10, 4097), (14, 14, 64)]


@pytest.mark.parametrize("ref_backend", ["numpy", "jax", "pallas"])
@pytest.mark.parametrize("rows, cols, width", SHAPES)
def test_project_equals_reference_backends_and_goldens(ref_backend, rows, cols, width):
    rng = np.random.default_rng(rows * 131 + cols)
    m = rng.integers(0, 256, (rows, cols), dtype=np.uint8)
    x = rng.integers(0, 256, (cols, width), dtype=np.uint8)
    golden = ref_gf8.gf_project(m, x)
    assert np.array_equal(gf8.gf_project(m, x), golden)
    assert np.array_equal(gf8.gf_project_bits(m, x), golden)
    ref = ref_codec.Encoder(10, 4, backend=ref_backend)
    want = np.asarray(ref.project(m, x))
    assert np.array_equal(want, golden)
    got = ENC.project(m, x)
    assert got.shape == (rows, width) and got.dtype == np.uint8
    assert np.array_equal(got, want)
    assert np.array_equal(np.asarray(ENC.project_lazy(m, x)), np.asarray(ref.project_lazy(m, x)))


def test_repair_projection_plan_equals_reference():
    for survivors, wanted in (([0, 1, 2, 4, 5, 6, 7, 8, 9, 10], [3, 12]),
                              ([1, 2, 3, 4, 6, 7, 8, 9, 11, 12], [0, 5, 10, 13])):
        plan, want = ENC.repair_projection_plan(survivors, wanted), REF.repair_projection_plan(
            survivors, wanted)
        m = ENC.reconstruction_matrix(survivors, wanted)
        assert list(plan) == list(want) == survivors
        for i, s in enumerate(survivors):
            assert np.array_equal(plan[s], want[s]) and np.array_equal(plan[s], m[:, i])


@pytest.mark.parametrize("coeffs, stack", [
    ((2, 3), (4, 8)),   # coefficient columns != stack rows
    ((3,), (3, 8)),     # 1-D coefficients
    ((2, 3), (3,)),     # 1-D stack
])
def test_project_validates_shapes_as_reference(coeffs, stack):
    c, x = np.zeros(coeffs, np.uint8), np.zeros(stack, np.uint8)
    for enc in (ENC, REF):
        with pytest.raises(ValueError):
            enc.project(c, x)
        with pytest.raises(ValueError):
            enc.project_lazy(c, x)


@pytest.mark.parametrize("split", [[4, 7], [1, 2, 3, 9], [10]])
def test_xor_of_group_projections_equals_fused_decode(split):
    rng = np.random.default_rng(7)
    shards = ENC.encode([rng.integers(0, 256, 2048, dtype=np.uint8) for _ in range(10)])
    missing = [0, 11, 13]
    survivors = [s for s in range(14) if s not in missing][:10]
    plan = ENC.repair_projection_plan(survivors, missing)
    direct = ENC.reconstruct_batch(np.stack([shards[s] for s in survivors])[None],
                                   survivors, missing)[0]
    bounds = [0, *split, len(survivors)]
    acc = np.zeros((len(missing), 2048), dtype=np.uint8)
    for lo, hi in zip(bounds, bounds[1:]):
        group = survivors[lo:hi]
        if group:
            coeffs = np.stack([plan[s] for s in group], axis=1)
            part = ENC.project(coeffs, np.stack([shards[s] for s in group]))
            assert np.array_equal(part, REF.project(coeffs, np.stack([shards[s] for s in group])))
            acc ^= part
    assert np.array_equal(acc, direct)
    for k, s in enumerate(missing):
        assert np.array_equal(acc[k], shards[s])


# -- the projection rebuild pipeline --------------------------------------------


def _shard_set(d, size: int = 400_000, seed: int = 5):
    """A 10+4 shard set written by the port; -> (base, {shard: bytes})."""
    base = os.path.join(str(d), "17")
    rng = np.random.default_rng(seed)
    with open(base + ".dat", "wb") as f:
        f.write(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
    stripe.write_ec_files(base, LARGE, SMALL, encoder=ENC)
    golden = {}
    for s in range(14):
        with open(stripe.shard_file_name(base, s), "rb") as f:
            golden[s] = f.read()
    os.unlink(base + ".dat")
    return base, golden


def _projecting_fetch(base, sids, coeffs, shard_size, enc):
    """A holder's server-side half: read the group's window of its shard
    files and project it with `enc`."""

    def fetch(offset: int, size: int) -> bytes:
        actual = max(0, min(size, shard_size - offset))
        if actual == 0:
            return b""
        stack = np.empty((len(sids), actual), dtype=np.uint8)
        for i, s in enumerate(sids):
            with open(stripe.shard_file_name(base, s), "rb") as f:
                stripe.read_padded_into(f, offset, stack[i])
        return np.asarray(enc.project(coeffs, stack)).tobytes()

    return fetch


def _groups(mod, base, survivors, plan, rows, shard_size, enc):
    """Two remote groups (one with an odd chunk, so windows take several
    sub-ranges) and the last survivor as the local group, built from
    `mod`'s classes (the port's or the reference's stripe)."""
    cols = lambda sids: np.stack([plan[s] for s in sids], axis=1)  # noqa: E731
    a, b, local = survivors[:4], survivors[4:9], survivors[9:]
    return [
        mod.TraceSlabSource("a", a, rows, _projecting_fetch(base, a, cols(a), shard_size, enc),
                            chunk_bytes=70_000),
        mod.TraceSlabSource("b", b, rows, _projecting_fetch(base, b, cols(b), shard_size, enc)),
        mod.LocalProjectionSource([stripe.shard_file_name(base, s) for s in local], cols(local),
                                  enc),
    ]


def test_projection_rebuild_equals_reference_and_serial_oracle(tmp_path):
    """Odd windows (16 KiB chunks, three per batch, a short last batch) and
    a two-shard loss: the port's pipeline, the reference's on the same
    holder math, and the port's serial oracle give the same files, equal
    to the originals, and the wire accounting agrees."""
    (tmp_path / "port").mkdir()
    base, golden = _shard_set(tmp_path / "port")
    missing = [3, 12]
    for s in missing:
        os.unlink(stripe.shard_file_name(base, s))
    shutil.copytree(tmp_path / "port", tmp_path / "ref")
    shutil.copytree(tmp_path / "port", tmp_path / "oracle")
    ref_base, oracle_base = (os.path.join(str(tmp_path / d), "17") for d in ("ref", "oracle"))
    shard_size = len(golden[0])
    survivors = stripe.find_local_shards(base)[:10]
    plan = ENC.repair_projection_plan(survivors, missing)
    kw = dict(buffer_size=16384, max_batch_bytes=10 * 3 * 16384)
    runs = {}
    for name, mod, b, enc in (("port", stripe, base, ENC), ("ref", ref_stripe, ref_base, REF)):
        groups = _groups(mod, b, survivors, plan, len(missing), shard_size, enc)
        try:
            with trace.collect() as spans:
                assert mod.rebuild_ec_files_from_projections(
                    b, groups, shard_size, missing, encoder=enc, **kw) == missing
        finally:
            for g in groups:
                g.close()
        runs[name] = [g.bytes_fetched for g in groups]
        if mod is stripe:
            staged = [s for s in spans if s["name"] == "rebuild.stage"]
            assert len(staged) == -(-shard_size // (3 * 16384))
            assert {s["name"] for s in spans} == {"rebuild.stage", "rebuild.drain"}
    assert runs["port"] == runs["ref"] == [2 * shard_size, 2 * shard_size, 0]
    assert stripe.rebuild_ec_files_serial(oracle_base, encoder=ENC) == missing
    for s in missing:
        files = []
        for b in (base, ref_base, oracle_base):
            with open(stripe.shard_file_name(b, s), "rb") as f:
                files.append(f.read())
        assert files[0] == files[1] == files[2] == golden[s], s


def test_projection_rebuild_failure_unlinks_partials(tmp_path):
    base, golden = _shard_set(tmp_path)
    os.unlink(stripe.shard_file_name(base, 2))
    shard_size = len(golden[0])
    survivors = stripe.find_local_shards(base)[:10]
    coeffs = np.stack([ENC.repair_projection_plan(survivors, [2])[s] for s in survivors], axis=1)
    real = _projecting_fetch(base, survivors, coeffs, shard_size, ENC)
    calls = {"n": 0}

    def dying_fetch(offset: int, size: int) -> bytes:
        calls["n"] += 1
        if calls["n"] > 2:
            raise IOError("holder died mid-rebuild")
        return real(offset, size)

    src = stripe.TraceSlabSource("dying", survivors, 1, dying_fetch, chunk_bytes=65536)
    try:
        with pytest.raises(IOError, match="died"):
            stripe.rebuild_ec_files_from_projections(
                base, [src], shard_size, [2], encoder=ENC,
                buffer_size=16384, max_batch_bytes=10 * 16384,
            )
    finally:
        src.close()
    assert not os.path.exists(stripe.shard_file_name(base, 2))


def test_projection_rebuild_checks_group_rows_and_crcs(tmp_path):
    base, golden = _shard_set(tmp_path)
    os.unlink(stripe.shard_file_name(base, 4))
    shard_size = len(golden[0])
    survivors = stripe.find_local_shards(base)[:10]
    with pytest.raises(ValueError, match="rows"):
        stripe.rebuild_ec_files_from_projections(
            base, [stripe.TraceSlabSource("x", survivors, 2, lambda o, n: b"")], shard_size, [4],
            encoder=ENC)
    with pytest.raises(ValueError, match="at least one"):
        stripe.rebuild_ec_files_from_projections(base, [], shard_size, [4], encoder=ENC)
    # a holder projecting with the wrong coefficients: the CRC check fails
    # the rebuild against the .eci and the partial is unlinked
    wrong = np.ones((1, 10), dtype=np.uint8)
    src = stripe.TraceSlabSource("w", survivors, 1,
                                 _projecting_fetch(base, survivors, wrong, shard_size, ENC))
    try:
        with pytest.raises(IOError, match="CRC mismatch"):
            stripe.rebuild_ec_files_from_projections(base, [src], shard_size, [4], encoder=ENC)
    finally:
        src.close()
    assert not os.path.exists(stripe.shard_file_name(base, 4))


def test_trace_source_rejects_bad_streams():
    for mod in (stripe, ref_stripe):
        src = mod.TraceSlabSource("x", [0, 1], 3, lambda off, n: b"\x00" * 7)
        with pytest.raises(IOError, match="not a multiple"):
            src.read_into(0, np.zeros(3 * 64, dtype=np.uint8))
        src.close()
        src = mod.TraceSlabSource("x", [0, 1], 2, lambda off, n: b"\x00" * (2 * n + 2))
        with pytest.raises(IOError, match="over-answered"):
            src.read_into(0, np.zeros(2 * 64, dtype=np.uint8))
        with pytest.raises(ValueError, match="not 2 rows"):
            src.read_into(0, np.zeros(5, dtype=np.uint8))
        src.close()
        with pytest.raises(ValueError):
            mod.TraceSlabSource("x", [0], 0, lambda off, n: b"")


def test_trace_source_zero_fills_past_the_shard_end_and_splits_windows():
    """A window running past the shard's end reads short: the rest is zero,
    and a window of several chunks joins them in order."""
    block = np.arange(2 * 200_000, dtype=np.uint64).astype(np.uint8).reshape(2, 200_000)
    calls = []

    def fetch(offset: int, size: int) -> bytes:
        calls.append((offset, size))
        return np.ascontiguousarray(block[:, offset : offset + size]).tobytes()

    src = stripe.TraceSlabSource("h", [1, 2], 2, fetch, chunk_bytes=65536, fanout=3)
    out = np.full(2 * 262_144, 0xFF, dtype=np.uint8)
    src.read_into(0, out)
    src.close()
    want = np.zeros((2, 262_144), dtype=np.uint8)
    want[:, :200_000] = block
    assert np.array_equal(out.reshape(2, -1), want)
    assert sorted(calls) == [(o, 65536) for o in range(0, 262_144, 65536)]
    assert src.bytes_fetched == block.size


def test_local_projection_source_rejects_mismatched_coeffs(tmp_path):
    base, _ = _shard_set(tmp_path, size=10_000)
    paths = [stripe.shard_file_name(base, s) for s in (0, 1)]
    with pytest.raises(ValueError):
        stripe.LocalProjectionSource(paths, np.ones((1, 3), np.uint8), ENC)


def test_local_projection_source_closes_what_it_opened_when_a_path_fails(tmp_path):
    """The reference opens the group's files in one comprehension and
    leaks the ones already open when a later path fails; the port closes
    them before raising."""
    import gc
    import warnings

    base, _ = _shard_set(tmp_path, size=10_000)
    paths = [stripe.shard_file_name(base, 0), str(tmp_path / "missing.ec01")]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with pytest.raises(FileNotFoundError):
            stripe.LocalProjectionSource(paths, np.ones((1, 2), np.uint8), ENC)
        gc.collect()
    assert not [w for w in caught if issubclass(w.category, ResourceWarning)]
