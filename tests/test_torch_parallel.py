"""The port's multi-card paths against the JAX package's, on this CPU: a
port mesh names the CPU 8 times, the reference runs on conftest's 8
virtual devices, and both get the same seeded numpy inputs at the
reference tests' shapes (8x1, 4x2, 2x4, 1x8, dcn 2x2x2) and losses.
Sharded encode and apply, the ec cycle and its mismatch count, the
all_to_all and ring rebuilds and the multislice cycle are byte-exact
(tolerance 0) with the reference and with the golden; the validation
raises where the reference's does; the dry run makes the reference dry
run's assertions at both scales. Also: a mesh that names one device
several times never aliases blocks, and one mesh dispatch over k
positions launches k kernels."""

import contextlib
import io
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, __file__.rsplit("/tests/", 1)[0])  # for __graft_entry__ at the repo root

import __graft_entry__ as ge  # noqa: E402
from seaweedfs_tpu.ops import gf8 as ref_gf8  # noqa: E402
from seaweedfs_tpu.ops.rs_codec import Encoder as RefEncoder  # noqa: E402
from seaweedfs_tpu.parallel import mesh as ref_mesh  # noqa: E402
from seaweedfs_tpu.parallel import ring as ref_ring  # noqa: E402
from seaweedfs_tpu.parallel import sharded as ref_sharded  # noqa: E402
from seaweedfs_tpu_torch.ops import gf8, rs_cuda  # noqa: E402
from seaweedfs_tpu_torch.ops.rs_codec import _reconstruction_matrix  # noqa: E402
from seaweedfs_tpu_torch.parallel import dryrun  # noqa: E402
from seaweedfs_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from seaweedfs_tpu_torch.parallel import ring, sharded  # noqa: E402

CPU8 = [torch.device("cpu")] * 8
REBUILD_LOST = (1, 5, 10, 13)
CYCLE_LOST = (0, 3, 11, 13)


def _mesh(axes, shape):
    return mesh_mod.device_mesh(axes, shape=shape, devices=CPU8)


def _survivors(lost):
    return tuple(i for i in range(14) if i not in lost)


def _golden_shards(data):
    golden = RefEncoder(10, 4, backend="numpy")
    return np.stack([np.stack(golden.encode(list(v))) for v in data])


def test_cpu_mesh_of_eight_matches_the_reference_device_count():
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    mesh = mesh_mod.device_mesh(("dp", "sp"), shape=(4, 2), devices=CPU8)
    ref = ref_mesh.device_mesh(("dp", "sp"), shape=(4, 2))
    assert mesh.shape == dict(ref.shape) and mesh.devices.shape == ref.devices.shape
    assert mesh.size == 8 and all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert list(mesh_mod.device_mesh(("dp",), devices=CPU8).shape.values()) == [8]
    if not torch.cuda.is_available():  # the default list is the cards: none here
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_mod.device_mesh(("dp",))


@pytest.mark.parametrize("shape,axes", [((8, 1), ("dp", "sp")), ((4, 2), ("dp", "sp")),
                                        ((2, 4), ("dp", "sp"))])
def test_sharded_encode_matches_reference_and_golden(shape, axes):
    rng = np.random.default_rng(0)
    b, n = shape[0], 128 * shape[1]
    data = rng.integers(0, 256, size=(b, 10, n), dtype=np.uint8)
    rmesh = ref_mesh.device_mesh(axes, shape=shape)
    want = np.asarray(ref_sharded.make_encode_fn(rmesh, ref_gf8.parity_matrix(10, 4))(
        ref_sharded.shard_batch(rmesh, data)))
    mesh = _mesh(axes, shape)
    got = np.asarray(sharded.make_encode_fn(mesh, gf8.parity_matrix(10, 4))(
        sharded.shard_batch(mesh, data)))
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert np.array_equal(got, _golden_shards(data))


def test_sharded_reconstruct_matches_reference():
    lost = (2, 7, 10, 12)
    surv = _survivors(lost)
    recon = _reconstruction_matrix("vandermonde", 10, 4, surv, lost)
    data = np.random.default_rng(1).integers(0, 256, size=(4, 10, 256), dtype=np.uint8)
    mesh = _mesh(("dp", "sp"), (4, 2))
    shards = np.asarray(sharded.make_encode_fn(mesh, gf8.parity_matrix(10, 4))(
        sharded.shard_batch(mesh, data)))
    rebuilt = np.asarray(sharded.make_apply_fn(mesh, recon)(
        sharded.shard_batch(mesh, shards[:, surv, :])))
    rmesh = ref_mesh.device_mesh(("dp", "sp"), shape=(4, 2))
    want = np.asarray(ref_sharded.make_apply_fn(rmesh, recon)(
        ref_sharded.shard_batch(rmesh, shards[:, surv, :])))
    assert np.array_equal(rebuilt, want)
    assert np.array_equal(rebuilt, shards[:, lost, :])


def test_ec_cycle_step_mismatch_count_matches_reference():
    surv = _survivors(CYCLE_LOST)
    recon = _reconstruction_matrix("vandermonde", 10, 4, surv, CYCLE_LOST)
    data = np.random.default_rng(2).integers(0, 256, size=(4, 10, 512), dtype=np.uint8)
    mesh = _mesh(("dp", "sp"), (2, 4))
    shards, bad = sharded.make_ec_cycle_fn(mesh, gf8.parity_matrix(10, 4), recon, CYCLE_LOST,
                                           surv)(sharded.shard_batch(mesh, data))
    rmesh = ref_mesh.device_mesh(("dp", "sp"), shape=(2, 4))
    rshards, rbad = ref_sharded.make_ec_cycle_fn(rmesh, ref_gf8.parity_matrix(10, 4), recon,
                                                 CYCLE_LOST, surv)(
        ref_sharded.shard_batch(rmesh, data))
    assert shards.shape == (4, 14, 512)
    assert int(bad) == int(rbad) == 0
    assert np.array_equal(np.asarray(shards), np.asarray(rshards))
    # a wrong decode matrix is counted, not hidden: every lost byte that differs
    wrong = np.roll(recon, 1, axis=0)
    _, bad = sharded.make_ec_cycle_fn(mesh, gf8.parity_matrix(10, 4), wrong, CYCLE_LOST,
                                      surv)(data)
    full = _golden_shards(data)
    want_bad = int((gf8.gf_mat_vec(wrong, np.moveaxis(full[:, surv, :], 0, 1))
                    != np.moveaxis(full[:, CYCLE_LOST, :], 0, 1)).sum())
    assert int(bad) == want_bad > 0


def test_single_device_entry_matches_the_reference_entry():
    ref_fn, (ref_example,) = ge.entry()
    want = np.asarray(jax.jit(ref_fn)(ref_example))
    fn, (example,) = dryrun.entry(device="cpu")
    assert np.array_equal(example.numpy(), ref_example)
    got = fn(example).numpy()
    assert got.shape == (4, 14, 1 << 16) and np.array_equal(got, want)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The plain version's products on a few threads: the suite runs with
    several test workers on one CPU at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_dryrun_makes_the_reference_dryrun_assertions(n, monkeypatch):
    """Both dry runs at both scales, the large one at 4 MiB of shard data
    for both (the reference's GRAFT_DRYRUN_MIB; at its default 64 MiB the
    port's plain version takes ~15 s per case on this CPU, and the chip runs
    the port at 64 MiB and 4096 MiB): zero mismatches, sharded parity
    equal to the host's, ring equal to all_to_all (the port raises on any
    failure), on the same shapes."""
    monkeypatch.setenv("GRAFT_DRYRUN_MIB", "4")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ge.dryrun_multichip(n)
    res = dryrun.dryrun([torch.device("cpu")] * n, large_mib=4)
    printed = buf.getvalue()
    assert f"shards=({res['small']['shards'][0]}, 14, {res['small']['shards'][2]})" in printed
    assert f"(b={res['large']['b']}, n={res['large']['n']})" in printed
    assert res["small"]["mismatches"] == 0 and res["large"]["shard_mib"] >= 3.9
    assert ("dcn" in res) == (n >= 8) == ("dryrun_multichip dcn ok" in printed)


def test_mesh_too_many_devices():
    with pytest.raises(ValueError, match="needs"):
        mesh_mod.device_mesh(("dp",), shape=(64,), devices=CPU8)
    with pytest.raises(ValueError, match="needs"):
        ref_mesh.device_mesh(("dp",), shape=(64,))


@pytest.mark.parametrize("shape", [(4, 2), (2, 4), (1, 8)])
def test_distributed_rebuild_all_to_all_matches_reference(shape):
    surv = _survivors(REBUILD_LOST)
    recon = _reconstruction_matrix("vandermonde", 10, 4, surv, REBUILD_LOST)
    rng = np.random.default_rng(3)
    b, n = shape[0] * 2, 128 * 8
    shards = _golden_shards(rng.integers(0, 256, size=(b, 10, n), dtype=np.uint8))
    got = np.asarray(sharded.make_distributed_rebuild_fn(_mesh(("dp", "sp"), shape), recon)(
        shards[:, surv, :]))
    want = np.asarray(ref_sharded.make_distributed_rebuild_fn(
        ref_mesh.device_mesh(("dp", "sp"), shape=shape), recon)(shards[:, surv, :]))
    assert got.shape == (b, 4, n)
    assert np.array_equal(got, want) and np.array_equal(got, shards[:, REBUILD_LOST, :])


def test_distributed_rebuild_rejects_bad_survivor_count():
    recon = np.zeros((4, 10), dtype=np.uint8)
    bad = np.zeros((4, 9, 256), dtype=np.uint8)
    with pytest.raises(ValueError, match="survivor"):
        sharded.make_distributed_rebuild_fn(_mesh(("dp", "sp"), (4, 2)), recon)(bad)
    with pytest.raises(ValueError):
        ref_sharded.make_distributed_rebuild_fn(
            ref_mesh.device_mesh(("dp", "sp"), shape=(4, 2)), recon)(bad)


@pytest.mark.parametrize("shape", [(4, 2), (2, 4), (1, 8)])
def test_ring_rebuild_matches_all_to_all_reference_and_golden(shape):
    surv = _survivors(REBUILD_LOST)
    recon = _reconstruction_matrix("vandermonde", 10, 4, surv, REBUILD_LOST)
    rng = np.random.default_rng(11)
    b, n = shape[0] * 2, 128 * 8
    shards = _golden_shards(rng.integers(0, 256, size=(b, 10, n), dtype=np.uint8))
    mesh = _mesh(("dp", "sp"), shape)
    ring_out = np.asarray(ring.make_ring_rebuild_fn(mesh, recon)(shards[:, surv, :]))
    want = np.asarray(ref_ring.make_ring_rebuild_fn(
        ref_mesh.device_mesh(("dp", "sp"), shape=shape), recon)(shards[:, surv, :]))
    assert ring_out.shape == (b, 4, n)
    assert np.array_equal(ring_out, want) and np.array_equal(ring_out, shards[:, REBUILD_LOST, :])
    a2a = np.asarray(sharded.make_distributed_rebuild_fn(mesh, recon)(shards[:, surv, :]))
    assert np.array_equal(ring_out, a2a)


def test_ring_rebuild_rejects_bad_shapes():
    recon = np.zeros((4, 10), dtype=np.uint8)
    fn = ring.make_ring_rebuild_fn(_mesh(("dp", "sp"), (2, 4)), recon)
    ref_fn = ref_ring.make_ring_rebuild_fn(ref_mesh.device_mesh(("dp", "sp"), shape=(2, 4)), recon)
    for bad, match in (((2, 9, 256), "survivor"), ((3, 10, 256), "divide"),
                       ((2, 10, 257), "divide")):
        for f in (fn, ref_fn):
            with pytest.raises(ValueError, match=match):
                f(np.zeros(bad, dtype=np.uint8))


def test_multislice_ec_cycle_dcn_mesh_matches_reference():
    surv = _survivors(CYCLE_LOST)
    recon = _reconstruction_matrix("vandermonde", 10, 4, surv, CYCLE_LOST)
    data = np.random.default_rng(17).integers(0, 256, size=(8, 10, 512), dtype=np.uint8)
    run = sharded.make_multislice_ec_cycle_fn(_mesh(("dcn", "dp", "sp"), (2, 2, 2)),
                                              gf8.parity_matrix(10, 4), recon, CYCLE_LOST, surv)
    shards, bad = run(data)
    ref_run = ref_sharded.make_multislice_ec_cycle_fn(
        ref_mesh.device_mesh(("dcn", "dp", "sp"), shape=(2, 2, 2)),
        ref_gf8.parity_matrix(10, 4), recon, CYCLE_LOST, surv)
    rshards, rbad = ref_run(data)
    assert int(bad) == int(rbad) == 0
    assert np.array_equal(np.asarray(shards), np.asarray(rshards))
    assert np.array_equal(np.asarray(shards), _golden_shards(data))


def test_multislice_run_rejects_bad_shapes():
    surv = _survivors(CYCLE_LOST)
    recon = _reconstruction_matrix("vandermonde", 10, 4, surv, CYCLE_LOST)
    cases = ((sharded, lambda a, s: _mesh(a, s), gf8),
             (ref_sharded, lambda a, s: ref_mesh.device_mesh(a, shape=s), ref_gf8))
    for mod, make_mesh, g in cases:
        run = mod.make_multislice_ec_cycle_fn(make_mesh(("dcn", "dp", "sp"), (2, 2, 2)),
                                              g.parity_matrix(10, 4), recon, CYCLE_LOST, surv)
        with pytest.raises(ValueError, match="divide"):
            run(np.zeros((6, 10, 512), dtype=np.uint8))
        with pytest.raises(ValueError, match="divide"):
            run(np.zeros((8, 10, 511), dtype=np.uint8))
        with pytest.raises(ValueError, match="dcn"):
            mod.make_multislice_ec_cycle_fn(make_mesh(("dp", "sp"), (4, 2)),
                                            g.parity_matrix(10, 4), recon, CYCLE_LOST, surv)


# -- the port's own contracts -------------------------------------------------


def test_matrix_bits_and_padding_equal_the_reference():
    surv = _survivors(REBUILD_LOST)
    recon = _reconstruction_matrix("vandermonde", 10, 4, surv, REBUILD_LOST)
    assert np.array_equal(sharded.matrix_bits(recon).numpy(),
                          np.asarray(ref_sharded.matrix_bits(recon)))
    for sp in (1, 2, 3, 4, 8):
        assert np.array_equal(sharded.pad_survivor_matrix(recon, sp),
                              ref_sharded.pad_survivor_matrix(recon, sp))


def test_a_mesh_naming_one_device_eight_times_never_aliases():
    """Placement, the all_to_all tiles and the ring's hops each copy into a
    fresh buffer: no two positions share storage, none shares the host
    array's, and changing the host array after placement changes nothing."""
    mesh = _mesh(("dp", "sp"), (2, 4))
    host = np.random.default_rng(5).integers(0, 256, size=(2, 12, 64), dtype=np.uint8)
    st = sharded.place_survivors(mesh, host[:, :10], 10, 12)
    ptrs = {t.data_ptr() for t in st.blocks.values()}
    assert len(ptrs) == 8 and host.ctypes.data not in ptrs
    assert np.array_equal(np.asarray(st)[:, :10], host[:, :10])
    assert not np.asarray(st)[:, 10:].any()  # pad rows zeroed on the device
    snapshot = np.asarray(st).copy()
    host[:] = 0
    assert np.array_equal(np.asarray(st), snapshot)
    t = torch.arange(6, dtype=torch.uint8)
    moved = sharded.transfer(t, torch.device("cpu"))
    assert moved.data_ptr() != t.data_ptr() and torch.equal(moved, t)


def test_one_mesh_dispatch_over_k_positions_launches_k_kernels(monkeypatch):
    """With the card's rule rehearsed (every CPU apply counted as a
    launch), an apply over 8 positions counts 8 launches, the all_to_all
    rebuild 8, the ring 8 x sp, each on its position's device."""
    real = rs_cuda.apply_matrix

    def counted(m, shards, tile=None, variant="int8"):
        rs_cuda.count_launch(variant, tuple(np.asarray(m).shape), str(shards.device))
        return real(m, shards, tile, variant)

    monkeypatch.setattr(rs_cuda, "apply_matrix", counted)
    surv = _survivors(REBUILD_LOST)
    recon = _reconstruction_matrix("vandermonde", 10, 4, surv, REBUILD_LOST)
    mesh = _mesh(("dp", "sp"), (4, 2))
    shards = _golden_shards(np.random.default_rng(6).integers(0, 256, (4, 10, 256), np.uint8))
    rs_cuda.reset_launches()
    sharded.make_matrix_apply_fn(mesh, gf8.parity_matrix(10, 4))(np.zeros((10, 64), np.uint8))
    assert rs_cuda.launches == 8 and rs_cuda.launches_by_device == {"cpu": 8}
    rs_cuda.reset_launches()
    sharded.make_distributed_rebuild_fn(mesh, recon)(shards[:, surv, :])
    assert rs_cuda.launches_by_shape == {(4, 10): 8}
    rs_cuda.reset_launches()
    ring.make_ring_rebuild_fn(mesh, recon)(shards[:, surv, :])
    assert rs_cuda.launches_by_shape == {(4, 5): 16}
    rs_cuda.reset_launches()
