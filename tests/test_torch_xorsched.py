"""The port's compiled XOR-schedule backend (`ops/xorsched.py`, the executor
in `csrc/gf_host.cc`) and its CPU promotion rule against the JAX package's:
the twins of `tests/test_xorsched.py` (all but the bench smoke, which comes
with the port's bench harness) and of the `xorsched.apply_blocks` cases of
`tests/test_rebuild_fusion.py`, on the same seeded numpy inputs.

Every program the port compiles equals the reference's op for op; both
executors (the numpy interpreter and the native one) are byte-exact against
the gf8 golden and the reference's at tile-edge, odd and tiny widths; the
schedule LRU evicts as the reference's does; and `pick_cpu_backend` gives
the reference's decision on the same fabricated evidence directory
(the reference's "numpy" is the port's "torch")."""

import datetime
import json
import os

import numpy as np
import pytest

from seaweedfs_tpu import stats as ref_stats
from seaweedfs_tpu.ec import stripe as ref_stripe
from seaweedfs_tpu.ops import gf8 as ref_gf8
from seaweedfs_tpu.ops import rs_codec as ref_codec
from seaweedfs_tpu.ops import xorsched as ref_xs
from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.ec import stripe
from seaweedfs_tpu_torch.ops import gf8, rs_codec, xorsched
from seaweedfs_tpu_torch.utils import config

# full tiles (512-symbol SIMD groups), partial tiles, sub-8-symbol scalar
# tails, and widths straddling the default 4096-symbol tile boundary
WIDTHS = [1, 7, 8, 31, 255, 512, 513, 4095, 4096, 4097]


def _forms() -> dict:
    """The four matrix shapes an Encoder dispatches, from one 10+4 encoder."""
    enc = rs_codec.Encoder(10, 4, device="cpu")
    survivors = [i for i in range(14) if i not in (2, 11)][:10]
    plan = enc.repair_projection_plan(survivors, [2, 11])
    return {
        "encode": enc.parity_matrix,
        "decode": enc.reconstruction_matrix(survivors, [2, 11]),
        "projection": np.stack([plan[s] for s in survivors[:5]], axis=1),
        "delta": enc.parity_matrix[:, [3]],
    }


def _same_program(mine: xorsched.XorProgram, ref: ref_xs.XorProgram) -> None:
    assert np.array_equal(mine.ops, ref.ops) and mine.ops.dtype == ref.ops.dtype
    for field in ("rows", "cols", "n_slots", "out_base", "tile_sym", "raw_xors",
                  "xor_count", "n_temps", "scratch_bytes"):
        assert getattr(mine, field) == getattr(ref, field), field


@pytest.fixture(autouse=True)
def _fresh_caches():
    xorsched.clear_schedule_cache()
    ref_xs.clear_schedule_cache()
    yield
    xorsched.clear_schedule_cache()
    ref_xs.clear_schedule_cache()


# -- byte-exactness ----------------------------------------------------------------


@pytest.mark.parametrize("name", ["encode", "decode", "projection", "delta"])
def test_interpreter_byte_exact_vs_golden_and_reference(name):
    m = _forms()[name]
    rng = np.random.default_rng(17)
    prog = xorsched.compile_schedule(m)
    _same_program(prog, ref_xs.compile_schedule(m))
    for n in WIDTHS:
        stack = rng.integers(0, 256, size=(m.shape[1], n), dtype=np.uint8)
        got = np.stack(xorsched.apply(prog, list(stack)))
        assert np.array_equal(got, gf8.gf_mat_vec(m, stack)), f"{name} at n={n}"
        assert np.array_equal(got, np.stack(ref_xs.apply(ref_xs.compile_schedule(m), list(stack))))


@pytest.mark.parametrize("name", ["encode", "decode", "projection", "delta"])
def test_native_executor_byte_exact_vs_golden_and_reference(name):
    assert xorsched.native_available(), "the gf_host library builds here"
    m = _forms()[name]
    rng = np.random.default_rng(18)
    prog = xorsched.compile_schedule(m)
    for n in WIDTHS:
        stack = rng.integers(0, 256, size=(m.shape[1], n), dtype=np.uint8)
        outs = xorsched.apply_native(prog, list(stack))
        assert outs is not None
        assert np.array_equal(np.stack(outs), gf8.gf_mat_vec(m, stack)), f"{name} at n={n}"
        want = ref_xs.apply_matrix(m, list(stack))
        assert all(np.array_equal(a, b) for a, b in zip(outs, want))


def test_non_multiple_of_tile_and_large_width():
    m = _forms()["encode"]
    rng = np.random.default_rng(19)
    prog = xorsched.compile_schedule(m, tile_sym=1024)
    n = 65536 + 488  # many tiles + a ragged final tile + scalar tail
    stack = rng.integers(0, 256, size=(10, n), dtype=np.uint8)
    golden = gf8.gf_mat_vec(m, stack)
    assert np.array_equal(np.stack(xorsched.apply(prog, list(stack))), golden)
    for threads in (1, 0, 3):
        assert np.array_equal(np.stack(xorsched.apply_native(prog, list(stack), threads)), golden)


# -- compiler properties ---------------------------------------------------------------


def test_schedule_determinism_and_reference_program():
    m = _forms()["encode"]
    a, b = xorsched.compile_schedule(m), xorsched.compile_schedule(m)
    _same_program(a, b)
    # the same matrix and tile compile to the reference's program, op for op
    for name, mat in _forms().items():
        for tile in (None, 512, 1024, 4096, 100):
            _same_program(xorsched.compile_schedule(mat, tile), ref_xs.compile_schedule(mat, tile))
    for k, p, kind in ((10, 4, "cauchy"), (12, 3, "cauchy"), (20, 4, "cauchy"), (6, 3, "vandermonde")):
        mat = gf8.parity_matrix(k, p, kind)
        _same_program(xorsched.compile_schedule(mat), ref_xs.compile_schedule(mat))


def test_grouping_reduces_xor_count_on_cauchy_10p4():
    m = gf8.parity_matrix(10, 4, kind="cauchy")
    prog = xorsched.compile_schedule(m)
    assert prog.raw_xors > 0 and prog.n_temps > 0
    assert prog.xor_count <= (2 * prog.raw_xors) // 3, (
        f"grouping too weak: {prog.xor_count} of {prog.raw_xors} raw XORs"
    )
    ref = ref_xs.compile_schedule(ref_gf8.parity_matrix(10, 4, kind="cauchy"))
    assert (prog.raw_xors, prog.xor_count, prog.n_temps) == (ref.raw_xors, ref.xor_count, ref.n_temps)


def test_tile_clamped_to_simd_multiple():
    m = _forms()["delta"]
    assert xorsched.compile_schedule(m, tile_sym=100).tile_sym == 512  # below the 512 floor
    assert xorsched.compile_schedule(m, tile_sym=1000).tile_sym % 512 == 0
    assert xorsched.compile_schedule(m, tile_sym=1000).tile_sym == ref_xs.compile_schedule(
        m, tile_sym=1000).tile_sym
    with pytest.raises(ValueError):
        xorsched.compile_schedule(np.zeros((0, 3), dtype=np.uint8))


# -- schedule LRU -------------------------------------------------------------------


def test_lru_bound_and_eviction(monkeypatch):
    monkeypatch.setenv("WEEDTPU_XORSCHED_CACHE", "2")
    xorsched.clear_schedule_cache()
    ref_xs.clear_schedule_cache()
    mats = [gf8.parity_matrix(4, 2), gf8.parity_matrix(5, 2), gf8.parity_matrix(6, 2)]
    for m in mats + [mats[0], mats[0]]:
        xorsched.get_schedule(m)
        ref_xs.get_schedule(m)
    info = xorsched.schedule_cache_info()
    assert info == {"hits": 1, "misses": 4, "evictions": 2, "size": 2, "cap": 2}
    assert info == ref_xs.schedule_cache_info()


def test_cache_keyed_by_tile_geometry():
    m = gf8.parity_matrix(4, 2)
    a = xorsched.get_schedule(m, tile_sym=1024)
    b = xorsched.get_schedule(m, tile_sym=2048)
    assert a.tile_sym != b.tile_sym
    assert xorsched.schedule_cache_info()["size"] == 2


# -- Encoder integration ---------------------------------------------------------------


def test_encoder_xorsched_equals_reference_on_public_ops():
    e_x = rs_codec.Encoder(10, 4, backend="xorsched")
    assert e_x.device.type == "cpu" and e_x.selection["xor_simd"] == xorsched.native_level()
    r_x = ref_codec.Encoder(10, 4, backend="xorsched")
    r_n = ref_codec.Encoder(10, 4, backend="numpy")
    rng = np.random.default_rng(20)
    data = [rng.integers(0, 256, 4097, dtype=np.uint8) for _ in range(10)]
    sx = e_x.encode(data)
    for want in (r_x.encode(data), r_n.encode(data)):
        assert all(np.array_equal(a, b) for a, b in zip(sx, want))
    shards = [None if i in (2, 11) else sx[i] for i in range(14)]
    rx = e_x.reconstruct(shards)
    assert all(np.array_equal(rx[i], sx[i]) for i in range(14))
    # delta-parity update rides the same dispatch
    parity = np.stack(sx[10:])
    old = data[3][100:200]
    new = (~old).astype(np.uint8)
    px = e_x.update_parity(parity[:, 100:200], 3, old, new)
    assert np.array_equal(px, r_x.update_parity(parity[:, 100:200], 3, old, new))
    # batched 3D stack (the streaming-pipeline shape)
    stack = np.stack([np.stack(data), np.stack(data)[:, ::-1]])
    assert np.array_equal(e_x._apply(e_x.parity_matrix, stack),
                          r_n._apply(r_n.parity_matrix, stack))


def _counter(family, backend: str) -> float:
    for line in family.collect():
        if f'backend="{backend}"' in line:
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def test_dispatch_counter_ticks_xorsched_label():
    before = _counter(stats.EcDispatchTotal, "xorsched")
    enc = rs_codec.Encoder(4, 2, backend="xorsched")
    enc.encode([np.zeros(64, dtype=np.uint8)] * 4)
    assert _counter(stats.EcDispatchTotal, "xorsched") >= before + 1
    # the LRU counters are mirrored at the dispatch, as the reference's are
    gauge = {line.split('"')[1]: float(line.rsplit(" ", 1)[1])
             for line in stats.XorschedCache.collect() if line.startswith("weedtpu_")}
    assert gauge == {k: float(v) for k, v in xorsched.schedule_cache_info().items()}
    ref_before = _counter(ref_stats.EcDispatchTotal, "xorsched")
    ref_codec.Encoder(4, 2, backend="xorsched").encode([np.zeros(64, dtype=np.uint8)] * 4)
    assert _counter(ref_stats.EcDispatchTotal, "xorsched") >= ref_before + 1


def test_missing_library_falls_back_to_interpreter(monkeypatch):
    """Where the gf_host library cannot be built, xorsched runs its numpy
    interpreter, byte-exact, and says so; the reference's stale-library
    case."""
    from seaweedfs_tpu_torch.utils import native

    monkeypatch.setattr(native, "load_gf", lambda *a, **k: None)
    assert xorsched.native_available() is False
    assert xorsched.native_level() == "unavailable"
    m = gf8.parity_matrix(4, 2)
    prog = xorsched.compile_schedule(m)
    stack = np.arange(4 * 100, dtype=np.uint8).reshape(4, 100) % 251
    assert xorsched.apply_native(prog, list(stack)) is None
    got = np.stack(xorsched.apply_matrix(m, list(stack)))
    assert np.array_equal(got, gf8.gf_mat_vec(m, stack))
    assert np.array_equal(np.stack(xorsched.apply_blocks([prog], [list(stack)])[0]), got)
    enc = rs_codec.Encoder(4, 2, backend="xorsched")
    assert enc.selection["xor_simd"] == "unavailable"
    assert np.array_equal(np.stack(enc.encode(list(stack))[4:]), got)
    assert rs_codec._cpu_backend() == "torch"


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def test_stripe_pipeline_rides_xorsched_byte_identical(tmp_path):
    """The streaming file pipelines (`write_ec_files`, `rebuild_ec_files`)
    ride the xorsched backend unchanged: shard files equal to the port's
    plain version and to the reference's numpy and xorsched encoders."""
    rng = np.random.default_rng(21)
    dat = rng.integers(0, 256, 123_457, dtype=np.uint8).tobytes()
    goldens = {}
    runs = [("ref_numpy", ref_stripe, ref_codec.Encoder(10, 4, backend="numpy")),
            ("ref_xorsched", ref_stripe, ref_codec.Encoder(10, 4, backend="xorsched")),
            ("torch", stripe, rs_codec.Encoder(10, 4, device="cpu")),
            ("xorsched", stripe, rs_codec.Encoder(10, 4, backend="xorsched"))]
    for name, mod, enc in runs:
        base = str(tmp_path / f"v_{name}")
        with open(base + ".dat", "wb") as f:
            f.write(dat)
        mod.write_ec_files(base, large_block_size=16384, small_block_size=4096,
                           buffer_size=4096, encoder=enc, max_batch_bytes=10 * 3 * 4096)
        goldens[name] = [_read(mod.shard_file_name(base, s)) for s in range(14)]
        if name == "xorsched":
            lost = [0, 5, 11]
            for s in lost:
                os.unlink(stripe.shard_file_name(base, s))
            assert stripe.rebuild_ec_files(base, encoder=enc) == lost
            for s in range(14):
                assert _read(stripe.shard_file_name(base, s)) == goldens[name][s], f"shard {s}"
    assert all(g == goldens["ref_numpy"] for g in goldens.values())


# -- xorsched.apply_blocks ------------------------------------------------------------


def test_apply_blocks_matches_apply_per_block_and_threads():
    """Two programs over different widths (tile edge, odd, tiny) through one
    apply_blocks call: equal to per-program apply and to the reference's
    apply_blocks for every thread setting, with caller-supplied outputs."""
    e10 = rs_codec.Encoder(10, 4, device="cpu")
    e12 = rs_codec.Encoder(12, 3, "cauchy", device="cpu")
    m1 = e10.reconstruction_matrix(list(range(10)), [12, 13])
    m2 = e12.reconstruction_matrix(list(range(12)), [14])
    p1, p2 = xorsched.get_schedule(m1), xorsched.get_schedule(m2)
    r1, r2 = ref_xs.get_schedule(m1), ref_xs.get_schedule(m2)
    rng = np.random.default_rng(11)
    for width1, width2 in [(p1.tile_sym, 3), (p1.tile_sym + 1, 513)]:
        in1 = list(rng.integers(0, 256, size=(10, width1), dtype=np.uint8))
        in2 = list(rng.integers(0, 256, size=(12, width2), dtype=np.uint8))
        want1 = np.stack(xorsched.apply(p1, in1))
        want2 = np.stack(xorsched.apply(p2, in2))
        ref = ref_xs.apply_blocks([r1, r2], [in1, in2])
        assert np.array_equal(np.stack(ref[0]), want1) and np.array_equal(np.stack(ref[1]), want2)
        for threads in (None, 1, 2, 0):
            got = xorsched.apply_blocks([p1, p2], [in1, in2], threads=threads)
            assert np.array_equal(np.stack(got[0]), want1)
            assert np.array_equal(np.stack(got[1]), want2)
        buf1 = np.zeros((2, width1), dtype=np.uint8)
        buf2 = np.zeros((1, width2), dtype=np.uint8)
        xorsched.apply_blocks([p1, p2], [in1, in2], outputs_per_block=[list(buf1), list(buf2)],
                              threads=2)
        assert np.array_equal(buf1, want1) and np.array_equal(buf2, want2)
    assert xorsched.apply_blocks([], []) == []


def test_apply_blocks_validates_outputs():
    e10 = rs_codec.Encoder(10, 4, device="cpu")
    p = xorsched.get_schedule(e10.reconstruction_matrix(list(range(10)), [13]))
    ins = [np.zeros(64, dtype=np.uint8)] * 10
    for bad in ([np.zeros(63, dtype=np.uint8)], [np.zeros(64, dtype=np.uint16)],
                [np.zeros((64, 2), dtype=np.uint8)[:, 0]], []):
        with pytest.raises(ValueError):
            xorsched.apply_blocks([p], [ins], outputs_per_block=[bad])
    with pytest.raises(ValueError):
        xorsched.apply_blocks([p], [ins, ins])
    with pytest.raises(ValueError):
        xorsched.apply_blocks([p, xorsched.get_schedule(e10.parity_matrix, tile_sym=1024)],
                              [ins, ins])  # blocks must share one tile


# -- pick_cpu_backend: the decision table ------------------------------------------------


def _xor_evidence(when=None, host=None, xorsched_gbps=4.0, native_gbps=1.6, match=True):
    return {
        "when": when or datetime.datetime.now(datetime.timezone.utc).strftime("%Y-%m-%dT%H:%MZ"),
        "host": host if host is not None else rs_codec._host_fingerprint(),
        "match": match,
        "encode": {"xorsched_gbps": xorsched_gbps, "native_gbps": native_gbps},
    }


def _write_bench(dirpath, xor, name="BENCH_r91.json"):
    with open(os.path.join(dirpath, name), "w", encoding="utf-8") as f:
        json.dump({"n": 91, "rc": 0, "parsed": {"xor": xor}}, f)


def _both(tmp_path, monkeypatch, native_ok=True) -> tuple:
    """(port decision, reference decision) on one directory, the native
    executor's availability forced the same way in both packages."""
    monkeypatch.setattr(xorsched, "native_available", lambda: native_ok)
    monkeypatch.setattr(ref_xs, "native_available", lambda: native_ok)
    mine = rs_codec.pick_cpu_backend(art_dir=str(tmp_path))
    ref = ref_codec.pick_cpu_backend(art_dir=str(tmp_path))
    ref_dec = {k: ("torch" if v == "numpy" else v) for k, v in ref[1].items()}
    assert mine[0] == ref[0].replace("numpy", "torch")
    assert mine[1] == ref_dec
    assert rs_codec._host_fingerprint() == ref_codec._host_fingerprint()
    return mine


CASES = {
    "winning": (dict(), "xorsched", "beats"),
    "stale": (dict(when="2020-01-01T00:00Z"), None, "stale"),
    "losing": (dict(xorsched_gbps=1.5, native_gbps=1.6), None, "does not beat"),
    "other_host": (dict(host={"cpu": "AMD EPYC 9999", "cores": 128}), None, "different host"),
    "unverified": (dict(match=False), None, "byte-verification"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cpu_decision_equals_reference(tmp_path, monkeypatch, case):
    kw, backend, reason = CASES[case]
    _write_bench(tmp_path, _xor_evidence(**kw))
    got, dec = _both(tmp_path, monkeypatch)
    assert got == (backend or rs_codec._cpu_backend())
    assert reason in dec["reason"]
    assert dec["evidence_file"] == "BENCH_r91.json" and dec["evidence_round"] == 91
    if case == "winning":
        assert dec["xorsched_gbps"] == 4.0 and dec["native_gbps"] == 1.6


def test_absent_evidence_keeps_library_path(tmp_path, monkeypatch):
    got, dec = _both(tmp_path, monkeypatch)
    assert got == rs_codec._cpu_backend() == "native"
    assert "no committed" in dec["reason"]


def test_missing_executor_blocks_promotion_even_on_winning_evidence(tmp_path, monkeypatch):
    _write_bench(tmp_path, _xor_evidence())
    got, dec = _both(tmp_path, monkeypatch, native_ok=False)
    assert got == rs_codec._cpu_backend()
    assert "weedtpu_xor_schedule_apply" in dec["reason"]


def test_rounds_without_xor_section_are_skipped_not_depromoting(tmp_path, monkeypatch):
    _write_bench(tmp_path, _xor_evidence(), name="BENCH_r91.json")
    # a NEWER round measuring other subsystems must not hide the xor one
    with open(os.path.join(tmp_path, "BENCH_r92.json"), "w", encoding="utf-8") as f:
        json.dump({"n": 92, "rc": 0, "parsed": {"metric": "other"}}, f)
    with open(os.path.join(tmp_path, "BENCH_r93.json"), "w", encoding="utf-8") as f:
        f.write("{ torn")
    got, dec = _both(tmp_path, monkeypatch)
    assert got == "xorsched" and dec["evidence_file"] == "BENCH_r91.json"


def test_new_encoder_auto_promotes_on_cpu_evidence(tmp_path, monkeypatch):
    monkeypatch.setattr(xorsched, "native_available", lambda: True)
    monkeypatch.setattr(rs_codec, "_artifacts_dir", lambda: str(tmp_path))
    _write_bench(tmp_path, _xor_evidence())
    enc = rs_codec.new_encoder(backend="auto", device="cpu")
    assert enc.backend == "xorsched"
    assert enc.selection["source"] == "cpu-bench-evidence"
    assert enc.selection["evidence_round"] == 91
    # the default never reads the CPU evidence: the plain version serves
    assert rs_codec.new_encoder(device="cpu").backend == "torch"


def test_new_encoder_auto_keeps_library_without_evidence(tmp_path, monkeypatch):
    monkeypatch.setattr(rs_codec, "_artifacts_dir", lambda: str(tmp_path))
    enc = rs_codec.new_encoder(backend="auto", device="cpu")
    assert enc.backend == rs_codec._cpu_backend()
    assert enc.selection["source"] == "platform"
    assert enc.selection["reason"] == "no committed CPU bench evidence with an xor section"


def test_committed_evidence_directory_moves_nothing():
    """The port reads its own evidence directory, which commits no CPU
    bench file: the reference's root BENCH_r*.json never reaches it."""
    assert rs_codec.load_cpu_bench_evidence() is None
    assert rs_codec.pick_cpu_backend()[1]["reason"] == (
        "no committed CPU bench evidence with an xor section")


# -- knobs ------------------------------------------------------------------------------


def test_xorsched_knobs_registered(monkeypatch):
    from seaweedfs_tpu.utils import config as ref_config

    assert config.env("WEEDTPU_XORSCHED_TILE_KB") == 4
    assert config.env("WEEDTPU_XORSCHED_CACHE") == 64
    assert config.env("WEEDTPU_XORSCHED_THREADS") == 1
    assert config.env("WEEDTPU_BACKEND") == ""
    for name in ("WEEDTPU_XORSCHED_TILE_KB", "WEEDTPU_XORSCHED_CACHE",
                 "WEEDTPU_XORSCHED_THREADS", "WEEDTPU_BACKEND"):
        mine, ref = config.ENV_REGISTRY[name], ref_config.ENV_REGISTRY[name]
        assert (mine.type, mine.default) == (ref.type, ref.default), name
    for name, raw in (("WEEDTPU_XORSCHED_TILE_KB", "0"), ("WEEDTPU_XORSCHED_CACHE", "-3"),
                      ("WEEDTPU_XORSCHED_THREADS", "-1"), ("WEEDTPU_XORSCHED_THREADS", "6")):
        monkeypatch.setenv(name, raw)
        assert config.env(name) == ref_config.env(name), (name, raw)


def test_concurrent_dispatches_share_the_lru_without_lost_counts():
    """Sixteen threads (more than cores) dispatch through one xorsched
    encoder and the LRU at once, the interpreter lock switching every
    microsecond: every result is byte-exact and no hit or miss is lost."""
    import sys
    import threading

    enc = rs_codec.Encoder(10, 4, backend="xorsched")
    rng = np.random.default_rng(23)
    stack = rng.integers(0, 256, (10, 5000), dtype=np.uint8)
    losses = [(0,), (3, 12), (1, 5, 9), (2, 6, 10, 13)]
    want = {}
    for lost in losses:
        survivors = [s for s in range(14) if s not in lost][:10]
        want[lost] = gf8.gf_mat_vec(enc.reconstruction_matrix(survivors, lost), stack)
    xorsched.clear_schedule_cache()
    errors, calls = [], 16 * 12

    def work(seed: int) -> None:
        for i in range(12):
            lost = losses[(seed + i) % len(losses)]
            survivors = [s for s in range(14) if s not in lost][:10]
            got = np.asarray(enc.reconstruct_lazy(stack, survivors, lost))
            if not np.array_equal(got, want[lost]):
                errors.append((seed, lost))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    info = xorsched.schedule_cache_info()
    assert info["hits"] + info["misses"] == calls
    assert info["size"] == len(losses) <= info["misses"]
