"""The port's host codecs (`Encoder(backend="native")`, the AVX2 split-table
GF library of `csrc/gf_host.cc`, and `Encoder(backend="xorsched")`) against
the JAX package's encoders with the same backend, on the same seeded numpy
inputs, byte-exact: the GF library (the twins of `tests/test_native.py`'s
GF cases), the native golden and the CPU rule of `tests/test_rs_codec.py`,
the `WEEDTPU_BACKEND` override and its stats export
(`tests/test_auto_backend.py`), the block-diagonal fused decode and the
mixed-signature rebuild storm with its per-block schedule cache
(`tests/test_rebuild_fusion.py`), every loss pattern the geometries
survive, the bucketed reconstruct, and the shell's `ec.backend` CPU-floor
line. Also what stays the port's own: with `WEEDTPU_BACKEND` unset no
default reaches a host codec, and "native" raises where its library cannot
be built."""

import io
import itertools
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from seaweedfs_tpu import stats as ref_stats
from seaweedfs_tpu.ec import stripe as ref_stripe
from seaweedfs_tpu.ops import gf8 as ref_gf8
from seaweedfs_tpu.ops import rs_codec as ref_codec
from seaweedfs_tpu.ops import xorsched as ref_xs
from seaweedfs_tpu.utils import native as ref_native
from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.ec import stripe
from seaweedfs_tpu_torch.ops import gf8, rs_codec, xorsched
from seaweedfs_tpu_torch.utils import native
from test_torch_rebuild_fusion import GEOMETRIES, MIXED, _relative, _run, _storm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST = ("native", "xorsched")


def _mine(k: int, backend: str) -> rs_codec.Encoder:
    d, p, kind = GEOMETRIES[k]
    return rs_codec.Encoder(d, p, kind, backend=backend)


def _ref(k: int, backend: str) -> ref_codec.Encoder:
    d, p, kind = GEOMETRIES[k]
    return ref_codec.Encoder(d, p, backend=backend, matrix_kind=kind)


@pytest.fixture(autouse=True)
def _fresh_caches():
    xorsched.clear_schedule_cache()
    ref_xs.clear_schedule_cache()
    yield
    xorsched.clear_schedule_cache()
    ref_xs.clear_schedule_cache()


# -- the GF library (tests/test_native.py) ------------------------------------------


def test_gf_matrix_apply_native_matches_gf8_and_reference():
    assert native.load_gf() is not None and native.has_avx2() == ref_native.has_avx2()
    rng = np.random.default_rng(1)
    rows, cols, length = 4, 10, 4096
    matrix = rng.integers(0, 256, size=(rows, cols), dtype=np.uint8)
    inputs = [rng.integers(0, 256, size=length, dtype=np.uint8) for _ in range(cols)]
    outs = native.gf_matrix_apply_native(matrix, [i.tobytes() for i in inputs], length)
    want = gf8.gf_mat_vec(matrix, np.stack(inputs))
    ref = ref_native.gf_matrix_apply_native(matrix, [i.tobytes() for i in inputs], length)
    for r in range(rows):
        assert np.array_equal(outs[r], want[r]) and np.array_equal(outs[r], ref[r])
    with pytest.raises(ValueError):
        native.gf_matrix_apply_native(matrix, [i.tobytes() for i in inputs[:9]], length)


def test_gf_matrix_apply_mt_matches_single_thread():
    """The multithreaded split is byte-identical to the single-core path at
    sizes that split, including the 64-byte alignment remainder."""
    assert native.has_mt()
    pm = gf8.parity_matrix(10, 4)
    rng = np.random.default_rng(7)
    for n in (1 << 20, (1 << 20) + 37):
        ins = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for _ in range(10)]
        st = native.gf_matrix_apply_native(pm, ins, n, threads=1)
        assert all(np.array_equal(a, b) for a, b in
                   zip(st, ref_native.gf_matrix_apply_native(pm, ins, n, threads=1)))
        for threads in (0, 2, 3, 8):
            mt = native.gf_matrix_apply_native(pm, ins, n, threads=threads)
            assert all(np.array_equal(a, b) for a, b in zip(st, mt)), threads


def test_gf_matrix_apply_batch_matches_per_stack():
    pm = gf8.parity_matrix(10, 4)
    rng = np.random.default_rng(31)
    shards = rng.integers(0, 256, (5, 10, 4097), dtype=np.uint8)
    got = native.gf_matrix_apply_batch_native(pm, shards)
    assert got.shape == (5, 4, 4097)
    assert np.array_equal(got, ref_native.gf_matrix_apply_batch_native(pm, shards))
    for b in range(5):
        want = native.gf_matrix_apply_native(pm, [bytes(shards[b, c]) for c in range(10)], 4097)
        assert all(np.array_equal(got[b, r], want[r]) for r in range(4))
    with pytest.raises(ValueError):
        native.gf_matrix_apply_batch_native(pm, shards[:, :9])


# -- the Encoder (tests/test_rs_codec.py) ----------------------------------------------


@pytest.mark.parametrize("backend", HOST)
@pytest.mark.parametrize("k", sorted(GEOMETRIES))
def test_host_codec_matches_reference_encoder(backend, k):
    """Encode, batched encode, a loss of every parity's worth of shards,
    verify, reconstruct_data and the delta update: the port's host codec
    equals the reference's encoder with the same backend and its numpy
    golden."""
    mine, ref, gold = _mine(k, backend), _ref(k, backend), _ref(k, "numpy")
    assert mine.device.type == "cpu" and mine.backend == backend
    rng = np.random.default_rng(21 + k)
    data = [rng.integers(0, 256, 4096 + k, dtype=np.uint8) for _ in range(mine.data_shards)]
    g = gold.encode(data)
    f = mine.encode(data)
    assert all(np.array_equal(a, b) for a, b in zip(g, f))
    assert all(np.array_equal(a, b) for a, b in zip(ref.encode(data), f))
    batch = rng.integers(0, 256, (3, mine.data_shards, 2048), dtype=np.uint8)
    assert np.array_equal(mine.encode_batch(batch), ref.encode_batch(batch))
    lost = list(range(0, mine.total_shards, 3))[: mine.parity_shards]
    shards = [None if i in lost else s for i, s in enumerate(f)]
    rec = mine.reconstruct(shards)
    assert all(np.array_equal(rec[i], g[i]) for i in range(mine.total_shards))
    bad = [s.copy() for s in rec]
    bad[-1][17] ^= 1
    assert mine.verify(rec) and not mine.verify(bad)
    part = mine.reconstruct_data(shards)
    assert all(part[i] is None for i in lost if i >= mine.data_shards)
    assert all(np.array_equal(part[i], g[i]) for i in range(mine.data_shards))
    old, new = data[1][10:300], rng.integers(0, 256, 290, dtype=np.uint8)
    parity = np.stack(f[mine.data_shards:])[:, 10:300]
    assert np.array_equal(mine.update_parity(parity, 1, old, new),
                          ref.update_parity(parity, 1, old, new))
    assert mine.warm_reconstruct() == 0 == ref.warm_reconstruct()


@pytest.mark.parametrize("backend", HOST)
def test_host_codec_bucketed_and_lazy_reconstruct_match_reference(backend):
    """`reconstruct_batch(bucketed=True)` (no pad on the host, as the
    reference), `reconstruct_lazy`, `project` and zero-width stacks."""
    mine, ref = _mine(10, backend), _ref(10, backend)
    rng = np.random.default_rng(3)
    survivors, wanted = [1, 2, 3, 4, 6, 7, 8, 9, 10, 12], [0, 5, 13]
    for n in (1, 4095, 4097, 70_001):
        stack = rng.integers(0, 256, (2, 10, n), dtype=np.uint8)
        got = mine.reconstruct_batch(stack, survivors, wanted, bucketed=True)
        assert np.array_equal(got, ref.reconstruct_batch(stack, survivors, wanted, bucketed=True))
        lazy = mine.reconstruct_lazy(stack[0], survivors, wanted)
        assert np.array_equal(np.asarray(lazy), got[0])
    assert mine._bucket_for(100) is None
    coeffs = rng.integers(0, 256, (2, 3), dtype=np.uint8)
    local = rng.integers(0, 256, (3, 999), dtype=np.uint8)
    assert np.array_equal(mine.project(coeffs, local), ref.project(coeffs, local))
    empty = mine.encode_parity_lazy(np.zeros((10, 0), dtype=np.uint8))
    assert np.asarray(empty).shape == (4, 0)


def _patterns(k: int, upto: int):
    total = k + GEOMETRIES[k][1]
    for n in range(1, min(upto, GEOMETRIES[k][1]) + 1):
        yield from itertools.combinations(range(total), n)


def _check_patterns(k: int, backend: str, patterns, width: int = 64) -> int:
    mine, ref = _mine(k, backend), _ref(k, backend)
    rng = np.random.default_rng(k)
    full = mine.encode(list(rng.integers(0, 256, (mine.data_shards, width), dtype=np.uint8)))
    count = 0
    for lost in patterns:
        shards = [None if i in lost else s for i, s in enumerate(full)]
        got = mine.reconstruct(shards)
        want = ref.reconstruct(shards)
        for i in lost:
            assert np.array_equal(got[i], full[i]) and np.array_equal(got[i], want[i]), (lost, i)
        count += 1
    return count


@pytest.mark.parametrize("k", sorted(GEOMETRIES))
def test_native_reconstructs_every_loss_pattern_as_reference(k):
    """Every loss pattern the geometry survives (up to 4 shards at 10+4
    and 20+4, 3 at 12+3) through the native codec, against the
    reference's native encoder."""
    want = {10: 1470, 12: 575, 20: 12950}[k]
    assert _check_patterns(k, "native", _patterns(k, 4)) == want


@pytest.mark.parametrize("k", sorted(GEOMETRIES))
def test_xorsched_reconstructs_loss_patterns_as_reference(k):
    """Every one-shard loss, and a seeded sample of two- to four-shard
    losses, through the xorsched codec against the reference's xorsched
    encoder (each pattern is a program of its own, compiled by both
    packages: the exhaustive sweep is the slow test below)."""
    rng = np.random.default_rng(100 + k)
    singles = list(_patterns(k, 1))
    more = [p for p in _patterns(k, 4) if len(p) > 1]
    sample = [more[i] for i in rng.choice(len(more), size=6, replace=False)]
    assert _check_patterns(k, "xorsched", singles + sample) == len(singles) + 6


@pytest.mark.slow
@pytest.mark.parametrize("k", sorted(GEOMETRIES))
def test_xorsched_reconstructs_every_loss_pattern_as_reference(k):
    """The exhaustive sweep of the case above (minutes at 10+4, hours at
    20+4: every pattern compiles a program in each package)."""
    _check_patterns(k, "xorsched", _patterns(k, 4))


# -- the block-diagonal fused decode and the storm (tests/test_rebuild_fusion.py) ---------


def _block(enc, missing, col_start, width):
    survivors = [s for s in range(enc.total_shards) if s not in missing][: enc.data_shards]
    return {"encoder": enc, "survivors": survivors, "wanted": list(missing),
            "col_start": col_start, "width": width}


@pytest.mark.parametrize("backend", HOST)
@pytest.mark.parametrize("widths", [(513, 7, 4096), (1, 4097, 300)], ids=["odd", "edge"])
def test_reconstruct_block_mixed_geometries_equals_reference(backend, widths):
    """Three blocks (10+4 losing two, 12+3 one, 20+4 two) side by side from
    column 3: on each block's wanted rows the port equals the reference's
    encoder with the same backend and the gf8 golden, in one dispatch."""
    specs = ((10, [12, 13]), (12, [5]), (20, [20, 23]))
    col, mine, ref = 3, [], []
    for (k, missing), w in zip(specs, widths):
        mine.append(_block(_mine(k, backend), missing, col, w))
        ref.append(_block(_ref(k, backend), missing, col, w))
        col += w
    staging = np.random.default_rng(sum(widths)).integers(0, 256, (20, col + 5), np.uint8)
    before = sum(float(line.rsplit(" ", 1)[1]) for line in stats.EcDispatchTotal.collect()
                 if f'backend="{backend}"' in line)
    got = _mine(10, backend).reconstruct_block(staging, mine)
    after = sum(float(line.rsplit(" ", 1)[1]) for line in stats.EcDispatchTotal.collect()
                if f'backend="{backend}"' in line)
    assert isinstance(got, np.ndarray) and got.shape == (2, col + 5)
    assert after - before == (1 if backend == "xorsched" else 3)
    want = np.asarray(_ref(10, backend).reconstruct_block(staging, ref))
    for b in mine:
        c0, w, rows = b["col_start"], b["width"], len(b["wanted"])
        enc = b["encoder"]
        m = enc.reconstruction_matrix(b["survivors"], b["wanted"])
        golden = gf8.gf_mat_vec(m, staging[: enc.data_shards, c0 : c0 + w])
        assert np.array_equal(got[:rows, c0 : c0 + w], golden)
        assert np.array_equal(got[:rows, c0 : c0 + w], want[:rows, c0 : c0 + w])
    if backend == "xorsched":  # one LRU'd program per block, never the composite
        assert xorsched.schedule_cache_info()["size"] == 3


@pytest.mark.parametrize("backend", HOST)
def test_batch_mixed_signatures_through_host_codec_equals_reference(tmp_path, backend):
    """The mixed 10+4 / 12+3 / 20+4 storm in one fused batch through the
    host codec: the result dict and every rebuilt shard equal the
    reference's storm with the same backend and the golden shards."""
    goldens = _storm(tmp_path, MIXED)
    kw = dict(buffer_size=16384, max_batch_bytes=163_840)
    res = _run(stripe, tmp_path / "port", MIXED, lambda k: _mine(k, backend), **kw)
    want = _run(ref_stripe, tmp_path / "ref", MIXED, lambda k: _ref(k, backend), **kw)
    assert _relative(res, tmp_path / "port") == _relative(want, tmp_path / "ref")
    assert not res["errors"] and res["dispatch_groups"] == 1
    for vid, (golden, missing, _) in goldens.items():
        for s in missing:
            with open(stripe.shard_file_name(str(tmp_path / "port" / str(vid)), s), "rb") as f:
                assert f.read() == golden[s], (vid, s)


def test_schedule_cache_keys_per_block_under_mixed_storm(tmp_path):
    """The fused dispatch compiles ONE schedule per block sub-matrix (keyed
    individually in the LRU), not one composite program: a re-run of the
    same storm is all hits, and the counters equal the reference's."""
    _storm(tmp_path, MIXED)
    n_sigs = len(MIXED)
    kw = dict(buffer_size=16384, max_batch_bytes=163_840)
    infos = []
    for _ in range(2):
        res = _run(stripe, tmp_path / "port", MIXED, lambda k: _mine(k, "xorsched"), **kw)
        want = _run(ref_stripe, tmp_path / "ref", MIXED, lambda k: _ref(k, "xorsched"), **kw)
        assert not res["errors"] and res["dispatch_groups"] == 1
        infos.append(xorsched.schedule_cache_info())
        assert infos[-1] == ref_xs.schedule_cache_info()
        for vid, _, missing, _ in MIXED:  # lose them again
            for d, mod in (("port", stripe), ("ref", ref_stripe)):
                for s in missing:
                    os.unlink(mod.shard_file_name(str(tmp_path / d / str(vid)), s))
        assert _relative(res, tmp_path / "port") == _relative(want, tmp_path / "ref")
    assert infos[0]["size"] == infos[0]["misses"] == n_sigs
    assert infos[1]["misses"] == n_sigs and infos[1]["hits"] > infos[0]["hits"]


# -- the factory: the override, its export, and the defaults ----------------------------


def _selected(backend: str, source: str) -> str:
    return f'weedtpu_ec_backend_selected{{backend="{backend}",source="{source}"}}'


def test_weedtpu_backend_env_overrides_a_caller_naming_no_backend(monkeypatch):
    monkeypatch.setenv("WEEDTPU_BACKEND", "torch")
    enc = rs_codec.new_encoder()
    assert (enc.backend, enc.device.type) == ("torch", "cpu")
    assert enc.selection["source"] == "env:WEEDTPU_BACKEND"
    for backend in HOST:
        monkeypatch.setenv("WEEDTPU_BACKEND", backend)
        for kw in ({}, {"device": "cpu"}, {"family": "cauchy_12_3"}):
            enc = rs_codec.new_encoder(**kw)
            assert (enc.backend, enc.device.type) == (backend, "cpu")
            assert enc.selection["source"] == "env:WEEDTPU_BACKEND"
        # explicit callers are never overridden
        enc = rs_codec.new_encoder(device="cpu", backend="torch")
        assert enc.backend == "torch" and enc.selection["source"] == "explicit"
    monkeypatch.setenv("WEEDTPU_BACKEND", "auto")
    enc = rs_codec.new_encoder(device="cpu")
    assert enc.backend == rs_codec.pick_cpu_backend()[0]
    assert enc.selection["source"] in ("platform", "cpu-bench-evidence")
    monkeypatch.setenv("WEEDTPU_BACKEND", "bogus")
    with pytest.raises(ValueError, match="WEEDTPU_BACKEND"):
        rs_codec.new_encoder()
    monkeypatch.setenv("WEEDTPU_BACKEND", "numpy")  # the reference's name, not the port's
    with pytest.raises(ValueError, match="WEEDTPU_BACKEND"):
        rs_codec.new_encoder(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("WEEDTPU_BACKEND", "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rs_codec.new_encoder()


def test_selection_exported_through_stats(monkeypatch):
    """The twin of the reference's case: an override's label pair is set,
    and a later different selection zeroes it."""
    for pkg_stats, pkg, name in ((stats, rs_codec, "native"), (ref_stats, ref_codec, "native")):
        monkeypatch.setenv("WEEDTPU_BACKEND", name)
        pkg.new_encoder()
        lines = "\n".join(pkg_stats.EcBackendSelected.collect())
        assert _selected(name, "env:WEEDTPU_BACKEND") + " 1.0" in lines
        monkeypatch.delenv("WEEDTPU_BACKEND")
        enc = pkg.new_encoder(device="cpu") if pkg is rs_codec else pkg.new_encoder()
        lines = "\n".join(pkg_stats.EcBackendSelected.collect())
        assert _selected(name, "env:WEEDTPU_BACKEND") + " 0.0" in lines
        src = enc.selection["source"]
        assert _selected(enc.backend, src) + " 1.0" in lines
    auto = rs_codec.new_encoder(backend="auto", device="cpu")
    lines = "\n".join(stats.EcBackendSelected.collect())
    assert _selected(auto.backend, auto.selection["source"]) + " 1.0" in lines


def test_defaults_never_reach_a_host_codec(tmp_path, monkeypatch):
    """With WEEDTPU_BACKEND unset, `new_encoder()` is the card's (and raises
    without one) and `new_encoder(device="cpu")` the plain version, even
    beside winning CPU bench evidence that promotes `auto`."""
    import datetime
    import json

    monkeypatch.delenv("WEEDTPU_BACKEND", raising=False)
    monkeypatch.setattr(rs_codec, "_artifacts_dir", lambda: str(tmp_path))
    when = datetime.datetime.now(datetime.timezone.utc).strftime("%Y-%m-%dT%H:%MZ")
    with open(tmp_path / "BENCH_r91.json", "w", encoding="utf-8") as f:
        json.dump({"n": 91, "parsed": {"xor": {
            "when": when, "host": rs_codec._host_fingerprint(), "match": True,
            "encode": {"xorsched_gbps": 9.0, "native_gbps": 1.0}}}}, f)
    assert rs_codec.new_encoder(backend="auto", device="cpu").backend == "xorsched"
    for kw in ({"device": "cpu"}, {"device": "cpu", "family": "merge_20_4"}):
        enc = rs_codec.new_encoder(**kw)
        assert enc.backend == "torch" and enc.selection["source"] == "explicit"
        assert "reason" not in enc.selection
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rs_codec.new_encoder()
    with pytest.raises(ValueError):
        rs_codec.Encoder(10, 4, backend="native", device="cuda")
    with pytest.raises(ValueError):
        rs_codec.Encoder(10, 4, backend="xorsched", device="cuda:0")


def test_native_without_a_compiler_raises(monkeypatch):
    """Where gf_host cannot be built, "native" raises at construction and
    through the factory, and the CPU rule's base is the plain version;
    nothing serves through numpy in its place. xorsched says it runs its
    interpreter."""
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    unbuilt = native._HostLib("gf_host", native.GF_SOURCE,
                              native.GF_CXX_FLAGS + ("-DUNBUILT",), native._bind_gf)
    monkeypatch.setattr(native, "_GF", unbuilt)
    assert not os.path.exists(unbuilt.path())
    assert native.load_gf() is None and not native.has_avx2() and not native.has_mt()
    assert native.gf_matrix_apply_native(np.ones((1, 1), np.uint8), [b"x"], 1) is None
    with pytest.raises(RuntimeError, match="native"):
        rs_codec.Encoder(10, 4, backend="native")
    with pytest.raises(RuntimeError, match="native"):
        rs_codec.new_encoder(backend="native")
    monkeypatch.setenv("WEEDTPU_BACKEND", "native")
    with pytest.raises(RuntimeError, match="native"):
        rs_codec.new_encoder(device="cpu")
    monkeypatch.delenv("WEEDTPU_BACKEND")
    assert rs_codec._cpu_backend() == "torch"
    assert rs_codec.new_encoder(backend="auto", device="cpu").backend == "torch"
    enc = rs_codec.new_encoder(backend="xorsched")
    assert enc.selection["xor_simd"] == "unavailable"


def test_cpu_rule_on_this_host_matches_the_reference(monkeypatch):
    """`auto` on the CPU is `pick_cpu_backend`: the library path here (no
    CPU bench file is committed to the port's evidence directory), equal to
    the reference's decision on the same directory."""
    expected, dec = rs_codec.pick_cpu_backend()
    assert expected == "native"
    assert dec == ref_codec.pick_cpu_backend(art_dir=rs_codec._artifacts_dir())[1]
    monkeypatch.delenv("WEEDTPU_BACKEND", raising=False)
    enc = rs_codec.new_encoder(backend="auto", device="cpu")
    assert enc.backend == expected and enc.selection["source"] == "platform"


# -- the shell's ec.backend line ----------------------------------------------------------


def _floor_fields(text: str) -> dict:
    line = next(ln for ln in text.splitlines() if ln.startswith("ec.backend: cpu floor: "))
    return dict(kv.split("=", 1) for kv in line.removeprefix("ec.backend: cpu floor: ").split())


@pytest.mark.parametrize("backend", HOST)
def test_ec_backend_cpu_floor_line_equals_reference(monkeypatch, backend):
    """The CPU-floor audit line for a native and an xorsched encoder: path,
    evidence round, the XOR executor's SIMD level and the schedule cache,
    field for field the reference's after one dispatch in each package."""
    from seaweedfs_tpu.shell import command_ec as ref_cec
    from seaweedfs_tpu_torch.shell import command_ec as port_cec

    monkeypatch.setenv("WEEDTPU_BACKEND", backend)
    data = [np.full(100, i, np.uint8) for i in range(10)]
    rs_codec.new_encoder().encode(data)
    ref_codec.new_encoder().encode(data)
    mine, ref = io.StringIO(), io.StringIO()
    port_cec.do_ec_backend([], types.SimpleNamespace(device=None), mine)
    ref_cec.do_ec_backend([], types.SimpleNamespace(), ref)
    got, want = _floor_fields(mine.getvalue()), _floor_fields(ref.getvalue())
    assert got == want
    assert got["path"] == backend and got["evidence_round"] == "-"
    assert got["xor_simd"] == xorsched.native_level()
    if backend == "xorsched":
        assert (got["sched_cache"], got["size"]) == ("0hit/1miss", "1/64")
    assert mine.getvalue().splitlines()[0] == (
        f"ec.backend: backend={backend} device=cpu source=env:WEEDTPU_BACKEND variant=int8"
        + (f" xor_simd={xorsched.native_level()}" if backend == "xorsched" else ""))


def test_ec_backend_cpu_floor_line_for_the_plain_version(monkeypatch):
    from seaweedfs_tpu_torch.shell import command_ec as port_cec

    monkeypatch.delenv("WEEDTPU_BACKEND", raising=False)
    out = io.StringIO()
    port_cec.do_ec_backend([], types.SimpleNamespace(device="cpu"), out)
    assert _floor_fields(out.getvalue())["path"] == "torch"


# -- the port's own library, never the reference's ----------------------------------------


PROBE = r"""
import numpy as np
from seaweedfs_tpu_torch.ops import rs_codec
data = [np.full(4096, i, np.uint8) for i in range(10)]
for backend in ("native", "xorsched"):
    enc = rs_codec.Encoder(10, 4, backend=backend)
    shards = enc.encode(data)
    assert enc.reconstruct([None] + shards[1:])[0].tobytes() == data[0].tobytes()
with open("/proc/self/maps", encoding="utf-8") as f:
    maps = f.read()
print("libgf_host-" in maps, "libweedtpu" in maps)
"""


def test_host_codecs_load_the_ports_own_library():
    proc = subprocess.run([sys.executable, "-c", PROBE], capture_output=True, text=True,
                          timeout=120, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["True", "False"]
    assert os.path.basename(native.gf_lib_path()).startswith("libgf_host-")
    assert ref_gf8.parity_matrix(10, 4).tobytes() == gf8.parity_matrix(10, 4).tobytes()
