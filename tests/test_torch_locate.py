"""The degraded read's small modules against the JAX package's: the
interval math (`ec/locate.py`) over a seeded grid of geometries, the
needle-record sizes and index parse (`storage/types.py`, `storage/idx.py`),
the holder-suspicion registry and its hedge delay (`ec/suspicion.py`), the
conversion journal's cut-over check (`ec/convert.py`), the `.ecj` journal
(`ec/stripe.py`), the read-path knobs (`utils/config.py`), and the launch
counter of `ops/rs_cuda.py` under threads. All comparisons exact."""

import json
import os
import sys
import threading

import numpy as np
import pytest

from seaweedfs_tpu.ec import convert as ref_convert
from seaweedfs_tpu.ec import locate as ref_locate
from seaweedfs_tpu.ec import stripe as ref_stripe
from seaweedfs_tpu.ec import suspicion as ref_suspicion
from seaweedfs_tpu.storage import idx as ref_idx
from seaweedfs_tpu.storage import types as ref_types
from seaweedfs_tpu.utils import config as ref_config
from seaweedfs_tpu_torch.ec import convert, locate, stripe, suspicion
from seaweedfs_tpu_torch.ops import rs_cuda
from seaweedfs_tpu_torch.storage import idx, types
from seaweedfs_tpu_torch.utils import config


def _geometries():
    """(large, small, data_shards, dat_size) from a seeded grid: the scaled
    blocks of the reference's tests, both codes' row widths, and .dat sizes
    on and around the tier edges."""
    rng = np.random.default_rng(7)
    out = []
    for large, small in ((1024, 64), (16384, 4096), (65536, 1024)):
        for k in (10, 12, 20):
            row = large * k
            for dat in (1, small * k, row, row + 1, 2 * row + 3 * small * k + 17,
                        int(rng.integers(1, 4 * row))):
                out.append((large, small, k, dat))
    return out


GEOMETRIES = _geometries()


@pytest.mark.parametrize("large, small, k, dat", GEOMETRIES,
                         ids=[f"{g[0]}-{g[1]}-k{g[2]}-{g[3]}" for g in GEOMETRIES])
def test_locate_data_matches_reference(large, small, k, dat):
    assert locate.large_row_count(dat, large, k) == ref_locate.large_row_count(dat, large, k)
    rng = np.random.default_rng(dat)
    probes = [(0, min(10, dat)), (max(0, dat - 7), min(7, dat)), (0, dat)]
    for _ in range(25):
        off = int(rng.integers(0, dat))
        probes.append((off, int(rng.integers(1, min(3 * large, dat - off) + 1))))
    for off, size in probes:
        assert locate.locate_offset(large, small, dat, off, k) == ref_locate.locate_offset(
            large, small, dat, off, k)
        got = locate.locate_data(large, small, dat, off, size, k)
        want = ref_locate.locate_data(large, small, dat, off, size, k)
        assert [vars(iv) for iv in got] == [vars(iv) for iv in want], (off, size)
        assert [iv.to_shard_id_and_offset(large, small) for iv in got] == [
            iv.to_shard_id_and_offset(large, small) for iv in want]
        assert sum(iv.size for iv in got) == size


@pytest.mark.parametrize("version", [2, 3])
def test_needle_record_sizes_and_offsets_match_reference(version):
    for name in ("NEEDLE_PADDING_SIZE", "NEEDLE_HEADER_SIZE", "NEEDLE_CHECKSUM_SIZE",
                 "TIMESTAMP_SIZE", "NEEDLE_MAP_ENTRY_SIZE", "TOMBSTONE_FILE_SIZE"):
        assert getattr(types, name) == getattr(ref_types, name), name
    for size in list(range(-2, 40)) + [1048568, (1 << 31) - 1]:
        assert types.actual_size(size, version) == ref_types.actual_size(size, version)
        assert types.padding_length(size, version) == ref_types.padding_length(size, version)
    for off in (0, 8, 1 << 20, 8 * ((1 << 32) - 1)):
        assert types.offset_to_bytes(off) == ref_types.offset_to_bytes(off)
        assert types.offset_to_actual(off // 8) == ref_types.offset_to_actual(off // 8)
    with pytest.raises(ValueError):
        types.offset_to_bytes(12)


def test_index_entries_array_matches_reference():
    rng = np.random.default_rng(3)
    buf = b"".join(
        types.pack_index_entry(int(k), int(o), int(s))
        for k, o, s in zip(rng.integers(0, 1 << 63, 50, dtype=np.uint64),
                           rng.integers(0, 1 << 32, 50, dtype=np.uint64),
                           rng.integers(-1, 1 << 31, 50))
    ) + b"\x01\x02\x03"  # a torn tail entry is ignored
    got, want = idx.index_entries_array(buf), ref_idx.index_entries_array(buf)
    assert got.dtype == want.dtype and len(got) == 50
    assert np.array_equal(got, want)


def test_ecj_append_and_compact_match_reference(tmp_path):
    bases = []
    for sub, mod in (("port", stripe), ("ref", ref_stripe)):
        os.makedirs(tmp_path / sub)
        base = str(tmp_path / sub / "4")
        idx.write_entries([(1, 1, 10), (2, 2, 20), (3, 3, -1), (9, 4, 7)], base + ".ecx")
        for nid in (2, 9, 3):
            mod.append_ecj(base, nid)
        with open(base + ".ecj", "ab") as f:
            f.write(b"\x00\x01")  # torn tail of a crashed append
        bases.append(base)
    assert stripe.read_ecj(bases[0]) == ref_stripe.read_ecj(bases[1]) == [2, 9, 3]
    assert stripe.compact_ecj(bases[0]) == ref_stripe.compact_ecj(bases[1]) == 3
    for ext in (".ecx",):
        with open(bases[0] + ext, "rb") as a, open(bases[1] + ext, "rb") as b:
            assert a.read() == b.read()
    assert not os.path.exists(bases[0] + ".ecj")
    assert stripe.compact_ecj(bases[0]) == 0  # idempotent


# -- the suspicion registry and the hedge delay --------------------------------


def _drive(reg, ops):
    out = []
    for op, *args in ops:
        out.append(getattr(reg, op)(*args))
    return out


def test_suspicion_registry_matches_reference():
    ops = [
        ("mark", ("peer", "a:1"), -1.0), ("mark", ("peer", "b:2"), -1.0),
        ("suspected", ("peer", "a:1")), ("mark", ("peer", "c:3"), 60.0),
        ("suspected", ("peer", "b:2")), ("suspected", ("peer", "c:3")),
        ("mark", ("volume-shard", "/v/7", 3), 60.0), ("mark", ("volume-shard", "/v/8", 3), 60.0),
        ("forget_volume", "/v/7"),
        ("suspected", ("volume-shard", "/v/7", 3)), ("suspected", ("volume-shard", "/v/8", 3)),
    ]
    mine, ref = suspicion.HolderSuspicion(), ref_suspicion.HolderSuspicion()
    assert _drive(mine, ops) == _drive(ref, ops)
    assert list(mine._until) == list(ref._until)
    mine.reset()
    assert not mine.suspected(("peer", "c:3"))


def test_hedge_delay_from_latency_ewma_matches_reference():
    key = ("peer", "10.0.0.1:1")
    for obs in ([0.10, 0.12, 0.08, 0.11], [0.1, 0.1], [0.002, 0.5, 0.003, 0.004, 9.0],
                [1e-5] * 6, [40.0] * 4):
        mine, ref = suspicion.HolderSuspicion(), ref_suspicion.HolderSuspicion()
        for s in obs + [-1.0]:  # a failure is never a sample
            mine.observe_latency(key, s)
            ref.observe_latency(key, s)
        assert mine.latency_estimate(key) == ref.latency_estimate(key)
        assert mine.hedge_delay(key) == ref.hedge_delay(key)
    assert suspicion.HolderSuspicion().hedge_delay(key) is None


def test_wedged_key_reads_suspected_until_its_call_returns():
    from concurrent.futures import Future

    for mod in (suspicion, ref_suspicion):
        reg, fut = mod.HolderSuspicion(), Future()
        reg.track_wedged(("peer", "x:1"), fut)
        assert reg.suspected(("peer", "x:1"))
        fut.set_result(None)
        assert not reg.suspected(("peer", "x:1"))


# -- the conversion journal's cut-over check -----------------------------------


@pytest.mark.parametrize("tail", [
    b"", b'{"type": "cutover"}', b'{"type": "cutover"}\n', b"garbage\n",
    b'{"type": "chunk", "i": 4}\n{"type": "cut', b'[1, 2]\n{"type": "cutover"}\n',
])
def test_pending_cutover_matches_reference(tmp_path, tail):
    base = str(tmp_path / "6")
    assert convert.pending_cutover(base) is ref_convert.pending_cutover(base) is False
    with open(convert.journal_path(base), "wb") as f:
        f.write(json.dumps({"type": "begin"}).encode() + b"\n" + tail)
    path = ref_convert.journal_path(base)
    assert convert.journal_path(base) == path
    assert convert.read_prefix(path) == ref_convert._Journal.read_prefix(path)
    assert convert.pending_cutover(base) == ref_convert.pending_cutover(base)


# -- the read path's knobs -----------------------------------------------------

KNOBS = ("WEEDTPU_READ_CACHE_MB", "WEEDTPU_READ_CACHE_TTL_S", "WEEDTPU_COALESCE_READS",
         "WEEDTPU_HEDGE_READS", "WEEDTPU_HEDGE_DELAY_MS")


@pytest.mark.parametrize("name", KNOBS)
@pytest.mark.parametrize("raw", [None, "", "0", "1", "-3", "2.5", "yes", "off", "ON"])
def test_read_knobs_match_reference(monkeypatch, name, raw):
    if raw is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, raw)

    def value(mod):
        try:
            return mod.env(name)
        except ValueError:
            return "ValueError"

    assert value(config) == value(ref_config)
    assert config.ENV_REGISTRY[name].default == ref_config.ENV_REGISTRY[name].default


# -- the launch counter under reader threads -----------------------------------


def test_launch_counts_are_exact_under_threads():
    """The card path's counter (`rs_cuda.count_launch`, called once per
    kernel launch) from 16 threads at once: no increment is lost."""
    total0, by0 = rs_cuda.launches, dict(rs_cuda.launches_by_variant)
    shape0 = dict(rs_cuda.launches_by_shape)
    per, variants, shapes = 4000, ("int8", "dma"), ((1, 3), (4, 10))
    start = threading.Barrier(16)

    def hammer(i):
        start.wait()
        for _ in range(per):
            rs_cuda.count_launch(variants[i % 2], shapes[i % 2])

    threads = [threading.Thread(target=hammer, args=(i,)) for i in range(16)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as possible
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert rs_cuda.launches == total0 + 16 * per
    for v in variants:
        assert rs_cuda.launches_by_variant[v] == by0.get(v, 0) + 8 * per
    for shape in shapes:
        assert rs_cuda.launches_by_shape[shape] == shape0.get(shape, 0) + 8 * per
    rs_cuda.reset_launches()
    assert rs_cuda.launches == 0 and rs_cuda.launches_by_variant == {}
    assert rs_cuda.launches_by_shape == {}
