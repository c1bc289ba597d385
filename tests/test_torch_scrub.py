"""The scrubber in the port against the JAX package's: verdicts of
`scan_shard_file` and `verify_ec_volume` equal to the reference's on the
same damaged files; the fsync'd cursor (round trip, garbage tolerance,
quarantine entries, exact mid-shard resume) loaded across the two
packages both ways; the repair backoff; `Scrubber.run_cycle` over the
port's `EcVolume` (every finding class, volumes without CRCs, the
admission hook, an interrupted cycle's cursor, the rate cap); quarantine
routing reads to reconstruction and a remount restoring them; and a
scrub, quarantine and rebuild cycle that ends with every shard verified."""

import os
import threading
import time
import zlib

import numpy as np
import pytest

from seaweedfs_tpu.ec import scrub as ref_scrub
from seaweedfs_tpu.ec.ec_volume import EcVolume as RefEcVolume
from seaweedfs_tpu.ops import rs_codec as ref_codec
from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.ec import scrub, stripe
from seaweedfs_tpu_torch.ec.constants import TOTAL_SHARDS_COUNT
from seaweedfs_tpu_torch.ec.ec_volume import EcDegradedReadError, EcShardCorrupt, EcVolume
from seaweedfs_tpu_torch.ops import rs_codec

ENC = rs_codec.Encoder(10, 4, device="cpu")
REF = ref_codec.Encoder(10, 4, backend="numpy")
LARGE, SMALL = 16384, 4096
VID = 9


def _build_ec_volume(dirpath: str, size: int = 400_000, seed: int = 3):
    base = os.path.join(dirpath, str(VID))
    rng = np.random.default_rng(seed)
    with open(base + ".dat", "wb") as f:
        f.write(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
    with open(base + ".idx", "wb"):
        pass
    stripe.write_ec_files(base, LARGE, SMALL, encoder=ENC)
    stripe.write_sorted_file_from_idx(base)
    golden = {}
    for s in range(TOTAL_SHARDS_COUNT):
        with open(stripe.shard_file_name(base, s), "rb") as f:
            golden[s] = f.read()
    os.unlink(base + ".dat")
    return base, golden


def _flip_byte(path: str, offset: int = None) -> None:
    size = os.path.getsize(path)
    offset = size // 2 if offset is None else offset
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0x40]))


def _mounted(base) -> EcVolume:
    return EcVolume(base, encoder=ENC, warm_on_mount=False)


# -- detection classes ---------------------------------------------------------------


def test_expected_shard_size_matches_files_and_reference(tmp_path):
    base, _ = _build_ec_volume(str(tmp_path))
    info = stripe.read_ec_info(base)
    want = scrub.expected_shard_size(info)
    assert want == ref_scrub.expected_shard_size(info)
    for s in range(TOTAL_SHARDS_COUNT):
        assert os.path.getsize(stripe.shard_file_name(base, s)) == want
    for fam, dat in (("cauchy_12_3", 123_457), ("merge_20_4", 1_000_001)):
        g = rs_codec.geometry_for(fam)
        info = {"dat_size": dat, "large_block_size": LARGE, "small_block_size": SMALL,
                "data_shards": g.data_shards, "parity_shards": g.parity_shards,
                "matrix_kind": g.matrix_kind, "family": fam}
        assert scrub.expected_shard_size(info) == ref_scrub.expected_shard_size(info)


@pytest.mark.parametrize("klass", ["ok", "corrupt", "truncated", "missing", "oversize"])
@pytest.mark.parametrize("chunk", [8192, 65536, 1 << 22])
def test_scan_shard_file_classes_equal_reference(tmp_path, klass, chunk):
    base, _ = _build_ec_volume(str(tmp_path))
    info = stripe.read_ec_info(base)
    want_size = scrub.expected_shard_size(info)
    crcs = info["shard_crc32"]
    p = stripe.shard_file_name(base, 3)
    expect = {"ok": scrub.OK, "corrupt": scrub.CORRUPT, "truncated": scrub.TRUNCATED,
              "missing": scrub.MISSING, "oversize": scrub.CORRUPT}[klass]
    if klass == "corrupt":
        _flip_byte(p)
    elif klass == "truncated":
        os.truncate(p, want_size - 17)
    elif klass == "missing":
        os.unlink(p)
    elif klass == "oversize":
        with open(p, "ab") as f:
            f.write(b"x")
    got = scrub.scan_shard_file(p, crcs[3], want_size, chunk_bytes=chunk)
    assert got == expect == ref_scrub.scan_shard_file(p, crcs[3], want_size, chunk_bytes=chunk)


def test_scan_shard_file_budget_hook_sees_every_chunk(tmp_path):
    base, _ = _build_ec_volume(str(tmp_path))
    info = stripe.read_ec_info(base)
    want_size = scrub.expected_shard_size(info)
    seen = []
    assert scrub.scan_shard_file(stripe.shard_file_name(base, 0), info["shard_crc32"][0],
                                 want_size, chunk_bytes=10_000, budget=seen.append) == scrub.OK
    assert sum(seen) == want_size and max(seen) <= 10_000


def test_mid_shard_resume_uses_saved_crc_accumulator(tmp_path):
    base, golden = _build_ec_volume(str(tmp_path))
    info = stripe.read_ec_info(base)
    want_size = scrub.expected_shard_size(info)
    p = stripe.shard_file_name(base, 2)
    k = want_size // 3
    prefix_crc = zlib.crc32(golden[2][:k])
    assert scrub.scan_shard_file(p, info["shard_crc32"][2], want_size, offset=k,
                                 crc=prefix_crc) == scrub.OK
    assert scrub.scan_shard_file(p, info["shard_crc32"][2], want_size, offset=k,
                                 crc=prefix_crc ^ 1) == scrub.CORRUPT


# -- the cursor --------------------------------------------------------------------


def test_cursor_roundtrip_and_garbage_tolerance(tmp_path):
    path = str(tmp_path / "cursor.json")
    c = scrub.ScrubCursor(path)
    c.point(7, 3, 123456, 0xDEAD)
    c.cycles = 4
    c.save()
    c2 = scrub.ScrubCursor(path)
    assert (c2.vid, c2.shard, c2.offset, c2.crc, c2.cycles) == (7, 3, 123456, 0xDEAD, 4)
    for garbage in ("{torn garbage", '{"vid": "x"}', '{"quarantine": [{"vid": 1}]}'):
        with open(path, "w") as f:
            f.write(garbage)
        c3, r3 = scrub.ScrubCursor(path), ref_scrub.ScrubCursor(path)
        got = (c3.vid, c3.shard, c3.offset, c3.crc, c3.cycles, c3.quarantine)
        assert got == (r3.vid, r3.shard, r3.offset, r3.crc, r3.cycles, r3.quarantine)
        assert got == (0, 0, 0, 0, 0, [])
    # valid JSON that is not an object: the reference's load raises, the
    # port's loads a fresh cursor, as for any other garbage
    with open(path, "w") as f:
        f.write("[1, 2]")
    with pytest.raises(AttributeError):
        ref_scrub.ScrubCursor(path)
    c4 = scrub.ScrubCursor(path)
    assert (c4.vid, c4.shard, c4.offset, c4.crc, c4.cycles, c4.quarantine) == (0, 0, 0, 0, 0, [])


def test_cursor_quarantine_entries_persist(tmp_path):
    path = str(tmp_path / "cursor.json")
    c = scrub.ScrubCursor(path)
    c.add_quarantine(7, 3, scrub.CORRUPT)
    c.add_quarantine(7, 3, scrub.CORRUPT)  # dedup
    c.add_quarantine(8, 1, scrub.TRUNCATED)
    assert len(scrub.ScrubCursor(path).quarantine) == 2
    c2 = scrub.ScrubCursor(path)
    c2.remove_quarantine(7, 3)
    assert scrub.ScrubCursor(path).quarantine == [{"vid": 8, "shard": 1,
                                                   "reason": scrub.TRUNCATED}]


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_cursor_loads_across_packages(tmp_path, writer):
    """A cursor saved by one package (a mid-shard point, cycles and
    quarantine entries) loads in the other to the same state, and the two
    write the same bytes."""
    paths = {name: str(tmp_path / f"{name}.json") for name in ("port", "ref")}
    for name, mod in (("port", scrub), ("ref", ref_scrub)):
        c = mod.ScrubCursor(paths[name])
        c.point(11, 6, 7 << 20, 0xC0FFEE)
        c.cycles = 3
        c.add_quarantine(11, 5, mod.CORRUPT)
        c.add_quarantine(12, 21, mod.MISSING)
    with open(paths["port"], "rb") as f, open(paths["ref"], "rb") as g:
        assert f.read() == g.read()
    reader = ref_scrub if writer == "port" else scrub
    c = reader.ScrubCursor(paths[writer])
    assert (c.vid, c.shard, c.offset, c.crc, c.cycles) == (11, 6, 7 << 20, 0xC0FFEE, 3)
    assert c.quarantine == [{"vid": 11, "shard": 5, "reason": "corrupt"},
                            {"vid": 12, "shard": 21, "reason": "missing"}]


# -- repair policy -------------------------------------------------------------------


def test_repair_policy_backoff_doubles_and_caps():
    now = [0.0]
    pol = scrub.RepairPolicy(base=2.0, max_backoff=10.0, time_fn=lambda: now[0])
    key = (7, 3)
    assert pol.due(key)
    assert pol.failed(key) == 2.0
    assert not pol.due(key) and pol.delay(key) == 2.0
    now[0] = 2.0
    assert pol.due(key)
    assert [pol.failed(key) for _ in range(4)] == [4.0, 8.0, 10.0, 10.0]
    pol.succeeded(key)
    assert pol.due(key)


@pytest.mark.parametrize("kw", [{}, {"base": 2.0, "max_backoff": 10.0}, {"base": 1.5},
                                {"max_backoff": 7.0}, {"base": 3.0, "max_backoff": 2.0},
                                {"base": 0.0, "max_backoff": 1.0}])
def test_repair_policy_schedule_equals_reference(kw):
    now = [0.0]
    pol = scrub.RepairPolicy(time_fn=lambda: now[0], **kw)
    ref = ref_scrub.RepairPolicy(time_fn=lambda: now[0], **kw)
    assert (pol.base, pol.max_backoff) == (ref.base, ref.max_backoff)
    if not kw:
        assert (pol.base, pol.max_backoff) == (5.0, 60.0)
    for _ in range(7):
        assert pol.failed("k") == ref.failed("k")
        assert (pol.due("k"), pol.delay("k")) == (ref.due("k"), ref.delay("k"))
        now[0] += 4.0
    pol.succeeded("k")
    ref.succeeded("k")
    assert pol.due("k") and ref.due("k")


# -- scrubber cycles -------------------------------------------------------------------


def test_run_cycle_detects_all_classes_and_reports(tmp_path):
    base, _ = _build_ec_volume(str(tmp_path))
    ev = _mounted(base)
    try:
        _flip_byte(stripe.shard_file_name(base, 1))
        os.truncate(stripe.shard_file_name(base, 5), 100)
        os.unlink(stripe.shard_file_name(base, 9))
        found = []
        c0 = {k: stats.ScrubCorruptionsFound.labels(k).value for k in scrub.FINDING_CLASSES}
        cycles0, scanned0 = stats.ScrubCycles.value, stats.ScrubBytesScanned.value
        s = scrub.Scrubber(volumes=lambda: {VID: ev},
                           on_finding=lambda vid, sh, v: found.append((vid, sh, v)),
                           cursor_path=str(tmp_path / "cursor.json"), rate_mb=0.0,
                           chunk_bytes=64 * 1024)
        out = s.run_cycle()
        assert sorted(found) == [(VID, 1, scrub.CORRUPT), (VID, 5, scrub.TRUNCATED),
                                 (VID, 9, scrub.MISSING)]
        assert sorted(out["findings"]) == sorted(found)
        want_size = scrub.expected_shard_size(stripe.read_ec_info(base))
        assert out["shards_ok"] == TOTAL_SHARDS_COUNT - 3
        assert out["scanned_bytes"] == (TOTAL_SHARDS_COUNT - 3) * want_size
        for k in scrub.FINDING_CLASSES:
            assert stats.ScrubCorruptionsFound.labels(k).value == c0[k] + 1
        assert stats.ScrubCycles.value == cycles0 + 1
        # the corrupt shard is read whole before its verdict
        assert stats.ScrubBytesScanned.value == scanned0 + (TOTAL_SHARDS_COUNT - 2) * want_size
        for sh, v in ((1, scrub.CORRUPT), (5, scrub.TRUNCATED), (9, scrub.MISSING)):
            ev.quarantine_shard(sh, v)
        out2 = s.run_cycle()
        assert out2["findings"] == [] and s.cursor.cycles == 2
        verdicts, has_crcs = scrub.verify_ec_volume(ev)
        assert has_crcs and verdicts == {**{sh: scrub.OK for sh in range(14)},
                                         1: scrub.CORRUPT, 5: scrub.TRUNCATED, 9: scrub.MISSING}
    finally:
        ev.close()


def test_verify_ec_volume_equals_reference(tmp_path):
    """The port's verify over its EcVolume gives the reference's verdicts
    over the reference EcVolume on the same files."""
    base, _ = _build_ec_volume(str(tmp_path))
    _flip_byte(stripe.shard_file_name(base, 2))
    os.truncate(stripe.shard_file_name(base, 11), 5)
    ev, rev = _mounted(base), RefEcVolume(base, encoder=REF, warm_on_mount=False)
    try:
        ev.quarantine_shard(4, scrub.CORRUPT)
        rev.quarantine_shard(4, ref_scrub.CORRUPT)
        os.unlink(stripe.shard_file_name(base, 13))
        got = scrub.verify_ec_volume(ev, chunk_bytes=65536)
        assert got == ref_scrub.verify_ec_volume(rev, chunk_bytes=65536)
        assert got[0][2] == scrub.CORRUPT and got[0][11] == scrub.TRUNCATED
        assert got[0][13] == scrub.MISSING and got[0][4] == scrub.CORRUPT
    finally:
        ev.close()
        rev.close()


def test_run_cycle_skips_volumes_without_crc_record(tmp_path):
    base, _ = _build_ec_volume(str(tmp_path))
    info = stripe.read_ec_info(base)
    stripe.write_ec_info(base, info["large_block_size"], info["small_block_size"],
                         info["dat_size"])
    ev = _mounted(base)
    try:
        s = scrub.Scrubber(volumes=lambda: {VID: ev},
                           on_finding=lambda *a: pytest.fail("nothing to find"),
                           cursor_path=str(tmp_path / "cursor.json"), rate_mb=0.0)
        out = s.run_cycle()
        assert out["unverifiable"] == 1 and out["findings"] == []
        verdicts, has_crcs = scrub.verify_ec_volume(ev)
        assert not has_crcs and set(verdicts.values()) == {scrub.UNVERIFIABLE}
    finally:
        ev.close()


def test_scrub_admission_hook_yields_then_proceeds(tmp_path):
    base, _ = _build_ec_volume(str(tmp_path), size=120_000)
    ev = _mounted(base)
    calls = []
    gate_open = threading.Event()

    def admit() -> bool:
        calls.append(1)
        return gate_open.is_set()

    try:
        s = scrub.Scrubber(volumes=lambda: {VID: ev}, on_finding=lambda *a: None,
                           cursor_path=str(tmp_path / "cursor.json"), rate_mb=0.0,
                           chunk_bytes=64 * 1024, admit=admit)
        t = threading.Thread(target=s.run_cycle, daemon=True)
        t.start()
        time.sleep(0.3)
        assert calls and t.is_alive()
        gate_open.set()
        t.join(20)
        assert not t.is_alive()
    finally:
        ev.close()


def test_interrupted_cycle_preserves_mid_shard_cursor(tmp_path):
    base, _ = _build_ec_volume(str(tmp_path), size=300_000)
    ev = _mounted(base)
    admits = [0]
    parked = threading.Event()

    def admit() -> bool:
        admits[0] += 1
        if admits[0] > 3:
            parked.set()
            return False
        return True

    try:
        s = scrub.Scrubber(volumes=lambda: {VID: ev}, on_finding=lambda *a: None,
                           cursor_path=str(tmp_path / "cursor.json"), rate_mb=0.0,
                           chunk_bytes=16 * 1024, interval=3600.0, admit=admit)
        s.start()
        assert parked.wait(10)
        s.stop()
        c = scrub.ScrubCursor(str(tmp_path / "cursor.json"))
        assert c.vid == VID and (c.shard > 0 or c.offset > 0)
        assert c.cycles == 0
        # the reference resumes from the port's cursor at the same point
        r = ref_scrub.ScrubCursor(str(tmp_path / "cursor.json"))
        assert (r.vid, r.shard, r.offset, r.crc) == (c.vid, c.shard, c.offset, c.crc)
    finally:
        ev.close()


def test_resumed_cycle_from_a_mid_shard_cursor_is_exact(tmp_path):
    """A cycle that starts from a saved mid-shard cursor (offset and CRC
    accumulator) scans only the rest and still finds every shard ok, and a
    wrong accumulator makes that shard corrupt."""
    base, golden = _build_ec_volume(str(tmp_path))
    ev = _mounted(base)
    try:
        k = len(golden[4]) // 2
        for crc, verdicts in ((zlib.crc32(golden[4][:k]), []),
                              (zlib.crc32(golden[4][:k]) ^ 1, [(VID, 4, scrub.CORRUPT)])):
            cur = scrub.ScrubCursor(str(tmp_path / "c.json"))
            cur.point(VID, 4, k, crc)
            cur.save()
            found = []
            s = scrub.Scrubber(volumes=lambda: {VID: ev},
                               on_finding=lambda vid, sh, v: found.append((vid, sh, v)),
                               cursor_path=str(tmp_path / "c.json"), rate_mb=0.0,
                               chunk_bytes=64 * 1024)
            out = s.run_cycle()
            assert found == verdicts
            assert out["scanned_bytes"] == (len(golden[4]) - k) * (not verdicts) + 9 * len(golden[4])
    finally:
        ev.close()


def test_rate_cap_paces_the_scan(tmp_path):
    """At 4 MiB/s a scan of 14 shards of 40 KiB in 16 KiB chunks takes at
    least about 0.1 s (unthrottled it takes a few ms)."""
    base, _ = _build_ec_volume(str(tmp_path))
    ev = _mounted(base)
    try:
        s = scrub.Scrubber(volumes=lambda: {VID: ev}, on_finding=lambda *a: None,
                           cursor_path=str(tmp_path / "c.json"), rate_mb=4.0,
                           chunk_bytes=16 * 1024)
        t0 = time.monotonic()
        out = s.run_cycle()
        paced = time.monotonic() - t0
        assert out["shards_ok"] == TOTAL_SHARDS_COUNT
        assert paced >= 0.8 * out["scanned_bytes"] / (4 << 20) - 0.01
    finally:
        ev.close()


# -- quarantine on the port's EcVolume -----------------------------------------------


def test_quarantine_routes_reads_to_reconstruction(tmp_path):
    base, golden = _build_ec_volume(str(tmp_path))
    ev = _mounted(base)
    try:
        want = golden[2][1000:1400]
        assert ev._read_shard_interval(2, 1000, 400).tobytes() == want
        _flip_byte(stripe.shard_file_name(base, 2), 1100)
        assert ev.quarantine_shard(2, scrub.CORRUPT)
        assert 2 not in ev.shard_ids and ev.quarantined == {2: "corrupt"}
        assert ev._read_shard_interval(2, 1000, 400).tobytes() == want
    finally:
        ev.close()


def test_mount_local_shard_restores_serving_and_clears_quarantine(tmp_path):
    base, golden = _build_ec_volume(str(tmp_path))
    ev = _mounted(base)
    try:
        ev.quarantine_shard(4, scrub.TRUNCATED)
        assert 4 not in ev.shard_ids
        assert ev.mount_local_shard(4)
        assert 4 in ev.shard_ids and not ev.quarantined
        assert ev._read_local(4, 0, 64).tobytes() == golden[4][:64]
    finally:
        ev.close()


def test_ec_shard_corrupt_raised_when_no_clean_copy(tmp_path):
    base, _ = _build_ec_volume(str(tmp_path))
    ev = _mounted(base)
    try:
        for s in (0, 1, 2, 3, 4):
            ev.quarantine_shard(s, scrub.CORRUPT)
        errs0 = stats.DegradedReadErrors.labels("EcShardCorrupt").value
        with pytest.raises(EcShardCorrupt) as ei:
            ev._read_shard_interval(0, 0, 128)
        assert issubclass(EcShardCorrupt, EcDegradedReadError)
        assert ei.value.quarantined == {s: "corrupt" for s in range(5)}
        assert stats.DegradedReadErrors.labels("EcShardCorrupt").value == errs0 + 1
    finally:
        ev.close()


def test_scrub_quarantine_rebuild_cycle(tmp_path):
    """Damage three shards, scrub with a quarantining callback (as a volume
    server's does), keep the ledger, rebuild the quarantined files with the
    stripe engine, remount: every shard verifies and the ledger is empty."""
    base, golden = _build_ec_volume(str(tmp_path))
    ev = _mounted(base)
    cursor = scrub.ScrubCursor(str(tmp_path / "c.json"))
    try:
        _flip_byte(stripe.shard_file_name(base, 5))
        os.truncate(stripe.shard_file_name(base, 9), len(golden[9]) - 1)
        os.unlink(stripe.shard_file_name(base, 12))

        def on_finding(vid, shard, verdict):
            ev.quarantine_shard(shard, verdict)
            cursor.add_quarantine(vid, shard, verdict)

        s = scrub.Scrubber(volumes=lambda: {VID: ev}, on_finding=on_finding, cursor_path="",
                           cursor=cursor, rate_mb=0.0, chunk_bytes=64 * 1024)
        out = s.run_cycle()
        assert sorted(out["findings"]) == [(VID, 5, "corrupt"), (VID, 9, "truncated"),
                                           (VID, 12, "missing")]
        assert ev.quarantined == {5: "corrupt", 9: "truncated", 12: "missing"}
        assert ev._read_shard_interval(5, 100, 3000).tobytes() == golden[5][100:3100]
        for q in list(cursor.quarantine):
            p = stripe.shard_file_name(base, q["shard"])
            if os.path.exists(p):
                os.unlink(p)
        assert stripe.rebuild_ec_files(base, encoder=ENC) == [5, 9, 12]
        for q in list(cursor.quarantine):
            assert ev.mount_local_shard(q["shard"])
            cursor.remove_quarantine(q["vid"], q["shard"])
        verdicts, has_crcs = scrub.verify_ec_volume(ev)
        assert has_crcs and verdicts == {sh: scrub.OK for sh in range(14)}
        assert scrub.ScrubCursor(str(tmp_path / "c.json")).quarantine == []
        for sh in (5, 9, 12):
            with open(stripe.shard_file_name(base, sh), "rb") as f:
                assert f.read() == golden[sh]
    finally:
        ev.close()


# -- settings -------------------------------------------------------------------------

SETTINGS = [
    {},
    {"rate_mb": 0},
    {"rate_mb": 7, "chunk_bytes": 131072, "interval": 2.5},
    {"chunk_bytes": 1},
    {"chunk_bytes": 65535},
    {"chunk_bytes": 65536},
    {"chunk_bytes": 9 << 20, "cursor_flush_bytes": 1 << 20},
    {"cursor_flush_bytes": 1},
    {"rate_mb": 2.5, "interval": 0},
]


@pytest.mark.parametrize("kw", SETTINGS)
def test_scrubber_settings_equal_reference(tmp_path, kw):
    """The constructor's defaults and clamps are the reference's; the
    environment does not move them (reading the WEEDTPU_SCRUB_* knobs is
    the volume server's job)."""
    with pytest.MonkeyPatch.context() as mp:
        for name, raw in (("WEEDTPU_SCRUB_RATE_MB", "7"), ("WEEDTPU_SCRUB_CHUNK", "131072"),
                          ("WEEDTPU_SCRUB_INTERVAL", "2.5")):
            mp.setenv(name, raw)
        s = scrub.Scrubber(volumes=dict, on_finding=lambda *a: None,
                           cursor_path=str(tmp_path / "c.json"), **kw)
        r = ref_scrub.Scrubber(volumes=dict, on_finding=lambda *a: None,
                               cursor_path=str(tmp_path / "c.json"), **kw)
    got = (s.rate_mb, s.chunk_bytes, s.interval, s._cursor_flush)
    assert got == (r.rate_mb, r.chunk_bytes, r.interval, r._cursor_flush)
    if not kw:
        assert got == (64.0, 4 << 20, 30.0, 256 << 20)
