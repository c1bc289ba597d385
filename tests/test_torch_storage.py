"""The port's storage engine against the JAX package's: the needle codec,
CRC32C, superblock, TTL, replica placement and file ids, `Volume` under one
seeded history of writes, overwrites, deletes and compactions, the .dat
scan behind `fix`, and `SortedFileNeedleMap`. The same seeded inputs go
through both packages, with `time.time_ns` pinned, and every output must be
byte-identical (tolerance 0: none of this is arithmetic that rounds)."""

import contextlib
import itertools
import os
import time

import numpy as np
import pytest

from seaweedfs_tpu.storage import file_id as ref_file_id
from seaweedfs_tpu.storage import idx as ref_idx
from seaweedfs_tpu.storage import needle as ref_needle
from seaweedfs_tpu.storage import needle_map as ref_needle_map
from seaweedfs_tpu.storage import scan as ref_scan
from seaweedfs_tpu.storage import super_block as ref_super_block
from seaweedfs_tpu.storage import volume as ref_volume
from seaweedfs_tpu.utils import config as ref_config
from seaweedfs_tpu.utils import native as ref_native
from seaweedfs_tpu_torch.storage import file_id, idx, needle, needle_map, scan, super_block, types
from seaweedfs_tpu_torch.storage import volume
from seaweedfs_tpu_torch.utils import config, native

PORT = {"needle": needle, "volume": volume, "scan": scan, "super_block": super_block,
        "needle_map": needle_map, "idx": idx}
REF = {"needle": ref_needle, "volume": ref_volume, "scan": ref_scan,
       "super_block": ref_super_block, "needle_map": ref_needle_map, "idx": ref_idx}
PACKAGES = {"port": PORT, "ref": REF}
T0 = 1_700_000_000_000_000_000


@pytest.fixture
def clock(monkeypatch):
    """`time.time_ns` as a counter both needle modules read; `reset()`
    starts it again, so the two packages see one sequence of stamps."""
    state = {}

    def reset():
        state["it"] = itertools.count(T0, 1_000)

    reset()
    monkeypatch.setattr(ref_needle.time, "time_ns", lambda: next(state["it"]))
    monkeypatch.setattr(needle.time, "time_ns", lambda: next(state["it"]))
    return reset


# -- the needle codec -------------------------------------------------------------


def _needle_kwargs(seed: int) -> dict:
    """A seeded needle with every optional field on or off."""
    rng = np.random.default_rng(seed)
    flags = rng.integers(0, 2, 7)
    return dict(
        cookie=int(rng.integers(0, 1 << 32)),
        id=int(rng.integers(1, 1 << 63)),
        data=rng.bytes(int(rng.choice([0, 1, 7, 100, 1024, 4097]))),
        name=rng.bytes(int(rng.integers(1, 40))) if flags[0] else b"",
        mime=b"text/plain" if flags[1] else b"",
        pairs=b'{"k":"' + rng.bytes(5).hex().encode() + b'"}' if flags[2] else b"",
        last_modified=int(rng.integers(1, 1 << 40)) if flags[3] else 0,
        ttl=bytes([int(rng.integers(1, 256)), int(rng.integers(1, 7))]) if flags[4] else b"",
        is_compressed=bool(flags[5]),
        is_chunk_manifest=bool(flags[6]),
        append_at_ns=int(rng.integers(1, 1 << 62)),
    )


@pytest.mark.parametrize("version", [2, 3])
@pytest.mark.parametrize("seed", range(12))
def test_needle_bytes_equal_reference(version, seed):
    kw = _needle_kwargs(seed)
    got = needle.Needle(**kw)
    want = ref_needle.Needle(**kw)
    buf = got.to_bytes(version)
    assert buf == want.to_bytes(version)
    assert len(buf) % types.NEEDLE_PADDING_SIZE == 0
    assert got.flags == want.flags and got.size == want.size
    assert got.actual_size(version) == want.actual_size(version) == len(buf)
    back = needle.Needle.from_bytes(buf, version)
    ref_back = ref_needle.Needle.from_bytes(buf, version)
    assert vars(back) == vars(ref_back)
    for f in ("cookie", "id", "data", "name", "mime", "pairs", "last_modified",
              "is_compressed", "is_chunk_manifest"):
        assert getattr(back, f) == kw[f], f
    assert back.ttl == (kw["ttl"] or b"")
    assert back.append_at_ns == (kw["append_at_ns"] if version == 3 else 0)


@pytest.mark.parametrize("version", [2, 3])
def test_empty_and_tombstone_needles_equal_reference(version, clock):
    for tomb in (False, True):
        clock()
        a = needle.Needle(cookie=0 if tomb else 9, id=3).to_bytes(version, tombstone=tomb)
        clock()
        b = ref_needle.Needle(cookie=0 if tomb else 9, id=3).to_bytes(version, tombstone=tomb)
        assert a == b
        assert needle.Needle.from_bytes(a, version).size == (0 if tomb else 5)


@pytest.mark.parametrize("seed", range(6))
def test_flipped_byte_raises_crc_error_in_both(seed):
    kw = _needle_kwargs(seed)
    kw["data"] = kw["data"] or b"payload"
    buf = bytearray(needle.Needle(**kw).to_bytes())
    buf[types.NEEDLE_HEADER_SIZE + 4 + len(kw["data"]) // 2] ^= 0x5A
    with pytest.raises(needle.CrcError):
        needle.Needle.from_bytes(bytes(buf))
    with pytest.raises(ref_needle.CrcError):
        ref_needle.Needle.from_bytes(bytes(buf))
    assert needle.Needle.from_bytes(bytes(buf), verify=False).data != kw["data"]


def test_needle_codec_rejects_what_the_reference_rejects():
    for kw, version in ((dict(name=b"x" * 256), 3), (dict(data=b"x"), 4)):
        with pytest.raises(ValueError):
            needle.Needle(**kw).to_bytes(version)
        with pytest.raises(ValueError):
            ref_needle.Needle(**kw).to_bytes(version)
    good = needle.Needle(cookie=1, id=2, data=b"abc", name=b"n").to_bytes()
    for bad in (good[:10], good[:20], good[:16] + b"\xff" * 4 + good[20:]):
        with pytest.raises(ValueError):
            needle.Needle.from_bytes(bad)
        with pytest.raises(ValueError):
            ref_needle.Needle.from_bytes(bad)


# -- CRC32C ---------------------------------------------------------------------


def test_crc32c_is_the_compiled_library_here():
    assert native.crc32c_impl() == "library"
    assert os.path.basename(native.lib_path()).startswith("libcrc32c-")


@pytest.mark.parametrize("impl", ["library", "table"])
def test_crc32c_equals_reference(impl):
    fn = native.crc32c if impl == "library" else native.crc32c_table
    assert fn(b"123456789") == 0xE3069283
    assert fn(b"") == 0
    rng = np.random.default_rng(17)
    lengths = list(range(0, 80)) + [255, 256, 1023, 1024, 1025, 4095, 4096, 4097]
    for n in lengths:
        buf = rng.bytes(n)
        want = ref_native.crc32c(buf)
        assert fn(buf) == want, n
        assert fn(buf[n // 2:], fn(buf[: n // 2])) == want, n


# -- superblock, TTL, replica placement, file ids ---------------------------------


@pytest.mark.parametrize("rp", ["000", "001", "010", "100", "012", "220"])
@pytest.mark.parametrize("ttl", ["", "5m", "3d", "45", "2w", "1M", "255y"])
def test_super_block_bytes_equal_reference(rp, ttl):
    got = super_block.SuperBlock(version=3, replica_placement=super_block.ReplicaPlacement.parse(rp),
                                 ttl=super_block.TTL.parse(ttl), compact_revision=7)
    want = ref_super_block.SuperBlock(
        version=3, replica_placement=ref_super_block.ReplicaPlacement.parse(rp),
        ttl=ref_super_block.TTL.parse(ttl), compact_revision=7)
    buf = got.to_bytes()
    assert buf == want.to_bytes() and len(buf) == super_block.SUPER_BLOCK_SIZE
    back = super_block.SuperBlock.from_bytes(buf)
    assert (str(back.replica_placement), str(back.ttl), back.compact_revision) == (
        str(ref_super_block.SuperBlock.from_bytes(buf).replica_placement),
        str(ref_super_block.SuperBlock.from_bytes(buf).ttl), 7)
    assert back.ttl.seconds == want.ttl.seconds and back.ttl.minutes == want.ttl.minutes
    assert back.replica_placement.copy_count == want.replica_placement.copy_count


@pytest.mark.parametrize("raw", ["300m", "-3m", "256h", "5q", "1000d", "x1"])
def test_ttl_rejects_what_the_reference_rejects(raw):
    with pytest.raises(ValueError):
        ref_super_block.TTL.parse(raw)
    with pytest.raises(ValueError):
        super_block.TTL.parse(raw)


def test_ttl_and_placement_edges_equal_reference():
    for raw in (b"", b"\x00\x05", b"\x07\x09", b"\x01\x03"):
        assert str(super_block.TTL.from_bytes(raw)) == str(ref_super_block.TTL.from_bytes(raw))
    for b in (0, 1, 10, 100, 255):
        assert (str(super_block.ReplicaPlacement.from_byte(b))
                == str(ref_super_block.ReplicaPlacement.from_byte(b)))
    for bad in ("12", "abc", "0000"):
        with pytest.raises(ValueError):
            super_block.ReplicaPlacement.parse(bad)
    with pytest.raises(ValueError):
        super_block.TTL(300, "m").to_bytes()
    with pytest.raises(ValueError):
        super_block.SuperBlock.from_bytes(b"\x03")


@pytest.mark.parametrize("fid", ["3,163737d6f2a4", "7,01637037d6", "12,ffffffffffffffff00000001",
                                 "3,163737d6f2a4_1", " 9,a00000000 "])
def test_file_id_parse_and_str_equal_reference(fid):
    got, want = file_id.FileId.parse(fid), ref_file_id.FileId.parse(fid)
    assert (got.volume_id, got.key, got.cookie) == (want.volume_id, want.key, want.cookie)
    assert str(got) == str(want)
    assert file_id.FileId.parse(str(got)) == got


@pytest.mark.parametrize("bad", ["nocomma", "3,1234", "3,"])
def test_file_id_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError):
        ref_file_id.FileId.parse(bad)
    with pytest.raises(ValueError):
        file_id.FileId.parse(bad)


@pytest.mark.parametrize("raw", [None, "", "0", "3", "-1", "2.5", "x"])
def test_verbosity_knob_equals_reference(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("WEEDTPU_V", raising=False)
    else:
        monkeypatch.setenv("WEEDTPU_V", raw)

    def value(mod):
        try:
            return mod.env("WEEDTPU_V")
        except ValueError:
            return "ValueError"

    assert value(config) == value(ref_config)


def test_glog_levels_and_context(caplog):
    import logging

    from seaweedfs_tpu_torch.utils import glog

    logger = logging.getLogger("seaweedfs_tpu_torch")
    logger.addHandler(caplog.handler)
    glog.set_verbosity(2)
    try:
        assert glog.V(2).enabled and not glog.V(3).enabled
        assert glog.kv(vid=3, shard=5) == "vid=3 shard=5"
        glog.warning("skipping %d", 7)
        glog.V(3).infof("hidden")
        glog.V(1).info("shown %s", "x")
        glog.error(ValueError("as is"))
    finally:
        glog.set_verbosity(config.env("WEEDTPU_V"))
        logger.removeHandler(caplog.handler)
    got = [(r.name, r.levelname, r.getMessage()) for r in caplog.records]
    assert got == [("seaweedfs_tpu_torch", "WARNING", "skipping 7"),
                   ("seaweedfs_tpu_torch", "INFO", "shown x"),
                   ("seaweedfs_tpu_torch", "ERROR", "as is")]


# -- the index file -----------------------------------------------------------------


def test_index_file_walk_and_write_equal_reference(tmp_path):
    rng = np.random.default_rng(3)
    entries = [(int(k), int(o), int(s)) for k, o, s in zip(
        rng.integers(1, 1 << 63, 50), rng.integers(0, 1 << 32, 50), rng.integers(-1, 1 << 20, 50))]
    idx.write_entries(entries, str(tmp_path / "a.idx"))
    with open(tmp_path / "b.idx", "wb") as f:
        idx.write_entries(entries, f)
        assert not f.closed
    ref_idx.write_entries(entries, str(tmp_path / "r.idx"))
    blobs = {p: (tmp_path / p).read_bytes() for p in ("a.idx", "b.idx", "r.idx")}
    assert blobs["a.idx"] == blobs["b.idx"] == blobs["r.idx"]
    got, want = [], []
    idx.walk_index_file(str(tmp_path / "a.idx"), lambda *e: got.append(e))
    with open(tmp_path / "a.idx", "rb") as f:
        ref_idx.walk_index_file(f, lambda *e: want.append(e))
    assert got == want == entries


# -- Volume ---------------------------------------------------------------------


def _history(pkg: dict, d: str, kind: str, ttl: str = "") -> dict:
    """One seeded history on a volume of `pkg`: writes (some with names,
    mimes, pairs), overwrites, deletes (some of absent ids), a compaction,
    more writes, a second compaction. Returns what each step showed."""
    N, V = pkg["needle"], pkg["volume"]
    sb = pkg["super_block"].SuperBlock(ttl=pkg["super_block"].TTL.parse(ttl))
    rng = np.random.default_rng(11)
    out: dict = {}
    v = V.Volume(d, 17, "col", super_block=sb, needle_map_kind=kind)
    try:
        for step in range(240):
            op = rng.random()
            nid = int(rng.integers(1, 90))
            if op < 0.75:
                v.write_needle(N.Needle(
                    cookie=int(rng.integers(0, 1 << 32)), id=nid,
                    data=rng.bytes(int(rng.integers(0, 700))),
                    name=b"f%d.txt" % step if step % 5 == 0 else b"",
                    mime=b"image/png" if step % 7 == 0 else b"",
                    pairs=b'{"a":"b"}' if step % 11 == 0 else b""))
            else:
                out[f"delete{step}"] = v.delete_needle(nid)
            if step in (60, 150):
                out[f"mid{step}"] = (v.content_size(), v.needle_count(), v.garbage_ratio())
        with open(v.dat_path, "rb") as f:
            out["dat0"] = f.read()
        with open(v.idx_path, "rb") as f:
            out["idx0"] = f.read()
        size = v.content_size()
        out["backups"] = [v.incremental_backup_since(o) for o in (0, 8, size // 2 // 8 * 8, size)]
        out["page"] = [v.needle_entries_page(s, lim) for s, lim in ((0, 10), (40, 25), (0, 999))]
        out["tombs"] = [v.tombstone_history(), v.tombstone_history(30, 5)]
        out["garbage"] = v.garbage_ratio()
        out["stats"] = v.stats_snapshot()[1:]
        out["ts"] = v.needle_append_ts(list(range(1, 95)))
        out["integrity"] = v.check_integrity()
        out["compact1"] = v.compact()
        for i in range(90, 110):
            v.write_needle(N.Needle(cookie=i, id=i, data=rng.bytes(int(rng.integers(1, 300)))))
        v.delete_needle(95)
        out["compact2"] = v.compact()
        with open(v.dat_path, "rb") as f:
            out["dat2"] = f.read()
        with open(v.idx_path, "rb") as f:
            out["idx2"] = f.read()
        out["after"] = (v.super_block.compact_revision, v.needle_count(), v.garbage_ratio(),
                        v.needle_entries_page(0, 999))
        reads = {}
        for key, _size in v.needle_entries_page(0, 999)[0]:
            n = v.read_needle(key)
            reads[key] = (n.cookie, n.data, n.name, n.mime, n.pairs, n.append_at_ns)
        out["reads"] = reads
    finally:
        v.close()
    if kind == "sorted_file":
        for ext in (".sdx", ".sdx.meta"):
            with open(os.path.join(d, "col_17" + ext), "rb") as f:
                out[ext] = f.read()
    return out


@pytest.mark.parametrize("kind", ["memory", "sorted_file"])
def test_volume_history_equals_reference(tmp_path, clock, kind):
    os.makedirs(tmp_path / "p")
    os.makedirs(tmp_path / "r")
    got = _history(PORT, str(tmp_path / "p"), kind)
    clock()
    want = _history(REF, str(tmp_path / "r"), kind)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k] == want[k], k
    assert got["compact1"][1] < got["compact1"][0]


@pytest.mark.parametrize("kind", ["memory", "sorted_file"])
def test_volume_remount_equals_reference(tmp_path, clock, kind):
    """Reopen both volumes from their files: the same maps, the same reads;
    a lost .idx heals by scan on mount in both."""
    views = {}
    for name, pkg in PACKAGES.items():
        clock()
        d = str(tmp_path / name)
        os.makedirs(d)
        _history(pkg, d, kind)
        os.remove(os.path.join(d, "col_17.idx"))
        for ext in (".sdx", ".sdx.meta"):
            if os.path.exists(os.path.join(d, "col_17" + ext)):
                os.remove(os.path.join(d, "col_17" + ext))
        with pkg["volume"].Volume(d, 17, "col", needle_map_kind=kind) as v:
            with open(v.idx_path, "rb") as f:
                healed = f.read()
            views[name] = (healed, v.needle_entries_page(0, 999), v.garbage_ratio(),
                           [v.read_needle(k).data for k, _ in v.needle_entries_page(0, 999)[0]])
    assert views["port"] == views["ref"]


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_read_only_and_cookie_checks(tmp_path, pkg):
    P = PACKAGES[pkg]
    with P["volume"].Volume(str(tmp_path), 1) as v:
        v.write_needle(P["needle"].Needle(cookie=5, id=1, data=b"z"))
        with pytest.raises(PermissionError):
            v.read_needle(1, cookie=6)
        assert v.read_needle(1, cookie=5).data == b"z"
        with pytest.raises(KeyError):
            v.read_needle(2)
        v.read_only = True
        with pytest.raises(P["volume"].VolumeReadOnly):
            v.write_needle(P["needle"].Needle(cookie=1, id=2, data=b"z"))
        with pytest.raises(P["volume"].VolumeReadOnly):
            v.delete_needle(1)
        assert v.read_needle(1).data == b"z"


def test_needle_ttl_expiry_equals_reference(tmp_path):
    """On a 1-minute TTL volume a needle stamped two minutes ago reads as
    expired (a KeyError) and compaction drops it; a fresh one stays."""
    now = time.time_ns()
    out = {}
    for name, pkg in PACKAGES.items():
        d = str(tmp_path / name)
        os.makedirs(d)
        N, V = pkg["needle"], pkg["volume"]
        sb = pkg["super_block"].SuperBlock(ttl=pkg["super_block"].TTL.parse("1m"))
        with V.Volume(d, 4, super_block=sb) as v:
            v.write_needle(N.Needle(cookie=1, id=1, data=b"fresh", append_at_ns=now))
            v.write_needle(N.Needle(cookie=1, id=2, data=b"stale", append_at_ns=now - 120 * 10**9))
            with pytest.raises(V.NeedleExpired, match="expired"):
                v.read_needle(2)
            assert v.read_needle(1).data == b"fresh"
            assert v.check_integrity() == 1
            assert not v.is_expired()
            compacted = v.compact()
            with pytest.raises(KeyError):
                v.read_needle(2)
            with open(v.dat_path, "rb") as f:
                out[name] = (compacted, f.read(), v.needle_count(), v.garbage_ratio())
            past = time.time() - 120
            os.utime(v.dat_path, (past, past))
            assert v.is_expired()
    assert out["port"] == out["ref"]


def test_compact_refuses_an_empty_index_over_data(tmp_path):
    """A map that lost its index over a populated .dat must not compact
    (it would wipe every needle); a fully deleted volume does."""
    with volume.Volume(str(tmp_path), 7) as v:
        v.write_needle(needle.Needle(cookie=1, id=1, data=b"x" * 100))
        v.nm = needle_map.CompactMap()
        os.truncate(v.idx_path, 0)
        with pytest.raises(IOError, match="refusing to compact"):
            v.compact()
    assert os.path.getsize(tmp_path / "7.dat") > 8
    with volume.Volume(str(tmp_path), 11) as v:
        for i in (1, 2, 3):
            v.write_needle(needle.Needle(cookie=i, id=i, data=b"z" * 500))
            v.delete_needle(i)
        before, after = v.compact()
        assert after < before and after == super_block.SUPER_BLOCK_SIZE


def test_tiered_volume_raises_a_clear_error(tmp_path, clock):
    """A volume whose .dat moved to remote storage (a `.tierinfo` beside its
    .idx, no .dat) opens through the port's `RemoteDatFile`, read-only, and
    serves the reference's bytes; writes and compaction raise, as the
    reference's do."""
    from seaweedfs_tpu.remote_storage import LocalRemoteStorage as RefLocal
    from seaweedfs_tpu.remote_storage.tier import tier_move as ref_tier_move
    from seaweedfs_tpu_torch.storage.backend import RemoteDatFile

    ids = range(1, 30)
    with ref_volume.Volume(str(tmp_path), 5) as v:
        for i in ids:
            v.write_needle(ref_needle.Needle(**{**_needle_kwargs(i), "id": i, "ttl": b""}))
        v.delete_needle(3)
    ref_tier_move(os.path.join(str(tmp_path), "5"), RefLocal(str(tmp_path / "cold")))
    assert not (tmp_path / "5.dat").exists() and (tmp_path / "5.tierinfo").exists()
    with volume.Volume(str(tmp_path), 5) as v, ref_volume.Volume(str(tmp_path), 5) as rv:
        assert isinstance(v._dat, RemoteDatFile) and v.tiered and v.read_only
        assert v.content_size() == rv.content_size()
        assert v.stats_snapshot() == rv.stats_snapshot()
        for i in ids:
            if i == 3:
                with pytest.raises(KeyError):
                    v.read_needle(i)
                continue
            assert v.read_needle(i).to_bytes(v.version) == rv.read_needle(i).to_bytes(rv.version)
        assert v.check_integrity() == rv.check_integrity() == len(ids) - 1
        with pytest.raises(volume.VolumeReadOnly):
            v.write_needle(needle.Needle(cookie=1, id=99, data=b"x"))
        with pytest.raises(IOError, match="tiered to remote storage"):
            v.compact()
        assert not v.is_expired()


# -- scan / fix -------------------------------------------------------------------


def _scan_volume(d: str) -> str:
    with volume.Volume(d, 7) as v:
        for i in range(1, 40):
            v.write_needle(needle.Needle(cookie=i, id=i, data=bytes([i]) * (37 * i % 500)))
            if i % 6 == 0:
                v.delete_needle(i - 2)
    return os.path.join(d, "7")


def _damage(base: str, how: str) -> None:
    records = list(scan.scan_volume_file(base + ".dat"))
    off = records[len(records) // 2][0]
    with open(base + ".dat", "r+b") as f:
        if how == "size":  # a size field that overruns the file
            f.seek(off + 12)
            f.write((0x7FFF0000).to_bytes(4, "big"))
        elif how == "negative":
            f.seek(off + 12)
            f.write((-5).to_bytes(4, "big", signed=True))
        elif how == "crc":  # a flipped data byte mid-file
            f.seek(off + types.NEEDLE_HEADER_SIZE + 6)
            b = f.read(1)
            f.seek(off + types.NEEDLE_HEADER_SIZE + 6)
            f.write(bytes([b[0] ^ 0xFF]))
        elif how == "truncate":
            f.seek(0, os.SEEK_END)
            f.truncate(f.tell() - 37)
        elif how == "tail_garbage":
            f.seek(0, os.SEEK_END)
            f.write(b"\x01" * 24)


@pytest.mark.parametrize("how", ["clean", "size", "negative", "crc", "truncate", "tail_garbage"])
@pytest.mark.parametrize("verify", [True, False])
def test_scan_and_rebuild_idx_equal_reference(tmp_path, how, verify):
    base = _scan_volume(str(tmp_path))
    if how != "clean":
        _damage(base, how)
    outcome = {}
    for name, pkg in PACKAGES.items():
        with contextlib.suppress(FileNotFoundError):
            os.remove(base + ".idx")
        try:
            records = [(o, n.id, n.size, n.data) for o, n in
                       pkg["scan"].scan_volume_file(base + ".dat", verify_crc=verify)]
            count = pkg["scan"].rebuild_idx(base, verify_crc=verify)
            with open(base + ".idx", "rb") as f:
                outcome[name] = (records, count, f.read())
        except pkg["scan"].CorruptVolume:
            outcome[name] = ("CorruptVolume",)
            assert not os.path.exists(base + ".idx.tmp")
    assert outcome["port"] == outcome["ref"]
    if how in ("size", "negative") or (how == "crc" and verify):
        assert outcome["port"][0] == "CorruptVolume"
    else:
        assert outcome["port"][1] > 0


# -- SortedFileNeedleMap ------------------------------------------------------------


def _fill(pkg, v, n, start=1):
    for i in range(start, start + n):
        v.write_needle(pkg["needle"].Needle(cookie=7, id=i, data=f"needle-{i}".encode()))


def _files(d: str, name: str) -> dict:
    out = {}
    for ext in (".dat", ".idx", ".sdx", ".sdx.meta"):
        p = os.path.join(d, name + ext)
        if os.path.exists(p):
            with open(p, "rb") as f:
                out[ext] = f.read()
    return out


def _case_roundtrip(pkg, d):
    V = pkg["volume"]
    v = V.Volume(d, 42, needle_map_kind="sorted_file")
    _fill(pkg, v, 50)
    v.delete_needle(7)
    assert v.read_needle(3).data == b"needle-3"
    v.close()
    seen = [_files(d, "42")]
    v2 = V.Volume(d, 42, needle_map_kind="sorted_file")
    assert not v2.nm.rebuilt_full and v2.nm.replayed_tail == 0
    with pytest.raises(KeyError):
        v2.read_needle(7)
    assert len(v2.nm) == 49
    _fill(pkg, v2, 5, start=100)
    v2.close()
    v3 = V.Volume(d, 42, needle_map_kind="sorted_file")
    assert v3.read_needle(104).data == b"needle-104"
    before, after = v3.compact()
    assert after <= before and v3.read_needle(104).data == b"needle-104"
    v3.close()
    return seen + [_files(d, "42")]


def _case_crash_tail(pkg, d):
    V = pkg["volume"]
    v = V.Volume(d, 9, needle_map_kind="sorted_file")
    _fill(pkg, v, 10)
    v.nm.flush()
    _fill(pkg, v, 5, start=50)
    v.delete_needle(2)
    v._idx.flush()
    v._dat.flush()
    v2 = V.Volume(d, 9, needle_map_kind="sorted_file")  # no close(): a crash
    assert not v2.nm.rebuilt_full and v2.nm.replayed_tail == 6
    assert v2.read_needle(52).data == b"needle-52"
    with pytest.raises(KeyError):
        v2.read_needle(2)
    v2.close()
    return [_files(d, "9")]


def _case_mid_replay_flush(pkg, d, monkeypatch):
    M = pkg["needle_map"].SortedFileNeedleMap
    base = os.path.join(d, "mid")
    m = M(base)
    m.set(1, 10, 100)
    m.close()
    with open(base + ".idx", "ab") as f:
        pkg["idx"].write_entries([(k, k * 10, 100) for k in range(2, 11)] + [(1, 10, -1)], f)
    monkeypatch.setattr(M, "OVERLAY_FLUSH_ENTRIES", 1)
    m2 = M(base)
    assert m2.replayed_tail == 10
    seen = [_files(d, "mid")]
    m3 = M(base)  # m2 never closed: a crash after its mid-replay flushes
    assert m3.get(5) == (50, 100)
    assert m3.get(1) is None, "a mid-replay flush resurrected a deleted key"
    m3.close()
    return seen + [_files(d, "mid"), list(m3.ascending_visit())]


def _case_mount_reads_only_tail(pkg, d, n=300_000):
    M = pkg["needle_map"].SortedFileNeedleMap
    base = os.path.join(d, "big")
    entries = np.zeros(n, dtype=idx._BE_ENTRY_DTYPE)
    entries["key"] = np.arange(1, n + 1, dtype=np.uint64)
    entries["offset"] = np.arange(1, n + 1, dtype=np.uint32)
    entries["size"] = 100
    with open(base + ".idx", "wb") as f:
        f.write(entries.tobytes())
    m1 = M(base)
    assert m1.rebuilt_full and len(m1) == n
    m1.close()
    t0 = time.perf_counter()
    m2 = M(base)
    mount_secs = time.perf_counter() - t0
    assert not m2.rebuilt_full and m2.replayed_tail == 0
    assert mount_secs < 1.0, f"clean mount took {mount_secs:.2f}s — not O(tail)"
    assert m2.get(123_456) == (123_456, 100) and m2.get(n + 1) is None and len(m2) == n
    page = list(itertools.islice(m2.ascending_visit(n - 5), 10))
    m2.close()
    return [_files(d, "big"), page]


SORTED_CASES = {"roundtrip": _case_roundtrip, "crash_tail": _case_crash_tail,
                "mid_replay_flush": _case_mid_replay_flush,
                "mount_reads_only_tail": _case_mount_reads_only_tail}


@pytest.mark.parametrize("case", sorted(SORTED_CASES))
def test_sorted_file_map_case_equals_reference(tmp_path, clock, monkeypatch, case):
    """The reference's four `test_sorted_file_map_*` flows, run on both
    packages: the same assertions hold and the .dat, .idx, .sdx and
    .sdx.meta bytes agree at every checkpoint."""
    fn = SORTED_CASES[case]
    seen = {}
    for name, pkg in PACKAGES.items():
        clock()
        d = str(tmp_path / name)
        os.makedirs(d)
        with monkeypatch.context() as mp:
            seen[name] = fn(pkg, d, mp) if case == "mid_replay_flush" else fn(pkg, d)
    assert seen["port"] == seen["ref"]


def test_sorted_file_map_visit_pages_and_overlay_merge(tmp_path):
    """`ascending_visit(start)` merges the sidecar with the overlay (new,
    overwritten and deleted keys) across its row chunks exactly as the
    reference does, from any start."""
    maps = {}
    for name, pkg in PACKAGES.items():
        base = str(tmp_path / name)
        m = pkg["needle_map"].SortedFileNeedleMap(base)
        for k in range(1, 20000, 2):
            m.set(k, k, 10)
        m.flush()
        for k in range(1, 20000, 7):
            if k % 3:
                m.set(k + 1, k, 20)
            else:
                m.delete(k)
        maps[name] = m
    port_m, ref_m = maps["port"], maps["ref"]
    port_m.VISIT_CHUNK = 333
    for start in (0, 1, 2, 4095, 9999, 19998, 30000):
        assert list(port_m.ascending_visit(start)) == list(ref_m.ascending_visit(start)), start
    assert len(port_m) == len(ref_m)
    assert needle_map.new_needle_map("memory", "x").__class__ is needle_map.CompactMap
    with pytest.raises(ValueError):
        needle_map.new_needle_map("leveldb", "x")
