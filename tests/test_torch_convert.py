"""Geometry conversion in the port against the JAX package's:
`conversion_matrix` equal to the reference's for the registered families
and ad-hoc geometries (and refusing k-changing pairs as it does); staged
sets byte-identical to the decode -> re-encode oracle and to the
reference's conversion, with the same `.ecc` journal bytes, across layouts
and from a degraded source; a kill mid-conversion resumed from the last
watermark, a torn tail, source drift; cut-over and the recovery of a crash
mid-swap, served through the port's `EcVolume`; and `.ecc` journals of a
conversion stopped midway resumed across the two packages, both ways.
All byte comparisons exact (tolerance 0)."""

from __future__ import annotations

import os
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest

from seaweedfs_tpu.ec import convert as ref_convert
from seaweedfs_tpu.ec import stripe as ref_stripe
from seaweedfs_tpu.ops import rs_codec as ref_codec
from seaweedfs_tpu.utils import config as ref_config
from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.ec import convert, locate, stripe
from seaweedfs_tpu_torch.ec.ec_volume import EcGeometryError, EcVolume
from seaweedfs_tpu_torch.ops import gf8, rs_codec
from seaweedfs_tpu_torch.utils import config

L, S = 4096, 512
FAMILIES = ("cauchy_12_3", "merge_20_4")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _enc(k=10, m=4, kind="vandermonde"):
    return rs_codec.Encoder(k, m, matrix_kind=kind, device="cpu")


def _ref(k=10, m=4, kind="vandermonde"):
    return ref_codec.Encoder(k, m, matrix_kind=kind, backend="numpy")


def _build_source(d, dat_bytes, seed=11, name="1"):
    os.makedirs(str(d), exist_ok=True)
    base = os.path.join(str(d), name)
    data = np.random.default_rng(seed).integers(0, 256, dat_bytes, dtype=np.uint8).tobytes()
    with open(base + ".dat", "wb") as f:
        f.write(data)
    stripe.write_ec_files(base, L, S, buffer_size=S, encoder=_enc())
    return base, data


def _copy_source(base, d) -> str:
    """A copy of `base`'s shard set and sidecars under directory `d`."""
    os.makedirs(str(d))
    out = os.path.join(str(d), os.path.basename(base))
    for name in os.listdir(os.path.dirname(base)):
        if name.startswith(os.path.basename(base) + "."):
            shutil.copy(os.path.join(os.path.dirname(base), name), str(d))
    return out


def _oracle(tmp_path, data: bytes, family, name="oracle"):
    """A warm encode of the .dat bytes at `family`: what decode -> re-encode
    makes."""
    ob = os.path.join(str(tmp_path), name, "1")
    os.makedirs(os.path.dirname(ob), exist_ok=True)
    with open(ob + ".dat", "wb") as f:
        f.write(data)
    geom = rs_codec.geometry_for(family)
    stripe.write_ec_files(ob, L, S, buffer_size=S,
                          encoder=_enc(geom.data_shards, geom.parity_shards, geom.matrix_kind))
    return ob


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _assert_staged_matches(base, ob, family):
    staged = convert.stage_base(base)
    for s in range(rs_codec.geometry_for(family).total_shards):
        assert _read(stripe.shard_file_name(staged, s)) == _read(stripe.shard_file_name(ob, s)), (
            f"{family} shard {s}: staged differs from oracle")
    with open(staged + ".eci", "rb") as f, open(ob + ".eci", "rb") as g:
        assert f.read() == g.read()


# -- the planner ---------------------------------------------------------------------

PAIRS = [(a, b) for a in rs_codec.CODE_FAMILIES for b in rs_codec.CODE_FAMILIES]


@pytest.mark.parametrize("src_family, tgt_family", PAIRS)
def test_conversion_matrix_equals_reference_for_registered_families(src_family, tgt_family):
    src, tgt = (rs_codec.new_encoder(family=f, device="cpu") for f in (src_family, tgt_family))
    rsrc, rtgt = (ref_codec.new_encoder(family=f, backend="numpy") for f in (src_family, tgt_family))
    if src.data_shards != tgt.data_shards:
        msgs = []
        for mod, a, b in ((convert, src, tgt), (ref_convert, rsrc, rtgt)):
            with pytest.raises(mod.ConversionError, match="k-changing") as ei:
                mod.conversion_matrix(a, b)
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]
        return
    k = src.data_shards
    for survivors in (None, list(range(1, k + 1)), list(range(src.total_shards))[-k:]):
        got = convert.conversion_matrix(src, tgt, survivors)
        want = ref_convert.conversion_matrix(rsrc, rtgt, survivors)
        assert got.dtype == np.uint8 and not got.flags.writeable
        assert np.array_equal(got, want)


def test_conversion_matrix_maps_survivors_to_target_shards():
    src, tgt = _enc(10, 4, "vandermonde"), _enc(10, 4, "cauchy")
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, (10, 257), dtype=np.uint8)
    src_shards, tgt_shards = np.stack(src.encode(list(data))), np.stack(tgt.encode(list(data)))
    m = convert.conversion_matrix(src, tgt)
    assert np.array_equal(m[:10], np.eye(10, dtype=np.uint8))
    assert np.array_equal(m, ref_convert.conversion_matrix(_ref(), _ref(10, 4, "cauchy")))
    assert np.array_equal(gf8.gf_mat_vec(m, src_shards[:10]), tgt_shards)
    survivors = [0, 1, 2, 3, 4, 5, 6, 7, 10, 13]
    m2 = convert.conversion_matrix(src, tgt, survivors)
    assert np.array_equal(gf8.gf_mat_vec(m2, src_shards[survivors]), tgt_shards)
    assert np.array_equal(m2, ref_convert.conversion_matrix(_ref(), _ref(10, 4, "cauchy"),
                                                            survivors))
    for bad in ([0, 1, 2], [0] * 10):
        with pytest.raises(convert.ConversionError, match="distinct survivor"):
            convert.conversion_matrix(src, tgt, bad)


# -- byte identity ---------------------------------------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("dat_bytes", [
    3 * L * 10 + 5 * S * 10 + 137,  # large + small + odd tail
    2 * L * 10,                      # exact large rows
    4 * S * 10,                      # small rows only, exact
    777,                             # a single partial small row
], ids=["mixed-odd", "large-exact", "small-exact", "tiny"])
def test_convert_equals_oracle_and_reference(tmp_path, family, dat_bytes):
    base, data = _build_source(tmp_path / "port", dat_bytes)
    ref_base = _copy_source(base, tmp_path / "ref")
    written0 = stats.EcConvertBytes.labels("written").value
    res = convert.convert_ec_files(base, family, encoder=_enc(), buffer_size=S,
                                   journal_bytes=1 << 16)
    want = ref_convert.convert_ec_files(ref_base, family, encoder=_ref(), buffer_size=S,
                                        journal_bytes=1 << 16)
    assert res["mode"] == want["mode"] == "converted"
    assert res["reconstructed_bytes"] == 0
    for k in ("src_family", "target_family", "bytes_read", "bytes_written", "shard_ids"):
        assert res[k] == want[k], k
    _assert_staged_matches(base, _oracle(tmp_path, data, family), family)
    _assert_staged_matches(base, convert.stage_base(ref_base), family)
    assert _read(convert.journal_path(base)) == _read(ref_convert.journal_path(ref_base))
    geom = rs_codec.geometry_for(family)
    n_l, n_s = stripe.stripe_layout(dat_bytes, L, S, geom.data_shards)
    assert res["bytes_written"] == geom.total_shards * (n_l * L + n_s * S)
    assert stats.EcConvertBytes.labels("written").value == written0 + res["bytes_written"]
    acct = convert.reencode_oracle_bytes(base, family)
    assert acct == ref_convert.reencode_oracle_bytes(base, family)
    assert acct["total"] == 3 * dat_bytes + res["bytes_written"]


@pytest.mark.parametrize("family", FAMILIES)
def test_convert_degraded_source_equals_oracle_and_reference(tmp_path, family):
    """Missing source data shards reconstruct per run from survivors: the
    staged set still equals the oracle and the reference's."""
    base, data = _build_source(tmp_path / "port", 2 * L * 10 + 3 * S * 10 + 99)
    for s in (0, 7):
        os.unlink(stripe.shard_file_name(base, s))
    ref_base = _copy_source(base, tmp_path / "ref")
    res = convert.convert_ec_files(base, family, encoder=_enc(), buffer_size=S)
    want = ref_convert.convert_ec_files(ref_base, family, encoder=_ref(), buffer_size=S)
    assert res["reconstructed_bytes"] == want["reconstructed_bytes"] > 0
    assert res["bytes_read"] == want["bytes_read"]
    _assert_staged_matches(base, _oracle(tmp_path, data, family), family)
    _assert_staged_matches(base, convert.stage_base(ref_base), family)


def test_virtual_dat_counts_one_reconstruct_per_degraded_run(tmp_path):
    """Each run of a lost data shard is one `reconstruct(wanted=[sid])`."""
    base, data = _build_source(tmp_path, 2 * L * 10 + 3 * S * 10 + 99)
    os.unlink(stripe.shard_file_name(base, 7))
    enc = _enc()
    calls = []
    orig = enc.reconstruct

    def counted(shards, data_only=False, wanted=None):
        calls.append(list(wanted))
        return orig(shards, data_only, wanted)

    enc.reconstruct = counted
    info = stripe.read_ec_info(base)
    with convert._VirtualDat(base, info, enc) as vdat:
        out = bytearray(len(data) + 13)
        assert vdat.readinto(memoryview(out)) == len(data)
        assert bytes(out[: len(data)]) == data and vdat.missing_data == [7]
    # shard 7 holds one block per row: 2 large rows and 3 small rows
    assert calls == [[7]] * 5
    assert vdat.reconstructed_bytes == 2 * L + 3 * S


def test_convert_too_few_survivors_noop_unknown_family_and_no_eci(tmp_path):
    base, _ = _build_source(tmp_path, 3 * S * 10)
    assert convert.convert_ec_files(base, "rs_10_4")["mode"] == "noop"
    with pytest.raises(ValueError, match="unknown code family"):
        convert.convert_ec_files(base, "bogus", encoder=_enc())
    for s in (0, 1, 2, 3, 4):
        os.unlink(stripe.shard_file_name(base, s))
    with pytest.raises(convert.ConversionError, match="cannot read source"):
        convert.convert_ec_files(base, "merge_20_4", encoder=_enc())
    os.unlink(base + ".eci")
    with pytest.raises(convert.ConversionError, match="no .eci"):
        convert.convert_ec_files(base, "cauchy_12_3", encoder=_enc())


def test_convert_verify_refuses_bad_staged_bytes(tmp_path, monkeypatch):
    """A staged byte that differs from the streamed CRC (bit rot below the
    watermark) fails the pre-cut-over verify and scrubs the staged state."""
    base, _ = _build_source(tmp_path, 2 * L * 10 + S * 10)
    orig = stripe._encode_rows
    flipped = []

    def corrupt_after(*a, **k):
        orig(*a, **k)
        if flipped:
            return
        flipped.append(1)
        outputs = a[2]
        outputs[3].flush()
        with open(outputs[3].name, "r+b") as f:
            f.seek(0)
            b = f.read(1)
            f.seek(0)
            f.write(bytes([b[0] ^ 1]))

    monkeypatch.setattr(stripe, "_encode_rows", corrupt_after)
    with pytest.raises(convert.ConversionError, match="refusing cut-over"):
        convert.convert_ec_files(base, "cauchy_12_3", encoder=_enc(), buffer_size=S, verify=True)
    assert not os.path.exists(convert.journal_path(base))
    assert stripe.find_local_shards(convert.stage_base(base)) == []


# -- crash / resume ---------------------------------------------------------------------

_CHILD = """
import sys
sys.path.insert(0, {root!r})
from seaweedfs_tpu_torch.ec import convert, stripe
from seaweedfs_tpu_torch.ops.rs_codec import Encoder
orig = stripe._encode_rows
calls = [0]
def hooked(*a, **k):
    calls[0] += 1
    if calls[0] > {after}:
        print("MIDWAY", flush=True)
        import time
        time.sleep(60)
    return orig(*a, **k)
stripe._encode_rows = hooked
convert.convert_ec_files(
    {base!r}, {family!r}, encoder=Encoder(10, 4, device="cpu"),
    buffer_size={S}, journal_bytes=4096,
)
"""


def test_convert_sigkill_resume_byte_identity(tmp_path):
    """The converting process is killed mid-stream: the source is
    untouched, and a re-run resumes from the last watermark and finishes
    byte-identical to the oracle."""
    base, data = _build_source(tmp_path, 6 * L * 10 + 2 * S * 10 + 55)
    src_files = {s: _read(stripe.shard_file_name(base, s)) for s in range(14)}
    child = _CHILD.format(root=ROOT, base=base, family="merge_20_4", S=S, after=2)
    p = subprocess.Popen([sys.executable, "-c", child], stdout=subprocess.PIPE, text=True)
    try:
        assert "MIDWAY" in p.stdout.readline()
    finally:
        p.send_signal(signal.SIGKILL)
        p.wait(30)
    marks = [r for r in convert._Journal.read(convert.journal_path(base))
             if r.get("type") == "watermark"]
    assert marks
    for s, blob in src_files.items():
        assert _read(stripe.shard_file_name(base, s)) == blob
    res = convert.convert_ec_files(base, "merge_20_4", encoder=_enc(), buffer_size=S,
                                   journal_bytes=4096)
    assert res["mode"] == "resumed"
    _assert_staged_matches(base, _oracle(tmp_path, data, "merge_20_4"), "merge_20_4")


class _Stop(Exception):
    pass


def _stop_after(mod, calls: int):
    """Patch `mod.stripe._encode_rows` to raise after `calls` calls: a
    conversion stopped midway, its watermarks on disk."""
    orig = mod.stripe._encode_rows
    n = [0]

    def hooked(*a, **k):
        n[0] += 1
        if n[0] > calls:
            raise _Stop()
        return orig(*a, **k)

    return orig, hooked


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("family", FAMILIES)
def test_ecc_journal_resumes_across_packages(tmp_path, monkeypatch, writer, family):
    """A conversion stopped midway by one package, with a torn tail after
    its last watermark, resumes in the other byte-identical to the oracle."""
    base, data = _build_source(tmp_path, 5 * L * 10 + 3 * S * 10 + 55)
    w_mod, w_enc = (ref_convert, _ref()) if writer == "ref" else (convert, _enc())
    r_mod, r_enc = (convert, _enc()) if writer == "ref" else (ref_convert, _ref())
    orig, hooked = _stop_after(w_mod, 3)
    monkeypatch.setattr(w_mod.stripe, "_encode_rows", hooked)
    with pytest.raises(_Stop):
        w_mod.convert_ec_files(base, family, encoder=w_enc, buffer_size=S, journal_bytes=4096)
    monkeypatch.setattr(w_mod.stripe, "_encode_rows", orig)
    assert any(r.get("type") == "watermark" for r in convert._Journal.read(convert.journal_path(base)))
    with open(convert.journal_path(base), "ab") as f:
        f.write(b'{"type": "watermark", "rows_la')  # torn
    res = r_mod.convert_ec_files(base, family, encoder=r_enc, buffer_size=S, journal_bytes=4096)
    assert res["mode"] == "resumed"
    _assert_staged_matches(base, _oracle(tmp_path, data, family), family)
    assert res["bytes_written"] == os.path.getsize(
        stripe.shard_file_name(convert.stage_base(base), 0)) * rs_codec.geometry_for(
            family).total_shards
    out = convert.cutover(base) if writer == "ref" else ref_convert.cutover(base)
    assert out["mode"] == "cutover" and not convert.pending_cutover(base)


def test_convert_torn_journal_tail_restarts_clean(tmp_path):
    base, data = _build_source(tmp_path, 2 * L * 10 + S * 10)
    with open(convert.journal_path(base), "ab") as f:
        f.write(b'{"type": "begin", "src_fam')
    res = convert.convert_ec_files(base, "cauchy_12_3", encoder=_enc(), buffer_size=S)
    assert res["mode"] == "converted"
    _assert_staged_matches(base, _oracle(tmp_path, data, "cauchy_12_3"), "cauchy_12_3")


def test_convert_rejects_source_drift_on_resume(tmp_path):
    base, data = _build_source(tmp_path, 2 * L * 10 + S * 10)
    assert convert.convert_ec_files(base, "cauchy_12_3", encoder=_enc(), buffer_size=S,
                                    journal_bytes=512)["mode"] == "converted"
    with open(base + ".dat", "r+b") as f:
        f.write(b"\xff" * 64)
    for s in range(14):
        os.unlink(stripe.shard_file_name(base, s))
    stripe.write_ec_files(base, L, S, buffer_size=S, encoder=_enc())
    res2 = convert.convert_ec_files(base, "cauchy_12_3", encoder=_enc(), buffer_size=S)
    assert res2["mode"] == "converted"
    _assert_staged_matches(base, _oracle(tmp_path, b"\xff" * 64 + data[64:], "cauchy_12_3", "o2"),
                           "cauchy_12_3")


# -- cut-over and serving ----------------------------------------------------------------


def _mountable(base):
    open(base + ".idx", "wb").close()
    stripe.write_sorted_file_from_idx(base)


def _read_range(ev, data, off, size):
    ivs = locate.locate_data(ev.large, ev.small, ev.dat_file_size, off, size, ev.data_shards)
    assert ev.read_intervals(ivs) == data[off: off + size]


def test_cutover_serves_through_port_ec_volume(tmp_path):
    base, data = _build_source(tmp_path, 3 * L * 10 + 2 * S * 10 + 201)
    _mountable(base)
    convert.convert_ec_files(base, "cauchy_12_3", encoder=_enc(), buffer_size=S)
    with EcVolume(base, encoder=_enc(), warm_on_mount=False) as ev:
        assert ev.total_shards == 14 and ev.data_shards == 10
        _read_range(ev, data, 0, 300)
    assert convert.cutover(base)["mode"] == "cutover"
    assert sorted(stripe.find_local_shards(base)) == list(range(15))
    assert not os.path.exists(convert.journal_path(base))
    with EcVolume(base, encoder=_enc(), warm_on_mount=False) as ev:
        assert ev.geometry.family == "cauchy_12_3"
        assert (ev.data_shards, ev.total_shards) == (12, 15)
        assert ev.encoder.data_shards == 12
        for off, size in [(0, 1), (L * 10 - 7, 300), (len(data) - 99, 99)]:
            _read_range(ev, data, off, size)
        fsck = ev.verify_local_shards()
        assert fsck is not None and all(fsck.values())
    os.unlink(stripe.shard_file_name(base, 3))
    with EcVolume(base, encoder=_enc(), warm_on_mount=False) as ev:
        _read_range(ev, data, L * 3, 513)  # reconstructs through 12+3
    assert stripe.rebuild_ec_files(base, encoder=stripe.encoder_for_base(base, _enc())) == [3]


def test_cutover_refuses_before_verification_and_without_journal(tmp_path):
    base, _ = _build_source(tmp_path, 2 * L * 10)
    with pytest.raises(convert.ConversionError, match="no conversion journal"):
        convert.cutover(base)
    with pytest.raises(convert.ConversionError, match="no cut-over intent"):
        convert.finish_cutover(base)


@pytest.mark.parametrize("finisher", ["finish_cutover", "reissue_merge_20_4",
                                      "reissue_cauchy_12_3", "reference_finish"])
def test_cutover_crash_midswap_refuses_then_recovers(tmp_path, finisher):
    """A crash between the .eci swap and the shard swaps: the port's
    EcVolume refuses to mount (typed error), and the swap is finished by
    `finish_cutover`, by a re-issued conversion of either family, or by
    the reference's `finish_cutover`."""
    base, data = _build_source(tmp_path, 2 * L * 10 + 3 * S * 10)
    _mountable(base)
    convert.convert_ec_files(base, "merge_20_4", encoder=_enc(), buffer_size=S)
    j = convert._Journal(convert.journal_path(base))
    j.append({"type": "cutover"})
    j.close()
    os.replace(convert.stage_base(base) + ".eci", base + ".eci")  # crash right here
    assert convert.pending_cutover(base)
    with pytest.raises(EcGeometryError):
        EcVolume(base, encoder=_enc(), warm_on_mount=False)
    if finisher == "finish_cutover":
        out = convert.finish_cutover(base)
    elif finisher == "reference_finish":
        out = ref_convert.finish_cutover(base)
    else:
        out = convert.convert_ec_files(base, finisher.split("_", 1)[1], encoder=_enc())
    assert out["mode"] == "cutover" and not convert.pending_cutover(base)
    with EcVolume(base, encoder=_enc(), warm_on_mount=False) as ev:
        assert (ev.data_shards, ev.total_shards) == (20, 24)
        _read_range(ev, data, 0, 257)
        _read_range(ev, data, len(data) - 31, 31)


def test_multi_geometry_mounts_coexist(tmp_path):
    base_a, data_a = _build_source(tmp_path / "a", 2 * L * 10 + 3 * S * 10, seed=1)
    base_b, data_b = _build_source(tmp_path / "b", L * 10 + 5 * S * 10, seed=2)
    for b in (base_a, base_b):
        _mountable(b)
    convert.convert_ec_files(base_b, "merge_20_4", encoder=_enc(), buffer_size=S)
    convert.cutover(base_b)
    shared = _enc()
    with EcVolume(base_a, encoder=shared, warm_on_mount=False) as ev_a, \
            EcVolume(base_b, encoder=shared, warm_on_mount=False) as ev_b:
        assert ev_a.total_shards == 14 and ev_b.total_shards == 24
        assert ev_a.encoder is shared and ev_b.encoder.data_shards == 20
        _read_range(ev_a, data_a, 123, 456)
        _read_range(ev_b, data_b, 123, 456)


def test_staged_eci_records_geometry_as_reference(tmp_path):
    base, _ = _build_source(tmp_path / "port", 2 * S * 10)
    ref_base = _copy_source(base, tmp_path / "ref")
    convert.convert_ec_files(base, "cauchy_12_3", encoder=_enc(), buffer_size=S)
    ref_convert.convert_ec_files(ref_base, "cauchy_12_3", encoder=_ref(), buffer_size=S)
    got = stripe.read_ec_info(convert.stage_base(base))
    assert got == ref_stripe.read_ec_info(ref_convert.stage_base(ref_base))
    assert got["family"] == "cauchy_12_3" and len(got["shard_crc32"]) == 15


def test_convert_siblings_keep_the_variant_and_device(tmp_path, monkeypatch):
    """The source and target encoders are same-device siblings running the
    caller's kernel variant."""
    base, data = _build_source(tmp_path, 2 * L * 10 + S * 10)
    seen = []
    orig = stripe._encode_rows

    def spy(f, enc, *a, **k):
        seen.append((enc.data_shards, enc.variant, enc.device.type, k.get("ring_cache") is not None))
        return orig(f, enc, *a, **k)

    monkeypatch.setattr(stripe, "_encode_rows", spy)
    convert.convert_ec_files(base, "merge_20_4", buffer_size=S,
                             encoder=rs_codec.Encoder(10, 4, device="cpu", variant="mplane"))
    assert seen and set(seen) == {(20, "mplane", "cpu", True)}
    _assert_staged_matches(base, _oracle(tmp_path, data, "merge_20_4"), "merge_20_4")


# -- knobs -------------------------------------------------------------------------------

KNOBS = ("WEEDTPU_CONVERT_BATCH", "WEEDTPU_CONVERT_JOURNAL_MB", "WEEDTPU_CONVERT_VERIFY")


@pytest.mark.parametrize("name", KNOBS)
@pytest.mark.parametrize("raw", [None, "", "0", "1", "-3", "2.5", "4194304", "yes", "off"])
def test_convert_knobs_match_reference(monkeypatch, name, raw):
    if raw is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, raw)

    def value(mod):
        try:
            return mod.env(name)
        except ValueError as e:
            return type(e)

    assert value(config) == value(ref_config)
