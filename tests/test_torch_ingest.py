"""Inline-EC ingest in the port against the JAX package's: `parity_delta` and
`update_parity` byte-exact against both packages' `gf8.gf_delta_parity`,
a full re-encode, and the reference's numpy, jax and interpret-mode pallas
backends, with the reference's validation messages; streamed ingest, the
journaled overwrite, crash/resume and refusal cases and the manager, each
byte-identical to a warm `write_ec_files` and to the reference builder on
the same appends; the `.ecp` journal written byte for byte as the
reference writes it, and resumed across the two packages both ways. All
comparisons byte-exact (tolerance 0)."""

import os
import shutil
import zlib

import numpy as np
import pytest

from seaweedfs_tpu.ec import ingest as ref_ingest
from seaweedfs_tpu.obs import trace as ref_trace
from seaweedfs_tpu.ops import gf8 as ref_gf8
from seaweedfs_tpu.ops import rs_codec as ref_codec
from seaweedfs_tpu.utils import config as ref_config
from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.ec import ingest, stripe
from seaweedfs_tpu_torch.ec.constants import DATA_SHARDS_COUNT, TOTAL_SHARDS_COUNT
from seaweedfs_tpu_torch.obs import trace
from seaweedfs_tpu_torch.ops import gf8, rs_codec
from seaweedfs_tpu_torch.utils import config

ENC = rs_codec.Encoder(10, 4, device="cpu")
REF = ref_codec.Encoder(10, 4, backend="numpy")
LARGE, SMALL, BUF = 8192, 2048, 2048
LARGE_ROW = LARGE * DATA_SHARDS_COUNT
VID = 7

#: (width, shard, reference backend): interpret-mode pallas at narrow widths only
DELTA_CASES = [(n, shard, b) for n in (1, 17, 4113, 65536) for shard in (0, 5, 9)
               for b in ("numpy", "jax")] + [(n, shard, "pallas") for n in (1, 17)
                                             for shard in (0, 9)]


def _write_dat(base: str, n_bytes: int, seed: int = 11) -> bytes:
    os.makedirs(os.path.dirname(base), exist_ok=True)
    data = np.random.default_rng(seed).integers(0, 256, n_bytes, dtype=np.uint8).tobytes()
    with open(base + ".dat", "wb") as f:
        f.write(data)
    return data


def _warm(tmp_path, data: bytes, name: str = "warm") -> str:
    wbase = os.path.join(str(tmp_path), name, str(VID))
    os.makedirs(os.path.dirname(wbase), exist_ok=True)
    with open(wbase + ".dat", "wb") as f:
        f.write(data)
    stripe.write_ec_files(wbase, LARGE, SMALL, buffer_size=BUF, encoder=ENC)
    return wbase


def _assert_identical(base: str, wbase: str) -> None:
    for s in range(TOTAL_SHARDS_COUNT):
        with open(stripe.shard_file_name(base, s), "rb") as f, \
                open(stripe.shard_file_name(wbase, s), "rb") as g:
            assert f.read() == g.read(), f"shard {s} differs from {wbase}"
    with open(base + ".eci", "rb") as f, open(wbase + ".eci", "rb") as g:
        assert f.read() == g.read(), ".eci differs"


def _builder(base, **kw):
    kw.setdefault("buffer_size", BUF)
    return ingest.InlineStripeBuilder(base, ENC, LARGE, SMALL, **kw)


def _resume(base, **kw):
    kw.setdefault("buffer_size", BUF)
    return ingest.InlineStripeBuilder.resume(base, ENC, LARGE, SMALL, **kw)


def _mutator(base: str, off: int, new: bytes):
    def mutate():
        with open(base + ".dat", "r+b") as f:
            f.seek(off)
            f.write(new)
    return mutate


# -- delta parity: Encoder.parity_delta / update_parity ----------------------------


@pytest.mark.parametrize("n, shard, ref_backend", DELTA_CASES)
def test_parity_delta_equals_goldens_reencode_and_reference(n, shard, ref_backend):
    rng = np.random.default_rng(n * 31 + shard)
    stack = rng.integers(0, 256, (DATA_SHARDS_COUNT, n), dtype=np.uint8)
    new_block = rng.integers(0, 256, n, dtype=np.uint8)
    golden = ref_gf8.gf_delta_parity(REF.parity_matrix[:, shard], stack[shard] ^ new_block)
    assert np.array_equal(gf8.gf_delta_parity(ENC.parity_matrix[:, shard],
                                              stack[shard] ^ new_block), golden)
    ref = ref_codec.Encoder(10, 4, backend=ref_backend)
    want = np.asarray(ref.parity_delta(shard, stack[shard], new_block))
    assert np.array_equal(want, golden)
    got = ENC.parity_delta(shard, stack[shard], new_block)
    assert got.shape == (4, n) and got.dtype == np.uint8
    assert np.array_equal(got, want)
    # update_parity equals a re-encode of the mutated stripe, and the reference's
    parity = np.asarray(ENC.encode_parity_lazy(stack))
    mutated = stack.copy()
    mutated[shard] = new_block
    updated = ENC.update_parity(parity, shard, stack[shard], new_block)
    assert np.array_equal(updated, np.asarray(ENC.encode_parity_lazy(mutated)))
    assert np.array_equal(updated, ref.update_parity(parity, shard, stack[shard], new_block))


@pytest.mark.parametrize("variant", rs_codec.FUSED_VARIANTS)
@pytest.mark.parametrize("n", [1, 17, 4113])
def test_parity_delta_every_variant_plain_version(variant, n):
    """Each variant's plain version (what the card's kernel is held to) at
    the delta's (4, 1) shape, odd widths included."""
    enc = rs_codec.Encoder(10, 4, device="cpu", variant=variant)
    rng = np.random.default_rng(n)
    old, new = rng.integers(0, 256, (2, n), dtype=np.uint8)
    assert np.array_equal(enc.parity_delta(3, old, new),
                          gf8.gf_delta_parity(enc.parity_matrix[:, 3], old ^ new))


@pytest.mark.parametrize("family", ["cauchy_12_3", "merge_20_4"])
def test_parity_delta_other_families_equal_reference(family):
    enc = rs_codec.new_encoder(family=family, device="cpu")
    ref = ref_codec.new_encoder(family=family, backend="numpy")
    rng = np.random.default_rng(3)
    old, new = rng.integers(0, 256, (2, 999), dtype=np.uint8)
    for shard in (0, enc.data_shards - 1):
        assert np.array_equal(enc.parity_delta(shard, old, new), ref.parity_delta(shard, old, new))


def test_update_parity_multi_block_composes():
    rng = np.random.default_rng(77)
    stack = rng.integers(0, 256, (DATA_SHARDS_COUNT, 1000), dtype=np.uint8)
    parity = np.asarray(ENC.encode_parity_lazy(stack))
    mutated = stack.copy()
    for shard in (2, 6, 9):
        new_block = rng.integers(0, 256, 1000, dtype=np.uint8)
        parity = ENC.update_parity(parity, shard, mutated[shard], new_block)
        mutated[shard] = new_block
    assert np.array_equal(parity, np.asarray(ENC.encode_parity_lazy(mutated)))


@pytest.mark.parametrize("call", [
    ("update_parity", (np.zeros((4, 10), np.uint8), 10, b"x" * 10, b"y" * 10)),  # shard oob
    ("update_parity", (np.zeros((4, 10), np.uint8), 0, b"x" * 9, b"y" * 10)),   # lengths
    ("update_parity", (np.zeros((4, 10), np.uint8), 0, b"x" * 11, b"y" * 11)),  # parity span
    ("update_parity", (np.zeros((3, 10), np.uint8), 0, b"x" * 10, b"y" * 10)),  # parity rows
    ("parity_delta", (-1, b"x", b"y")),
    ("parity_delta", (0, b"xx", b"y")),
])
def test_delta_validation_errors_match_reference(call):
    name, args = call
    msgs = []
    for enc in (ENC, REF):
        with pytest.raises(ValueError) as ei:
            getattr(enc, name)(*args)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


# -- streamed ingest ---------------------------------------------------------------


@pytest.mark.parametrize("n_bytes", [
    LARGE_ROW * 3 + 12345,      # large rows + odd small tail
    LARGE_ROW * 2,              # exact row multiple (last row is SMALL)
    LARGE_ROW + SMALL * 3 + 1,  # one large row + partial small rows
    SMALL * 2 + 7,              # no large rows at all
])
def test_streamed_ingest_equals_reference_builder_and_warm(tmp_path, n_bytes):
    """Appends in bursts with a poll per burst, then a seal: the port's
    shards and .eci equal the reference builder's on the same appends and
    a warm encode of the final .dat; the journals match byte for byte
    until the seal removes them."""
    data = np.random.default_rng(n_bytes).integers(0, 256, n_bytes, dtype=np.uint8).tobytes()
    bases, journals = {}, {}
    for name, mod, enc in (("port", ingest, ENC), ("ref", ref_ingest, REF)):
        base = os.path.join(str(tmp_path), name, str(VID))
        os.makedirs(os.path.dirname(base))
        b = mod.InlineStripeBuilder(base, enc, LARGE, SMALL, buffer_size=BUF)
        with open(base + ".dat", "wb") as f:
            for off in range(0, n_bytes, 30_000):
                f.write(data[off: off + 30_000])
                f.flush()
                b.poll()
        b._flush_watermark()
        with open(mod.journal_path(base), "rb") as f:
            journals[name] = f.read()
        info = b.seal()
        assert info["rows_total"] == stripe.stripe_layout(n_bytes, LARGE, SMALL)[0]
        assert not os.path.exists(mod.journal_path(base))
        assert not any(os.path.exists(mod.part_path(base, s)) for s in range(TOTAL_SHARDS_COUNT))
        bases[name] = base
    assert journals["port"] == journals["ref"]
    _assert_identical(bases["port"], bases["ref"])
    _assert_identical(bases["port"], _warm(tmp_path, data))


def test_partials_invisible_to_shard_discovery(tmp_path):
    base = os.path.join(str(tmp_path), str(VID))
    _write_dat(base, LARGE_ROW * 2 + 99)
    b = _builder(base)
    b.poll()
    assert stripe.find_local_shards(base) == []
    assert ingest.part_path(base, 3) == ref_ingest.part_path(base, 3)
    b.abort()
    assert not os.path.exists(ingest.journal_path(base))


def test_ring_cache_reused_across_polls_and_bounded(tmp_path):
    """One ring per geometry across polls, at most two geometries kept."""
    base = os.path.join(str(tmp_path), str(VID))
    data = np.random.default_rng(4).integers(0, 256, LARGE_ROW * 4 + 5, dtype=np.uint8).tobytes()
    b = _builder(base)
    rings = []
    with open(base + ".dat", "wb") as f:
        for k in range(1, 5):
            f.write(data[(k - 1) * LARGE_ROW: k * LARGE_ROW])
            f.flush()
            b.poll()
            rings.append(set(map(id, b._ring_cache.values())))
    f_rows = [r for r in rings if r]
    assert len(f_rows) >= 2 and all(r == f_rows[0] for r in f_rows)
    cache: dict = {}
    for width in (1, 2, 3):
        stripe._ring_for(cache, ENC, 3, (10, width))
    assert [k[1] for k in cache] == [(10, 2), (10, 3)]
    with open(base + ".dat", "ab") as f:
        f.write(data[4 * LARGE_ROW:])
    b.seal()
    _assert_identical(base, _warm(tmp_path, data))


# -- overwrites ----------------------------------------------------------------------


@pytest.mark.parametrize("off, length", [
    (LARGE * 5 - 100, 300),   # crosses the shard-4/shard-5 block boundary
    (LARGE * 12 + 31, 400),   # row 1, shard 2
    (LARGE_ROW * 3 - 10, 50),  # the last encoded row's end into the unencoded tail
    (0, 1),
])
def test_overwrite_equals_reference_and_warm(tmp_path, off, length):
    """An overwrite inside encoded rows, journaled and folded in as deltas:
    the journal equals the reference's byte for byte and the sealed set
    equals the reference's and a warm encode of the mutated .dat."""
    new = bytes(np.random.default_rng(off).integers(0, 256, length, dtype=np.uint8))
    out, journals = {}, {}
    for name, mod, enc in (("port", ingest, ENC), ("ref", ref_ingest, REF)):
        base = os.path.join(str(tmp_path), name, str(VID))
        data = _write_dat(base, LARGE_ROW * 3 + 4321)
        b = mod.InlineStripeBuilder(base, enc, LARGE, SMALL, buffer_size=BUF)
        b.poll()
        assert b.rows_done == 3
        patched = b.overwrite(off, data[off: off + length], new, mutate=_mutator(base, off, new))
        assert patched == min(off + length, 3 * LARGE_ROW) - off
        assert b.delta_stats["updates"] == 1
        with open(mod.journal_path(base), "rb") as f:
            journals[name] = f.read()
        assert b.seal()["delta_updates"] == 1
        out[name] = base
    assert journals["port"] == journals["ref"]
    _assert_identical(out["port"], out["ref"])
    final = bytearray(data)
    final[off: off + length] = new
    _assert_identical(out["port"], _warm(tmp_path, bytes(final)))


def test_overwrite_identical_bytes_is_free(tmp_path):
    base = os.path.join(str(tmp_path), str(VID))
    data = _write_dat(base, LARGE_ROW * 2)
    b = _builder(base)
    b.poll()
    assert b.overwrite(100, data[100:200], data[100:200]) == 0
    assert b.delta_stats["updates"] == 0 and b.crc_valid
    b.abort()


def test_overwrite_length_mismatch_raises_as_reference(tmp_path):
    base = os.path.join(str(tmp_path), str(VID))
    _write_dat(base, LARGE_ROW * 2)
    msgs = []
    for mod, enc in ((ingest, ENC), (ref_ingest, REF)):
        b = mod.InlineStripeBuilder(base, enc, LARGE, SMALL, buffer_size=BUF)
        with pytest.raises(ValueError) as ei:
            b.overwrite(0, b"ab", b"abc")
        msgs.append(str(ei.value))
        b.abort()
    assert msgs[0] == msgs[1]


def test_overwrite_with_delta_disabled_forces_warm(tmp_path):
    base = os.path.join(str(tmp_path), str(VID))
    data = _write_dat(base, LARGE_ROW * 2 + 5)
    b = _builder(base, delta_enabled=False)
    b.poll()
    ran = []
    assert b.overwrite(0, data[:50], b"\x01" * 50, mutate=lambda: ran.append(1)) == 0
    assert ran == [1] and b.broken
    with pytest.raises(IOError):
        b.seal()
    b.abort()


def test_overwrite_mutate_failure_breaks_builder_and_propagates(tmp_path):
    base = os.path.join(str(tmp_path), str(VID))
    data = _write_dat(base, LARGE_ROW * 2)
    b = _builder(base)
    b.poll()

    def bad_mutate():
        raise OSError("disk full")

    with pytest.raises(OSError):
        b.overwrite(0, data[:16], b"\x05" * 16, mutate=bad_mutate)
    assert b.broken
    with pytest.raises(IOError):
        b.seal()
    b.abort()


def test_overwrite_on_closed_builder_still_mutates(tmp_path):
    base = os.path.join(str(tmp_path), str(VID))
    data = _write_dat(base, LARGE_ROW + 20)
    b = _builder(base)
    b.poll()
    b.seal()
    ran = []
    assert b.overwrite(0, data[:8], b"\x01" * 8, mutate=lambda: ran.append(1)) == 0
    assert ran == [1]


def test_delta_invalidates_cached_intervals(tmp_path):
    """A delta changes encoded bytes of the base: the port's decoded-
    interval cache drops the volume's entries."""
    from seaweedfs_tpu_torch.ec import read_planner

    base = os.path.join(str(tmp_path), str(VID))
    data = _write_dat(base, LARGE_ROW * 2 + 5)
    b = _builder(base)
    b.poll()
    calls = []
    orig = read_planner.CACHE.invalidate_volume
    read_planner.CACHE.invalidate_volume = lambda v: calls.append(v) or orig(v)
    try:
        new = b"\x09" * 32
        b.overwrite(64, data[64:96], new, mutate=_mutator(base, 64, new))
    finally:
        read_planner.CACHE.invalidate_volume = orig
    assert calls == [base]
    b.abort()


# -- crash / resume --------------------------------------------------------------------


def test_resume_after_crash_continues_and_matches(tmp_path):
    base = os.path.join(str(tmp_path), "v", str(VID))
    os.makedirs(os.path.dirname(base))
    data = np.random.default_rng(9).integers(0, 256, LARGE_ROW * 4 + 777, dtype=np.uint8).tobytes()
    with open(base + ".dat", "wb") as f:
        f.write(data[: LARGE_ROW * 2 + 7])
    b = _builder(base)
    b.poll()
    b._flush_watermark()
    assert b.rows_done == 2
    b._close_handles()  # crash: no seal, no abort
    with open(base + ".dat", "ab") as f:
        f.write(data[LARGE_ROW * 2 + 7:])
    r = _resume(base)
    assert r is not None and r.resumed and r.rows_done == 2
    r.poll()
    assert r.rows_done == 4
    r.seal()
    _assert_identical(base, _warm(tmp_path, data))


def test_resume_truncates_rows_past_durable_watermark(tmp_path):
    base = os.path.join(str(tmp_path), str(VID))
    data = _write_dat(base, LARGE_ROW * 3 + 10)
    b = _builder(base)
    b.poll()
    assert b.rows_done == 3 and b._durable_rows == 0
    b._close_handles()
    r = _resume(base)
    assert r is not None and r.rows_done == 0
    r.poll()
    assert r.rows_done == 3
    r.seal()
    _assert_identical(base, _warm(tmp_path, data))


def test_resume_ignores_torn_journal_tail(tmp_path):
    base = os.path.join(str(tmp_path), str(VID))
    data = _write_dat(base, LARGE_ROW * 2 + 50)
    b = _builder(base)
    b.poll()
    b._flush_watermark()
    b._close_handles()
    with open(ingest.journal_path(base), "ab") as f:
        f.write(b'{"kind":"rows","rows"')  # crash mid-append
    r = _resume(base)
    assert r is not None and r.rows_done == 2
    r.seal()
    _assert_identical(base, _warm(tmp_path, data))


@pytest.mark.parametrize("damage", ["truncated_partial", "geometry", "codec", "compacted",
                                    "unknown_mutation", "missing_partial", "foreign_head"])
def test_resume_refuses_like_reference(tmp_path, damage):
    """Each state the journal cannot vouch for: the port's resume returns
    None, and so does the reference's on a copy of the same state."""
    base = os.path.join(str(tmp_path), "v", str(VID))
    data = _write_dat(base, LARGE_ROW * 2 + 9)
    b = _builder(base)
    b.poll()
    b._flush_watermark()
    if damage == "unknown_mutation":
        ingest._append_record(b._journal, {"kind": "ow", "off": 0, "old": ingest._b64(data[:50]),
                                           "new": ingest._b64(b"\x01" * 50)})
    b._close_handles()
    large, port_enc, ref_enc = LARGE, ENC, REF
    if damage == "truncated_partial":
        with open(ingest.part_path(base, 4), "r+b") as f:
            f.truncate(100)
    elif damage == "geometry":
        large = LARGE * 2
    elif damage == "codec":
        port_enc = rs_codec.Encoder(10, 4, matrix_kind="cauchy", device="cpu")
        ref_enc = ref_codec.Encoder(10, 4, matrix_kind="cauchy", backend="numpy")
    elif damage == "compacted":
        with open(base + ".dat", "r+b") as f:
            f.seek(4)
            f.write((99).to_bytes(2, "big"))
    elif damage == "unknown_mutation":
        with open(base + ".dat", "r+b") as f:
            f.write(b"\x02" * 50)  # neither the old nor the new bytes
    elif damage == "missing_partial":
        os.unlink(ingest.part_path(base, 13))
    elif damage == "foreign_head":
        with open(ingest.journal_path(base), "wb") as f:
            f.write(b'{"kind":"rows","rows":1}\n')
    ref_base = os.path.join(str(tmp_path), "r", str(VID))
    shutil.copytree(os.path.dirname(base), os.path.dirname(ref_base))
    assert ingest.InlineStripeBuilder.resume(base, port_enc, large, SMALL, buffer_size=BUF) is None
    assert ref_ingest.InlineStripeBuilder.resume(ref_base, ref_enc, large, SMALL,
                                                 buffer_size=BUF) is None


def test_resume_ignores_replication_byte_rewrite(tmp_path):
    """The superblock's replica-placement byte is not part of the pin."""
    base = os.path.join(str(tmp_path), str(VID))
    _write_dat(base, LARGE_ROW * 2 + 9)
    b = _builder(base)
    b.poll()
    b._flush_watermark()
    b._close_handles()
    with open(base + ".dat", "r+b") as f:
        f.seek(1)
        f.write(b"\x77")
    r = _resume(base)
    assert r is not None
    r.abort()


def test_resume_resolves_pending_overwrite_intent(tmp_path):
    """A crash after the intent, the .dat write and the first segment's
    delta: resume finishes exactly the second segment."""
    base = os.path.join(str(tmp_path), "v", str(VID))
    data = _write_dat(base, LARGE_ROW * 3 + 123)
    b = _builder(base)
    b.poll()
    b._flush_watermark()
    off = LARGE * 7 - 100  # spans two blocks: two delta segments
    old = data[off: off + 300]
    new = bytes(np.random.default_rng(2).integers(0, 256, 300, dtype=np.uint8))
    ingest._append_record(b._journal, {"kind": "ow", "off": off, "old": ingest._b64(old),
                                       "new": ingest._b64(new)})
    _mutator(base, off, new)()
    row, q = divmod(off, LARGE_ROW)
    d, col = divmod(q, LARGE)
    seg = min(LARGE - col, 300)
    b._apply_delta(row * LARGE + col, d, np.frombuffer(old, np.uint8)[:seg],
                   np.frombuffer(new, np.uint8)[:seg])
    b._close_handles()
    r = _resume(base)
    assert r is not None
    r.seal()
    final = bytearray(data)
    final[off: off + 300] = new
    _assert_identical(base, _warm(tmp_path, bytes(final)))


def test_resume_pending_delta_seal_crcs_match_disk(tmp_path):
    base = os.path.join(str(tmp_path), "v", str(VID))
    data = _write_dat(base, LARGE_ROW * 3 + 123)
    b = _builder(base)
    b.poll()
    b._flush_watermark()
    off = LARGE * 3 + 17
    old = data[off: off + 200]
    new = bytes(np.random.default_rng(5).integers(0, 256, 200, dtype=np.uint8))
    ingest._append_record(b._journal, {"kind": "ow", "off": off, "old": ingest._b64(old),
                                       "new": ingest._b64(new)})
    _mutator(base, off, new)()
    b._close_handles()
    r = _resume(base)
    assert r is not None and not r.crc_valid
    off2 = LARGE * 12 + 5
    cur = bytearray(data)
    cur[off: off + 200] = new
    new2 = bytes(np.random.default_rng(6).integers(0, 256, 100, dtype=np.uint8))
    assert r.overwrite(off2, bytes(cur[off2: off2 + 100]), new2,
                       mutate=_mutator(base, off2, new2)) > 0
    r.seal()
    recorded = stripe.read_ec_info(base)["shard_crc32"]
    for s in range(TOTAL_SHARDS_COUNT):
        with open(stripe.shard_file_name(base, s), "rb") as f:
            assert zlib.crc32(f.read()) == recorded[s]
    cur[off2: off2 + 100] = new2
    _assert_identical(base, _warm(tmp_path, bytes(cur), "wseam"))


def test_journal_reader_ignores_torn_tail(tmp_path):
    base = os.path.join(str(tmp_path), str(VID))
    with open(ingest.journal_path(base), "wb") as f:
        f.write(b'{"kind":"begin","version":1}\n{"kind":"rows","rows":2}\n')
        f.write(b'{"kind":"rows","ro')
    assert [r["kind"] for r in ingest.read_journal(base)] == ["begin", "rows"]
    assert ingest._read_journal_prefix(base) == ref_ingest._read_journal_prefix(base)


# -- across the two packages -------------------------------------------------------------


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("pending", [False, True])
def test_ecp_journal_resumes_across_packages(tmp_path, writer, pending):
    """A `.ecp` journal with its partials, written mid-ingest by one
    package (rows, a finished overwrite, optionally a pending intent whose
    first segment landed), resumes and seals in the other byte-identical to
    a warm encode of the final .dat."""
    w_ingest, w_enc = (ref_ingest, REF) if writer == "ref" else (ingest, ENC)
    r_ingest, r_enc = (ingest, ENC) if writer == "ref" else (ref_ingest, REF)
    base = os.path.join(str(tmp_path), "v", str(VID))
    data = np.random.default_rng(21).integers(0, 256, LARGE_ROW * 4 + 999, dtype=np.uint8)
    final = bytearray(data.tobytes())
    os.makedirs(os.path.dirname(base))
    with open(base + ".dat", "wb") as f:
        f.write(bytes(final[: LARGE_ROW * 3 + 5]))
    b = w_ingest.InlineStripeBuilder(base, w_enc, LARGE, SMALL, buffer_size=BUF)
    b.poll()
    off, new = LARGE * 15 - 40, bytes(range(80))  # row 1, across shards 4 and 5
    b.overwrite(off, bytes(final[off: off + 80]), new, mutate=_mutator(base, off, new))
    final[off: off + 80] = new
    if pending:
        off2 = LARGE * 2 - 10
        new2 = bytes(np.random.default_rng(2).integers(0, 256, 30, dtype=np.uint8))
        old2 = bytes(final[off2: off2 + 30])
        b._journal_append({"kind": "ow", "off": off2, "old": w_ingest._b64(old2),
                           "new": w_ingest._b64(new2)})
        _mutator(base, off2, new2)()
        # the first segment (row 0, shard 1, its last 10 columns) landed
        b._apply_delta(LARGE - 10, 1, np.frombuffer(old2, np.uint8)[:10],
                       np.frombuffer(new2, np.uint8)[:10])
        final[off2: off2 + 30] = new2
    b._close_handles()  # crash
    with open(base + ".dat", "ab") as f:
        f.write(bytes(final[LARGE_ROW * 3 + 5:]))
    r = r_ingest.InlineStripeBuilder.resume(base, r_enc, LARGE, SMALL, buffer_size=BUF)
    assert r is not None and r.resumed and r.rows_done == 3
    assert r.crc_valid is False
    r.poll()
    r.seal()
    _assert_identical(base, _warm(tmp_path, bytes(final)))


# -- the manager ---------------------------------------------------------------------


class _FakeVol:
    def __init__(self, base):
        self.base_path = base
        self.dat_path = base + ".dat"
        self.read_only = False
        self.tiered = False


class _FakeStore:
    def __init__(self, base, encoder=ENC):
        self.encoder = encoder
        self._vol = _FakeVol(base)

    def get_volume(self, vid):
        return self._vol


def _manager(base, **kw):
    return ingest.IngestManager(_FakeStore(base), large_block_size=LARGE,
                                small_block_size=SMALL, buffer_size=BUF, **kw)


def test_manager_seal_inline_then_warm_fallback(tmp_path):
    base = os.path.join(str(tmp_path), "v", str(VID))
    data = _write_dat(base, LARGE_ROW * 2 + 999)
    seals0 = {m: stats.InlineEcSeals.labels(m).value for m in ("inline", "warm")}
    mgr = _manager(base, seal_bytes=0)
    try:
        mgr.on_write(VID)
        info = mgr.seal_volume(VID, base)
    finally:
        mgr.close()
    assert info["mode"] == "inline" and info["rows_inline"] == 2
    _assert_identical(base, _warm(tmp_path, data))
    base2 = os.path.join(str(tmp_path), "v2", str(VID))
    data2 = _write_dat(base2, LARGE_ROW + 100, seed=3)
    mgr2 = _manager(base2, seal_bytes=0)
    try:
        mgr2.on_write(VID)
        with mgr2._lock:
            b = mgr2._builders.pop(VID)
        b.poll()
        b._flush_watermark()
        b._close_handles()
        with open(ingest.journal_path(base2), "r+b") as f:
            f.truncate(3)  # unreadable head
        info2 = mgr2.seal_volume(VID, base2, buffer_size=BUF)
    finally:
        mgr2.close()
    assert info2["mode"] == "warm"
    _assert_identical(base2, _warm(tmp_path, data2, "w2"))
    assert not os.path.exists(ingest.journal_path(base2))
    assert stats.InlineEcSeals.labels("inline").value == seals0["inline"] + 1
    assert stats.InlineEcSeals.labels("warm").value == seals0["warm"] + 1


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_manager_seal_resumed_after_crash(tmp_path, writer):
    """A new manager (a fresh process) seals a volume whose builder
    crashed, in either package, as `resumed`."""
    base = os.path.join(str(tmp_path), "v", str(VID))
    data = _write_dat(base, LARGE_ROW * 2 + 11)
    mod, enc = (ingest, ENC) if writer == "port" else (ref_ingest, REF)
    b = mod.InlineStripeBuilder(base, enc, LARGE, SMALL, buffer_size=BUF)
    b.poll()
    b._flush_watermark()
    b._close_handles()
    mgr = _manager(base)
    try:
        info = mgr.seal_volume(VID, base)
    finally:
        mgr.close()
    assert info["mode"] == "resumed"
    _assert_identical(base, _warm(tmp_path, data))


def test_manager_discard_scrubs_disk_state(tmp_path):
    base = os.path.join(str(tmp_path), str(VID))
    _write_dat(base, LARGE_ROW + 50)
    mgr = _manager(base)
    try:
        mgr.on_write(VID)
        with mgr._lock:
            b = mgr._builders.get(VID)
        b.poll()
        b._flush_watermark()
        assert os.path.exists(ingest.journal_path(base))
        mgr.discard(VID, base)
    finally:
        mgr.close()
    assert not os.path.exists(ingest.journal_path(base))
    assert not any(os.path.exists(ingest.part_path(base, s)) for s in range(TOTAL_SHARDS_COUNT))


def test_manager_worker_polls_and_overwrite_routes_through_builder(tmp_path):
    """on_write hands the poll to the worker thread; an overwrite through the
    manager is journaled as a delta; the seal is inline and warm-identical."""
    import time

    base = os.path.join(str(tmp_path), "v", str(VID))
    data = _write_dat(base, LARGE_ROW * 2 + 300)
    mgr = _manager(base, seal_bytes=0)
    try:
        mgr.on_write(VID)
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            with mgr._lock:
                b = mgr._builders.get(VID)
            if b is not None and b.rows_done == 2:
                break
            time.sleep(0.02)
        assert b.rows_done == 2
        off, new = LARGE * 3 + 3, b"\xaa" * 64
        assert mgr.overwrite(VID, off, data[off: off + 64], new,
                             mutate=_mutator(base, off, new)) == 64
        info = mgr.seal_volume(VID, base)
    finally:
        mgr.close()
    assert not mgr._worker.is_alive()
    assert info["mode"] == "inline" and info["delta_updates"] == 1
    final = bytearray(data)
    final[off: off + 64] = new
    _assert_identical(base, _warm(tmp_path, bytes(final)))


# -- counters and knobs ------------------------------------------------------------


def test_inline_counters_move(tmp_path):
    rows0, bytes0 = stats.InlineEcRows.value, stats.InlineEcBytes.value
    deltas0, dbytes0 = stats.InlineEcDeltaUpdates.value, stats.InlineEcDeltaBytes.value
    base = os.path.join(str(tmp_path), str(VID))
    data = _write_dat(base, LARGE_ROW * 2 + 10)
    b = _builder(base)
    b.poll()
    assert stats.InlineEcRows.value == rows0 + 2
    assert stats.InlineEcBytes.value == bytes0 + 2 * LARGE_ROW
    new = bytes(np.random.default_rng(5).integers(0, 256, 64, dtype=np.uint8))
    b.overwrite(0, data[:64], new, mutate=_mutator(base, 0, new))
    assert stats.InlineEcDeltaUpdates.value == deltas0 + 1
    assert stats.InlineEcDeltaBytes.value == dbytes0 + 64 * (2 + 2 * 4)
    b.abort()


KNOBS = ("WEEDTPU_INLINE_EC_SEAL_BYTES", "WEEDTPU_INLINE_EC_DELTA",
         "WEEDTPU_INLINE_EC_LARGE_BLOCK", "WEEDTPU_INLINE_EC_SMALL_BLOCK")


@pytest.mark.parametrize("name", KNOBS)
@pytest.mark.parametrize("raw", [None, "", "0", "1", "-3", "100", "yes", "off"])
def test_inline_knobs_match_reference(monkeypatch, name, raw):
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


def test_poll_root_records_nothing_and_seal_nests_under_a_collector(tmp_path, monkeypatch):
    """A poll's root (`trace.start("ingest.encode")`) lands in the trace
    ring with its encode spans under it, as the reference's does, and an
    outer collector sees none of them (the root is a trace of its own);
    `trace.ensure` (the seal's span) records under an ambient collector
    and roots a trace of its own without one; an unregistered name records
    instead of raising. (The name dates from when a root recorded nothing.)"""
    data = np.random.default_rng(5).integers(0, 256, LARGE * 10 + 3000, dtype=np.uint8)
    monkeypatch.setenv("WEEDTPU_TRACE", "on")
    rings, builders = {}, {}
    for name, mod, tmod, enc in (("port", ingest, trace, ENC),
                                 ("ref", ref_ingest, ref_trace, REF)):
        ring = rings[name] = tmod.TraceRing(capacity=64, slowest_n=8, sample=1.0, seed=1)
        monkeypatch.setattr(tmod, "RING", ring)
        base = str(tmp_path / name)
        with open(base + ".dat", "wb") as f:
            f.write(data.tobytes())
        b = builders[name] = mod.InlineStripeBuilder(base, enc, LARGE, SMALL)
        with trace.collect() as spans:
            assert b.poll() == 1
        assert spans == []
    for name in rings:
        [t] = rings[name].snapshot()
        assert (t["kind"], t["class"], t["error"]) == ("ingest.encode", "ingest", None)
        assert t["root"]["attrs"] == {"rows": 1, "row_start": 0}
        assert [s["name"] for s in t["root"]["spans"]] == [
            s["name"] for s in rings["ref"].snapshot()[0]["root"]["spans"]]
        assert {s["name"] for s in ref_trace.iter_spans(t)} == {
            "ingest.encode", "encode.stage", "encode.drain"}
    ring = rings["port"]
    ring.clear()
    with trace.collect() as spans:
        builders["port"].seal()  # the seal encodes the small-row tail under its span
    assert spans[-1]["name"] == "ingest.seal"
    assert {s["name"] for s in spans[:-1]} == {"encode.stage", "encode.drain"}
    assert ring.snapshot() == []
    with trace.ensure("scrub.cycle") as root:  # no ambient trace: a root of its own
        root.annotate(shards=1)
    [t] = ring.snapshot()
    assert (t["kind"], t["class"], t["root"]["attrs"]) == ("scrub.cycle", "maint", {"shards": 1})
    with trace.start("ingest.unknown"), trace.span("encode.unknown"):
        pass
    assert {t["kind"] for t in ring.snapshot()} == {"scrub.cycle", "ingest.unknown"}
