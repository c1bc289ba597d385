"""Crash-prefix replay of the port's three on-disk states, with the JAX
package's `analysis.fsrec` harness: every filesystem op of a port workload
is recorded, and for every sampled crash prefix x variant (clean, torn or
lost tail) the post-crash tree is materialized and driven through the
port's real recovery entry point.

  .ecp  an ingest with appends, polls, a journaled overwrite and a seal ->
        `InlineStripeBuilder.resume` + seal, or refusal and a warm encode;
        the torn prefix inside the overwrite's .dat write must refuse
  .ecc  a conversion and its cut-over -> `convert_ec_files` (+ `cutover`)
  scrub cursor -> `ScrubCursor` load: fresh, or exactly a saved state

Each recovered result must be byte-identical to the warm encode of the
surviving .dat (or to the decode -> re-encode oracle), as the reference's
replay tests hold the reference."""

import os
import time
import zlib

import numpy as np
import pytest
import torch

from seaweedfs_tpu.analysis import fsrec
from seaweedfs_tpu.utils import config as ref_config
from seaweedfs_tpu_torch.ec import convert, ingest, scrub, stripe
from seaweedfs_tpu_torch.ec.constants import TOTAL_SHARDS_COUNT
from seaweedfs_tpu_torch.ops import rs_codec

ENC = rs_codec.Encoder(10, 4, device="cpu")
LARGE, SMALL, BUF = 8192, 2048, 2048
LARGE_ROW = LARGE * 10


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """A replay runs hundreds of small plain-version encodes. In a parallel
    test run every worker's intra-op threads contend for the same cores,
    and a replay then spends its 30 s budget waiting on them: one thread
    keeps each replay's time its own."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _record(root, workload) -> fsrec.FsTrace:
    rec = fsrec.install(str(root))
    try:
        workload()
    finally:
        trace = rec.trace()
        fsrec.uninstall()
    return trace


def _dedup_key(state: dict) -> tuple:
    return tuple(sorted((p, len(b), zlib.crc32(b)) for p, b in state.items()))


def _replay(trace, scratch_root, check, extra_prefixes=()):
    """`check(scratch_dir, n_ops, variant)` over the sampled prefixes x
    crash variants, identical post-crash states deduplicated."""
    sched = set(fsrec.prefix_schedule(
        len(trace.ops), int(ref_config.env("WEEDTPU_FSREPLAY_MAX_PREFIXES"))))
    sched.update(extra_prefixes)
    seen, outcomes, n_dirs = set(), [], 0
    for n in sorted(sched):
        for variant in fsrec.VARIANTS:
            state = fsrec.simulate_prefix(trace, n, variant)
            key = _dedup_key(state)
            if key in seen:
                continue
            seen.add(key)
            dest = os.path.join(str(scratch_root), f"p{n_dirs}")
            n_dirs += 1
            os.makedirs(dest)
            for rel, data in state.items():
                p = os.path.join(dest, rel)
                os.makedirs(os.path.dirname(p), exist_ok=True)
                with open(p, "wb") as f:
                    f.write(data)
            outcomes.append(check(dest, n, variant))
    return outcomes


def _warm_oracle(cache_root, cache: dict, dat_bytes: bytes) -> str:
    key = (len(dat_bytes), zlib.crc32(dat_bytes))
    if key not in cache:
        wbase = os.path.join(str(cache_root), f"w{len(cache)}", "v")
        os.makedirs(os.path.dirname(wbase))
        with open(wbase + ".dat", "wb") as f:
            f.write(dat_bytes)
        stripe.write_ec_files(wbase, LARGE, SMALL, buffer_size=BUF, encoder=ENC)
        cache[key] = wbase
    return cache[key]


def _assert_matches_warm(base: str, wbase: str, ctx: str) -> None:
    for s in range(TOTAL_SHARDS_COUNT):
        with open(stripe.shard_file_name(base, s), "rb") as f, \
                open(stripe.shard_file_name(wbase, s), "rb") as g:
            assert f.read() == g.read(), f"{ctx}: shard {s} differs from the warm encode"
    with open(base + ".eci", "rb") as f, open(wbase + ".eci", "rb") as g:
        assert f.read() == g.read(), f"{ctx}: .eci differs from the warm encode"


def test_port_ingest_journal_crash_prefix_replay(tmp_path, monkeypatch):
    t0 = time.monotonic()
    monkeypatch.setenv("WEEDTPU_INLINE_EC_DELTA", "1")
    work = tmp_path / "work"
    work.mkdir()
    base = os.path.join(str(work), "7")
    n_bytes = LARGE_ROW + SMALL * 10 + 617
    data = np.random.default_rng(7).integers(0, 256, n_bytes, dtype=np.uint8).tobytes()
    ow_off, ow_len = 96, 64
    old_seg = data[ow_off: ow_off + ow_len]
    new_seg = bytes(b ^ 0xFF for b in old_seg)  # differs in every byte

    def workload():
        # the superblock prefix is durable before `begin` pins dat_rev
        with open(base + ".dat", "wb") as f:
            f.write(data[:32])
            f.flush()
            os.fsync(f.fileno())
        b = ingest.InlineStripeBuilder(base, ENC, LARGE, SMALL, buffer_size=BUF)
        with open(base + ".dat", "ab") as f:
            for off in range(32, n_bytes, 30_000):
                f.write(data[off: off + 30_000])
                f.flush()
                os.fsync(f.fileno())
                b.poll()

        def mutate():
            with open(base + ".dat", "r+b") as g:
                g.seek(ow_off)
                g.write(new_seg)
                g.flush()
                os.fsync(g.fileno())

        assert b.overwrite(ow_off, old_seg, new_seg, mutate=mutate) == ow_len
        b.seal()

    trace = _record(work, workload)
    ow_idx = next(i for i, op in enumerate(trace.ops)
                  if op.kind == "write" and op.path.endswith(".ecp") and b'"ow"' in op.data)
    mutate_idx = next(i for i, op in enumerate(trace.ops[ow_idx + 1:], start=ow_idx + 1)
                      if op.kind == "write" and op.path.endswith(".dat"))
    oracles = tmp_path / "oracles"
    oracles.mkdir()
    cache: dict = {}

    def check(dest, n, variant):
        sb = os.path.join(dest, "7")
        has_dat = os.path.exists(sb + ".dat")
        b = ingest.InlineStripeBuilder.resume(sb, ENC, LARGE, SMALL, buffer_size=BUF)
        ctx = f"{variant} prefix {n}"
        if b is not None:
            b.seal()
            with open(sb + ".dat", "rb") as f:
                dat = f.read()
            _assert_matches_warm(sb, _warm_oracle(oracles, cache, dat), ctx)
            return ("resumed", n, variant)
        if not has_dat:
            return ("no-dat", n, variant)
        with open(sb + ".dat", "rb") as f:
            dat = f.read()
        if not dat:
            return ("empty-dat", n, variant)
        ingest._cleanup_partials(sb)
        stripe.write_ec_files(sb, LARGE, SMALL, buffer_size=BUF, encoder=ENC)
        _assert_matches_warm(sb, _warm_oracle(oracles, cache, dat), ctx)
        return ("warm", n, variant)

    outcomes = _replay(trace, tmp_path / "replay", check, extra_prefixes={mutate_idx + 1})
    kinds = [o[0] for o in outcomes]
    assert "resumed" in kinds and "warm" in kinds, kinds
    assert ("warm", mutate_idx + 1, "torn") in outcomes, outcomes
    assert time.monotonic() - t0 < 30.0


def test_port_convert_journal_crash_prefix_replay(tmp_path):
    t0 = time.monotonic()
    cl, cs, fam = 4096, 512, "cauchy_12_3"
    work = tmp_path / "work"
    work.mkdir()
    base = os.path.join(str(work), "1")
    data = np.random.default_rng(3).integers(0, 256, 20000, dtype=np.uint8).tobytes()
    with open(base + ".dat", "wb") as f:
        f.write(data)
    stripe.write_ec_files(base, cl, cs, buffer_size=cs, encoder=ENC)
    os.unlink(base + ".dat")  # the conversion streams the virtual .dat
    geom = rs_codec.geometry_for(fam)
    ob = os.path.join(str(tmp_path), "oracle", "1")
    os.makedirs(os.path.dirname(ob))
    with open(ob + ".dat", "wb") as f:
        f.write(data)
    stripe.write_ec_files(ob, cl, cs, buffer_size=cs, encoder=rs_codec.new_encoder(
        family=fam, device="cpu"))

    def convert_once(b):
        return convert.convert_ec_files(b, fam, encoder=ENC, buffer_size=cs,
                                        journal_bytes=2048, verify=True)

    def workload():
        convert_once(base)
        convert.cutover(base)

    trace = _record(work, workload)

    def after_record(tag: bytes) -> int:
        i = next(k for k, op in enumerate(trace.ops)
                 if op.kind == "write" and op.path.endswith(".ecc") and tag in op.data)
        assert trace.ops[i + 2].kind == "fsync", trace.ops[i: i + 3]
        return i + 3  # write, flush, fsync: the record is durable

    extra = {after_record(b'"watermark"'), after_record(b'"cutover"')}

    def check(dest, n, variant):
        sb = os.path.join(dest, "1")
        res = convert_once(sb)
        if res["mode"] in ("converted", "resumed"):
            convert.cutover(sb)
        ctx = f"{variant} prefix {n}"
        info = stripe.read_ec_info(sb)
        assert info is not None, f"{ctx}: the cut-over volume lost its .eci"
        assert stripe.geometry_from_info(info).family == fam, ctx
        assert not convert.pending_cutover(sb), f"{ctx}: swap left unfinished"
        for s in range(geom.total_shards):
            with open(stripe.shard_file_name(sb, s), "rb") as f, \
                    open(stripe.shard_file_name(ob, s), "rb") as g:
                assert f.read() == g.read(), f"{ctx}: shard {s} differs from the oracle"
        return res["mode"]

    modes = _replay(trace, tmp_path / "replay", check, extra_prefixes=extra)
    assert "resumed" in modes and "cutover" in modes and "noop" in modes, modes
    assert time.monotonic() - t0 < 30.0


def test_port_scrub_cursor_crash_prefix_replay(tmp_path):
    work = tmp_path / "work"
    work.mkdir()
    cpath = os.path.join(str(work), "scrub_cursor.json")
    saved = []

    def workload():
        cur = scrub.ScrubCursor(cpath)
        for i in range(1, 6):
            cur.point(i, i % 14, i * 1000, i * 7)
            cur.save()
            saved.append((i, i % 14, i * 1000, i * 7, 0, ()))
        cur.add_quarantine(3, 5, "corrupt")  # saves at once
        saved.append((5, 5, 5000, 35, 0, ((3, 5),)))

    trace = _record(work, workload)
    fresh = (0, 0, 0, 0, 0, ())
    allowed = {fresh, *saved}
    states = set()

    def check(dest, n, variant):
        cur = scrub.ScrubCursor(os.path.join(dest, "scrub_cursor.json"))
        got = (cur.vid, cur.shard, cur.offset, cur.crc, cur.cycles,
               tuple((q["vid"], q["shard"]) for q in cur.quarantine))
        assert got in allowed, f"{variant} prefix {n}: loaded {got}, never saved"
        states.add(got)
        return got

    _replay(trace, tmp_path / "replay", check)
    assert fresh in states and len(states & set(saved)) >= 2
