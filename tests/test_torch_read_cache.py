"""The port's decoded-interval cache (`read_planner.DecodedIntervalCache`)
against the JAX package's: cached reads byte-identical to uncached ones
and to the reference's reads (tolerance 0), the coalesce leader publishing,
hits that feed no decode or hedge statistics, the invalidations
(quarantine, shard remount, unmount and remount), the LRU budget and the
TTL, and the cache disabled. The port's cache, stats and suspicion
registry are its own, so each test starts them empty."""

import os
import shutil
import threading
import time

import numpy as np
import pytest

from seaweedfs_tpu.ec import ec_volume as ref_ec_volume
from seaweedfs_tpu.ec import read_planner as ref_read_planner
from seaweedfs_tpu.ec import stripe as ref_stripe
from seaweedfs_tpu.ops import rs_codec as ref_codec
from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.ec import ec_volume, read_planner, stripe, suspicion
from seaweedfs_tpu_torch.ec.read_planner import CACHE
from seaweedfs_tpu_torch.ops import rs_codec
from seaweedfs_tpu_torch.storage import idx, types

LARGE = 1024
SMALL = 64
ENC = rs_codec.Encoder(10, 4, device="cpu")
REF_ENC = ref_codec.Encoder(10, 4, backend="numpy")


@pytest.fixture(autouse=True)
def _fresh_port_state():
    CACHE.clear()
    yield
    CACHE.clear()
    suspicion.GLOBAL.reset()


def _build(base: str, seed: int, pkg_stripe, enc, nids=(3, 10, 42, 999)) -> dict:
    """The reference fixture's volume: records at 8-aligned offsets after
    an 8-byte superblock, with a matching index."""
    rng = np.random.default_rng(seed)
    records, offset, blobs = {}, types.NEEDLE_PADDING_SIZE, [b"\x03" + bytes(7)]
    for nid in nids:
        body = int(rng.integers(1, 300))
        rec = rng.integers(0, 256, size=types.actual_size(body), dtype=np.uint8).tobytes()
        records[nid] = (offset, body, rec)
        blobs.append(rec)
        offset += len(rec)
    with open(base + ".dat", "wb") as f:
        f.write(b"".join(blobs))
    idx.write_entries(
        [(nid, types.offset_to_bytes(off), size) for nid, (off, size, _) in records.items()],
        base + ".idx",
    )
    pkg_stripe.write_ec_files(base, large_block_size=LARGE, small_block_size=SMALL,
                              buffer_size=64, encoder=enc)
    pkg_stripe.write_sorted_file_from_idx(base)
    return records


@pytest.fixture()
def volume(tmp_path):
    base = str(tmp_path / "v9")
    return base, _build(base, 23, stripe, ENC)


def open_vol(base, **kw):
    kw.setdefault("encoder", ENC)
    kw.setdefault("warm_on_mount", False)
    return ec_volume.EcVolume(base, large_block_size=LARGE, small_block_size=SMALL, **kw)


def enable_cache(monkeypatch, mb="64", ttl="0"):
    monkeypatch.setenv("WEEDTPU_READ_CACHE_MB", mb)
    monkeypatch.setenv("WEEDTPU_READ_CACHE_TTL_S", ttl)


def drop_shards(base, shards):
    for s in shards:
        os.remove(stripe.shard_file_name(base, s))


def test_cached_reads_identical_to_uncached_and_to_reference(tmp_path, monkeypatch):
    """Uncached, cold (decode and publish) and warm (hit) reads give the
    same bytes, in the port and in the reference alike."""
    blobs = {}
    for sub, pkg_stripe, enc, pkg_ev, cache in (
        ("port", stripe, ENC, ec_volume, CACHE),
        ("ref", ref_stripe, REF_ENC, ref_ec_volume, ref_read_planner.CACHE),
    ):
        os.makedirs(tmp_path / sub)
        base = str(tmp_path / sub / "v9")
        records = _build(base, 23, pkg_stripe, enc)
        drop_shards(base, [0, 13])

        def vol(_base=base, _pkg=pkg_ev, _enc=enc):
            return _pkg.EcVolume(_base, encoder=_enc, large_block_size=LARGE,
                                 small_block_size=SMALL, warm_on_mount=False)

        monkeypatch.setenv("WEEDTPU_READ_CACHE_MB", "0")
        with vol() as ev:
            uncached = {nid: ev.read_needle_blob(nid) for nid in records}
        enable_cache(monkeypatch)
        with vol() as ev:
            cold = {nid: ev.read_needle_blob(nid) for nid in records}
            entries = cache.snapshot()["entries"]
            warm = {nid: ev.read_needle_blob(nid) for nid in records}
        blobs[sub] = (uncached, cold, warm, entries)
        cache.clear()
    assert blobs["port"] == blobs["ref"]
    uncached, cold, warm, entries = blobs["port"]
    assert cold == uncached and warm == uncached and entries >= 1
    for nid, (_, _, rec) in records.items():
        assert uncached[nid][: len(rec)] == rec


def test_hit_and_miss_counters_on_cold_and_warm_passes(volume, monkeypatch):
    base, records = volume
    drop_shards(base, [0, 13])
    enable_cache(monkeypatch)
    with open_vol(base) as ev:
        h0, m0 = stats.ReadCacheHits.value, stats.ReadCacheMisses.value
        cold = {nid: ev.read_needle_blob(nid) for nid in records}
        assert stats.ReadCacheHits.value == h0, "cold pass must not hit"
        assert stats.ReadCacheMisses.value > m0
        warm = {nid: ev.read_needle_blob(nid) for nid in records}
        assert stats.ReadCacheHits.value > h0, "warm pass must hit"
    assert warm == cold
    assert stats.ReadCacheBytes.value == CACHE.snapshot()["bytes"] == 0  # close() flushed


def test_coalesce_leader_publishes_into_cache(volume, monkeypatch):
    base, records = volume
    with open(stripe.shard_file_name(base, 0), "rb") as f:
        golden0 = f.read()
    drop_shards(base, [0])
    enable_cache(monkeypatch)
    with open_vol(base, recover_fetch_parallelism=16) as ev:
        decodes = []
        real = ev.encoder.reconstruct

        def counting(shards, wanted=None, **kw):
            decodes.append(1)
            return real(shards, wanted=wanted, **kw)

        monkeypatch.setattr(ev.encoder, "reconstruct", counting)
        results, barrier, lock = [], threading.Barrier(5), threading.Lock()

        def one():
            barrier.wait()
            out = ev._recover_interval(0, 0, 64).tobytes()
            with lock:
                results.append(out)

        threads = [threading.Thread(target=one) for _ in range(5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(20)
        assert len(results) == 5 and all(r == golden0[:64] for r in results)
        assert CACHE.snapshot()["entries"] >= 1, "leader did not publish"
        n_decodes = len(decodes)
        late = ev._read_present(0, 0, 64)
        assert late is not None and late.tobytes() == golden0[:64]
        assert len(decodes) == n_decodes


def test_cache_hits_feed_no_decode_or_hedge_stats(volume, monkeypatch):
    base, records = volume
    drop_shards(base, [0, 1])
    enable_cache(monkeypatch)
    monkeypatch.setenv("WEEDTPU_HEDGE_READS", "1")
    with open_vol(base) as ev:
        warm = {nid: ev.read_needle_blob(nid) for nid in records}  # decode once
        rec0 = stats.EcReconstructSeconds.labels().total
        deg0 = stats.DegradedReadSeconds.labels().total
        hed0, coa0 = stats.HedgeFired.value, stats.CoalescedReads.value
        h0 = stats.ReadCacheHits.value
        for _ in range(3):
            for nid in records:
                assert ev.read_needle_blob(nid) == warm[nid]
        assert stats.ReadCacheHits.value > h0
        assert stats.EcReconstructSeconds.labels().total == rec0
        assert stats.DegradedReadSeconds.labels().total == deg0
        assert stats.HedgeFired.value == hed0
        assert stats.CoalescedReads.value == coa0


def test_quarantine_flushes_volume_entries(volume, monkeypatch):
    base, records = volume
    drop_shards(base, [0])
    enable_cache(monkeypatch)
    with open_vol(base) as ev:
        for nid in records:
            ev.read_needle_blob(nid)
        assert CACHE.snapshot()["entries"] >= 1
        inv0 = stats.ReadCacheInvalidations.value
        ev.quarantine_shard(5, "corrupt")
        assert CACHE.snapshot()["entries"] == 0
        assert stats.ReadCacheInvalidations.value > inv0
        rec0 = stats.EcReconstructSeconds.labels().total
        for nid, (_, _, rec) in records.items():
            assert ev.read_needle_blob(nid)[: len(rec)] == rec
        assert stats.EcReconstructSeconds.labels().total > rec0


def test_shard_remount_flushes_that_shard(volume, monkeypatch):
    base, records = volume
    shutil.copy(stripe.shard_file_name(base, 0), base + ".ec00.save")
    drop_shards(base, [0])
    enable_cache(monkeypatch)
    with open_vol(base) as ev:
        ev._read_shard_interval(0, 0, 64)  # decode and publish for shard 0
        ev._read_shard_interval(3, 0, 64)  # local: never cached
        assert {k[1] for k in CACHE._entries} == {0}
        CACHE.put(base, 7, 0, 64, b"z" * 64, CACHE.generation(base))
        shutil.copy(base + ".ec00.save", stripe.shard_file_name(base, 0))
        assert ev.mount_local_shard(0)
        assert {k[1] for k in CACHE._entries} == {7}, "remount flushed the wrong shard"


def test_unmount_and_remount_serve_fresh_bytes(tmp_path, monkeypatch):
    """close() is the cut-over seam: re-encode different contents under
    the same base, remount, and the read serves the new bytes."""
    enable_cache(monkeypatch)
    base = str(tmp_path / "v5")

    def build(seed):
        for f in os.listdir(tmp_path):
            if f.startswith("v5"):
                os.remove(tmp_path / f)
        rec = _build(base, seed, stripe, ENC, nids=(77,))[77][2]
        drop_shards(base, [0])  # force a degraded read
        return rec

    old_rec = build(1)
    ev = open_vol(base)
    assert ev.read_needle_blob(77)[: len(old_rec)] == old_rec
    assert CACHE.snapshot()["entries"] >= 1
    gen = CACHE.generation(base)
    ev.close()
    assert CACHE.snapshot()["entries"] == 0, "close() left stale intervals"
    # a decode that began before the flush may not publish
    assert not CACHE.put(base, 0, 0, 16, b"y" * 16, gen)
    new_rec = build(2)
    assert new_rec != old_rec
    with open_vol(base) as ev2:
        assert ev2.read_needle_blob(77)[: len(new_rec)] == new_rec


def test_lru_bound_and_ttl_match_reference(monkeypatch):
    enable_cache(monkeypatch, mb=str(4096 / (1 << 20)))  # a 4 KiB budget
    trail = []
    for cache, ev_stats in ((CACHE, stats), (ref_read_planner.CACHE, None)):
        ev0 = stats.ReadCacheEvictions.value
        gen = cache.generation("b")
        puts = [cache.put("b", 0, i * 1024, 1024, bytes([i]) * 1024, gen) for i in range(8)]
        puts.append(cache.put("b", 0, 0, 8192, bytes(8192), gen))  # over the budget
        snap = cache.snapshot()
        got = [cache.get("b", 0, 0, 1024), cache.get("b", 0, 7 * 1024, 1024)]
        trail.append((puts, snap, got))
        if ev_stats is not None:
            assert stats.ReadCacheEvictions.value - ev0 == 4
    assert trail[0] == trail[1]
    puts, snap, got = trail[0]
    assert puts == [True] * 8 + [False]
    assert snap == {"entries": 4, "bytes": 4096}
    assert got == [None, bytes([7]) * 1024]
    monkeypatch.setenv("WEEDTPU_READ_CACHE_TTL_S", "0.05")
    ev0 = stats.ReadCacheEvictions.value
    time.sleep(0.06)
    assert CACHE.get("b", 0, 7 * 1024, 1024) is None, "TTL did not expire the entry"
    assert stats.ReadCacheEvictions.value - ev0 == 1
    ref_read_planner.CACHE.clear()


def test_cache_disabled_is_bypassed(volume, monkeypatch):
    base, records = volume
    drop_shards(base, [0])
    monkeypatch.setenv("WEEDTPU_READ_CACHE_MB", "0")
    h0, m0 = stats.ReadCacheHits.value, stats.ReadCacheMisses.value
    with open_vol(base) as ev:
        for nid, (_, _, rec) in records.items():
            assert ev.read_needle_blob(nid)[: len(rec)] == rec
            assert ev.read_needle_blob(nid)[: len(rec)] == rec
    assert CACHE.snapshot() == {"entries": 0, "bytes": 0}
    assert (stats.ReadCacheHits.value, stats.ReadCacheMisses.value) == (h0, m0)
    assert not CACHE.put(base, 0, 0, 8, bytes(8), CACHE.generation(base))


def test_cache_is_on_by_default(monkeypatch):
    """The production default: a 64 MiB budget with a 30 s epoch."""
    monkeypatch.delenv("WEEDTPU_READ_CACHE_MB", raising=False)
    monkeypatch.delenv("WEEDTPU_READ_CACHE_TTL_S", raising=False)
    assert CACHE.enabled() and ref_read_planner.CACHE.enabled()
    assert CACHE._cap_bytes() == ref_read_planner.CACHE._cap_bytes() == 64 << 20
