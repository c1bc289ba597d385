"""The port's degraded read (`EcVolume` + `ReadPlanner`) against the JAX
package's: the same seeded volume, encoded by each package's stripe engine,
read through the reference `EcVolume` (numpy encoder) and the port's
(`Encoder(10, 4, device="cpu")`). Every needle's blob must be byte-identical
(tolerance 0) and every error the same typed class, under shard loss, a
truncated shard, journal compaction, an injected remote reader (moved,
hung, failing, wedged and slow holders) and concurrent decodes. Timing
cases keep the reference tests' own margins. Also the Encoder's bucketed
reconstruct against the reference's `jax` and interpret-mode `pallas`
backends, and the rule that a card encoder never falls back to the plain
version."""

import os
import shutil
import sys
import threading
import time

import numpy as np
import pytest

from seaweedfs_tpu.ec import ec_volume as ref_ec_volume
from seaweedfs_tpu.ec import read_planner as ref_read_planner
from seaweedfs_tpu.ec import stripe as ref_stripe
from seaweedfs_tpu.ec import suspicion as ref_suspicion
from seaweedfs_tpu.ops import rs_codec as ref_codec
from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.ec import ec_volume, read_planner, stripe, suspicion
from seaweedfs_tpu_torch.ops import rs_codec
from seaweedfs_tpu_torch.storage import idx, types

LARGE = 1024
SMALL = 64
ENC = rs_codec.Encoder(10, 4, device="cpu")
REF_ENC = ref_codec.Encoder(10, 4, backend="numpy")
NEEDLES = [3, 10, 42, 999, 2**40 + 5]


@pytest.fixture(autouse=True)
def _fresh_port_state():
    """The port keeps its own process-wide cache and suspicion registry
    (the reference's are reset by conftest)."""
    yield
    read_planner.CACHE.clear()
    suspicion.GLOBAL.reset()


def _write(base: str, records: dict, pkg_stripe, enc) -> None:
    blobs = [b"\x03" + bytes(7)]
    for off, size, rec in records.values():
        blobs.append(rec)
    with open(base + ".dat", "wb") as f:
        f.write(b"".join(blobs))
    idx.write_entries(
        [(nid, types.offset_to_bytes(off), size) for nid, (off, size, _) in records.items()],
        base + ".idx",
    )
    pkg_stripe.write_ec_files(base, large_block_size=LARGE, small_block_size=SMALL,
                              buffer_size=64, encoder=enc)
    pkg_stripe.write_sorted_file_from_idx(base)


def _records(seed: int = 11) -> dict:
    """needle id -> (offset, body size, record bytes): the reference
    fixture's construction (records at 8-aligned offsets after an 8-byte
    superblock)."""
    rng = np.random.default_rng(seed)
    records, offset = {}, types.NEEDLE_PADDING_SIZE
    for nid in NEEDLES:
        body = int(rng.integers(1, 300))
        total = types.actual_size(body, version=3)
        records[nid] = (offset, body, rng.integers(0, 256, size=total, dtype=np.uint8).tobytes())
        offset += total
    return records


@pytest.fixture()
def pair(tmp_path):
    """The same volume encoded by each package: (port base, ref base, records)."""
    records = _records()
    bases = []
    for sub, pkg_stripe, enc in (("port", stripe, ENC), ("ref", ref_stripe, REF_ENC)):
        os.makedirs(tmp_path / sub)
        base = str(tmp_path / sub / "v7")
        _write(base, records, pkg_stripe, enc)
        bases.append(base)
    for ext in [stripe.to_ext(s) for s in range(14)] + [".ecx", ".eci"]:
        with open(bases[0] + ext, "rb") as a, open(bases[1] + ext, "rb") as b:
            assert a.read() == b.read(), ext
    return bases[0], bases[1], records


def open_port(base, **kw):
    kw.setdefault("encoder", ENC)
    return ec_volume.EcVolume(base, large_block_size=LARGE, small_block_size=SMALL, **kw)


def open_ref(base, **kw):
    kw.setdefault("encoder", REF_ENC)
    return ref_ec_volume.EcVolume(base, large_block_size=LARGE, small_block_size=SMALL, **kw)


def outcome(ev, nid):
    """A read's blob, or the name of the error class it raised."""
    try:
        return ev.read_needle_blob(nid)
    except Exception as e:  # noqa: BLE001 — the class is the outcome
        return type(e).__name__


def outcomes(ev, nids=None) -> dict:
    return {nid: outcome(ev, nid) for nid in (nids or NEEDLES + [12345])}


def both(pair, lost=(), port_kw=None, ref_kw=None) -> tuple[dict, dict]:
    port_base, ref_base, _ = pair
    for base in (port_base, ref_base):
        for s in lost:
            os.remove(stripe.shard_file_name(base, s))
    with open_port(port_base, **(port_kw or {})) as ev:
        got = outcomes(ev)
    with open_ref(ref_base, **(ref_kw or {})) as ev:
        want = outcomes(ev)
    return got, want


def assert_records(got: dict, records: dict) -> None:
    for nid, (_, _, rec) in records.items():
        assert isinstance(got[nid], bytes) and got[nid][: len(rec)] == rec, nid


def test_every_needle_intact(pair):
    got, want = both(pair)
    assert got == want
    assert_records(got, pair[2])
    assert got[12345] == "NeedleNotFound"


def test_not_found_and_deleted_survive_a_reopen(pair):
    port_base, ref_base, records = pair
    seen = []
    for base, opener in ((port_base, open_port), (ref_base, open_ref)):
        with opener(base) as ev:
            first = (ev.delete_needle(42), ev.delete_needle(42), ev.delete_needle(12345))
            now = outcomes(ev)
        with opener(base) as ev:  # the journal persisted
            seen.append((first, now, outcomes(ev)))
    assert seen[0] == seen[1]
    first, now, reopened = seen[0]
    assert first == (True, False, False)
    assert now[42] == reopened[42] == "NeedleDeleted"
    assert now[12345] == "NeedleNotFound"
    with open(port_base + ".ecj", "rb") as a, open(ref_base + ".ecj", "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("lost", [(0, 4, 11, 13), (0, 5, 10, 13), (0,), (7,), (13,)],
                         ids=lambda t: "-".join(map(str, t)))
def test_degraded_reads_under_loss(pair, lost):
    got, want = both(pair, lost)
    assert got == want
    assert_records(got, pair[2])


def test_five_lost_raise_the_typed_error(pair):
    got, want = both(pair, lost=range(5))
    assert got == want
    recovering = [nid for nid in NEEDLES if got[nid] == "EcNoViableHolders"]
    assert recovering, "some needle must need a lost data shard"
    with open_port(pair[0]) as ev:
        with pytest.raises(IOError, match="surviving") as ei:
            ev.read_needle_blob(recovering[0])
    assert isinstance(ei.value, ec_volume.EcDegradedReadError)
    assert ei.value.retry_after == ref_ec_volume.EcNoViableHolders.retry_after


def test_truncated_shard_reconstructs(pair):
    for base in pair[:2]:
        p = stripe.shard_file_name(base, 0)
        with open(p, "r+b") as f:
            f.truncate(os.path.getsize(p) // 2)
    got, want = both(pair)
    assert got == want
    assert_records(got, pair[2])


def test_ecj_compaction_at_the_mount_threshold(pair):
    port_base, ref_base, records = pair
    seen = []
    for base, opener in ((port_base, open_port), (ref_base, open_ref)):
        with opener(base) as ev:
            ev.delete_needle(42)
            ev.delete_needle(999)
        with opener(base, ecj_compact_threshold=1 << 20) as ev:  # below: kept
            kept = os.path.exists(base + ".ecj")
        with opener(base, ecj_compact_threshold=8) as ev:  # at/above: folded
            reads = outcomes(ev)
        seen.append((kept, os.path.exists(base + ".ecj"), reads))
        stripe.write_idx_file_from_ec_index(base)
    assert seen[0] == seen[1]
    assert seen[0][:2] == (True, False)
    assert seen[0][2][42] == seen[0][2][999] == "NeedleDeleted"
    for ext in (".ecx", ".idx"):
        with open(port_base + ext, "rb") as a, open(ref_base + ext, "rb") as b:
            assert a.read() == b.read(), ext


# -- the injected remote reader -------------------------------------------------


def _move_remote(base: str, shards, gone=()) -> str:
    """Move `shards` to a "remote" directory beside the volume, and delete
    the remote copies of `gone`; returns that directory."""
    remote_dir = os.path.join(os.path.dirname(base), "remote")
    os.makedirs(remote_dir, exist_ok=True)
    for s in shards:
        shutil.move(stripe.shard_file_name(base, s), os.path.join(remote_dir, f"v7.ec{s:02d}"))
    for s in gone:
        os.remove(os.path.join(remote_dir, f"v7.ec{s:02d}"))
    return remote_dir


def _fetcher(remote_dir: str):
    def fetch(shard_id, offset, size):
        p = os.path.join(remote_dir, f"v7.ec{shard_id:02d}")
        if not os.path.exists(p):
            return None
        with open(p, "rb") as f:
            f.seek(offset)
            return f.read(size)

    return fetch


def _on_shard(ev, shard, avoiding=()):
    """Needles with an interval on `shard` and none on `avoiding`."""
    out = []
    for nid in NEEDLES:
        sids = {iv.to_shard_id_and_offset(LARGE, SMALL)[0] for iv in ev.locate_needle(nid)[2]}
        if shard in sids and not (sids & set(avoiding)):
            out.append(nid)
    return out


def test_remote_reader_serves_moved_shards(pair):
    calls = {}
    for name, base in zip(("port", "ref"), pair[:2]):
        fetch = _fetcher(_move_remote(base, range(5)))

        def remote(shard_id, offset, size, _fetch=fetch, _name=name):
            calls.setdefault(_name, []).append(shard_id)
            return _fetch(shard_id, offset, size)

        opener = open_port if name == "port" else open_ref
        with opener(base, remote_reader=remote) as ev:
            calls[name + "_out"] = outcomes(ev)
    assert calls["port_out"] == calls["ref_out"]
    assert_records(calls["port_out"], pair[2])
    assert calls["port"], "the remote reader was never consulted"


def test_recover_tolerates_hung_and_failing_peers(pair):
    """One peer raises and one hangs past the deadline: the read still
    completes from the other survivors, without waiting on the hung one
    (the reference test's margins)."""
    port_base, ref_base, records = pair
    results = []
    for base, opener in ((port_base, open_port), (ref_base, open_ref)):
        fetch = _fetcher(_move_remote(base, range(10), gone=(0,)))

        def remote(shard_id, offset, size, _fetch=fetch):
            if shard_id == 1:
                raise ConnectionError("peer down")
            if shard_id == 2:
                time.sleep(5.0)  # hung peer
                return None
            return _fetch(shard_id, offset, size)

        with opener(base, remote_reader=remote, recover_fetch_parallelism=16,
                    recover_fetch_deadline=3.0) as ev:
            t0 = time.monotonic()
            blob = ev.read_needle_blob(3)
            results.append((blob, time.monotonic() - t0))
    assert results[0][0] == results[1][0]
    assert results[0][0][: len(records[3][2])] == records[3][2]
    assert results[0][1] < 3.0, "read waited on the hung peer"


def test_no_viable_holders_carries_context(pair):
    port_base, ref_base, _ = pair
    errs = []
    for base, opener in ((port_base, open_port), (ref_base, open_ref)):
        for s in range(5):
            os.remove(stripe.shard_file_name(base, s))
        calls = []

        def reader(shard_id, offset, size, _calls=calls):
            _calls.append(shard_id)
            return None  # a fast miss everywhere

        with opener(base, remote_reader=reader, warm_on_mount=False) as ev:
            nid = _on_shard(ev, 0)[0]
            with pytest.raises(IOError, match="surviving") as ei:
                ev.read_needle_blob(nid)
        errs.append((ei.value, sorted(set(calls))))
    (mine, my_calls), (ref, ref_calls) = errs
    assert type(mine).__name__ == type(ref).__name__ == "EcNoViableHolders"
    assert isinstance(mine, ec_volume.EcDegradedReadError)
    assert str(mine) == str(ref)
    assert (mine.shard_id, mine.suspected, mine.retry_after) == (
        ref.shard_id, ref.suspected, ref.retry_after)
    # the holder keys name the volume's own base; the shard ids must agree
    assert [k[2] for k in mine.attempted] == [k[2] for k in ref.attempted]
    assert my_calls == ref_calls and my_calls
    assert stats.DegradedReadErrors.labels("EcNoViableHolders").value >= 1


def test_degraded_timeout_is_typed(pair):
    port_base = pair[0]
    for s in range(5):
        os.remove(stripe.shard_file_name(port_base, s))
    release = threading.Event()

    def hang(shard_id, offset, size):
        release.wait(5.0)
        return None

    errs0 = stats.DegradedReadErrors.labels("EcDegradedReadTimeout").value
    try:
        with open_port(port_base, remote_reader=hang, warm_on_mount=False,
                       recover_fetch_deadline=0.4) as ev:
            with pytest.raises(ec_volume.EcDegradedReadTimeout) as ei:
                ev.read_needle_blob(_on_shard(ev, 0)[0])
    finally:
        release.set()
    assert "deadline expired" in str(ei.value) and "surviving" in str(ei.value)
    assert ei.value.attempted
    assert ei.value.retry_after == ref_read_planner.EcDegradedReadTimeout.retry_after
    assert stats.DegradedReadErrors.labels("EcDegradedReadTimeout").value > errs0


def test_wedged_holder_costs_one_capped_wait(pair):
    """A wedged holder the reconstruct needs costs one per-holder cap, not
    the overall deadline; then it sits suspected and the next read fails
    fast (the reference test's margins)."""
    base = pair[0]
    fetch = _fetcher(_move_remote(base, range(10), gone=(0, 1, 2, 4)))
    wedge = threading.Event()

    def remote(shard_id, offset, size):
        if shard_id == 3:
            wedge.wait(30.0)  # no answer, no error
            return None
        return fetch(shard_id, offset, size)

    try:
        with open_port(base, remote_reader=remote, recover_fetch_parallelism=16,
                       recover_fetch_deadline=30.0, recover_holder_timeout=0.6,
                       recover_holder_backoff=60.0) as ev:
            on_missing = _on_shard(ev, 0)
            t0 = time.monotonic()
            with pytest.raises(IOError, match="surviving"):
                ev.read_needle_blob(on_missing[0])
            dt = time.monotonic() - t0
            assert 0.5 <= dt < 5.0, f"expected ~0.6 s per-holder cap, took {dt:.2f} s"
            assert ev._holder_suspected(3)
            t0 = time.monotonic()
            with pytest.raises(IOError, match="surviving"):
                ev.read_needle_blob(on_missing[-1])
            assert time.monotonic() - t0 < 0.4, "suspected holder was re-waited on"
    finally:
        wedge.set()


def test_wedged_peer_suspected_across_volumes(pair, tmp_path):
    """Readers that name the peer share suspicion through one registry:
    volume A's capped attempt marks the peer, and volume B skips it
    without calling its reader."""
    base_a = pair[0]
    base_b = str(tmp_path / "v8")
    for ext in [".ecx", ".eci"] + [stripe.to_ext(s) for s in range(14)]:
        shutil.copy(base_a + ext, base_b + ext)
    calls = {"a": 0, "b": 0}
    wedge = threading.Event()

    def reader_a(shard_id, offset, size):
        calls["a"] += 1
        wedge.wait(30.0)
        return None

    def reader_b(shard_id, offset, size):
        calls["b"] += 1
        return None

    reader_a.peer_for = reader_b.peer_for = lambda shard_id: "10.0.0.9:18080"
    reg = suspicion.HolderSuspicion()
    try:
        with open_port(base_a, remote_reader=reader_a, warm_on_mount=False,
                       recover_holder_timeout=0.3, recover_holder_backoff=60.0,
                       suspicion=reg) as ev_a, \
                open_port(base_b, remote_reader=reader_b, warm_on_mount=False,
                          recover_holder_backoff=60.0, suspicion=reg) as ev_b:
            assert ev_a._remote_fetch_capped(0, 0, 16) is None
            assert calls["a"] == 1 and ev_a._holder_suspected(0)
            assert ev_b._holder_suspected(0) and ev_b._holder_suspected(5)
            assert ev_b._remote_fetch_capped(0, 0, 16) is None
            assert calls["b"] == 0
    finally:
        wedge.set()
    # a reader that cannot name peers keeps suspicion per volume, and an
    # unmount forgets it
    reg = suspicion.HolderSuspicion()
    with open_port(base_a, remote_reader=lambda s, o, n: None, warm_on_mount=False,
                   suspicion=reg) as ev_a, \
            open_port(base_b, remote_reader=lambda s, o, n: None, warm_on_mount=False,
                      suspicion=reg) as ev_b:
        ev_a._mark_holder_suspect(3)
        assert ev_a._holder_suspected(3) and not ev_a._holder_suspected(4)
        assert not ev_b._holder_suspected(3)
    with open_port(base_a, remote_reader=lambda s, o, n: None, warm_on_mount=False,
                   suspicion=reg) as ev_a:
        assert not ev_a._holder_suspected(3)


def test_hedge_delay_matches_reference(pair, monkeypatch):
    port_base, ref_base, _ = pair
    with open_port(port_base, warm_on_mount=False, recover_holder_timeout=2.0) as ev, \
            open_ref(ref_base, warm_on_mount=False, recover_holder_timeout=2.0) as rv:
        for fixed in ("123", "0", ""):
            monkeypatch.setenv("WEEDTPU_HEDGE_DELAY_MS", fixed)
            assert ev._hedge_delay(0) == rv._hedge_delay(0)
        monkeypatch.delenv("WEEDTPU_HEDGE_DELAY_MS")
        for s in (0.10, 0.12, 0.08, 0.11):  # a measured peer
            ev._suspicion.observe_latency(ev.planner._holder_key(2), s)
            rv._suspicion.observe_latency(rv.planner._holder_key(2), s)
        assert ev._hedge_delay(2) == rv._hedge_delay(2)
        assert ev._hedge_delay(0) == pytest.approx(min(max(0.05, 5.0 / 2.0), 1.0))


def test_hedged_fetch_first_success_wins(pair, monkeypatch):
    """A wedged survivor on the critical path: the backup launches at the
    configured delay against the other holder, wins, and the read ends far
    under the wedge; the loser drains byte-identical (the reference test's
    margins)."""
    base, records = pair[0], pair[2]
    fetch = _fetcher(_move_remote(base, range(10), gone=(0, 7, 8, 9)))
    slow_gate = threading.Event()
    via_calls = []

    def remote(shard_id, offset, size):
        if shard_id == 3:
            slow_gate.wait(10.0)
        return fetch(shard_id, offset, size)

    def via(addr, shard_id, offset, size):
        via_calls.append((addr, shard_id, time.monotonic()))
        return fetch(shard_id, offset, size)

    remote.via = via
    remote.holders_for = lambda sid: ["peerA:1", "peerB:2"]
    remote.peer_for = lambda sid: "peerA:1"
    monkeypatch.setenv("WEEDTPU_HEDGE_DELAY_MS", "100")
    fired0, won0 = stats.HedgeFired.value, stats.HedgeWon.value
    mism0 = stats.DegradedReadErrors.labels("HedgeMismatch").value
    try:
        with open_port(base, remote_reader=remote, warm_on_mount=False,
                       recover_fetch_parallelism=16, recover_fetch_deadline=10.0,
                       recover_holder_timeout=8.0) as ev:
            nid = _on_shard(ev, 0, avoiding=(3,))[0]
            t0 = time.monotonic()
            got = ev.read_needle_blob(nid)
            dt = time.monotonic() - t0
            assert got[: len(records[nid][2])] == records[nid][2]
            assert dt < 2.0, f"read waited on the wedged primary ({dt:.2f} s)"
            assert stats.HedgeFired.value - fired0 >= 1
            assert stats.HedgeWon.value - won0 >= 1
            hedge3 = [c for c in via_calls if c[1] == 3]
            assert hedge3 and hedge3[0][0] == "peerB:2"
            assert 0.09 <= hedge3[0][2] - t0 <= 0.6
    finally:
        slow_gate.set()
    time.sleep(0.3)
    assert stats.DegradedReadErrors.labels("HedgeMismatch").value == mism0


@pytest.mark.parametrize("coalesce", ["1", "0"])
def test_concurrent_decodes_coalesce(pair, monkeypatch, coalesce):
    """Concurrent degraded reads of one interval: with coalescing one
    decode serves every waiter; without, each reader decodes. Every waiter
    gets the shard's bytes."""
    base = pair[0]
    with open(stripe.shard_file_name(base, 0), "rb") as f:
        golden0 = f.read()
    fetch = _fetcher(_move_remote(base, range(10), gone=(0,)))

    def remote(shard_id, offset, size):
        time.sleep(0.08)  # widen the coalesce window
        return fetch(shard_id, offset, size)

    monkeypatch.setenv("WEEDTPU_COALESCE_READS", coalesce)
    with open_port(base, remote_reader=remote, warm_on_mount=False,
                   recover_fetch_parallelism=32) as ev:
        decodes = []
        real = ev.encoder.reconstruct

        def counting(shards, wanted=None, **kw):
            decodes.append(1)
            return real(shards, wanted=wanted, **kw)

        monkeypatch.setattr(ev.encoder, "reconstruct", counting)
        n = 6 if coalesce == "1" else 4
        results, lock, barrier = [], threading.Lock(), threading.Barrier(n)

        def one():
            barrier.wait()
            out = ev._recover_interval(0, 0, 64).tobytes()
            with lock:
                results.append(out)

        coal0 = stats.CoalescedReads.value
        threads = [threading.Thread(target=one) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(20)
    assert len(results) == n and all(r == golden0[:64] for r in results)
    if coalesce == "1":
        assert len(decodes) <= 2, f"{len(decodes)} decodes for one hot interval"
        assert stats.CoalescedReads.value - coal0 >= 4
    else:
        assert len(decodes) == n


def test_multi_interval_needle_decodes_in_one_batch(tmp_path, monkeypatch):
    """A needle whose record crosses rows puts several intervals on one
    lost shard: `read_intervals` decodes them in one bucketed
    `reconstruct_batch` (ref read_planner.py:1027), byte-identical to the
    reference."""
    rng = np.random.default_rng(5)
    body = 3 * 10 * SMALL  # three small rows
    records = {77: (8, body, rng.integers(0, 256, types.actual_size(body), np.uint8).tobytes())}
    bases = []
    for sub, pkg_stripe, enc in (("port", stripe, ENC), ("ref", ref_stripe, REF_ENC)):
        os.makedirs(tmp_path / sub)
        base = str(tmp_path / sub / "v7")
        _write(base, records, pkg_stripe, enc)
        for s in (0, 5, 10, 13):
            os.remove(stripe.shard_file_name(base, s))
        bases.append(base)
    batches = []
    real = rs_codec.Encoder.reconstruct_batch

    def spy(self, stack, survivors, wanted, bucketed=False):
        batches.append((tuple(stack.shape), tuple(wanted), bucketed))
        return real(self, stack, survivors, wanted, bucketed=bucketed)

    monkeypatch.setattr(rs_codec.Encoder, "reconstruct_batch", spy)
    with open_port(bases[0]) as ev, open_ref(bases[1]) as rv:
        got, want = ev.read_needle_blob(77), rv.read_needle_blob(77)
    assert got == want and got[: len(records[77][2])] == records[77][2]
    assert {(wanted, b) for _, wanted, b in batches} == {((0,), True), ((5,), True)}
    assert all(shape[0] >= 3 for shape, _, _ in batches), batches


# -- mount-time checks -----------------------------------------------------------


def test_geometry_refusals_match_reference(pair):
    port_base, ref_base, _ = pair
    for base in (port_base, ref_base):  # a stray shard id past 10+4
        shutil.copy(stripe.shard_file_name(base, 0), stripe.shard_file_name(base, 14))
    with pytest.raises(ec_volume.EcGeometryError) as mine:
        open_port(port_base)
    with pytest.raises(ref_ec_volume.EcGeometryError) as ref:
        open_ref(ref_base)
    assert mine.value.details == ref.value.details
    for base in (port_base, ref_base):  # a journaled cut-over not yet finished
        os.remove(stripe.shard_file_name(base, 14))
        with open(base + ".ecc", "w") as f:
            f.write('{"type": "begin"}\n{"type": "cutover"}\n')
    with pytest.raises(ec_volume.EcGeometryError) as mine:
        open_port(port_base)
    with pytest.raises(ref_ec_volume.EcGeometryError) as ref:
        open_ref(ref_base)
    assert mine.value.details == ref.value.details == {"pending_cutover": True}


def test_verify_local_shards_and_quarantine_match_reference(pair):
    port_base, ref_base, records = pair
    for base in (port_base, ref_base):
        with open(stripe.shard_file_name(base, 2), "r+b") as f:
            first = f.read(1)[0]
            f.seek(0)
            f.write(bytes([first ^ 0xFF]))  # bit rot in shard 2
    with open_port(port_base) as ev, open_ref(ref_base) as rv:
        assert ev.verify_local_shards() == rv.verify_local_shards()
        assert ev.verify_local_shards()[2] is False
        assert ev.quarantine_shard(2) == rv.quarantine_shard(2) is True
        assert ev.shard_ids == rv.shard_ids
        got, want = outcomes(ev), outcomes(rv)
        assert got == want
        assert_records(got, records)
        assert ev.mount_local_shard(2) == rv.mount_local_shard(2) is True
        assert ev.quarantined == rv.quarantined == {}


# -- the Encoder pieces the read path dispatches through ------------------------


@pytest.mark.parametrize("ref_backend", ["jax", "pallas"])
@pytest.mark.parametrize("batch, n", [(1, 4096), (3, 100), (2, 4095)])
def test_bucketed_reconstruct_batch_matches_reference(ref_backend, batch, n):
    """`reconstruct_batch(bucketed=True)` at and under the 4 KiB bucket:
    the reference's jax (XLA) and interpret-mode pallas backends pad to
    4096, the port's CPU encoder does not pad; the bytes agree."""
    ref = ref_codec.Encoder(10, 4, backend=ref_backend)
    rng = np.random.default_rng(batch * n)
    data = rng.integers(0, 256, (batch, 10, n), np.uint8)
    full = np.concatenate([data, np.stack([np.stack(ENC.encode(list(d))[10:]) for d in data])], 1)
    survivors, wanted = [1, 2, 3, 4, 6, 7, 8, 9, 11, 12], [0, 5]
    stack = full[:, survivors]
    got = ENC.reconstruct_batch(stack, survivors, wanted, bucketed=True)
    want = ref.reconstruct_batch(stack, survivors, wanted, bucketed=True)
    assert got.shape == want.shape == (batch, 2, n)
    assert np.array_equal(got, want)
    assert np.array_equal(got, full[:, wanted])
    assert np.array_equal(ENC.reconstruct_batch(stack, survivors, wanted), got)


def test_bucket_rule_and_warm_counts_match_reference():
    card = rs_codec.Encoder(10, 4, device="cuda")  # built, never launched here
    assert rs_codec.Encoder.RECONSTRUCT_BUCKETS == ref_codec.Encoder.RECONSTRUCT_BUCKETS
    for n in (0, 1, 4095, 4096, 4097, 65536, 65537, 1 << 20, (1 << 20) + 1):
        assert card._bucket_for(n) == ref_codec.Encoder(10, 4, backend="jax")._bucket_for(n)
        assert ENC._bucket_for(n) == REF_ENC._bucket_for(n) is None
    assert ENC.warm_reconstruct() == REF_ENC.warm_reconstruct() == 0
    for local in ((), (0, 5, 13), tuple(range(14))):
        assert ENC.warm_decode_matrices(local) == REF_ENC.warm_decode_matrices(local)
    data = np.random.default_rng(2).integers(0, 256, (10, 333), np.uint8)
    shards = ENC.encode(list(data))
    lost = [None if i in (1, 11) else s for i, s in enumerate(shards)]
    got, want = ENC.reconstruct_data(list(lost)), REF_ENC.reconstruct_data(list(lost))
    assert all((a is None and b is None) or np.array_equal(a, b) for a, b in zip(got, want))
    assert got[11] is None and np.array_equal(got[1], shards[1])


def test_card_encoder_never_falls_back_to_the_plain_version(pair, monkeypatch):
    """Without a card, `EcVolume(base)` raises (its default encoder is the
    factory's, on the card), and a volume handed a card encoder still
    serves intact needles, while a read that must decode raises instead of
    running the plain version."""
    import torch

    port_base, _, records = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ec_volume.EcVolume(port_base, large_block_size=LARGE, small_block_size=SMALL)
    os.remove(stripe.shard_file_name(port_base, 0))
    card = rs_codec.Encoder(10, 4, device="cuda")
    with open_port(port_base, encoder=card, warm_on_mount=False) as ev:
        on_lost = set(_on_shard(ev, 0))
        for nid in NEEDLES:
            if nid in on_lost:
                with pytest.raises((RuntimeError, AssertionError)):
                    ev.read_needle_blob(nid)
            else:
                assert ev.read_needle_blob(nid)[: len(records[nid][2])] == records[nid][2]
    assert on_lost


def test_reads_from_threads_share_shard_handles_safely(tmp_path):
    """Readers on 8 threads share one volume's shard handles: every blob
    equals the .dat's bytes. The reference's `_read_local` (a seek, then a
    read, on the shared handle) served another read's bytes here; the
    port reads by position."""
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(21)
    records, offset, blobs = {}, 8, [b"\x03" + bytes(7)]
    for nid in range(1, 97):
        rec = rng.integers(0, 256, types.actual_size(int(rng.integers(16 << 10, 96 << 10))),
                           np.uint8).tobytes()
        records[nid] = rec
        blobs.append(rec)
        offset += len(rec)
    base = str(tmp_path / "v3")
    with open(base + ".dat", "wb") as f:
        f.write(b"".join(blobs))
    offsets = np.cumsum([8] + [len(r) for r in records.values()])[:-1]
    idx.write_entries([(nid, int(off) // 8, types.actual_size(0)) for nid, off in
                       zip(records, offsets)], base + ".idx")
    stripe.write_ec_files(base, large_block_size=1 << 20, small_block_size=16384,
                          buffer_size=16384, encoder=ENC)
    stripe.write_sorted_file_from_idx(base)
    with ec_volume.EcVolume(base, encoder=ENC, warm_on_mount=False) as ev:
        # each record's region of the .dat, read as intervals of local shards
        spans = {nid: (int(off), len(records[nid])) for nid, off in zip(records, offsets)}

        def read(nid):
            off, n = spans[nid]
            ivs = ec_volume.locate_mod.locate_data(ev.large, ev.small, ev.dat_file_size, off, n)
            return nid, ev.read_intervals(ivs)

        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            with ThreadPoolExecutor(8) as pool:
                got = list(pool.map(read, list(records) * 6, timeout=120))
        finally:
            sys.setswitchinterval(interval)
    bad = [nid for nid, blob in got if blob != records[nid]]
    assert not bad, f"{len(bad)} of {len(got)} threaded reads served other bytes"
