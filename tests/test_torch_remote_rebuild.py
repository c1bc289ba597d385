"""The remote-survivor rebuild in the port against the JAX package's:
`RemoteSlabSource` with an injected `fetch` (mid-pipeline failover,
least-inflight striping across holders, the bounded holder re-lookup, the
rebuild's span carried onto fetch threads), drain-and-unlink when every
holder dies, and `rebuild_ec_files_from_sources` over remote sources equal
to the local rebuild and to the reference's on the same fetches. Also the
slice's knobs, and that a card encoder without a card raises from each
of the three rebuild entry points instead of running the plain version.
All byte comparisons exact."""

import os
import shutil
import threading

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ec import stripe as ref_stripe
from seaweedfs_tpu.ops import rs_codec as ref_codec
from seaweedfs_tpu.utils import config as ref_config
from seaweedfs_tpu_torch.ec import stripe
from seaweedfs_tpu_torch.obs import trace
from seaweedfs_tpu_torch.ops import rs_codec
from seaweedfs_tpu_torch.utils import config

ENC = rs_codec.Encoder(10, 4, device="cpu")
REF = ref_codec.Encoder(10, 4, backend="numpy")
LARGE, SMALL = 16384, 4096


def _volume(d, size: int = 400_000, seed: int = 5):
    """A 10+4 shard set written by the port; -> (base, {shard: bytes})."""
    base = os.path.join(str(d), "v")
    rng = np.random.default_rng(seed)
    with open(base + ".dat", "wb") as f:
        f.write(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
    stripe.write_ec_files(base, LARGE, SMALL, encoder=ENC)
    golden = {}
    for s in range(14):
        with open(stripe.shard_file_name(base, s), "rb") as f:
            golden[s] = f.read()
    return base, golden


def _file_fetch(base: str, shard_id: int):
    """fetch(addr, offset, size) reading the shard file by position."""

    def fetch(addr: str, offset: int, size: int) -> bytes:
        with open(stripe.shard_file_name(base, shard_id), "rb") as f:
            return os.pread(f.fileno(), size, offset)

    return fetch


def _read(base: str, s: int) -> bytes:
    with open(stripe.shard_file_name(base, s), "rb") as f:
        return f.read()


def test_failover_mid_pipeline_equals_reference(tmp_path):
    """The first holder dies after its third fetch: later windows go to the
    second with the pipeline and its earlier output intact. The port and
    the reference, on the same fetches, rebuild the same bytes."""
    (tmp_path / "port").mkdir()
    base, golden = _volume(tmp_path / "port")
    missing = [0, 5, 11, 13]
    for s in missing:
        os.unlink(stripe.shard_file_name(base, s))
    shutil.copytree(tmp_path / "port", tmp_path / "ref")
    ref_base = os.path.join(str(tmp_path / "ref"), "v")
    present = [s for s in range(14) if s not in missing]
    results = {}
    for name, mod, b, enc in (("port", stripe, base, ENC), ("ref", ref_stripe, ref_base, REF)):
        calls = {"dead": 0, "live": 0}
        lock = threading.Lock()
        sources = {}
        for s in present:
            real = _file_fetch(b, s)

            def fetch(addr, offset, size, _real=real):
                with lock:
                    calls[addr] += 1
                    dying = addr == "dead" and calls["dead"] > 3
                if dying:
                    raise IOError("holder gone")
                return _real(addr, offset, size)

            sources[s] = mod.RemoteSlabSource(s, ["dead", "live"], fetch)
        try:
            rebuilt = mod.rebuild_ec_files_from_sources(
                b, sources, len(golden[1]), encoder=enc,
                buffer_size=8192, max_batch_bytes=10 * 2 * 8192,
            )
        finally:
            for src in sources.values():
                src.close()
        assert rebuilt == missing
        assert calls["live"] > 0
        assert any(src.failovers == ["dead"] for src in sources.values())
        assert sum(src.bytes_fetched for src in sources.values()) >= 10 * len(golden[1])
        results[name] = {s: _read(b, s) for s in range(14)}
    assert results["port"] == results["ref"] == golden


def test_holders_all_die_drains_and_unlinks(tmp_path):
    base, golden = _volume(tmp_path)
    missing = [10, 11, 12, 13]
    for s in missing:
        os.unlink(stripe.shard_file_name(base, s))
    present = [s for s in range(14) if s not in missing]
    calls = {"n": 0}
    lock = threading.Lock()
    sources = {}
    for s in present:
        real = _file_fetch(base, s)

        def fetch(addr, offset, size, _real=real):
            with lock:
                calls["n"] += 1
                lost = calls["n"] > 12
            if lost:
                raise IOError("cluster lost")
            return _real(addr, offset, size)

        sources[s] = stripe.RemoteSlabSource(s, ["only"], fetch)
    try:
        with pytest.raises(IOError, match="no reachable holder"):
            stripe.rebuild_ec_files_from_sources(
                base, sources, len(golden[1]), encoder=ENC,
                buffer_size=8192, max_batch_bytes=10 * 2 * 8192,
            )
    finally:
        for src in sources.values():
            src.close()
    for s in missing:
        assert not os.path.exists(stripe.shard_file_name(base, s))
    for s in present:
        assert _read(base, s) == golden[s]


@pytest.mark.parametrize("missing", [[2, 12], [0, 5, 10, 13], [7]])
def test_remote_sources_equal_local_rebuild_and_reference(tmp_path, missing):
    (tmp_path / "remote").mkdir()
    base, golden = _volume(tmp_path / "remote", size=123_457)
    for s in missing:
        os.unlink(stripe.shard_file_name(base, s))
    for d in ("local", "ref"):
        shutil.copytree(tmp_path / "remote", tmp_path / d)
    local_base, ref_base = (os.path.join(str(tmp_path / d), "v") for d in ("local", "ref"))
    present = [s for s in range(14) if s not in missing]
    kw = dict(buffer_size=8192, max_batch_bytes=10 * 3 * 8192)
    for mod, b, enc in ((stripe, base, ENC), (ref_stripe, ref_base, REF)):
        sources = {s: mod.RemoteSlabSource(s, ["a", "b"], _file_fetch(b, s), stripe_bytes=1)
                   for s in present}
        try:
            assert mod.rebuild_ec_files_from_sources(
                b, sources, len(golden[0]), encoder=enc, **kw) == missing
        finally:
            for src in sources.values():
                src.close()
    assert stripe.rebuild_ec_files(local_base, encoder=ENC, **kw) == missing
    for s in missing:
        assert _read(base, s) == _read(ref_base, s) == _read(local_base, s) == golden[s]


def test_striped_windows_spread_across_holders_and_fail_over():
    counts = {"a": 0, "b": 0}
    dead = set()
    lock = threading.Lock()
    blob = bytes(range(256)) * 1024  # 256 KiB

    def fetch(addr, offset, size):
        if addr in dead:
            raise IOError(f"{addr} down")
        with lock:
            counts[addr] += 1
        return blob[offset : offset + size]

    src = stripe.RemoteSlabSource(0, ["a", "b"], fetch, stripe_bytes=64 * 1024, fanout=4)
    out = np.zeros(256 * 1024, dtype=np.uint8)
    src.read_into(0, out)
    assert bytes(out) == blob
    assert counts["a"] > 0 and counts["b"] > 0, counts
    assert src.bytes_fetched == len(blob)
    dead.add("a")
    before_b = counts["b"]
    src.read_into(0, out)
    assert bytes(out) == blob
    assert counts["b"] >= before_b + 4
    assert src.failovers == ["a"]
    assert src.bytes_fetched == 2 * len(blob)
    src.close()


def test_least_inflight_pick_prefers_idle_holder():
    src = stripe.RemoteSlabSource(0, ["a", "b"], lambda *a: b"", fanout=2)
    with src._lock:
        src._inflight["a"] = 3
    assert src._pick_holder(["a", "b"], 0) == "b"
    with src._lock:  # equal loads: the rotation by sub-range breaks the tie
        src._inflight["b"] = 4
        src._inflight["a"] = 4
    first = src._pick_holder(["a", "b"], 0)
    second = src._pick_holder(["a", "b"], src._stripe)
    assert {first, second} == {"a", "b"}
    src.close()


@pytest.mark.parametrize("mod", [stripe, ref_stripe], ids=["port", "ref"])
def test_refresh_holders_is_bounded_and_resurrects(mod):
    """With every known holder dead, a re-lookup adds the holders it names
    and revives re-listed ones, at most twice in the source's life; then a
    range no holder serves raises. The port and the reference agree."""
    blob = bytes(range(256)) * 512
    alive = {"c"}
    lookups = []

    def fetch(addr, offset, size):
        if addr not in alive:
            raise IOError(f"{addr} down")
        return blob[offset : offset + size]

    def refresh():
        lookups.append(1)
        return ["c"]

    src = mod.RemoteSlabSource(3, ["a"], fetch, refresh_holders=refresh, fanout=1)
    out = np.zeros(len(blob), dtype=np.uint8)
    src.read_into(0, out)
    assert bytes(out) == blob and src.failovers == ["a"] and len(lookups) == 1
    alive.clear()
    with pytest.raises(IOError, match="no reachable holder"):
        src.read_into(0, out)
    # c dies, the second lookup revives it, it dies again; no third lookup
    assert len(lookups) == 2 and src.failovers == ["a", "c", "c"]
    src.close()


def test_fetches_carry_the_rebuilds_span_onto_pool_threads():
    seen = []

    def fetch(addr, offset, size):
        seen.append(trace.current())
        with trace.span("ec.fetch", addr=addr):
            return bytes(size)

    with trace.collect() as spans:
        with trace.span("rebuild.stage", batch=0):
            src = stripe.RemoteSlabSource(0, ["a"], fetch, stripe_bytes=65536)
            src.read_into(0, np.zeros(3 * 65536, dtype=np.uint8))
            src.close()
    assert len(seen) == 3 and all(s is not None for s in seen)
    assert [s["name"] for s in spans].count("ec.fetch") == 3


def test_slice_knobs_match_reference(monkeypatch):
    names = ("WEEDTPU_TRACE_CHUNK", "WEEDTPU_SLAB_FANOUT", "WEEDTPU_REBUILD_FUSE")
    for name in names:
        monkeypatch.delenv(name, raising=False)
    assert [config.env(n) for n in names] == [4 << 20, 4, "on"]
    assert [config.env(n) for n in names] == [ref_config.env(n) for n in names]
    for raw in (("1", "0", "OFF"), ("9999999", "7", " on ")):
        for name, value in zip(names, raw):
            monkeypatch.setenv(name, value)
        assert [config.env(n) for n in names] == [ref_config.env(n) for n in names]
    assert config.env("WEEDTPU_SLAB_FANOUT") == 7
    monkeypatch.setenv("WEEDTPU_TRACE_CHUNK", "1")
    assert config.env("WEEDTPU_TRACE_CHUNK") == 64 * 1024
    monkeypatch.setenv("WEEDTPU_REBUILD_FUSE", "maybe")
    with pytest.raises(ValueError):
        config.env("WEEDTPU_REBUILD_FUSE")


@pytest.mark.parametrize("entry", ["remote", "trace", "batch"])
def test_card_encoder_without_a_card_raises_not_plain(tmp_path, monkeypatch, entry):
    """A card encoder on a machine with no card: each rebuild entry point
    fails (the batch engine records it per volume), unlinks its partial
    outputs, and never runs the plain version."""
    from seaweedfs_tpu_torch.ops import rs_cuda

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base, golden = _volume(tmp_path, size=50_000)
    missing = [1, 12]
    for s in missing:
        os.unlink(stripe.shard_file_name(base, s))
    card = rs_codec.Encoder(10, 4, device="cuda")
    present = [s for s in range(14) if s not in missing]
    plain = []
    real = rs_cuda.plain_apply
    monkeypatch.setattr(rs_cuda, "plain_apply", lambda *a, **k: plain.append(1) or real(*a, **k))
    if entry == "remote":
        sources = {s: stripe.RemoteSlabSource(s, ["a"], _file_fetch(base, s)) for s in present}
        with pytest.raises((RuntimeError, AssertionError)):
            stripe.rebuild_ec_files_from_sources(base, sources, len(golden[0]), encoder=card)
        for src in sources.values():
            src.close()
    elif entry == "trace":
        survivors = present[:10]
        plan = card.repair_projection_plan(survivors, missing)
        group = stripe.LocalProjectionSource(
            [stripe.shard_file_name(base, s) for s in survivors],
            np.stack([plan[s] for s in survivors], axis=1), card)
        with pytest.raises((RuntimeError, AssertionError)):
            stripe.rebuild_ec_files_from_projections(base, [group], len(golden[0]), missing,
                                                     encoder=card)
        group.close()
        with pytest.raises((RuntimeError, AssertionError)):
            card.project(np.ones((1, 3), np.uint8), np.zeros((3, 64), np.uint8))
    else:
        job = {"base": base, "shard_size": len(golden[0]), "encoder": card,
               "sources": {s: stripe.LocalSlabSource(stripe.shard_file_name(base, s))
                           for s in present}}
        for fuse in (True, False):
            res = stripe.rebuild_ec_files_batch([job], fuse=fuse)
            assert list(res["errors"]) == [base] and res["rebuilt"] == {}
        for src in job["sources"].values():
            src.close()
        with pytest.raises((RuntimeError, AssertionError)):
            card.reconstruct_block(np.zeros((10, 64), np.uint8), [{
                "survivors": present[:10], "wanted": missing, "col_start": 0, "width": 64}])
    assert not plain
    for s in missing:
        assert not os.path.exists(stripe.shard_file_name(base, s))
