"""The port's stats registry (`seaweedfs_tpu_torch/stats`) against the
reference's (`seaweedfs_tpu/stats`): the same 50 families (names, help,
labels, kinds, buckets, order), byte-equal exposition text for the same
seeded update sequence, the same histogram quantiles, and the standalone
metrics server serving the registry."""

import urllib.request

import numpy as np
import pytest

from seaweedfs_tpu import stats as ref_stats
from seaweedfs_tpu_torch import stats

PACKAGES = {"port": stats, "ref": ref_stats}


def _families(mod) -> dict:
    return {name: m for name, m in vars(mod).items() if isinstance(m, mod._Labeled)}


def _shape(m) -> tuple:
    return (m.name, m.help, m.label_names, m.kind, getattr(m, "buckets", None))


def test_fifty_families_equal_the_reference():
    port = [_shape(m) for m in stats.REGISTRY._metrics.values()]
    ref = [_shape(m) for m in ref_stats.REGISTRY._metrics.values()]
    assert len(port) == 50 and port == ref


def test_module_attributes_name_the_same_families():
    """Every metric attribute the port ticks (`stats.ReadCacheHits`, ...)
    and every other one names the reference's family under the same
    attribute name."""
    port, ref = _families(stats), _families(ref_stats)
    assert set(port) == set(ref)
    assert {k: _shape(m) for k, m in port.items()} == {k: _shape(m) for k, m in ref.items()}
    for name in ("EcReconstructSeconds", "DegradedReadSeconds", "ReadCacheHits",
                 "InlineEcSeals", "EcConvertBytes", "ScrubCorruptionsFound", "RpcServerSeconds"):
        assert port[name] is stats.REGISTRY._metrics[port[name].name]


def _fresh(mod):
    """A new registry holding fresh copies of the module's 50 families, in
    registration order (the global one carries other tests' samples)."""
    reg = mod.Registry()
    for m in mod.REGISTRY._metrics.values():
        if isinstance(m, mod.Histogram):
            reg.histogram(m.name, m.help, m.label_names, m.buckets)
        else:
            getattr(reg, m.kind)(m.name, m.help, m.label_names)
    return reg


def _updates(reg, seed: int, n: int = 3000) -> None:
    rng = np.random.default_rng(seed)
    metrics = list(reg._metrics.values())
    for _ in range(n):
        m = metrics[int(rng.integers(len(metrics)))]
        child = m.labels(*(f"v{int(rng.integers(3))}" for _ in m.label_names))
        op = int(rng.integers(3))
        if m.kind == "histogram":
            child.observe(float(rng.exponential(0.05)) if op else float(rng.integers(0, 40)))
        elif m.kind == "counter":
            child.inc() if op else child.inc(float(rng.integers(1, 1 << 20)))
        elif op == 0:
            child.set(float(rng.normal()))
        elif op == 1:
            child.inc(float(rng.exponential()))
        else:
            child.dec(0.5)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_exposition_is_byte_equal_for_the_same_updates(seed):
    port, ref = _fresh(stats), _fresh(ref_stats)
    assert port.expose() == ref.expose()  # zero samples of the label-less families
    _updates(port, seed)
    _updates(ref, seed)
    text = port.expose()
    assert text == ref.expose()
    assert text.count("# TYPE ") == 50 and text.endswith("\n")
    for m in port._metrics.values():
        assert f"# HELP {m.name} {m.help}\n# TYPE {m.name} {m.kind}\n" in text


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_histogram_quantile(pkg):
    mod = PACKAGES[pkg]
    h = mod.Histogram("t_q_seconds", "test", buckets=(0.001, 0.01, 0.1, 1.0))
    assert h.quantile(0.5) == 0.0  # empty
    for _ in range(50):
        h.observe(0.005)
    for _ in range(50):
        h.observe(0.05)
    assert h.quantile(0.25) == 0.01
    assert h.quantile(0.9) == 0.1
    h.observe(5.0)
    assert h.quantile(1.0) == float("inf")


@pytest.mark.parametrize("seed", [4, 5])
def test_histogram_quantiles_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    values = rng.exponential(0.02, 500).tolist()
    hs = [mod.Histogram("t_seconds", "t", ("k",)) for mod in (stats, ref_stats)]
    for v in values:
        for h in hs:
            h.labels("a").observe(v)
    for q in (0.01, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert hs[0].labels("a").quantile(q) == hs[1].labels("a").quantile(q)
    assert hs[0].labels("a").total == 500 and hs[0].labels("a").sum == hs[1].labels("a").sum


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_labels_and_gauges(pkg):
    mod = PACKAGES[pkg]
    reg = mod.Registry()
    c = reg.counter("t_total", "t", ("a", "b"))
    with pytest.raises(ValueError):
        c.labels("x")
    c.labels("x", 1).inc(2)
    assert c.labels("x", "1").value == 2.0  # label values stringify
    g = reg.gauge("t_g", "g")
    g.set(3)
    g.inc()
    g.labels().dec(0.5)
    assert g.value == 3.5
    assert reg.counter("t_total", "other help") is c  # first registration wins
    assert 't_total{a="x",b="1"} 2.0' in reg.expose()


def test_standalone_metrics_server():
    srv = stats.start_metrics_server(0)
    try:
        port = srv.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=5) as r:
            body = r.read().decode()
            assert r.headers["Content-Type"] == "text/plain; version=0.0.4"
        assert body == stats.REGISTRY.expose()
        assert "# TYPE weedtpu_ec_reconstruct_seconds histogram" in body
        assert "\nweedtpu_master_assign_total " in body
    finally:
        srv.shutdown()
        srv.server_close()


def test_reconstruct_count_follows_degraded_decodes(tmp_path, monkeypatch):
    """The exposition's `weedtpu_ec_reconstruct_seconds_count` rises by one
    per real decode of the port's degraded read (the `obs` phase's check on
    the card, here on the CPU)."""
    import os

    from seaweedfs_tpu_torch.ec import ec_volume, stripe
    from seaweedfs_tpu_torch.ops import rs_codec
    from seaweedfs_tpu_torch.storage import idx, types

    monkeypatch.setenv("WEEDTPU_READ_CACHE_MB", "0")  # every read decodes
    rng = np.random.default_rng(9)
    base = str(tmp_path / "v1")
    records, offset, blobs = [], types.NEEDLE_PADDING_SIZE, [b"\x03" + bytes(7)]
    for nid in range(1, 41):
        body = int(rng.integers(1, 300))
        rec = rng.integers(0, 256, size=types.actual_size(body, version=3), dtype=np.uint8)
        records.append((nid, offset, body, rec.tobytes()))
        blobs.append(rec.tobytes())
        offset += len(rec)
    with open(base + ".dat", "wb") as f:
        f.write(b"".join(blobs))
    idx.write_entries([(nid, types.offset_to_bytes(off), size) for nid, off, size, _ in records],
                      base + ".idx")
    enc = rs_codec.Encoder(10, 4, device="cpu")
    stripe.write_ec_files(base, large_block_size=1024, small_block_size=64, buffer_size=64,
                          encoder=enc)
    stripe.write_sorted_file_from_idx(base)
    os.remove(stripe.shard_file_name(base, 2))

    def count() -> float:
        for line in stats.REGISTRY.expose().splitlines():
            if line.startswith("weedtpu_ec_reconstruct_seconds_count"):
                return float(line.split()[-1])
        raise AssertionError("no reconstruct count in the exposition")

    with ec_volume.EcVolume(base, large_block_size=1024, small_block_size=64,
                            encoder=enc) as ev:
        decodes = []
        real = ev.planner._recover_interval_inner

        def counted(*a):
            decodes.append(a)
            return real(*a)

        ev.planner._recover_interval_inner = counted
        before = count()
        for nid, _, _, rec in records:
            assert ev.read_needle_blob(nid) == rec
        assert decodes and count() - before == len(decodes)
