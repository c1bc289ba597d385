"""The port's mesh backend against the JAX package's, on this CPU: the
Encoder's mesh branches over a mesh of the CPU (the reference's over
conftest's 8 virtual devices) byte-exact with the reference mesh encoder
and the single-device oracle on tile-edge, odd and multi-loss shapes; the
file pipelines' shard files; the GPU_MULTICHIP evidence rule against the
reference's MULTICHIP rule on the same tables (files in tmp_path); the
WEEDTPU_MESH* knobs; the stats; the factory's promotion and audit; the
shell's `ec.backend` line; the mesh bench and its assembler; and the
ingest builder's staging ring and watermark with a mesh encoder."""

import datetime
import io
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ec import ingest as ref_ingest
from seaweedfs_tpu.ec import stripe as ref_stripe
from seaweedfs_tpu.ops import rs_codec as ref_codec
from seaweedfs_tpu_torch import stats
from seaweedfs_tpu_torch.ec import ingest, stripe
from seaweedfs_tpu_torch.ops import rs_codec
from seaweedfs_tpu_torch.ops.rs_codec import Encoder
from seaweedfs_tpu_torch.parallel import backend as mb
from seaweedfs_tpu_torch.parallel import mesh as mesh_mod
from seaweedfs_tpu_torch.scripts import device_window, mesh_bench
from seaweedfs_tpu_torch.shell import command_ec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """The plain version's products on a few threads: the suite runs with
    several test workers on one CPU at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _golden():
    return ref_codec.Encoder(10, 4, backend="numpy")


def _mesh_enc(shape, rebuild=None):
    return Encoder(10, 4, backend="mesh", device="cpu", mesh_shape=shape, mesh_rebuild=rebuild)


def _ref_mesh_enc(shape, rebuild=None):
    return ref_codec.Encoder(10, 4, backend="mesh", mesh_shape=shape, mesh_rebuild=rebuild)


def _encode_all(enc, data):
    return np.stack(enc.encode(list(data)))


# -- the mesh bench (tier-1 smoke) -----------------------------------------------
# (first in the file: the reference's own bench smoke, in its file's last
# third, sits at the edge of its GB/s rounding and fails when a twin's bench
# runs beside it)


def test_mesh_bench_smoke_schema_and_byte_verify(tmp_path):
    """The port's mesh bench at the reference bench smoke's sizes on a mesh
    of the CPU: both rebuild formulations measured, every shape
    byte-verified, the body through `assemble_multichip` as the reference's
    round-trips through its assembler."""
    sys.path.insert(0, ROOT)
    import bench

    sizes = dict(dat_bytes=2 * 64 * 1024 * 10 + 12345, large=64 * 1024, small=16 * 1024,
                 buffer_size=16 * 1024, max_batch_bytes=1 << 20, shapes=[(4, 2)])
    os.makedirs(tmp_path / "ref")
    os.makedirs(tmp_path / "port")
    ref = bench._measure_mesh(str(tmp_path / "ref"), **sizes)
    out = mesh_bench.measure_mesh(str(tmp_path / "port"), device="cpu", **sizes)
    assert out["kind"] == ref["kind"] == "multichip" and out["n_devices"] == ref["n_devices"] == 8
    assert out["ok"] is True and ref["ok"] is True and out["platform"] == "cpu"
    rec = out["shapes"]["4x2"]
    assert rec["match"] is True and set(ref["shapes"]["4x2"]) <= set(rec)
    for key in ("encode_gbps", "rebuild_ring_gbps", "rebuild_alltoall_gbps"):
        assert rec[key] > 0
    assert out["single_device"]["encode_gbps"] > 0 and out["single_device"]["match"]
    meas = device_window.assemble_multichip(out, 16)
    assert meas["shapes"] == out["shapes"] and meas["round"] == 16
    with pytest.raises(ValueError, match="per-mesh-shape"):
        device_window.assemble_multichip(dict(out, shapes={}))
    # a CPU body is never evidence
    with open(tmp_path / "GPU_MULTICHIP_r16.json", "w", encoding="utf-8") as f:
        json.dump(meas, f)
    ok, dec = rs_codec.pick_mesh_backend(8, art_dir=str(tmp_path))
    assert not ok and "on-chip" in dec["reason"]
    assert mesh_bench.default_shapes(4) == [(4, 1), (2, 2), (1, 4)]


@pytest.mark.parametrize("returncode", [0, 255])
def test_mesh_bench_topology_survives_an_unreadable_topology(monkeypatch, returncode):
    """`host_topology` runs after the whole measurement: where `nvidia-smi
    topo -m` fails (exit 255, "Failed to run topology matrix", as on some
    multi-card hosts) it records the failure and the peer-access matrix
    instead of raising and losing the bench's body."""
    import subprocess
    import types

    def run(argv, **kw):
        assert argv == ["nvidia-smi", "topo", "-m"] and "check" not in kw
        return types.SimpleNamespace(returncode=returncode, stderr="",
                                     stdout="GPU0 X" if returncode == 0 else
                                     "Failed to run topology matrix")

    monkeypatch.setattr(subprocess, "run", run)
    got = mesh_bench.host_topology(0)
    if returncode:
        assert got == {"topology": None, "peer_access": [],
                       "topology_error": "exit 255: Failed to run topology matrix"}
    else:
        assert got == {"topology": "GPU0 X", "peer_access": []}


# -- dispatch-level byte identity ----------------------------------------------


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_mesh_encode_matches_reference_odd_width(shape):
    """Odd widths take the zero-pad path: byte-identical to the reference
    mesh encoder and the numpy oracle."""
    data = np.random.default_rng(1).integers(0, 256, size=(10, 1003), dtype=np.uint8)
    out = np.asarray(_mesh_enc(shape).encode_parity_lazy(data))
    assert out.shape == (4, 1003)
    assert np.array_equal(out, np.asarray(_ref_mesh_enc(shape).encode_parity_lazy(data)))
    assert np.array_equal(out, np.asarray(_golden().encode_parity_lazy(data)))


@pytest.mark.parametrize("rebuild", ["ring", "alltoall"])
@pytest.mark.parametrize("lost", [(3,), (1, 5, 10, 13), (0, 1, 2, 3)])
def test_mesh_reconstruct_lazy_matches_reference(rebuild, lost):
    data = np.random.default_rng(2).integers(0, 256, size=(10, 777), dtype=np.uint8)
    shards = _encode_all(_golden(), data)
    surv = [i for i in range(14) if i not in lost][:10]
    got = np.asarray(_mesh_enc((4, 2), rebuild).reconstruct_lazy(shards[surv], surv, list(lost),
                                                                  donate=True))
    want = np.asarray(_ref_mesh_enc((4, 2), rebuild).reconstruct_lazy(shards[surv], surv,
                                                                       list(lost), donate=True))
    assert np.array_equal(got, want) and np.array_equal(got, shards[list(lost)])


def test_mesh_batched_forms_match_reference():
    enc, ref = _mesh_enc((2, 4)), _ref_mesh_enc((2, 4))
    data = np.random.default_rng(3).integers(0, 256, size=(3, 10, 257), dtype=np.uint8)
    assert np.array_equal(enc.encode_batch(data), ref.encode_batch(data))
    assert np.array_equal(enc.encode_batch(data), _golden().encode_batch(data))
    shards = np.stack([_encode_all(_golden(), v) for v in data])
    lost = [2, 7, 11]
    surv = [i for i in range(14) if i not in lost][:10]
    got = enc.reconstruct_batch(shards[:, surv, :], surv, lost)
    assert np.array_equal(got, ref.reconstruct_batch(shards[:, surv, :], surv, lost))
    assert np.array_equal(got, shards[:, lost, :])


def test_mesh_serving_reconstruct_and_verify():
    enc, ref = _mesh_enc((4, 2)), _ref_mesh_enc((4, 2))
    data = np.random.default_rng(4).integers(0, 256, size=(10, 5000), dtype=np.uint8)
    shards = list(_encode_all(_golden(), data))
    assert enc.verify(shards) and ref.verify(shards)
    bad = list(shards)
    bad[11] = bad[11] ^ np.uint8(1)
    assert not enc.verify(bad)
    holed = list(shards)
    holed[0] = holed[12] = None
    rec, ref_rec = enc.reconstruct(list(holed)), ref.reconstruct(list(holed))
    for s in range(14):
        assert np.array_equal(rec[s], shards[s]) and np.array_equal(rec[s], ref_rec[s]), s


# -- the file pipelines ---------------------------------------------------------


def _write_dat(base, data):
    os.makedirs(os.path.dirname(base), exist_ok=True)
    with open(base + ".dat", "wb") as f:
        f.write(data)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_mesh_write_ec_files_byte_identical_tile_edge(tmp_path):
    """write_ec_files through the mesh pipeline (aligned spans, zero-filled
    tail, inline CRC) against the reference's mesh encoder and the oracle,
    on a tile-edge/odd layout; the .eci sidecars are equal too."""
    rng = np.random.default_rng(5)
    large, small, buf = 64 * 1024, 16 * 1024, 16 * 1024
    data = rng.integers(0, 256, 2 * large * 10 + 3 * small * 10 + 4321, dtype=np.uint8).tobytes()
    bases = {k: str(tmp_path / k / "7") for k in ("oracle", "ref", "port")}
    for b in bases.values():
        _write_dat(b, data)
    ref_stripe.write_ec_files(bases["oracle"], large, small, buf, encoder=_golden(),
                              max_batch_bytes=1 << 20)
    ref_stripe.write_ec_files(bases["ref"], large, small, buf, encoder=_ref_mesh_enc((4, 2)),
                              max_batch_bytes=1 << 20)
    enc = _mesh_enc((4, 2))
    assert enc.width_align == 8
    stripe.write_ec_files(bases["port"], large, small, buf, encoder=enc, max_batch_bytes=1 << 20)
    for s in range(14):
        got = _read(stripe.shard_file_name(bases["port"], s))
        assert got == _read(ref_stripe.shard_file_name(bases["oracle"], s)), f"shard {s}"
        assert got == _read(ref_stripe.shard_file_name(bases["ref"], s)), f"shard {s}"
    assert _read(bases["port"] + ".eci") == _read(bases["oracle"] + ".eci")


@pytest.mark.parametrize("rebuild", ["ring", "alltoall"])
def test_mesh_rebuild_ec_files_byte_identical_to_serial(tmp_path, rebuild):
    """rebuild_ec_files with the mesh encoder (both formulations), the .eci
    CRC gate on, against the shards written and the serial oracle, and the
    reference's mesh rebuild of the same survivors."""
    rng = np.random.default_rng(6)
    large, small, buf = 64 * 1024, 16 * 1024, 16 * 1024
    data = rng.integers(0, 256, 3 * large * 10 + 987, dtype=np.uint8).tobytes()
    base, ref_base = str(tmp_path / "v" / "7"), str(tmp_path / "r" / "7")
    for b in (base, ref_base):
        _write_dat(b, data)
        ref_stripe.write_ec_files(b, large, small, buf, encoder=_golden(), max_batch_bytes=1 << 20)
    lost = (0, 5, 11, 13)
    expected = {s: _read(stripe.shard_file_name(base, s)) for s in lost}
    for b in (base, ref_base):
        for s in lost:
            os.unlink(stripe.shard_file_name(b, s))
    rebuilt = stripe.rebuild_ec_files(base, encoder=_mesh_enc((2, 4), rebuild),
                                      buffer_size=48 * 1024, max_batch_bytes=1 << 20)
    ref_rebuilt = ref_stripe.rebuild_ec_files(ref_base, encoder=_ref_mesh_enc((2, 4), rebuild),
                                              buffer_size=48 * 1024, max_batch_bytes=1 << 20)
    assert sorted(rebuilt) == sorted(ref_rebuilt) == sorted(lost)
    for s in lost:
        assert _read(stripe.shard_file_name(base, s)) == expected[s]
        assert _read(stripe.shard_file_name(ref_base, s)) == expected[s]
    for s in lost:
        os.unlink(stripe.shard_file_name(base, s))
    stripe.rebuild_ec_files_serial(base, encoder=Encoder(10, 4, device="cpu"))
    for s in lost:
        assert _read(stripe.shard_file_name(base, s)) == expected[s]


# -- factory, knobs, audit --------------------------------------------------------


def test_new_encoder_mesh_explicit_and_audit(monkeypatch):
    monkeypatch.delenv("WEEDTPU_MESH_SHAPE", raising=False)
    enc = rs_codec.new_encoder(device="cpu", backend="mesh")
    ref = ref_codec.new_encoder(backend="mesh")
    assert enc.backend == ref.backend == "mesh"
    sel = enc.selection
    assert sel["mesh_shape"] == enc._mesh_dispatch().shape_str() and "x" in sel["mesh_shape"]
    assert sel["mesh_rebuild"] == ref.selection["mesh_rebuild"] == "ring"
    assert sel["mesh_devices"] >= 1 and sel["source"] == "explicit"
    assert sel["audit"].startswith("mesh ") and sel["audit"].endswith("evidence=r-)")
    assert ref.selection["audit"].endswith("evidence=r-)")
    # a sibling geometry keeps the backend, shape and rebuild formulation
    sib = stripe.encoder_for_info({"data_shards": 12, "parity_shards": 3,
                                   "matrix_kind": "cauchy"}, enc)
    assert (sib.backend, sib.mesh_shape, sib.mesh_rebuild) == ("mesh", None, None)
    pinned = _mesh_enc((2, 2), "alltoall")
    sib = stripe.encoder_for_info({"data_shards": 12, "parity_shards": 3,
                                   "matrix_kind": "cauchy"}, pinned)
    assert (sib.backend, sib.mesh_shape, sib.mesh_rebuild) == ("mesh", (2, 2), "alltoall")


def test_mesh_shape_env_knob(monkeypatch):
    monkeypatch.setenv("WEEDTPU_MESH_SHAPE", "2x2")
    md = Encoder(10, 4, backend="mesh", device="cpu")._mesh_dispatch()
    ref_md = ref_codec.Encoder(10, 4, backend="mesh")._mesh_dispatch()
    assert (md.dp, md.sp) == (ref_md.dp, ref_md.sp) == (2, 2)
    assert md.width_align == ref_md.width_align == 4
    assert md.n_devices == 4 and md.mesh.size == 4


def test_mesh_shape_env_knob_malformed(monkeypatch):
    monkeypatch.setenv("WEEDTPU_MESH_SHAPE", "banana")
    for enc in (Encoder(10, 4, backend="mesh", device="cpu"),
                ref_codec.Encoder(10, 4, backend="mesh")):
        with pytest.raises(ValueError, match="DPxSP"):
            enc._mesh_dispatch()


def test_mesh_rebuild_variant_validation(monkeypatch):
    for enc in (_mesh_enc((2, 2), "bogus"), _ref_mesh_enc((2, 2), "bogus")):
        with pytest.raises(ValueError, match="variant"):
            enc._mesh_dispatch()
    monkeypatch.setenv("WEEDTPU_MESH_REBUILD", "bogus")  # the knob's own parser refuses it
    with pytest.raises(ValueError):
        _mesh_enc((2, 2))._mesh_dispatch()
    # no fallback: a shape larger than the devices raises, on a list or the cards
    with pytest.raises(ValueError, match="needs 8 devices"):
        Encoder(10, 4, backend="mesh", device="cpu", mesh_shape=(4, 2),
                mesh_devices=["cpu"] * 4)._mesh_dispatch()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Encoder(10, 4, backend="mesh", device="cuda", mesh_shape=(1, 1))._mesh_dispatch()


def test_default_mesh_shape_rule():
    from seaweedfs_tpu.parallel import backend as ref_mb

    for n in (1, 2, 3, 4, 6, 8, 16):
        assert mb.default_mesh_shape(n) == ref_mb.default_mesh_shape(n)
    assert mb.default_mesh_shape(8) == (4, 2) and mb.default_mesh_shape(2) == (2, 1)
    for raw in ("", "auto", "4x2", " 2X4 "):
        assert mb.parse_mesh_shape(raw) == ref_mb.parse_mesh_shape(raw)
    for raw in ("0x4", "4x", "x2", "4x2x1", "banana"):
        for mod in (mb, ref_mb):
            with pytest.raises(ValueError):
                mod.parse_mesh_shape(raw)
    assert mb.REBUILD_VARIANTS == ref_mb.REBUILD_VARIANTS
    assert mb._COMPILED_CACHE_CAP == ref_mb._COMPILED_CACHE_CAP


def test_mesh_stats_gauge_and_dispatch_counter():
    enc = _mesh_enc((4, 2))
    before = stats.EcDispatchTotal.labels("mesh").value
    data = np.random.default_rng(8).integers(0, 256, size=(10, 64), dtype=np.uint8)
    np.asarray(enc.encode_parity_lazy(data))
    assert stats.EcMeshDevices.value == 8
    assert stats.EcDispatchTotal.labels("mesh").value == before + 1
    # the per-matrix cache of dispatch functions stays bounded under churn
    md = enc._mesh_dispatch()
    for i in range(mb._COMPILED_CACHE_CAP + 5):
        md.apply(np.full((1, 10), i % 256, dtype=np.uint8), data)
    assert len(md._apply_fns) == mb._COMPILED_CACHE_CAP


# -- the evidence rule ------------------------------------------------------------


def _fresh_when():
    return datetime.datetime.now(datetime.timezone.utc).strftime("%Y-%m-%dT%H:%MZ")


def _evidence(**kw):
    ev = {
        "when": _fresh_when(), "round": 91, "single_device": {"encode_gbps": 31.0},
        "shapes": {
            "4x2": {"encode_gbps": 180.0, "rebuild_ring_gbps": 120.0,
                    "rebuild_alltoall_gbps": 95.0, "match": True},
            "16x2": {"encode_gbps": 500.0, "match": True},
        },
    }
    ev.update(kw)
    return ev


def _on_chip(ev, platform_ok=True):
    """The same table as each package's on-chip file: the reference's
    platform string, or the port's `platform` "gpu" with its `card`."""
    ref = dict(ev, platform="tpu (TPU v5 lite)" if platform_ok else "cpu (cpu)")
    port = dict(ev, platform="gpu" if platform_ok else "cpu", card=CARD)
    return ref, port


def _write_both(tmp_path, ref_ev, port_ev, rnd=91):
    for sub, name, ev in (("ref", f"MULTICHIP_r{rnd}.json", ref_ev),
                          ("port", f"GPU_MULTICHIP_r{rnd}.json", port_ev)):
        os.makedirs(tmp_path / sub, exist_ok=True)
        with open(tmp_path / sub / name, "w", encoding="utf-8") as f:
            json.dump(ev, f)


def _decide(tmp_path, n=8):
    ok, dec = rs_codec.pick_mesh_backend(n, art_dir=str(tmp_path / "port"))
    ref_ok, ref_dec = ref_codec.pick_mesh_backend(n, art_dir=str(tmp_path / "ref"))
    assert ok == ref_ok
    for k in ("mesh_shape", "mesh_rebuild", "encode_gbps", "single_device_gbps",
              "evidence_round"):
        assert dec.get(k) == ref_dec.get(k), k
    return ok, dec, ref_dec


def test_mesh_evidence_promotes_on_fresh_onchip(tmp_path):
    _write_both(tmp_path, *_on_chip(_evidence()))
    ok, dec, ref_dec = _decide(tmp_path)
    assert ok and dec["mesh_shape"] == "4x2"  # 16x2 needs 32 devices
    assert dec["mesh_rebuild"] == "ring" and dec["evidence_round"] == 91
    assert dec["reason"] == ref_dec["reason"] and "beats single-device" in dec["reason"]
    assert dec["evidence_file"] == "GPU_MULTICHIP_r91.json"


def test_mesh_evidence_alltoall_wins_when_faster(tmp_path):
    ev = _evidence()
    ev["shapes"]["4x2"]["rebuild_alltoall_gbps"] = 200.0
    _write_both(tmp_path, *_on_chip(ev))
    ok, dec, _ = _decide(tmp_path)
    assert ok and dec["mesh_rebuild"] == "alltoall"


def test_mesh_evidence_absent_keeps_backend(tmp_path):
    os.makedirs(tmp_path / "port")
    os.makedirs(tmp_path / "ref")
    ok, dec, _ = _decide(tmp_path)
    assert not ok and "no committed mesh evidence" in dec["reason"]
    assert rs_codec.load_mesh_evidence(str(tmp_path / "nowhere")) is None


def test_mesh_evidence_off_chip_never_promotes(tmp_path):
    _write_both(tmp_path, *_on_chip(_evidence(), platform_ok=False))
    ok, dec, _ = _decide(tmp_path)
    assert not ok and "on-chip" in dec["reason"]
    # a GPU file that does not name its card is not evidence either
    ev = dict(_evidence(), platform="gpu")
    _write_both(tmp_path, _on_chip(_evidence())[0], ev, rnd=92)
    ok, dec = rs_codec.pick_mesh_backend(8, art_dir=str(tmp_path / "port"))
    assert not ok and "naming its card" in dec["reason"]


def test_mesh_evidence_stale_never_promotes(tmp_path):
    _write_both(tmp_path, *_on_chip(_evidence(when="2020-01-01T00:00Z")))
    ok, dec, _ = _decide(tmp_path)
    assert not ok and "stale" in dec["reason"]


def test_mesh_evidence_unparseable_age_is_stale(tmp_path):
    _write_both(tmp_path, *_on_chip(_evidence(when="yesterday-ish")))
    ok, dec, _ = _decide(tmp_path)
    assert not ok and "stale" in dec["reason"]


def test_mesh_evidence_losing_shape_keeps_backend(tmp_path):
    ev = _evidence()
    ev["shapes"]["4x2"]["encode_gbps"] = 12.0  # below single_device 31.0
    del ev["shapes"]["16x2"]
    _write_both(tmp_path, *_on_chip(ev))
    ok, dec, ref_dec = _decide(tmp_path)
    assert not ok and dec["reason"] == ref_dec["reason"]
    assert "beats the single-device" in dec["reason"]


def test_mesh_evidence_failed_byte_verify_disqualifies(tmp_path):
    ev = _evidence()
    ev["shapes"]["4x2"]["match"] = False
    del ev["shapes"]["16x2"]
    _write_both(tmp_path, *_on_chip(ev))
    ok, _, _ = _decide(tmp_path)
    assert not ok


def test_mesh_evidence_no_shape_table_keeps_backend(tmp_path):
    ev = {"when": _fresh_when(), "tail": "ok"}
    _write_both(tmp_path, dict(ev, platform="tpu"), dict(ev, platform="gpu", card=CARD))
    ok, dec, _ = _decide(tmp_path)
    assert not ok and "per-mesh-shape" in dec["reason"]


def test_mesh_evidence_newest_round_wins(tmp_path):
    _write_both(tmp_path, *_on_chip(_evidence()), rnd=90)
    _write_both(tmp_path, *_on_chip(_evidence(), platform_ok=False), rnd=91)
    ok, dec, ref_dec = _decide(tmp_path)
    # the newest round is off-chip: it must NOT fall back to older rounds
    assert not ok and dec["evidence_file"] == "GPU_MULTICHIP_r91.json"
    assert ref_dec["evidence_file"] == "MULTICHIP_r91.json"


def test_no_committed_gpu_multichip_evidence_so_no_promotion():
    """No GPU_MULTICHIP file is committed (the reference's committed
    MULTICHIP_r06 is a CPU run and never promotes either), so a multi-card
    host keeps the single-card encoder until one is."""
    assert rs_codec.load_mesh_evidence() is None
    assert not any(f.startswith("GPU_MULTICHIP") for f in os.listdir(os.path.join(ROOT, "artifacts")))
    ok, dec = rs_codec.pick_mesh_backend(8)
    assert not ok and "no committed mesh evidence" in dec["reason"]
    ev = ref_codec.load_mesh_evidence()
    assert ev is not None and ev["_file"] >= "MULTICHIP_r06.json"
    if ev["_file"] == "MULTICHIP_r06.json":
        assert not ref_codec.pick_mesh_backend(8)[0]


def _fake_cards(monkeypatch, tmp_path, n=8):
    """A host with n cards as far as the factory can tell, whose mesh
    devices are the CPU (the plain version does the work)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(rs_codec, "_card_count", lambda: n)
    monkeypatch.setattr(mesh_mod, "local_devices", lambda: [torch.device("cpu")] * n)
    monkeypatch.setattr(rs_codec, "_artifacts_dir", lambda: str(tmp_path / "none"))
    monkeypatch.setattr(rs_codec, "_multichip_dir", lambda: str(tmp_path / "port"))


def test_new_encoder_promotes_to_mesh_on_evidence(tmp_path, monkeypatch):
    """The factory on a simulated 8-card host with fresh committed mesh
    evidence promotes to the mesh backend with the evidence's shape and
    rebuild formulation in the audit, as the reference's does on a
    simulated pod, and the promoted encoder still encodes byte-identically."""
    from seaweedfs_tpu.utils import devices as devices_mod

    ref_ev, port_ev = _on_chip(_evidence())
    _write_both(tmp_path, ref_ev, port_ev)
    _fake_cards(monkeypatch, tmp_path)
    monkeypatch.setattr(devices_mod, "is_tpu_device", lambda d: True)
    monkeypatch.setattr(ref_codec, "_artifacts_dir", lambda: str(tmp_path / "none"))
    monkeypatch.setattr(ref_codec, "_multichip_dir", lambda: str(tmp_path / "ref"))
    enc, ref = rs_codec.new_encoder(), ref_codec.new_encoder()
    assert enc.backend == ref.backend == "mesh"
    assert enc.mesh_shape == ref.mesh_shape == (4, 2)
    assert enc.mesh_rebuild == ref.mesh_rebuild == "ring"
    sel = enc.selection
    assert sel["source"] == ref.selection["source"] == "mesh-evidence"
    assert sel["mesh_shape"] == "4x2" and sel["mesh_devices"] == 8
    assert "evidence=r91" in sel["audit"] and sel["audit"] == ref.selection["audit"]
    data = np.random.default_rng(11).integers(0, 256, size=(10, 123), dtype=np.uint8)
    assert np.array_equal(np.asarray(enc.encode_parity_lazy(data)),
                          np.asarray(_golden().encode_parity_lazy(data)))


def test_new_encoder_keeps_backend_without_mesh_evidence(tmp_path, monkeypatch):
    from seaweedfs_tpu.utils import devices as devices_mod

    _fake_cards(monkeypatch, tmp_path)
    monkeypatch.setattr(devices_mod, "is_tpu_device", lambda d: True)
    monkeypatch.setattr(ref_codec, "_artifacts_dir", lambda: str(tmp_path / "none"))
    monkeypatch.setattr(ref_codec, "_multichip_dir", lambda: str(tmp_path / "ref"))
    enc, ref = rs_codec.new_encoder(), ref_codec.new_encoder()
    assert enc.backend == "cuda" and ref.backend == "jax"  # each package's single-device default
    assert "no committed mesh evidence" in enc.selection["mesh"]["reason"]
    assert "no committed mesh evidence" in ref.selection["mesh"]["reason"]
    # one card: nothing to decide
    monkeypatch.setattr(rs_codec, "_card_count", lambda: 1)
    assert "mesh" not in rs_codec.new_encoder().selection


# -- the shell's audit line ------------------------------------------------------


def test_ec_backend_shell_command_reports_selection(tmp_path, monkeypatch):
    """`ec.backend` names the selection and, on a multi-card host that was
    not promoted, the reference's "mesh not promoted: <reason>" line."""
    out = io.StringIO()
    command_ec.do_ec_backend([], types.SimpleNamespace(device="cpu"), out)
    assert out.getvalue().startswith("ec.backend: ") and "backend=torch" in out.getvalue()
    assert "mesh not promoted" not in out.getvalue()
    _fake_cards(monkeypatch, tmp_path)
    out = io.StringIO()
    command_ec.do_ec_backend([], types.SimpleNamespace(device=None), out)
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("ec.backend: backend=cuda") and "mesh=" not in lines[0]
    assert lines[1] == ("ec.backend: mesh not promoted: no committed mesh evidence "
                        "(GPU_MULTICHIP_r*.json)")


# -- the ingest builder with a mesh encoder ---------------------------------------


def test_inline_builder_reuses_staging_ring_across_polls(tmp_path):
    """Steady-state polls of a mesh-encoded builder hit the SAME cached ring
    and reuse the builder-lifetime .dat handle, as the reference's do, and
    its partial shards equal the reference builder's."""
    large, small, buf = 64 * 1024, 16 * 1024, 16 * 1024
    base, ref_base = str(tmp_path / "5"), str(tmp_path / "r5")
    b = ingest.InlineStripeBuilder(base, _mesh_enc((4, 2)), large, small, buffer_size=buf)
    rb = ref_ingest.InlineStripeBuilder(ref_base, _golden(), large, small, buffer_size=buf)
    rng = np.random.default_rng(9)
    first = rng.integers(0, 256, large * 10 + 1, dtype=np.uint8).tobytes()
    second = rng.integers(0, 256, large * 10, dtype=np.uint8).tobytes()
    with open(base + ".dat", "wb") as f, open(ref_base + ".dat", "wb") as rf:
        for chunk in (first, second):
            f.write(chunk)
            f.flush()
            rf.write(chunk)
            rf.flush()
            assert b.poll() == rb.poll() == 1
            if chunk is first:
                ring_ids = {id(r) for r in b._ring_cache.values()}
                dat_handle = b._dat
                assert len(ring_ids) == 1 and dat_handle is not None
        assert {id(r) for r in b._ring_cache.values()} == ring_ids
        assert b._dat is dat_handle
    for s in range(14):
        assert _read(ingest.part_path(base, s)) == _read(ref_ingest.part_path(ref_base, s)), s
    b.abort()
    rb.abort()
    assert b._dat is None and not b._ring_cache


def test_inline_builder_async_watermark_lands_before_seal(tmp_path):
    """With a mesh encoder the flusher-thread watermark keeps the
    fsync-before-record order, and the seal equals a warm encode and the
    reference builder's seal."""
    large, small, buf = 64 * 1024, 16 * 1024, 16 * 1024
    base_i, base_w, base_r = str(tmp_path / "i"), str(tmp_path / "w"), str(tmp_path / "r")
    data = np.random.default_rng(10).integers(0, 256, 4 * large * 10 + 321, dtype=np.uint8)
    data = data.tobytes()
    b = ingest.InlineStripeBuilder(base_i, _mesh_enc((4, 2)), large, small, buffer_size=buf)
    b._durable_batch = large * 10  # force a watermark per row
    for path in (base_i, base_w, base_r):
        with open(path + ".dat", "wb") as f:
            f.write(data)
    assert b.poll() == 4
    if b._flusher is not None:
        b._flusher.shutdown(wait=True)  # drain the async watermark
        b._flusher = None
    rows_records = [r for r in ingest.read_journal(base_i) if r.get("kind") == "rows"]
    assert rows_records and rows_records[-1]["rows"] >= 1
    for s in range(14):
        assert os.path.getsize(ingest.part_path(base_i, s)) >= rows_records[-1]["rows"] * large
    b.seal()
    rb = ref_ingest.InlineStripeBuilder(base_r, _golden(), large, small, buffer_size=buf)
    assert rb.poll() == 4
    rb.seal()
    stripe.write_ec_files(base_w, large, small, buf, encoder=Encoder(10, 4, device="cpu"))
    for s in range(14):
        got = _read(stripe.shard_file_name(base_i, s))
        assert got == _read(stripe.shard_file_name(base_w, s)), s
        assert got == _read(ref_stripe.shard_file_name(base_r, s)), s
