"""The port's evidence-driven kernel choice and the sweep that makes the
evidence, on the CPU, mirroring `tests/test_auto_backend.py`: fabricated
`GPU_MEASUREMENT` files (a variant faster / slower than int8, absent,
stale, unparseable, off-card, torn) each select the expected kernel; sweep
labels parse by the reference's grammar; the harvest JSONL resumes past
its own mode's records and survives a torn tail; the assembler's output is
exactly what the factory reads; and `kernel_sweep --smoke` passes over all
five variants' plain versions."""

from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys

import pytest
import torch

from seaweedfs_tpu.ops import rs_codec as ref_codec
from seaweedfs_tpu_torch.ops import measure, rs_codec
from seaweedfs_tpu_torch.scripts import device_window, kernel_sweep as ks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def _write_evidence(dirpath, meas, name="GPU_MEASUREMENT_r91.json"):
    with open(os.path.join(dirpath, name), "w", encoding="utf-8") as f:
        json.dump(meas, f)


def _fresh_when():
    return datetime.datetime.now(datetime.timezone.utc).strftime("%Y-%m-%dT%H:%MZ")


def _gpu(**kw):
    return {"when": _fresh_when(), "platform": "gpu", "card": CARD, **kw}


# -- pick_device_backend: the decision table ---------------------------------


def test_variant_faster_than_int8_is_chosen_with_its_config(tmp_path):
    _write_evidence(tmp_path, _gpu(cuda_steady_gbps=31.0, cuda_bf16_steady_gbps=44.5))
    variant, dec = rs_codec.pick_device_backend(art_dir=str(tmp_path))
    assert variant == "bf16" and dec["variant"] == "bf16" and dec["tile"] is None
    assert "beats" in dec["reason"]
    assert dec["evidence_file"] == "GPU_MEASUREMENT_r91.json" and dec["card"] == CARD


def test_variant_slower_than_int8_keeps_int8(tmp_path):
    _write_evidence(tmp_path, _gpu(cuda_steady_gbps=31.0, cuda_u8_steady_gbps=18.7))
    variant, dec = rs_codec.pick_device_backend(art_dir=str(tmp_path))
    assert variant == "int8" and "no variant beats" in dec["reason"]


def test_absent_evidence_keeps_int8(tmp_path):
    variant, dec = rs_codec.pick_device_backend(art_dir=str(tmp_path))
    assert variant == "int8" and dec["tile"] is None
    assert "no committed" in dec["reason"]


def test_stale_evidence_keeps_int8_even_when_a_variant_wins(tmp_path):
    _write_evidence(tmp_path, {**_gpu(cuda_steady_gbps=31.0, cuda_bf16_steady_gbps=44.5),
                               "when": "2024-01-01T00:00Z"})
    variant, dec = rs_codec.pick_device_backend(art_dir=str(tmp_path))
    assert variant == "int8" and "stale" in dec["reason"]


def test_unparseable_when_is_treated_as_stale(tmp_path):
    _write_evidence(tmp_path, {**_gpu(cuda_steady_gbps=31.0, cuda_dma_steady_gbps=50.0),
                               "when": "last tuesday"})
    variant, dec = rs_codec.pick_device_backend(art_dir=str(tmp_path))
    assert variant == "int8" and "unparseable" in dec["reason"]


@pytest.mark.parametrize("platform, card", [("cpu", CARD), ("gpu", None), ("tpu", CARD)])
def test_off_card_evidence_never_flips(tmp_path, platform, card):
    _write_evidence(tmp_path, {**_gpu(cuda_steady_gbps=0.04, cuda_mplane_steady_gbps=1.0),
                               "platform": platform, "card": card})
    variant, dec = rs_codec.pick_device_backend(art_dir=str(tmp_path))
    assert variant == "int8" and "not an on-chip" in dec["reason"]


def test_evidence_without_an_int8_number_keeps_int8(tmp_path):
    _write_evidence(tmp_path, _gpu(sweep={"encode": {"cuda-dma-65536": 45.0}}))
    variant, dec = rs_codec.pick_device_backend(art_dir=str(tmp_path))
    assert variant == "int8" and "lacks an int8" in dec["reason"]


def test_newest_round_wins_and_unreadable_newest_falls_back(tmp_path):
    _write_evidence(tmp_path, _gpu(cuda_steady_gbps=31.0, cuda_auto_steady_gbps=30.0,
                                   cuda_u8_steady_gbps=18.0), name="GPU_MEASUREMENT_r04.json")
    _write_evidence(tmp_path, _gpu(cuda_steady_gbps=31.0, cuda_dma_steady_gbps=50.0),
                    name="GPU_MEASUREMENT_r06.json")
    variant, dec = rs_codec.pick_device_backend(art_dir=str(tmp_path))
    assert variant == "dma" and dec["evidence_file"] == "GPU_MEASUREMENT_r06.json"
    with open(os.path.join(tmp_path, "GPU_MEASUREMENT_r06.json"), "w") as f:
        f.write("{torn")
    variant, dec = rs_codec.pick_device_backend(art_dir=str(tmp_path))
    assert variant == "int8" and dec["evidence_file"] == "GPU_MEASUREMENT_r04.json"


def test_reference_evidence_files_are_not_read(tmp_path):
    _write_evidence(tmp_path, {"when": _fresh_when(), "platform": "tpu", "xla_steady_gbps": 1.0,
                               "pallas_dma_steady_gbps": 50.0}, name="DEVICE_MEASUREMENT_r06.json")
    variant, dec = rs_codec.pick_device_backend(art_dir=str(tmp_path))
    assert variant == "int8" and "no committed" in dec["reason"]


def test_sweep_section_counts_as_evidence(tmp_path):
    _write_evidence(tmp_path, _gpu(sweep={
        "encode": {"cuda-mplane-32768": 47.2, "cuda-auto": 31.0},
        "rebuild": {"rebuild-cuda-dma-auto": 90.0}}))
    variant, dec = rs_codec.pick_device_backend(art_dir=str(tmp_path))
    assert variant == "mplane" and dec["tile"] == 32768
    assert dec["int8_steady_gbps"] == 31.0


def test_sweep_only_evidence_decides_and_rebuild_numbers_never_pick(tmp_path):
    _write_evidence(tmp_path, _gpu(sweep={"encode": {"cuda-auto": 31.2, "cuda-dma-65536": 45.0}}))
    variant, dec = rs_codec.pick_device_backend(art_dir=str(tmp_path))
    assert (variant, dec["tile"], dec["int8_steady_gbps"]) == ("dma", 65536, 31.2)
    _write_evidence(tmp_path, _gpu(sweep={"encode": {"cuda-auto": 31.2, "cuda-u8-auto": 19.0},
                                          "rebuild": {"rebuild-cuda-bf16-8192": 99.0}}))
    variant, dec = rs_codec.pick_device_backend(art_dir=str(tmp_path))
    assert variant == "int8" and "no variant beats" in dec["reason"]


def test_int8_at_an_explicit_tile_can_beat_its_own_default(tmp_path):
    _write_evidence(tmp_path, _gpu(sweep={"encode": {"cuda-auto": 30.0, "cuda-16384": 33.0}}))
    variant, dec = rs_codec.pick_device_backend(art_dir=str(tmp_path))
    assert (variant, dec["tile"]) == ("int8", 16384)


def test_evidence_naming_a_tile_its_kernel_rejects_keeps_int8(tmp_path, monkeypatch):
    """The best label, cuda-bf16-1024, names a tile the bf16 kernel does not
    take (whole trips of 2048): it is skipped, as the reference leaves its
    default for evidence it cannot use, and the factory still builds an
    encoder. A usable label that beats int8 is still chosen beside it."""
    _write_evidence(tmp_path, _gpu(sweep={"encode": {"cuda-auto": 580.0, "cuda-bf16-1024": 700.0}}))
    variant, dec = rs_codec.pick_device_backend(art_dir=str(tmp_path))
    assert (variant, dec["tile"]) == ("int8", None)
    assert list(dec["skipped"]) == ["cuda-bf16-1024"] and "cuda-bf16-1024" in dec["reason"]
    assert "multiple of 2048" in dec["skipped"]["cuda-bf16-1024"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(rs_codec, "_artifacts_dir", lambda: str(tmp_path))
    enc = rs_codec.new_encoder()
    assert (enc.variant, enc.tile, enc.selection["source"]) == ("int8", None, "on-chip-evidence")
    _write_evidence(tmp_path, _gpu(sweep={"encode": {"cuda-auto": 580.0, "cuda-bf16-1024": 700.0,
                                                     "cuda-u8-1024": 600.0}}))
    enc = rs_codec.new_encoder()
    assert (enc.variant, enc.tile) == ("u8", 1024)


def test_variant_label_parsing():
    cases = {
        "cuda_steady_gbps": ("int8", None),
        "cuda_auto_steady_gbps": ("int8", None),
        "cuda_bf16_steady_gbps": ("bf16", None),
        "cuda_tile8192_steady_gbps": ("int8", 8192),
        "cuda-u8-16384": ("u8", 16384),
        "cuda-dma-auto": ("dma", None),
        "cuda-65536": ("int8", 65536),
        "rebuild-cuda-mplane-8192": ("mplane", 8192),
    }
    for label, want in cases.items():
        assert rs_codec.parse_fused_variant(label) == want, label
        ref_label = label.replace("cuda", "pallas")
        assert ref_codec.parse_fused_variant(ref_label) == want, ref_label


# -- new_encoder ----------------------------------------------------------------


def test_new_encoder_on_the_card_applies_evidence(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(rs_codec, "_artifacts_dir", lambda: str(tmp_path))
    enc = rs_codec.new_encoder()
    assert (enc.variant, enc.tile) == ("int8", None)
    assert enc.selection["source"] == "default" and enc.selection["variant"] == "int8"
    _write_evidence(tmp_path, _gpu(sweep={"encode": {"cuda-auto": 31.0, "cuda-u8-8192": 40.0}}))
    enc = rs_codec.new_encoder(family="cauchy_12_3")
    assert (enc.variant, enc.tile, enc.device.type) == ("u8", 8192, "cuda")
    assert enc.selection["source"] == "on-chip-evidence"
    assert enc.selection["evidence_file"] == "GPU_MEASUREMENT_r91.json"
    cpu = rs_codec.new_encoder(device="cpu")  # the CPU path reads no evidence
    assert (cpu.variant, cpu.tile, cpu.selection["source"]) == ("int8", None, "explicit")


def test_evidence_age_knob_is_registered():
    from seaweedfs_tpu_torch.utils import config

    assert config.env("WEEDTPU_EVIDENCE_MAX_AGE_DAYS") == ref_codec.EVIDENCE_MAX_AGE_DAYS
    assert rs_codec.EVIDENCE_MAX_AGE_DAYS == 120.0


# -- the sweep's harvest file and the assembler ----------------------------------


def test_sweep_resume_ignores_other_mode_records(tmp_path):
    p = tmp_path / "SWEEP.jsonl"
    with open(p, "w") as f:
        f.write(json.dumps({"variant": "cuda-auto", "platform": "cpu", "tiny": True,
                            "exact": True}) + "\n")
        f.write(json.dumps({"variant": "cuda-dma-auto", "platform": "gpu", "tiny": False,
                            "steady_gbps": 50.0}) + "\n")
    done = ks.load_done(str(p), platform="gpu", tiny=False)
    assert "cuda-dma-auto" in done and "cuda-auto" not in done
    done = ks.load_done(str(p), platform="cpu", tiny=True)
    assert "cuda-auto" in done and "cuda-dma-auto" not in done


def test_resume_terminates_a_torn_tail(tmp_path):
    out = str(tmp_path / "harvest.jsonl")
    recs = [{"variant": f"v{i}", "platform": "gpu", "tiny": False, "steady_gbps": float(i)}
            for i in range(5)]
    f = ks.open_resume_out(out, resume=False)
    for r in recs[:3]:
        ks.persist_record(f, r)
    f.close()
    with open(out, "a") as f:  # a crash mid-write: half a record, no newline
        f.write(json.dumps(recs[3])[:17])
    f = ks.open_resume_out(out, resume=True)
    for r in recs[3:]:
        ks.persist_record(f, r)
    f.close()
    done = ks.load_done(out)
    assert sorted(done) == [f"v{i}" for i in range(5)]
    assert all(done[r["variant"]] == r for r in recs)


def test_assembled_harvest_is_what_the_factory_reads(tmp_path):
    sweep = tmp_path / "SWEEP.jsonl"
    when = datetime.datetime.now(datetime.timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")
    rows = [("cuda-auto", 30.0), ("cuda-bf16-auto", 29.0), ("cuda-mplane-16384", 36.5),
            ("rebuild-cuda-auto", 55.0)]
    with open(sweep, "w") as f:
        for name, gbps in rows:
            f.write(json.dumps({"variant": name, "platform": "gpu", "card": CARD, "tiny": False,
                                "when": when, "steady_gbps": gbps}) + "\n")
        f.write(json.dumps({"variant": "cuda-u8-auto", "platform": "gpu", "card": CARD,
                            "tiny": False, "when": when, "error": "boom"}) + "\n")
        f.write(json.dumps({"variant": "cuda-dma-auto", "platform": "cpu", "tiny": True,
                            "steady_gbps": 999.0}) + "\n")
        f.write('{"variant": "cuda-dma-8192", "platf')  # torn tail
    art = tmp_path / "art"
    assert device_window.main(["--sweep", str(sweep), "--out",
                               str(art / "GPU_MEASUREMENT_r02.json"), "--round", "2"]) == 0
    with open(art / "GPU_MEASUREMENT_r02.json") as f:
        meas = json.load(f)
    assert meas["platform"] == "gpu" and meas["card"] == CARD and meas["round"] == 2
    assert meas["sweep"]["encode"] == {"cuda-auto": 30.0, "cuda-bf16-auto": 29.0,
                                       "cuda-mplane-16384": 36.5}
    assert meas["sweep"]["rebuild"] == {"rebuild-cuda-auto": 55.0}
    assert meas["sweep"]["failed"] == ["cuda-u8-auto"]
    assert meas["sweep_best_encode"] == {"variant": "cuda-mplane-16384", "steady_gbps": 36.5}
    variant, dec = rs_codec.pick_device_backend(art_dir=str(art))
    assert (variant, dec["tile"]) == ("mplane", 16384)


def test_sweep_configs_cover_every_variant():
    names = [c[0] for c in ks.build_variants(quick=True)]
    assert len(names) == len(set(names))
    for c in ks.build_variants(quick=True):
        assert rs_codec.parse_fused_variant(c[0]) == (c[1], c[2]), c[0]
    assert {c[1] for c in ks.build_variants(quick=False)} == set(rs_codec.FUSED_VARIANTS)


def test_sweep_outside_smoke_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ks.main(["--quick"])
    with pytest.raises(ValueError, match="CUDA tensor"):
        measure.scan_chain_gbps(lambda d: d, torch.zeros((1, 10, 8), dtype=torch.uint8), 80)


def test_kernel_sweep_smoke_gate(tmp_path):
    """`--smoke` checks every configuration of every variant on the CPU and
    exits nonzero on any failure; its records land in --out."""
    out = tmp_path / "smoke.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch.scripts.kernel_sweep", "--smoke",
         "--out", str(out)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    summary = lines[-1]
    assert summary["smoke_ok"] and not summary["failed"]
    assert summary["kernels"] == sorted(rs_codec.FUSED_VARIANTS)
    recs = [r for r in lines if "exact" in r]
    assert len(recs) == summary["variants"] and all(r["exact"] for r in recs)
    assert all(r["platform"] == "cpu" and r["tiny"] for r in recs)
    assert len(ks.load_done(str(out), platform="cpu", tiny=True)) == summary["variants"]
    assert device_window.parse_sweep_jsonl(str(out))["encode"] == {}  # never evidence
