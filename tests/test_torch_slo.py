"""The port's SLO recorder (`seaweedfs_tpu_torch/ec/slo.py`) against the
reference's: twins of the recorder, verdict and report cases of
`tests/test_slo_harness.py` and of `test_obs.py`'s trace-attribution
case. Each case makes the reference's own assertions on both packages
from the same seeded observations and requires the recorder JSON, the
quantiles, the verdicts and the reports to be equal (tolerance 0; the
report's `when` stamp taken out)."""

import json

import numpy as np
import pytest

from seaweedfs_tpu.ec import slo as ref_slo
from seaweedfs_tpu_torch.ec import slo as port_slo

from test_torch_obs import _fake_trace

PACKAGES = {"ref": ref_slo, "port": port_slo}


def both(case, *args):
    """`case(slo, *args)` on each package: the results must be equal."""
    out = {name: case(slo, *args) for name, slo in PACKAGES.items()}
    assert out["port"] == out["ref"]
    return out["port"]


def test_bucket_bounds_are_the_reference():
    assert port_slo.BUCKET_BOUNDS == ref_slo.BUCKET_BOUNDS
    assert port_slo.REPORT_SCHEMA_KEYS == ref_slo.REPORT_SCHEMA_KEYS
    assert port_slo.TRACE_ATTRIB_SCHEMA_KEYS == ref_slo.TRACE_ATTRIB_SCHEMA_KEYS


def _quantiles_track_numpy(slo):
    rng = np.random.default_rng(5)
    samples = np.exp(rng.normal(-4.0, 1.0, size=20_000))  # lognormal, ~18ms median
    rec = slo.LatencyRecorder()
    for s in samples:
        rec.observe("steady", "healthy", float(s))
    cell = rec.merged("healthy")
    got = {}
    for q in (0.50, 0.95, 0.99):
        exact = float(np.percentile(samples, q * 100))
        got[q] = cell.quantile(q)
        assert exact * 0.9 <= got[q] <= exact * 1.12, (q, got[q], exact)
    assert cell.total == len(samples)
    return {"quantiles": got, "recorder": rec.to_dict(), "phases": rec.phases()}


def test_recorder_quantiles_track_numpy():
    both(_quantiles_track_numpy)


def _phases_classes_and_errors(slo):
    rec = slo.LatencyRecorder()
    rec.observe("steady", "healthy", 0.01)
    rec.observe("steady", "degraded", 0.05)
    rec.observe("chaos", "degraded", 0.2)
    rec.error("chaos", "degraded")
    phases = rec.phases()
    assert set(phases) == {"steady", "chaos"}
    assert phases["chaos"]["degraded"]["errors"] == 1
    assert phases["steady"]["healthy"]["count"] == 1
    merged = rec.merged("degraded")
    assert merged.total == 2 and merged.errors == 1
    return {"phases": phases, "merged": merged.summary(), "recorder": rec.to_dict()}


def test_recorder_phases_classes_and_errors():
    both(_phases_classes_and_errors)


def _round_trips_and_merges(slo):
    a, b = slo.LatencyRecorder(), slo.LatencyRecorder()
    local = slo.LatencyRecorder()
    rng = np.random.default_rng(11)
    for s in np.exp(rng.normal(-4.0, 1.0, size=2000)):
        a.observe("steady", "cached", float(s))
        local.observe("steady", "cached", float(s))
    for s in np.exp(rng.normal(-3.0, 1.0, size=500)):
        b.observe("chaos", "degraded", float(s))
        local.observe("chaos", "degraded", float(s))
    b.error("chaos", "degraded")
    local.error("chaos", "degraded")
    merged = slo.LatencyRecorder()
    merged.merge_dict(json.loads(json.dumps(a.to_dict())))
    merged.merge_dict(json.loads(json.dumps(b.to_dict())))
    for klass in ("cached", "degraded"):
        want, got = local.merged(klass), merged.merged(klass)
        assert got.total == want.total and got.errors == want.errors
        for q in (0.5, 0.99):
            assert got.quantile(q) == want.quantile(q)
    bad = a.to_dict()
    key = next(iter(bad))
    bad[key]["counts"] = bad[key]["counts"][:-1]
    with pytest.raises(ValueError, match="bucket count mismatch"):
        slo.LatencyRecorder().merge_dict(bad)
    return {"merged": merged.to_dict(), "phases": merged.phases()}


def test_recorder_round_trips_and_merges_across_processes():
    both(_round_trips_and_merges)


def test_recorder_json_merges_across_packages():
    """A worker's recorder JSON from one package folds into the other's
    recorder bucket for bucket (the weedload worker-file contract)."""
    rng = np.random.default_rng(3)
    recs = {name: slo.LatencyRecorder() for name, slo in PACKAGES.items()}
    for s in np.exp(rng.normal(-4.5, 1.2, size=3000)):
        for rec in recs.values():
            rec.observe("chaos", "degraded", float(s))
    into_port, into_ref = port_slo.LatencyRecorder(), ref_slo.LatencyRecorder()
    into_port.merge_dict(json.loads(json.dumps(recs["ref"].to_dict())))
    into_ref.merge_dict(json.loads(json.dumps(recs["port"].to_dict())))
    assert into_port.to_dict() == into_ref.to_dict() == recs["ref"].to_dict()


def _verdict_and_report_schema(slo, tmp_path):
    rec = slo.LatencyRecorder()
    for _ in range(30):
        rec.observe("steady", "healthy", 0.01)
        rec.observe("steady", "degraded", 0.03)
    verdict = slo.slo_verdict(rec, factor=5.0)
    assert verdict["ok"] and verdict["enough_samples"]
    assert verdict["ratio"] is not None and verdict["ratio"] < 5.0
    for _ in range(5):
        rec.observe("steady", "degraded", 3.0)
    over = slo.slo_verdict(rec, factor=5.0)
    assert not over["ok"]
    empty = slo.LatencyRecorder()
    empty.observe("steady", "degraded", 0.1)
    v = slo.slo_verdict(empty)
    assert v["ratio"] is None and not v["ok"]
    json.dumps(v, allow_nan=False)
    erry = slo.LatencyRecorder()
    for _ in range(30):
        erry.observe("steady", "healthy", 0.01)
        erry.observe("steady", "degraded", 0.02)
    for _ in range(60):
        erry.error("steady", "degraded")
    ve = slo.slo_verdict(erry, factor=5.0)
    assert ve["ratio"] is not None and ve["ratio"] < 5.0
    assert ve["degraded_error_rate"] > 0.5 and not ve["ok"]

    report = slo.assemble_report(rec, workload={"rps": 1}, chaos={"killed": ["n0"]},
                                 lost=[], classes=("healthy", "degraded", "put"),
                                 corruption={"all_healed": True, "injected": 2})
    for key in slo.REPORT_SCHEMA_KEYS:
        assert key in report
    out = tmp_path / f"SLO_{slo.__name__.split('.')[0]}.json"
    slo.write_report(str(out), report)
    again = json.loads(out.read_text())
    assert again["slo"]["target"].startswith("degraded_p99 < ")
    with pytest.raises(ValueError, match="missing required key"):
        slo.write_report(str(out), {"when": "x"})
    again.pop("when")
    return {"verdicts": [verdict, over, v, ve], "report": again}


def test_slo_verdict_and_report_schema(tmp_path):
    both(_verdict_and_report_schema, tmp_path)


def _attribution_aggregation_consistency(slo, tmp_path):
    traces = [_fake_trace() for _ in range(10)]
    for i, t in enumerate(traces):
        t["trace_id"] = f"ab{i:02x}"
        t["duration_s"] = 0.1 * (i + 1)
    attrib = slo.assemble_trace_attribution(traces)
    cls = attrib["classes"]["degraded"]
    assert cls["count"] == 10
    assert abs(cls["stage_coverage"] - 1.0) < 1e-6
    assert abs(cls["e2e_total_s"] - sum(0.1 * (i + 1) for i in range(10))) < 1e-6
    assert len(attrib["slowest"]) == 5
    assert attrib["slowest"][0]["duration_s"] == pytest.approx(1.0)
    shares = sum(s["share"] for s in cls["stages"].values())
    assert abs(shares - 1.0) < 1e-3
    out = tmp_path / f"TRACE_ATTRIB_{slo.__name__.split('.')[0]}.json"
    slo.write_trace_attribution(str(out), attrib)
    with pytest.raises(ValueError, match="missing required key"):
        slo.write_trace_attribution(str(out), {"when": "x"})
    again = json.loads(out.read_text())
    again.pop("when")
    return again


def test_attribution_aggregation_consistency(tmp_path):
    """The `slo` case of `test_obs.py`: per-class stage totals equal the
    summed end-to-end latencies (stage_coverage 1.0), port and reference
    alike."""
    both(_attribution_aggregation_consistency, tmp_path)
