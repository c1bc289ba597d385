"""A run whose timed path is broken underneath comes out not correct, and
a sound one correct: every cell at a cut size on the CPU, the harness's
look for a card skipped. The control (the reference in the program's
place, answering with the call before's bytes) fails too."""

import pytest

from ecbench import faults, run, workload

CUT = {"max_width": 2048}
CELLS = [w["name"] for w in workload.benchmark_file(run.ROOT)["workloads"]]


def _run(cell, seed, encoder=None):
    return run.run_cell(cell, seed, 1.0, False, device="cpu", encoder=encoder, **CUT)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = _run(cell, 2**31 + 11)
    assert r["correct"] is True
    assert r["compared"]["wrong_bytes"]["value"] == 0


@pytest.mark.parametrize("kind", faults.KINDS)
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_is_not_correct(cell, kind):
    with faults.planted(kind):
        r = _run(cell, 2**31 + 12)
    assert r["correct"] is False
    assert r["compared"]["wrong_bytes"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    cfg = workload.config_file(workload.cell_entry(workload.benchmark_file(run.ROOT), cell)["config"])
    control = faults.Control(cfg["data_shards"], cfg["parity_shards"], "cpu")
    r = _run(cell, 2**31 + 13, encoder=control)
    assert r["correct"] is False
    assert r["compared"]["wrong_bytes"]["value"] > 0


@pytest.mark.parametrize("at", [30, 120])  # in set-up's warm calls, in the window
def test_a_call_that_raises_is_not_correct(monkeypatch, at):
    from seaweedfs_tpu_torch.ops import rs_cuda

    real = rs_cuda.apply_matrix
    calls = {"n": 0}

    def flaky(m, shards, tile=None, variant="int8"):
        calls["n"] += 1
        if calls["n"] == at:
            raise RuntimeError("planted launch failure")
        return real(m, shards, tile, variant)

    monkeypatch.setattr(rs_cuda, "apply_matrix", flaky)
    r = _run("rs10p4-30g.encode", 2**31 + 14)
    assert r["compared"]["failed_calls"]["value"] == 1 and r["correct"] is False
    assert r["failed"] == (1 if at > 100 else 0)
