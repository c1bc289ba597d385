"""On the card (skipped without one): the two readings that each limit of
the comparison is set from, at each cell's own size and load, and a
traced run of each cell that reads the device, and an encoder that the
factory sends off the card gives no result.

The limits test reads, in one process, the program on a dozen seeds (the
lower reading of each number compared: the largest), the control on
three and each planted fault on three (the upper: the smallest), each a
short window of the cell made and checked as `run.py` makes and checks
it, and prints the readings as one JSON line per cell:

    python3 -m pytest ecbench/tests/test_ecbench_card.py -q -s
"""

import json

import pytest

from ecbench import faults, run, workload

BENCH = workload.benchmark_file(run.ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
PROGRAM_SEEDS = range(2**31 + 101, 2**31 + 113)
OTHER_SEEDS = (2**31 + 201, 2**31 + 202, 2**31 + 203)


def _note(sides: dict, side: str, r: dict) -> None:
    s = sides.setdefault(side, {"runs": 0, "correct": 0})
    s["runs"] += 1
    s["correct"] += int(r["correct"])
    pick = max if side == "program" else min
    for k, v in r["compared"].items():
        s[k] = v["value"] if k not in s else pick(s[k], v["value"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_limits_separate_the_program_from_the_control_and_faults(card, cell):
    cfg = workload.config_file(workload.cell_entry(BENCH, cell)["config"])
    sides: dict = {}
    for seed in PROGRAM_SEEDS:
        r = run.run_cell(cell, seed, 1.0, False)
        assert r["failed"] == 0
        assert set(r["metrics"]) == {m["name"] for m in run.metrics_for(BENCH, cell, False)}
        _note(sides, "program", r)
    for seed in OTHER_SEEDS:
        control = faults.Control(cfg["data_shards"], cfg["parity_shards"], card)
        _note(sides, "control", run.run_cell(cell, seed, 1.0, False, encoder=control))
    for kind in faults.KINDS:
        for seed in OTHER_SEEDS:
            with faults.planted(kind):
                _note(sides, f"fault:{kind}", run.run_cell(cell, seed, 1.0, False))
    print(json.dumps({"workload": cell, "readings": sides}), flush=True)
    program = sides.pop("program")
    assert program["correct"] == len(PROGRAM_SEEDS) and program["wrong_bytes"] == 0, program
    for side, s in sides.items():
        assert s["correct"] == 0 and s["wrong_bytes"] > 0, (side, s)


@pytest.mark.cuda
def test_an_encoder_off_the_card_gives_no_result(card, monkeypatch):
    monkeypatch.setenv("WEEDTPU_BACKEND", "xorsched")
    with pytest.raises(RuntimeError, match="not on one card"):
        run.run_cell("rs10p4-30g.rebuild1", 2**31 + 401, 1.0, False)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_device(card, cell):
    r = run.run_cell(cell, 2**31 + 301, 3.0, True)
    assert r["correct"] is True
    assert set(r["metrics"]) == {m["name"] for m in run.metrics_for(BENCH, cell, True)}
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    op = workload.traffic_file(workload.cell_entry(BENCH, cell)["traffic"])["op"]
    assert 0 < r["metrics"][f"kernel_roofline.{op}"]["value"] <= 105
    assert r["breakdown"]["device_ops"] and r["breakdown"]["idle_gaps"]
