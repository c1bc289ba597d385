"""The benchmark of `seaweedfs_tpu_torch`, the PyTorch/CUDA port: the
Encoder's stripe stream on one card.

Run one cell once (from the root of a checkout, on a machine with a card):

    python3 ecbench/run.py --workload rs10p4-30g.encode --seed 7 --seconds 51 --trace 0

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), `device`, with `--trace 1` `breakdown`,
and last `compared`, the numbers the check compared, each with its
limit; standard error ends with the same numbers, one per line. Without
a card the run exits 2 and prints no result.

What each file holds:

  * `run.py`: the harness. Set-up, the closed-loop window, the traced
    window, the check, the result line.
  * `workload.py`: the one general generator. A cell `<config>.<traffic>`
    is a `workloads` entry of BENCHMARK.json; its configuration and
    traffic files become the call shape and the seeded inputs.
  * `configs/<name>.json`: a deployment: the code, the layout of bytes
    into a call, buffer sizes, the guarantee, its public source and what
    was assumed.
  * `traffic/<name>.json`: the operation (`encode`, or `rebuild` of
    `lost`) and the calls in flight (`depth`). The harness's own settings
    (pinned input batches, warm calls, answers sampled) are constants in
    `workload.py`.
  * `metrics/<name>.py`: one reader per metric, `read(record)` returning a
    number or None; a metric `a.b` without its own file is read by
    `metrics/a.py`.
  * `reference.py`: the plain GF(2^8) Reed-Solomon reference (NumPy
    matrices, plain PyTorch bytes); it imports nothing of the program.
  * `devtrace.py`: `torch.profiler` events to busy, idle, copy and kernel
    time and the idle gaps by host span.
  * `peaks.json`: the table of peaks the rooflines divide by.
  * `faults.py`: the control (the reference in the program's place,
    answering with the previous call's bytes) and the planted faults.
  * `tests/`: `python3 -m pytest ecbench/tests -q`; the `cuda`-marked
    tests skip without a card and run on the chip, where
    `test_ecbench_card.py` reads the two sides that each limit of the
    comparison is set from (the program on a dozen seeds, the control
    and each fault on three), one JSON line per cell with `-s`.

Adding, with new files only: a deployment is `configs/<name>.json` (a new
`layout` needs a branch in `workload.plan`); a traffic mix is
`traffic/<name>.json`; a cell is a `workloads` entry naming both; a
per-layer metric is an entry in `per_layer` and, where no reader of its
stem exists, `metrics/<name>.py` reading the run's record (`op`,
`setup_s`, `window`: seconds, bytes in, per-call latencies and enqueue
times; `trace`: window, busy, kernel and copy seconds, bytes; `peak`).
"""
