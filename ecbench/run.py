"""Run one cell of the port's benchmark once, on one card.

    python3 ecbench/run.py --workload rs10p4-30g.encode --seed 7 --seconds 20 --trace 0

The cell (a `workloads` entry of BENCHMARK.json) names a configuration
(`configs/<name>.json`) and a traffic mix (`traffic/<name>.json`);
`workload.py` turns them into the call and its seeded inputs. Set-up makes
the inputs on the card, copies them into pinned host batches, and warms
the cell's one call shape. The window then drives the Encoder the volume
server gets, `rs_codec.new_encoder(k, m, "vandermonde", device="cuda")`,
as `ec/stripe.py` does: one closed-loop stream that issues
`encode_parity_lazy` (or `reconstruct_lazy`) on the next batch, drains
the oldest call with `np.asarray` whenever `depth` calls are in flight,
and drains all at the end. Disk reads, shard writes and CRCs are not in it.

With `--trace 0` the last line's metrics are the cell's end-to-end
metrics; with `--trace 1` its per-layer ones: the host-clock readings
from an untraced first part of the window, the device readings from
`torch.profiler` over the rest (at most 5 s). Each metric is read by
`metrics/<name>.py` (or `metrics/<name before the first dot>.py`), which
gets the run's record and returns a number or None.

After the window the peak device memory is read, the program's state is
dropped, and a sample of the drained answers, drawn from the seed with
the last one always in it, is compared with the plain reference
(`reference.py`) on the card; the numbers compared, each with its limit,
end standard error and the result line's `compared`.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from collections import deque  # noqa: E402
from contextlib import nullcontext  # noqa: E402
from typing import Callable, Optional  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[:1] != [ROOT]:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

_T_NUMPY = time.perf_counter()
import torch  # noqa: E402

_T_TORCH = time.perf_counter()
from ecbench import devtrace, workload  # noqa: E402

HERE = os.path.join(ROOT, "ecbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "seaweedfs_tpu")
TRACED_MAX_S = 5.0


def log(tag: str, payload) -> None:
    print(f"{tag} {json.dumps(payload)}", file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Top-level names in sys.modules that the run must not have loaded,
    compared whole: `seaweedfs_tpu_torch` is not `seaweedfs_tpu`."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def metrics_for(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (those without `workloads` are every
    cell's), or with `trace` the per-layer ones whose `workloads` list it."""
    if trace:
        return [m for m in bench["per_layer"] if cell in m["workloads"]]
    return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]


def reader(name: str) -> Callable:
    """`read(record)` of `metrics/<name>.py`, else of the file named by the
    part of `name` before its first dot."""
    for stem in (name, name.split(".")[0]):
        path = os.path.join(HERE, "metrics", f"{stem}.py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(f"ecbench_metric_{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r} under ecbench/metrics")


def peak_entry(kind: str) -> Optional[dict]:
    with open(os.path.join(HERE, "peaks.json"), encoding="utf-8") as f:
        return json.load(f).get(kind)


class Sampler:
    """Copies of `k` drained answers, each the first drained after one of
    `k` instants of the window drawn from the seed, into buffers made and
    touched in set-up, so sampling allocates nothing in the window; and the
    last answer the window drained, each as (call index, input slot,
    bytes)."""

    def __init__(self, k: int, seed: int, out_shape: tuple, seconds: float):
        rng = np.random.default_rng(np.random.SeedSequence([int(seed) % (1 << 64), 7]))
        self.at = sorted(float(x) for x in rng.uniform(0.0, seconds, k))
        self.bufs = []
        for _ in range(k):
            buf = np.empty(out_shape, dtype=np.uint8)
            buf.fill(0)
            self.bufs.append(buf)
        self.kept: list[tuple] = []
        self.last: Optional[tuple] = None
        self.t0: Optional[float] = None

    def offer(self, index: int, out: np.ndarray, t: float) -> None:
        if self.t0 is None:
            self.t0 = t
        n = len(self.kept)
        if n < len(self.at) and t - self.t0 >= self.at[n] and out.shape == self.bufs[n].shape:
            np.copyto(self.bufs[n], out)
            self.kept.append((index, index % workload.SLOTS, self.bufs[n]))

    def items(self) -> list[tuple]:
        out = list(self.kept)
        if self.last is not None and all(t[0] != self.last[0] for t in out):
            out.append(self.last)
        return out


def _span(on: bool):
    if not on:
        return lambda name: nullcontext()
    from torch.profiler import record_function

    return record_function


def drive(call: Callable, inputs: list, depth: int, state: dict, seconds: Optional[float] = None,
          calls: Optional[int] = None, sampler: Optional[Sampler] = None, traced: bool = False
          ) -> dict:
    """One closed-loop stream: issue the next batch, draining the oldest call
    first whenever `depth` are in flight, until `seconds` have passed or
    `calls` were issued; then drain every call in flight. `state` carries
    the call index (and so the input slot) and the count of failed calls
    across parts."""
    clock = time.perf_counter
    span = _span(traced)
    inflight: deque = deque()
    lat: list[float] = []
    enq: list[float] = []
    done_at: list[float] = []
    counts = {"attempted": 0, "failed": 0}

    def drain(last: bool = False) -> None:
        index, handle, t_issue = inflight.popleft()
        try:
            with span("ecbench.drain"):
                out = np.asarray(handle)
        except Exception:  # noqa: BLE001 — a call that never answers is counted, not fatal
            counts["failed"] += 1
            if counts["failed"] == 1:
                traceback.print_exc(file=sys.stderr)
            return
        t = clock()
        lat.append(t - t_issue)
        done_at.append(t)
        if sampler is not None:
            sampler.offer(index, out, t)
            if last:
                sampler.last = (index, index % len(inputs), out)

    i = state.get("next", 0)
    t0 = clock()
    deadline = None if seconds is None else t0 + seconds
    while True:
        if deadline is not None and clock() >= deadline:
            break
        if calls is not None and counts["attempted"] >= calls:
            break
        if len(inflight) >= depth:
            drain()
        counts["attempted"] += 1
        t_issue = clock()
        try:
            with span("ecbench.issue"):
                handle = call(inputs[i % len(inputs)])
        except Exception:  # noqa: BLE001 — counted as a call that never answers
            counts["failed"] += 1
            if counts["failed"] == 1:
                traceback.print_exc(file=sys.stderr)
            if counts["failed"] > 50:
                break
            i += 1
            continue
        enq.append(clock() - t_issue)
        inflight.append((i, handle, t_issue))
        i += 1
    while inflight:
        drain(last=len(inflight) == 1)
    t1 = clock()
    state["next"] = i
    state["failed"] = state.get("failed", 0) + counts["failed"]
    return {"seconds": t1 - t0, "attempted": counts["attempted"], "failed": counts["failed"],
            "drained": len(lat), "latency_s": lat, "enqueue_s": enq,
            "done_at": [d - t0 for d in done_at]}


def per_second(done_at: list[float], call_bytes: int) -> list[float]:
    """GB/s drained in each whole second of a window: a diagnostic."""
    if not done_at:
        return []
    bins = [0] * (int(done_at[-1]) + 1)
    for t in done_at:
        bins[int(t)] += 1
    return [round(n * call_bytes / 1e9, 3) for n in bins[: max(1, len(bins) - 1)]]


def _caller(enc, p: workload.Plan) -> Callable:
    if p.op == "encode":
        return enc.encode_parity_lazy
    survivors, lost = list(p.survivors), list(p.lost)
    return lambda stack: enc.reconstruct_lazy(stack, survivors, lost)


def check(p: workload.Plan, seed: int, items: list[tuple], device) -> dict:
    """The numbers compared, each with its limit. Every sampled answer is
    held against the reference's answer for its input (encode: the
    parity; rebuild: the shards that were lost, which the reference's own
    rebuild must equal as well)."""
    wrong = ref_wrong = 0
    by_slot: dict[int, list] = {}
    for index, slot, out in items:
        by_slot.setdefault(slot, []).append(out)
    for slot, outs in sorted(by_slot.items()):
        answer, lost = workload.expected(p, seed, slot, device)
        truth = answer
        if lost is not None:
            ref_wrong += int((answer != lost).sum())
            truth = lost
        for out in outs:
            if tuple(out.shape) != tuple(truth.shape):
                wrong += truth.numel()
                continue
            got = torch.from_numpy(np.ascontiguousarray(out)).to(device)
            wrong += int((got != truth).sum())
        del answer, lost, truth
    compared = {"wrong_bytes": {"value": wrong, "limit": 0}}
    if p.op == "rebuild":
        compared["reference_wrong_bytes"] = {"value": ref_wrong, "limit": 0}
    compared["answers_checked"] = {"value": len(items), "at_least": 2}
    return compared


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             max_width: Optional[int] = None, encoder=None) -> dict:
    """One run of `cell`; returns the result line as a dict. The benchmark
    calls it on a card; the tests call it with device="cpu" at a cut width
    (`max_width`) and, for the control, their own `encoder`."""
    clock = time.perf_counter
    bench = workload.benchmark_file(ROOT)
    entry = workload.cell_entry(bench, cell)
    p = workload.plan(workload.config_file(entry["config"]),
                      workload.traffic_file(entry["traffic"]), max_width)
    parts: dict[str, float] = {}

    t = clock()
    from seaweedfs_tpu_torch.ops import rs_codec

    parts.update(start_to_numpy_s=_T_NUMPY - _T0, import_torch_s=_T_TORCH - _T_NUMPY,
                 import_port_s=clock() - t)
    t = clock()
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.init()
        torch.empty(1, device=dev)
        torch.cuda.synchronize()
    parts["context_s"] = clock() - t
    t = clock()
    enc = encoder if encoder is not None else rs_codec.new_encoder(
        p.data_shards, p.parity_shards, p.matrix_kind, device=device)
    if on_card and encoder is None and (enc.backend != "cuda" or enc.device.type != "cuda"):
        # WEEDTPU_BACKEND can send the factory to a host codec or the mesh
        raise RuntimeError(f"the encoder runs on {enc.backend}/{enc.device}, not on one card; "
                           f"no result (selection {enc.selection})")
    parts["encoder_s"] = clock() - t
    t = clock()
    inputs = workload.make_inputs(p, seed, dev)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    parts["inputs_s"] = clock() - t
    call = _caller(enc, p)
    state: dict = {}
    t = clock()
    drive(call, inputs, p.depth, state, calls=1)
    parts["first_call_s"] = clock() - t
    t = clock()
    drive(call, inputs, p.depth, state, calls=workload.WARM_CALLS)
    parts["warm_s"] = clock() - t
    sampler = Sampler(workload.SAMPLE, seed, p.out_shape, seconds)
    if trace and on_card:
        from torch.profiler import ProfilerActivity, profile

        t = clock()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            drive(call, inputs, p.depth, state, calls=2, traced=True)
        parts["profiler_s"] = clock() - t
    setup_s = clock() - _T0
    parts["setup_s"] = setup_s
    log("ecbench.setup", parts)

    traced_s = min(TRACED_MAX_S, seconds * 0.3) if trace else 0.0
    host = drive(call, inputs, p.depth, state, seconds=seconds - traced_s, sampler=sampler)
    red = None
    if trace:
        if on_card:
            from torch.profiler import ProfilerActivity, profile, record_function

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                with record_function(devtrace.WINDOW):
                    part = drive(call, inputs, p.depth, state, seconds=traced_s,
                                 sampler=sampler, traced=True)
            t = clock()
            red = devtrace.reduce(devtrace.from_profiler(prof))
            log("ecbench.trace_read_s", clock() - t)
            del prof
        else:
            part = drive(call, inputs, p.depth, state, seconds=traced_s, sampler=sampler)
        traced_calls = part["drained"]
        if red is not None:
            red.update(calls=traced_calls, in_bytes=traced_calls * p.in_bytes,
                       out_bytes=traced_calls * p.out_bytes,
                       min_bytes=traced_calls * (p.in_bytes + p.out_bytes))
        host = {**host, "attempted": host["attempted"] + part["attempted"],
                "failed": host["failed"] + part["failed"]}
    log("ecbench.per_second_GBps", per_second(host["done_at"], p.in_bytes))

    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    del call, enc, encoder
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = clock()
    compared = check(p, seed, sampler.items(), dev)
    compared["failed_calls"] = {"value": state["failed"], "limit": 0}  # set-up's calls too
    log("ecbench.check_s", clock() - t)

    rec = {
        "op": p.op, "setup_s": setup_s, "trace": red, "peak": peak_entry(kind),
        "window": {"seconds": host["seconds"], "in_bytes": host["drained"] * p.in_bytes,
                   "latency_s": host["latency_s"], "enqueue_s": host["enqueue_s"]},
    }
    metrics = {}
    for m in metrics_for(bench, cell, trace):
        value = reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(v["value"] <= v["limit"] for v in compared.values() if "limit" in v) and all(
        v["value"] >= v["at_least"] for v in compared.values() if "at_least" in v)
    dev_info = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": 1,
                "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": host["attempted"], "failed": host["failed"],
              "metrics": metrics, "device": dev_info}
    if red is not None:
        dev_info.update(busy_s=red["busy_s"], window_s=red["window_s"])
        result["breakdown"] = {"device_ops": red["device_ops"], "idle_gaps": red["idle_gaps"]}
    result["compared"] = compared
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    entry = workload.cell_entry(workload.benchmark_file(ROOT), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(entry["chips"]):
        print(f"ecbench: the cell needs {entry['chips']} CUDA card(s); "
              f"this machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"ecbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    for name, v in result["compared"].items():
        bound = f"limit {v['limit']}" if "limit" in v else f"at least {v['at_least']}"
        print(f"compared {name} {v['value']} {bound}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
