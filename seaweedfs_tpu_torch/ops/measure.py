"""Scan-chain throughput on the card: the slope method of the reference's
`ops/measure.py`, with CUDA-event timing.

Time one chain of K=1 and one of K=8 chained, data-dependent applies
(`acc ^= apply(d ^ i)[:, :out_rows]`); the slope (t8 - t1) / 7 is the
device time of one apply with the fixed per-chain cost cancelled. The
xor-chain keeps every apply dependent on its index, so none can be
skipped. Each apply's input `d ^ i` is a fresh tensor, as in the
reference, so the slope includes that elementwise pass (one read and one
write of the data) besides the kernel.

The chains are captured as CUDA graphs when capture of the ctypes launch
works (the operand caches are warmed first, so nothing uploads inside the
capture), which takes Python and launch overhead out of the chain;
otherwise they run eagerly. `last_method` says which.

`graph_ms` times one kernel call with no host time in it: many launches
captured in one CUDA graph, the graph replayed between two events.
`eager_ms` times one eager call, the host time of the call included.
"""

from __future__ import annotations

import statistics
import subprocess

import torch

#: "graph" or "eager": how the last `scan_chain_gbps` ran its chains
last_method = None

#: H100 SXM published peaks (dense): HBM bytes/s, and tensor-core operations
#: per second for the type each variant's TPU kernel takes its product in
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "u8": 1979e12, "mplane": 1979e12, "dma": 1979e12}


def bound_ms(variant: str, c: int, r: int, n: int, batch: int = 1) -> tuple[float, str]:
    """The least time in ms the card could take to apply an (R, C) matrix
    to (batch, C, N) bytes with `variant`, and what sets it ("bytes" or
    "operations"): the larger of the (C + R) * N bytes over HBM bandwidth
    and the TPU kernel's product, 2 * 8R * 8C operations per column, at
    the tensor-core rate of that variant's type (bf16 989e12; int8, u8,
    mplane and dma, whose TPU kernel takes an int8 `dot_general` per
    chunk, 1979e12)."""
    if variant not in OPS_PER_S:
        raise ValueError(f"no bound for variant {variant!r}")
    bytes_ms = (c + r) * n * batch / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * 8 * r * 8 * c * n * batch / OPS_PER_S[variant] * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` gives them: every time kept beside
    it, since a card set below its maximum power runs slower under load."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def eager_ms(fn, runs: int, warmed: bool = False) -> float:
    """Median of `runs` warm eager calls of `fn()`, each between two CUDA
    events: the host time of the call lies inside the window whenever the
    card waits on it. One call warms first, unless the caller has `warmed`
    it with a call of its own."""
    if not warmed:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, launches: int = 20, replays: int = 7) -> float:
    """Device milliseconds of one call `fn(i)` (i = 0 .. launches - 1),
    without the wrapper's host time: warm `fn` so that libraries load and
    operands upload outside the capture, capture `launches` calls in one
    CUDA graph, replay it `replays` times between two CUDA events, and
    return the median replay time over `launches`. Let `fn(i)` take its
    input in turn from buffers that together exceed the 50 MB L2, so that
    no launch finds its input there. Needs a card; raises without one."""
    if not torch.cuda.is_available():
        raise RuntimeError("graph_ms times the card: no CUDA device")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture, as torch asks
        for i in range(2):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(launches):
            fn(i)
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    del g
    torch.cuda.empty_cache()
    return statistics.median(times)


def _chain(encode_fn, data: torch.Tensor, k: int, out_rows: int) -> torch.Tensor:
    b, _c, n = data.shape
    acc = torch.zeros((b, out_rows, n), dtype=torch.uint8, device=data.device)
    for i in range(k):
        acc ^= encode_fn(data ^ i)[:, :out_rows]
    return acc


def _graph(encode_fn, data: torch.Tensor, k: int, out_rows: int):
    side = torch.cuda.Stream(device=data.device)
    side.wait_stream(torch.cuda.current_stream(data.device))
    with torch.cuda.stream(side):  # warm-up outside the capture, as torch asks
        _chain(encode_fn, data, k, out_rows)
    torch.cuda.current_stream(data.device).wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        _chain(encode_fn, data, k, out_rows)
    return g.replay


def _best_seconds(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


def scan_chain_gbps(
    encode_fn, data: torch.Tensor, data_bytes: int, iters: int = 3, out_rows: int = 4
) -> float:
    """Steady-state GB/s of `encode_fn` ((B, C, N) uint8 -> (B, R >= out_rows,
    N)) on `data`, a CUDA tensor. Raises ValueError when the slope is not
    positive: timing noise swamped it, and that is no throughput."""
    global last_method
    if not data.is_cuda:
        raise ValueError("scan_chain_gbps times the card: give it a CUDA tensor")
    encode_fn(data)  # load the library and upload the operand outside any capture
    torch.cuda.synchronize()
    try:
        runs = {k: _graph(encode_fn, data, k, out_rows) for k in (1, 8)}
        last_method = "graph"
    except RuntimeError:  # capture refused: time the chains eagerly
        torch.cuda.synchronize()
        runs = {k: (lambda k=k: _chain(encode_fn, data, k, out_rows)) for k in (1, 8)}
        last_method = "eager"
    t1 = _best_seconds(runs[1], iters)
    t8 = _best_seconds(runs[8], iters)
    per = (t8 - t1) / 7
    if per <= 0:
        raise ValueError(f"slope not measurable: t(1)={t1:.6f}s t(8)={t8:.6f}s")
    return data_bytes / per / 1e9
