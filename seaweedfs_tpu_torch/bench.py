"""The port's measurement harness: RS(10+4) encode GB/s on the card, the
degraded-read latency, and the byte-verified smokes of the EC features (the
counterpart of the reference's top-level `bench.py`).

    python -m seaweedfs_tpu_torch.bench [--device cuda|cpu] [--smoke]
    BENCH_MODE=<mode> python -m seaweedfs_tpu_torch.bench [--device cuda|cpu]
        [--smoke] [--out PATH] [--round N]

Prints ONE JSON line, the last line of standard output that starts with
`{`; warnings and the kernels' build output go to standard error.

Modes (`BENCH_MODE`), each the reference mode of the same name:
  probe           a child that counts the CUDA cards under a timeout
  cpu             the host baselines (gf8's numpy tables, the AVX2 library
                  of `csrc/gf_host.cc` on one core and on all), the bench
                  device's encode GB/s, the degraded-read latency through
                  `EcVolume`, a 128 MiB file encode end to end and a
                  4-lost rebuild per backend against the serial oracle
  xor             the XOR-schedule executors (`ops/xorsched`) against the
                  AVX2 library and the gf8 golden, each form also through
                  the bench device's int8 kernel; `--smoke` is
                  deterministic (no timing, no `when`). The full run is
                  the `xor` section that `rs_codec.pick_cpu_backend` reads;
                  it is written to a file only when `--out` names one
  rebuild_batch   a mixed-signature rebuild storm, fused (one dispatch)
                  against unfused (one per signature); `--smoke`
                  deterministic
  remote          the degraded-read ladder over an in-process owner and a
                  volume server subprocess
  rebuild_remote  the distributed rebuild over two in-process servers,
                  against a local rebuild and a serial fetch-then-decode
  rebuild_trace   the single-shard distributed rebuild, trace mode against
                  slab mode: wire bytes and walls
  ingest          inline encode-on-write against the warm encode, and the
                  delta-parity byte gate
  convert         geometry conversion against the decode + re-encode oracle
  mesh            `scripts/mesh_bench.measure_mesh` at the reference's sizes
  dp              the encode curve over `parallel/` meshes of 1, 2, 4, 8
                  positions, up to the number of cards
  device          a compile check at a tiny shape, then per-call and steady
                  GB/s (`ops/measure.scan_chain_gbps`) and device ms
                  (`measure.graph_ms`) of the plain version (`rs_torch`)
                  and of each of the five kernels, the rebuild matrix for
                  loss (0, 5, 11, 13), `new_encoder().selection`, and a
                  `torch.profiler` trace into `BENCH_TRACE_DIR`
  (none)          main: a probe child, the CPU-side suites (cpu, remote,
                  rebuild_remote, rebuild_trace, ingest, xor, dp, mesh),
                  the build proof on a card, then the device suite; one
                  JSON line with `metric`, `value`, `unit`, `vs_baseline`

Every mode measures on `cuda` unless the caller passes `device="cpu"`
(`--device cpu`), where the card's kernels are their plain PyTorch
versions; with no card and no `--device cpu` it raises. Each report names
its device and the card line (`ops/measure.card_line()`). `--smoke` runs a
mode at the sizes of the reference tests' smokes.

No fallback hides the card or a kernel: a mode that fails records its
`*_error`, as the reference's does, and its `ok` is then false. The
parent's last-ditch numpy number, taken when even the cpu child dies, is
a host number under `host`, never the headline.

The headline `value` is the device suite's best steady encode GB/s of the
five kernels (with `--device cpu`: the plain version's encode GB/s from
the cpu suite). `vs_baseline` is that value over the AVX2 library's
single-core encode GB/s measured in the same run on the same host; it is
not the reference's fraction of a TPU target."""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from seaweedfs_tpu_torch.utils import config

#: the checkout holding the package: children run `-m` from here
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("probe", "cpu", "xor", "rebuild_batch", "remote", "rebuild_remote",
         "rebuild_trace", "ingest", "convert", "mesh", "dp", "device")
#: the five kernels of `rs_cuda.apply_matrix`
VARIANTS = ("int8", "bf16", "u8", "mplane", "dma")
#: the worst loss RS(10+4) allows: 2 data + 2 parity shards
REBUILD_LOST = (0, 5, 11, 13)
#: the device suite's stack width, the reference's: (8, 10, 4 MiB), 320 MiB
#: an apply (`--smoke`: one batch element)
DEVICE_WIDTH = 4 << 20
#: the sizes of the reference's smoke tests of each mode (test_remote_rebuild.py,
#: test_trace_repair.py; test_inline_ec.py; test_convert.py)
SMOKE_REMOTE = dict(dat_bytes=1 << 20, large=65536, small=16384, buffer_size=16384,
                    max_batch_bytes=10 * 2 * 16384, delay_ms=0)
SMOKE_INGEST = dict(dat_bytes=1 << 20, large=16384, small=4096, buffer_size=4096,
                    append_chunk=96 << 10, overwrite_count=4)
SMOKE_CONVERT = dict(dat_bytes=2 << 20, large=128 << 10, small=16 << 10, buffer_size=16 << 10)


# ---------------------------------------------------------------------------
# child-process plumbing
# ---------------------------------------------------------------------------


def _run_child(mode: str, timeout: int, device: str = "cuda", smoke: bool = False,
               extra_env: Optional[dict] = None) -> tuple[Optional[dict], Optional[str]]:
    """Run `python -m seaweedfs_tpu_torch.bench` with BENCH_MODE=mode;
    return (parsed JSON | None, err)."""
    env = dict(os.environ, BENCH_MODE=mode)
    if extra_env:
        env.update(extra_env)
    argv = [sys.executable, "-m", "seaweedfs_tpu_torch.bench"]
    if mode != "probe":
        argv += ["--device", device] + (["--smoke"] if smoke else [])
    try:
        proc = subprocess.run(argv, cwd=ROOT, env=env, timeout=timeout,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    except subprocess.TimeoutExpired:
        return None, f"timeout after {timeout}s"
    except OSError as e:
        return None, f"spawn failed: {e}"
    # the child's result is its last JSON line
    for line in reversed(proc.stdout.decode(errors="replace").splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line), None
            except json.JSONDecodeError:
                continue
    tail = proc.stderr.decode(errors="replace").strip()[-300:]
    return None, f"exit={proc.returncode}, no JSON on stdout: {tail}"


def _emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def resolve_device(device: str = "cuda") -> torch.device:
    """The bench's device: the card unless the caller names the CPU."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the bench runs on cuda or cpu, not {device}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the bench measures the card; pass "
                           "device='cpu' (--device cpu) for the plain versions")
    return dev


def _card(dev: torch.device) -> Optional[str]:
    from seaweedfs_tpu_torch.ops import measure

    return measure.card_line() if dev.type == "cuda" else None


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launches() -> dict:
    from seaweedfs_tpu_torch.ops import rs_cuda

    return dict(rs_cuda.launches_by_variant)


def _launch_delta(before: dict) -> dict:
    now = _launches()
    return {k: v - before.get(k, 0) for k, v in sorted(now.items()) if v > before.get(k, 0)}


def _errors(out: dict) -> list[str]:
    """Every `*_error` key of a report, at any depth."""
    found = []
    for k, v in out.items():
        if k.endswith("_error") or k == "error":
            found.append(k)
        elif isinstance(v, dict):
            found += [f"{k}.{e}" for e in _errors(v)]
    return found


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 22), b""):
            h.update(chunk)
    return h.hexdigest()


def _write_bytes(path: str, data: bytes) -> None:
    """A volume fixture's file, written whole before any reader or server
    opens the volume."""
    with open(path, "wb") as f:
        f.write(data)


def _write_random(path: str, size: int, rng: np.random.Generator) -> None:
    _write_bytes(path, rng.integers(0, 256, size, dtype=np.uint8).tobytes())


# ---------------------------------------------------------------------------
# stage 1: device probe (child)
# ---------------------------------------------------------------------------


def mode_probe() -> dict:
    t0 = time.perf_counter()
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return {
        "ok": n > 0,
        "secs": round(time.perf_counter() - t0, 2),
        "platform": "gpu" if n else "cpu",
        "count": n,
        "devices": [torch.cuda.get_device_name(i) for i in range(min(n, 8))],
    }


# ---------------------------------------------------------------------------
# timing helpers (shared by the cpu and device suites)
# ---------------------------------------------------------------------------


def _median_time(fn, iters: int, warmup: int) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _min_time(fn, iters: int, warmup: int = 1) -> float:
    """min-of-iters wall time: the xorsched-vs-native gate is a same-run
    ratio on a shared noisy box, and min is the estimator least polluted
    by scheduler preemption."""
    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _measure_numpy_gbps(n: int = 1 << 20) -> float:
    """The golden path: table-driven GF(2^8) encode in host numpy."""
    from seaweedfs_tpu_torch.ops import gf8

    pm = gf8.parity_matrix(10, 4)
    data = np.random.default_rng(0).integers(0, 256, size=(10, n), dtype=np.uint8)
    t = _median_time(lambda: gf8.gf_mat_mul(pm, data), iters=3, warmup=1)
    return 10 * n / t / 1e9


def _measure_avx2(n: int = 8 << 20) -> tuple[Optional[float], bool, Optional[float], int]:
    """The host codec library (`csrc/gf_host.cc`, AVX2 when the host has
    it): (single-core GB/s, avx2?, all-cores GB/s, host core count)."""
    from seaweedfs_tpu_torch.ops import gf8
    from seaweedfs_tpu_torch.utils import native

    cores = os.cpu_count() or 1
    if native.load_gf() is None:
        return None, False, None, cores
    rng = np.random.default_rng(0)
    bufs = [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes() for _ in range(10)]
    pm = gf8.parity_matrix(10, 4)
    t = _median_time(lambda: native.gf_matrix_apply_native(pm, bufs, n), iters=5, warmup=1)
    mt_gbps = None
    if cores > 1 and native.has_mt():
        t_mt = _median_time(lambda: native.gf_matrix_apply_native(pm, bufs, n, threads=0),
                            iters=5, warmup=1)
        mt_gbps = 10 * n / t_mt / 1e9
    return 10 * n / t / 1e9, native.has_avx2(), mt_gbps, cores


def _measure_device_gbps(dev: torch.device, batch: int, n: int, iters: int,
                         warmup: int) -> float:
    """The encode on the bench's device through `rs_cuda.apply_matrix`:
    the card's int8 kernel, or on the CPU its plain version (`rs_torch`);
    data on the device, each call waited for."""
    from seaweedfs_tpu_torch.ops import gf8, rs_cuda

    pm = gf8.parity_matrix(10, 4)
    gen = torch.Generator(device=dev).manual_seed(0)
    data = torch.randint(0, 256, (batch, 10, n), dtype=torch.uint8, device=dev, generator=gen)

    def encode() -> None:
        rs_cuda.apply_matrix(pm, data)
        _sync(dev)

    t = _median_time(encode, iters, warmup)
    return batch * 10 * n / t / 1e9


def _route(dev: torch.device) -> str:
    return "cuda int8 kernel" if dev.type == "cuda" else "plain version (rs_torch) on cpu"


def _measure_reconstruct_latency(tmpdir: str, dev: torch.device) -> dict:
    """p50/p99 single-needle degraded-read latency through the port's
    EcVolume ladder: a synthetic volume striped, one data shard's file
    deleted, then reads that must reconstruct from the 13 survivors. Cold
    = the first degraded read, warm = the rest."""
    from seaweedfs_tpu_torch.ec import stripe
    from seaweedfs_tpu_torch.ec.ec_volume import EcVolume
    from seaweedfs_tpu_torch.ops.rs_codec import Encoder
    from seaweedfs_tpu_torch.storage import idx as idx_mod
    from seaweedfs_tpu_torch.storage import types

    enc = Encoder(10, 4, device=dev)
    large, small = 64 << 10, 4 << 10
    base = os.path.join(tmpdir, "bench_vol")
    rng = np.random.default_rng(7)
    offset = types.NEEDLE_PADDING_SIZE
    blobs = [b"\x03" + bytes(7)]
    records = {}
    for nid in range(1, 301):
        body = int(rng.integers(256, 4096))
        total = types.actual_size(body, version=3)
        records[nid] = (offset, body)
        blobs.append(rng.integers(0, 256, size=total, dtype=np.uint8).tobytes())
        offset += total
    _write_bytes(base + ".dat", b"".join(blobs))
    idx_mod.write_entries(
        [(nid, types.offset_to_bytes(off), sz) for nid, (off, sz) in records.items()],
        base + ".idx",
    )
    stripe.write_ec_files(base, large_block_size=large, small_block_size=small, encoder=enc)
    stripe.write_sorted_file_from_idx(base)
    lost = 2
    os.unlink(stripe.shard_file_name(base, lost))

    recon_ms: list[float] = []
    local_ms: list[float] = []
    cold_ms = None
    with EcVolume(base, encoder=enc, large_block_size=large, small_block_size=small) as ev:
        if ev.warm_thread is not None:
            ev.warm_thread.join(30)  # the mount's warm-up precedes traffic
        for nid in records:
            _, _, intervals = ev.locate_needle(nid)
            degraded = any(iv.to_shard_id_and_offset(large, small)[0] == lost
                           for iv in intervals)
            t0 = time.perf_counter()
            ev.read_needle_blob(nid)
            dt = (time.perf_counter() - t0) * 1e3
            if degraded and cold_ms is None:
                cold_ms = dt
            elif degraded:
                recon_ms.append(dt)
            else:
                local_ms.append(dt)
    recon_ms.sort()
    local_ms.sort()

    def q(xs, p):
        return round(xs[min(len(xs) - 1, int(p * len(xs)))], 4) if xs else None

    return {
        "reconstruct_p50_ms": q(recon_ms, 0.50),
        "reconstruct_p99_ms": q(recon_ms, 0.99),
        "reconstruct_cold_ms": round(cold_ms, 4) if cold_ms is not None else None,
        "reconstruct_reads": len(recon_ms) + (cold_ms is not None),
        "local_read_p50_ms": q(local_ms, 0.50),
    }


# ---------------------------------------------------------------------------
# stage 2: the cpu suite (child)
# ---------------------------------------------------------------------------


def _measure_file_encode_e2e(td: str, dev: torch.device, size: int = 128 << 20) -> dict:
    """A synthetic .dat -> 14 shard files through `write_ec_files` (reads
    + kernel + writes + pipeline overlap) with the factory's encoder on
    the bench's device, then the pipeline-depth sweep."""
    from seaweedfs_tpu_torch.ec import stripe
    from seaweedfs_tpu_torch.ops.rs_codec import new_encoder

    base = os.path.join(td, "9")
    _write_random(base + ".dat", size, np.random.default_rng(5))
    enc = new_encoder(device=dev)
    t0 = time.perf_counter()
    stripe.write_ec_files(base, large_block_size=4 << 20, small_block_size=1 << 20, encoder=enc)
    dt = time.perf_counter() - t0
    out = {
        "file_encode_e2e_gbps": round(size / dt / 1e9, 3),
        "file_encode_backend": enc.backend,
        "file_encode_dat_mib": size >> 20,
    }
    # the depths the configured default did not measure already
    sweep = {str(stripe.DEFAULT_PIPELINE_DEPTH): out["file_encode_e2e_gbps"]}
    for depth in (1, 2, 4):
        if str(depth) in sweep:
            continue
        try:
            t0 = time.perf_counter()
            stripe.write_ec_files(base, large_block_size=4 << 20, small_block_size=1 << 20,
                                  encoder=enc, pipeline_depth=depth)
            sweep[str(depth)] = round(size / (time.perf_counter() - t0) / 1e9, 3)
        except (RuntimeError, ValueError, OSError) as e:  # one depth must not zero the sweep
            sweep[str(depth)] = f"error: {str(e)[:120]}"
    out["file_encode_depth_sweep_gbps"] = sweep
    return out


def _host_encoder():
    """The host baseline's encoder: the AVX2 library where it builds, else
    the plain version on the CPU."""
    from seaweedfs_tpu_torch.ops.rs_codec import Encoder
    from seaweedfs_tpu_torch.utils import native

    if native.load_gf() is not None:
        return "native", Encoder(10, 4, backend="native")
    return "torch", Encoder(10, 4, device="cpu")


def _measure_rebuild(td: str, dev: torch.device, size: int = 128 << 20) -> dict:
    """A 4-missing-shard volume rebuilt end to end through the pipelined
    `rebuild_ec_files` per backend (the host codecs and the bench's
    device), against the serial oracle (`rebuild_ec_files_serial`, one
    blocking reconstruct per chunk) on the host baseline's encoder. GB/s
    counts the data footprint (10 x shard bytes) over the wall time; the
    loss is 2 data + 2 parity shards."""
    from seaweedfs_tpu_torch.ec import stripe
    from seaweedfs_tpu_torch.ec.constants import DATA_SHARDS_COUNT
    from seaweedfs_tpu_torch.ops.rs_codec import Encoder, new_encoder

    base = os.path.join(td, "rb")
    _write_random(base + ".dat", size, np.random.default_rng(9))
    stripe.write_ec_files(base, large_block_size=4 << 20, small_block_size=1 << 20,
                          encoder=new_encoder(device=dev))
    os.unlink(base + ".dat")
    missing = list(REBUILD_LOST)
    golden = {s: _read(stripe.shard_file_name(base, s)) for s in missing}
    shard_size = len(golden[missing[0]])
    data_bytes = shard_size * DATA_SHARDS_COUNT

    def run(fn, enc, iters: int) -> tuple[float, bool]:
        """Best-of-`iters` rebuild wall; the outputs checked byte-equal to
        the original shard files after the last run."""
        times = []
        for _ in range(iters):
            for s in missing:
                os.unlink(stripe.shard_file_name(base, s))
            t0 = time.perf_counter()
            fn(base, encoder=enc, buffer_size=1 << 20)
            times.append(time.perf_counter() - t0)
        match = all(_read(stripe.shard_file_name(base, s)) == golden[s] for s in missing)
        return data_bytes / min(times) / 1e9, match

    out: dict = {
        "dat_mib": size >> 20,
        "missing": missing,
        "protocol": "GB/s = data footprint (10 x shard bytes) / rebuild wall time",
    }
    serial_name, serial_enc = _host_encoder()
    serial, ok = run(stripe.rebuild_ec_files_serial, serial_enc, 2)
    out["serial_backend"] = serial_name
    out["serial_gbps"] = round(serial, 3)
    if not ok:
        out["serial_match"] = False
    candidates: dict[str, float] = {}
    suite = []
    if serial_name == "native":
        suite.append(("native", serial_enc, 3))
    suite.append(("xorsched", Encoder(10, 4, backend="xorsched"), 3))
    suite.append(("cuda" if dev.type == "cuda" else "torch", Encoder(10, 4, device=dev), 3))
    for name, enc, iters in suite:
        try:
            gbps, match = run(stripe.rebuild_ec_files, enc, iters)
            out[f"{name}_gbps"] = round(gbps, 3)
            if not match:
                out[f"{name}_match"] = False  # a wrong rebuild is not a result
                continue
            candidates[name] = gbps
        except (RuntimeError, ValueError, OSError) as e:  # one backend must not zero the section
            out[f"{name}_error"] = str(e)[:200]
    if candidates and serial > 0:
        best = max(candidates, key=candidates.get)
        out["best_backend"] = best
        out["pipelined_vs_serial"] = round(candidates[best] / serial, 2)
        enc_by_name = {name: e for name, e, _ in suite}
        sweep: dict = {}
        for depth in (1, 2, 4):
            try:
                gbps, match = run(functools.partial(stripe.rebuild_ec_files, pipeline_depth=depth),
                                  enc_by_name[best], 1)
                sweep[str(depth)] = round(gbps, 3) if match else "mismatch"
            except (RuntimeError, ValueError, OSError) as e:  # one depth must not zero the sweep
                sweep[str(depth)] = f"error: {str(e)[:120]}"
        out["depth_sweep_gbps"] = sweep
    out["ok"] = bool(candidates) and ok and not any(
        k.endswith(("_match", "_error")) for k in out)
    return out


def mode_cpu(device: str = "cuda", smoke: bool = False) -> dict:
    """The host baselines beside the bench device's encode, the degraded
    read, the file encode and the rebuild suite (`--smoke`: 8 MiB volumes
    instead of 128 MiB)."""
    from seaweedfs_tpu_torch.ops.rs_codec import _host_fingerprint, new_encoder

    dev = resolve_device(device)
    size = (8 << 20) if smoke else (128 << 20)
    out: dict = {"device": str(dev), "card": _card(dev), "host": _host_fingerprint(),
                 "device_encode_route": _route(dev)}
    before = _launches()
    try:
        n = (64 << 10) if smoke and dev.type == "cpu" else (1 << 20)
        out["device_encode_gbps"] = round(_measure_device_gbps(dev, 2, n, 5, 2), 3)
    except (RuntimeError, ValueError) as e:
        out["device_encode_error"] = str(e)[:200]
    try:
        out["numpy_gbps"] = round(_measure_numpy_gbps((64 << 10) if smoke else (1 << 20)), 3)
    except (RuntimeError, ValueError) as e:
        out["numpy_error"] = str(e)[:200]
    try:
        gbps, avx2, mt_gbps, cores = _measure_avx2((1 << 20) if smoke else (8 << 20))
        out["host_cores"] = cores
        if gbps is not None:
            out["native_gbps"] = round(gbps, 3)
            out["native_avx2"] = avx2
        else:
            out["native_error"] = "the host codec library (csrc/gf_host.cc) does not build here"
        if mt_gbps is not None:
            out["native_mt_gbps"] = round(mt_gbps, 3)
    except (RuntimeError, ValueError, OSError) as e:
        out["native_error"] = str(e)[:200]
    for key, fn in (("reconstruct", lambda td: _measure_reconstruct_latency(td, dev)),
                    ("file_encode", lambda td: _measure_file_encode_e2e(td, dev, size))):
        try:
            with tempfile.TemporaryDirectory() as td:
                out.update(fn(td))
        except (RuntimeError, ValueError, OSError) as e:
            out[f"{key}_error"] = str(e)[:200]
    try:
        with tempfile.TemporaryDirectory() as td:
            out["ec_rebuild"] = _measure_rebuild(td, dev, size)
    except (RuntimeError, ValueError, OSError) as e:
        out["ec_rebuild_error"] = str(e)[:200]
    try:
        # the factory's audited decision on this device
        out["auto_backend"] = new_encoder(device=dev).selection
    except (RuntimeError, ValueError) as e:
        out["auto_backend_error"] = str(e)[:200]
    out["launches"] = _launch_delta(before)
    out["ok"] = not _errors(out) and bool(out.get("ec_rebuild", {}).get("ok"))
    return out


# ---------------------------------------------------------------------------
# stage 2i: the compiled XOR-schedule backend against the AVX2 library
# ---------------------------------------------------------------------------


def _xor_matrix_forms(enc) -> list[tuple[str, np.ndarray]]:
    """The four matrix shapes an Encoder dispatches, as (name, matrix)."""
    survivors = [i for i in range(14) if i not in (2, 11)][:10]
    decode = enc.reconstruction_matrix(survivors, [2, 11])
    plan = enc.repair_projection_plan(survivors, [2, 11])
    local = survivors[:5]  # a holder owning 5 of the survivors
    projection = np.stack([plan[s] for s in local], axis=1)
    delta = enc.parity_matrix[:, [3]]  # a generator column: the rank-1 update
    return [
        ("encode", enc.parity_matrix),
        ("decode", decode),
        ("projection", projection),
        ("delta", delta),
    ]


def mode_xor(device: str = "cuda", smoke: bool = False, out_path: Optional[str] = None,
             round_: Optional[int] = None) -> dict:
    """BENCH_MODE=xor: the XOR-schedule backend (`ops/xorsched`) against
    the AVX2 library, measured in the same run, every form byte-verified
    against the gf8 golden (`match`, which gates `pick_cpu_backend`) and
    through the bench device's int8 kernel (`device_verify`). `--smoke`:
    verification across tail widths only, no timing and no `when`. The
    full run writes its report as a BENCH round's `xor` section
    (`{"n", "cmd", "rc", "parsed": {"xor": ...}}`) to `out_path` when one
    is given, and nowhere else."""
    from seaweedfs_tpu_torch.ops import gf8, rs_cuda, xorsched
    from seaweedfs_tpu_torch.ops.rs_codec import Encoder, _host_fingerprint
    from seaweedfs_tpu_torch.utils import native

    dev = resolve_device(device)
    enc = Encoder(10, 4, device="cpu")  # matrices only; no dispatch here
    forms = _xor_matrix_forms(enc)
    out: dict = {
        "host": _host_fingerprint(),
        "native_level": xorsched.native_level(),
        "tile_kb": config.env("WEEDTPU_XORSCHED_TILE_KB"),
        "device": str(dev),
        "card": _card(dev),
    }
    if not smoke:
        out["when"] = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())

    # the compile pass: fresh cache, per-form compile time and schedule stats
    xorsched.clear_schedule_cache()
    compile_info: dict = {}
    progs: dict = {}
    for name, m in forms:
        t0 = time.perf_counter()
        prog = xorsched.get_schedule(m)
        if not smoke:
            compile_info[f"{name}_ms"] = round((time.perf_counter() - t0) * 1e3, 2)
        compile_info[f"{name}_xors"] = prog.xor_count
        compile_info[f"{name}_raw_xors"] = prog.raw_xors
        compile_info[f"{name}_temps"] = prog.n_temps
        progs[name] = prog
    out["compile"] = compile_info

    # byte verification: the interpreter and the native executor against the
    # gf8 golden, and the device's int8 kernel on the same stacks, across
    # full tiles, partial tiles and the sub-8-symbol scalar tails
    match = device_match = True
    verify: dict = {}
    device_verify: dict = {}
    before = _launches()
    widths = [1, 7, 31, 512, 4097] if smoke else [4097, 65536 + 488]
    rng = np.random.default_rng(0)
    for name, m in forms:
        ok = dev_ok = True
        for n in widths:
            stack = rng.integers(0, 256, size=(m.shape[1], n), dtype=np.uint8)
            golden = gf8.gf_mat_vec(m, stack)
            interp = np.stack(xorsched.apply(progs[name], list(stack)))
            ok = ok and bool((interp == golden).all())
            nat = xorsched.apply_native(progs[name], list(stack))
            if nat is not None:
                ok = ok and bool((np.stack(nat) == golden).all())
            got = rs_cuda.apply_matrix(m, torch.from_numpy(stack).to(dev)).cpu().numpy()
            dev_ok = dev_ok and bool(np.array_equal(got, golden))
        verify[name] = ok
        device_verify[name] = dev_ok
        match = match and ok
        device_match = device_match and dev_ok
    out["verify"] = verify
    out["match"] = match
    out["device_verify"] = device_verify
    out["device_match"] = device_match
    out["launches"] = _launch_delta(before)
    out["cache"] = xorsched.schedule_cache_info()
    if smoke:
        out["ok"] = match and device_match
        return out

    # throughput: the xorsched native executor against the AVX2 library, the
    # same data in the same run, min-of-iters (GB/s counts input shard bytes)
    n = 8 << 20
    have_native_lib = native.load_gf() is not None
    for name, m in forms:
        if name == "delta":
            continue  # a 1-column rank-1 update: the latency path, not bandwidth
        stack = rng.integers(0, 256, size=(m.shape[1], n), dtype=np.uint8)
        sec: dict = {}
        if xorsched.native_available():
            ins = list(stack)
            t = _min_time(lambda: xorsched.apply_native(progs[name], ins), iters=5)
            sec["xorsched_gbps"] = round(m.shape[1] * n / t / 1e9, 3)
        if have_native_lib:
            bufs = [s.tobytes() for s in stack]
            t = _min_time(lambda: native.gf_matrix_apply_native(m, bufs, n), iters=5)
            sec["native_gbps"] = round(m.shape[1] * n / t / 1e9, 3)
        if "xorsched_gbps" in sec and "native_gbps" in sec:
            sec["ratio"] = round(sec["xorsched_gbps"] / sec["native_gbps"], 2)
        out[name] = sec

    # the interpreter floor, at a small width and one iteration
    small = rng.integers(0, 256, size=(10, 1 << 20), dtype=np.uint8)
    ins_small = list(small)
    t = _min_time(lambda: xorsched.apply(progs["encode"], ins_small), iters=1, warmup=0)
    out["encode"]["interp_gbps"] = round(10 * (1 << 20) / t / 1e9, 3)

    enc_sec = out.get("encode", {})
    dec_sec = out.get("decode", {})
    out["gate"] = {
        "encode_2x": bool(enc_sec.get("ratio", 0) >= 2.0),
        "decode_parity": bool(dec_sec.get("ratio", 0) >= 1.0),
    }
    out["ok"] = match and device_match
    if out_path:
        wrapper = {"n": round_, "cmd": f"BENCH_MODE=xor python -m seaweedfs_tpu_torch.bench "
                                       f"--device {device} --out {out_path}",
                   "rc": 0, "parsed": {"xor": out}}
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        tmp = out_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(wrapper, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, out_path)
        out["written"] = out_path
    return out


# ---------------------------------------------------------------------------
# heterogeneous rebuild fusion
# ---------------------------------------------------------------------------


def _rebatch_storm(smoke: bool, dev: torch.device):
    """(specs, n_signatures) for the mixed-signature rebuild storm: each
    spec is (vid, dat_bytes, missing, encoder) over three geometries (10+4
    vandermonde, 12+3 and 20+4 cauchy), with 2-missing and 1-missing loss
    classes; several signatures carry two volumes. Volumes of tens of KB:
    the dispatch-bound regime the fusion targets."""
    from seaweedfs_tpu_torch.ops.rs_codec import Encoder

    e10 = Encoder(10, 4, device=dev)
    e12 = Encoder(12, 3, matrix_kind="cauchy", device=dev)
    e20 = Encoder(20, 4, matrix_kind="cauchy", device=dev)
    if smoke:
        pats = [
            (e10, [10, 13]),
            (e10, [10, 13]),  # shares the signature above
            (e10, [0]),
            (e12, [0, 12]),
            (e20, [20, 23]),
            (e12, [5]),
        ]
    else:
        pats = (
            [(e10, [10, 13])] * 2 + [(e10, [11, 12])] * 2
            + [(e10, [0, 5]), (e10, [2, 7])]
            + [(e10, [0])] * 2 + [(e10, [1]), (e10, [2])]
            + [(e12, [0, 12])] * 2 + [(e12, [3, 14]), (e12, [7, 13])]
            + [(e12, [5])] * 2 + [(e12, [6])]
            + [(e20, [20, 23])] * 2 + [(e20, [1, 21]), (e20, [5, 22])]
            + [(e20, [8])] * 2 + [(e20, [9])]
        )
    specs = []
    for vid, (enc, missing) in enumerate(pats, start=1):
        specs.append((vid, 24_000 + vid * 500, list(missing), enc))
    n_sigs = len({
        (enc.data_shards, enc.total_shards, enc.matrix_kind, tuple(missing))
        for _, _, missing, enc in specs
    })
    return specs, n_sigs


def mode_rebuild_batch(device: str = "cuda", smoke: bool = False) -> dict:
    """BENCH_MODE=rebuild_batch: a mixed-signature storm rebuilt in one
    block-diagonal fused dispatch against the per-signature dispatch loop,
    in the same run, on the bench device's encoders; every rebuilt shard
    byte-compared with the encode-time golden. `--smoke`: byte accounting
    and the dispatch counts (a homogeneous batch fuses to one trivially, a
    heterogeneous one only through the block-diagonal path), no timing,
    no `when`."""
    from seaweedfs_tpu_torch.ec import stripe
    from seaweedfs_tpu_torch.ops import xorsched
    from seaweedfs_tpu_torch.ops.rs_codec import _host_fingerprint

    dev = resolve_device(device)
    specs, n_sigs = _rebatch_storm(smoke, dev)
    out: dict = {
        "kind": "rebuild_batch",
        "host": _host_fingerprint(),
        "native_level": xorsched.native_level(),
        "tile_kb": config.env("WEEDTPU_XORSCHED_TILE_KB"),
        "device": str(dev),
        "card": _card(dev),
        "protocol": (
            "same-run fused (WEEDTPU_REBUILD_FUSE=on, one block-diagonal "
            "dispatch) vs unfused (per-signature-group dispatches) wall, "
            "min-of-iters; every rebuilt shard byte-compared vs the "
            "encode-time golden"
        ),
    }
    if not smoke:
        out["when"] = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())

    td = tempfile.mkdtemp(prefix="rebatch_")
    jobs = []
    golden: list[dict[int, bytes]] = []
    rng_total = 0
    before = _launches()
    try:
        for vid, size, missing, enc in specs:
            base = os.path.join(td, f"v{vid}")
            _write_random(base + ".dat", size, np.random.default_rng(vid))
            _write_bytes(base + ".idx", b"")
            stripe.write_ec_files(base, large_block_size=16 * 1024, small_block_size=4 * 1024,
                                  encoder=enc)
            stripe.write_sorted_file_from_idx(base)
            gold = {s: _read(stripe.shard_file_name(base, s)) for s in missing}
            golden.append(gold)
            shard_n = len(next(iter(gold.values())))
            rng_total += sum(len(b) for b in gold.values())
            os.unlink(base + ".dat")
            present = [s for s in range(enc.total_shards) if s not in missing]
            jobs.append({
                "base": base,
                "sources": {s: stripe.LocalSlabSource(stripe.shard_file_name(base, s))
                            for s in present},
                "shard_size": shard_n,
                "missing": missing,
                "encoder": enc,
            })
        out["storm"] = {
            "volumes": len(jobs),
            "signatures": n_sigs,
            "geometries": ["10+4 vandermonde", "12+3 cauchy", "20+4 cauchy"],
            "missing_shard_bytes": rng_total,
        }

        def drop(batch: list) -> None:
            for job in batch:
                for s in job["missing"]:
                    p = stripe.shard_file_name(job["base"], s)
                    if os.path.exists(p):
                        os.unlink(p)

        def run(fuse: bool, batch: list = jobs) -> tuple[float, dict]:
            drop(batch)
            t0 = time.perf_counter()
            res = stripe.rebuild_ec_files_batch(batch, buffer_size=64 * 1024,
                                                max_batch_bytes=32 * 1024 * 1024, fuse=fuse)
            wall = time.perf_counter() - t0
            if res["errors"]:
                raise RuntimeError(f"rebuild errors: {res['errors']}")
            return wall, res

        def verify() -> tuple[bool, int]:
            ok, checked = True, 0
            for (_vid, _size, missing, _enc), gold, job in zip(specs, golden, jobs):
                for s in missing:
                    ok = ok and _read(stripe.shard_file_name(job["base"], s)) == gold[s]
                    checked += 1
            return ok, checked

        _, res_f = run(True)
        ok_f, n_checked = verify()
        _, res_u = run(False)
        ok_u, _ = verify()
        out["fused"] = {
            "dispatch_groups": res_f["dispatch_groups"],
            "signature_groups": res_f["signature_groups"],
            "volumes_fused": res_f["volumes_fused"],
        }
        out["unfused"] = {"dispatch_groups": res_u["dispatch_groups"]}
        out["verify"] = {
            "shards_checked": n_checked,
            "fused_bytes_match": ok_f,
            "unfused_bytes_match": ok_u,
        }
        if smoke:
            # the homogeneous control: one signature repeated; both paths
            # collapse to one dispatch, so the fused-vs-unfused delta above
            # is the heterogeneity, not batching itself
            homo = [j for j, (_, _, m, e) in zip(jobs, specs)
                    if e is specs[0][3] and m == [10, 13]]
            for fuse in (True, False):
                _, res_h = run(fuse, homo)
                out[f"homogeneous_{'fused' if fuse else 'unfused'}"] = {
                    "dispatch_groups": res_h["dispatch_groups"],
                    "signature_groups": res_h["signature_groups"],
                }
            out["rebuilt_bytes"] = rng_total
            out["launches"] = _launch_delta(before)
            out["ok"] = bool(
                ok_f and ok_u
                and res_f["dispatch_groups"] == 1
                and res_u["dispatch_groups"] == n_sigs
                and res_f["signature_groups"] == n_sigs
                and out["homogeneous_fused"]["dispatch_groups"] == 1
                and out["homogeneous_unfused"]["dispatch_groups"] == 1
            )
            return out

        # throughput: min-of-iters on each side, warm
        iters = 8
        wall_f = min(run(True)[0] for _ in range(iters))
        wall_u = min(run(False)[0] for _ in range(iters))
        out["fused"]["wall_ms"] = round(wall_f * 1e3, 3)
        out["unfused"]["wall_ms"] = round(wall_u * 1e3, 3)
        out["fused_speedup"] = round(wall_u / wall_f, 2)

        # the host executor's width scaling: the widest decode program of
        # the storm through the native XOR executor at 1 thread against all
        cores = out["host"].get("cores", 0)
        e20 = specs[-1][3]
        survivors = [s for s in range(24) if s not in (20, 23)][:20]
        m = e20.reconstruction_matrix(survivors, [20, 23])
        prog = xorsched.get_schedule(m)
        stack = np.random.default_rng(7).integers(0, 256, size=(m.shape[1], 8 << 20),
                                                  dtype=np.uint8)
        ins = list(stack)
        if xorsched.native_available():
            t1 = _min_time(lambda: xorsched.apply_native(prog, ins, threads=1), iters=5)
            tn = _min_time(lambda: xorsched.apply_native(prog, ins, threads=0), iters=5)
            scaling = round(t1 / tn, 2)
            out["threads"] = {"cores": cores, "single_ms": round(t1 * 1e3, 2),
                              "multi_ms": round(tn * 1e3, 2), "scaling": scaling}
        else:
            scaling = 0.0
            out["threads"] = {"cores": cores, "note": "no native XOR executor on this host"}
        gate: dict = {
            "fused_speedup_15x": bool(out["fused_speedup"] >= 1.5),
            "bytes_match": bool(ok_f and ok_u),
            "one_dispatch": bool(res_f["dispatch_groups"] == 1),
            "thread_scaling_15x": bool(cores > 1 and scaling >= 1.5),
        }
        out["gate"] = gate
        out["launches"] = _launch_delta(before)
        out["ok"] = bool(ok_f and ok_u and res_f["dispatch_groups"] == 1)
        return out
    finally:
        for job in jobs:
            for src in job["sources"].values():
                src.close()
        shutil.rmtree(td, ignore_errors=True)


# ---------------------------------------------------------------------------
# stage 2c: the remote degraded-read ladder
# ---------------------------------------------------------------------------


def mode_remote(device: str = "cuda", smoke: bool = False) -> dict:
    """The two-server degraded-read ladder, run twice: loopback as-is, and
    with a 5 ms server-side delay per `VolumeEcShardRead` (the RTT a real
    network adds; sleeping releases the GIL, so the owner's parallel
    survivor fetches can overlap)."""
    dev = resolve_device(device)
    out: dict = {"device": str(dev), "card": _card(dev)}
    before = _launches()
    try:
        out.update(_remote_ladder(dev, delay_ms=0, n_fids=40 if smoke else 200))
        out["simulated_rtt_5ms"] = _remote_ladder(dev, delay_ms=5, n_fids=20 if smoke else 100)
    except (RuntimeError, OSError) as e:
        out["ladder_error"] = f"{type(e).__name__}: {e}"[:300]
    out["host_cores"] = os.cpu_count()
    out["launches"] = _launch_delta(before)
    out["ok"] = not _errors(out) and all(
        isinstance(out.get(k), dict) for k in ("local", "remote", "reconstruct_remote"))
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _remote_ladder(dev: torch.device, delay_ms: int, n_fids: int) -> dict:
    """One ladder pass: a master, an in-process owner and a volume server
    SUBPROCESS peer (so the owner's fetch concurrency is not serialized
    against the peer's serving threads by one GIL); EC-encode a volume on
    the owner, hand shards 7-13 to the peer, then time reads through the
    owner's HTTP data path in three classes: local, remote (an interval
    fetched from the peer), reconstruct_remote (shard 3 lost everywhere:
    the owner decodes from survivors, at least 4 of them remote)."""
    import urllib.request

    import grpc

    from seaweedfs_tpu_torch import rpc
    from seaweedfs_tpu_torch.cluster.client import MasterClient
    from seaweedfs_tpu_torch.cluster.master import MasterServer
    from seaweedfs_tpu_torch.cluster.volume_server import VolumeServer
    from seaweedfs_tpu_torch.ec import stripe
    from seaweedfs_tpu_torch.ops.rs_codec import Encoder
    from seaweedfs_tpu_torch.pb import VOLUME_SERVICE
    from seaweedfs_tpu_torch.storage.file_id import FileId

    out: dict = {}
    large, small = 64 << 10, 4 << 10
    peer_proc = None
    with tempfile.TemporaryDirectory() as td:
        master = MasterServer(port=0, reap_interval=3600)
        master.start()
        d0 = os.path.join(td, "srv0")
        os.makedirs(d0)
        owner = VolumeServer([d0], master.address, heartbeat_interval=0.3,
                             encoder=Encoder(10, 4, device=dev))
        owner.start()
        d1 = os.path.join(td, "srv1")
        os.makedirs(d1)

        def start_peer():
            """The peer volume server subprocess, started after the uploads
            so that the volume lives on the owner; waits for its gRPC."""
            peer_http, peer_grpc = _free_port(), _free_port()
            env = dict(os.environ)
            if delay_ms:
                env["WEEDTPU_BENCH_RPC_DELAY_MS"] = str(delay_ms)
            err_path = os.path.join(td, "peer.err")
            with open(err_path, "wb") as err_f:
                proc = subprocess.Popen(
                    [sys.executable, "-m", "seaweedfs_tpu_torch", "volume",
                     "-port", str(peer_http), "-grpcPort", str(peer_grpc), "-dir", d1,
                     "-mserver", master.address, "--device", dev.type],
                    cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=err_f,
                )
            addr = f"127.0.0.1:{peer_grpc}"
            try:
                deadline0 = time.monotonic() + 60
                while True:
                    if proc.poll() is not None:
                        tail = _read(err_path)[-500:].decode(errors="replace")
                        raise RuntimeError(f"peer exited rc={proc.returncode}: {tail}")
                    if time.monotonic() > deadline0:
                        raise RuntimeError("peer not serving after 60s")
                    try:
                        with rpc.RpcClient(addr) as pc:
                            pc.call(VOLUME_SERVICE, "VolumeStatus", {"volume_id": 999999},
                                    timeout=5)
                        break
                    except grpc.RpcError as e:
                        if e.code() == grpc.StatusCode.NOT_FOUND:
                            break  # the server answered: it is up
                        time.sleep(0.5)
            except BaseException:
                proc.terminate()  # never leak the subprocess on a failed start
                proc.wait(timeout=10)
                raise
            return proc, addr

        client = MasterClient(master.address)
        try:
            rng = np.random.default_rng(11)
            first = client.submit(rng.integers(0, 256, 8192, dtype=np.uint8).tobytes())
            vid = int(first.fid.split(",")[0])
            fids = [first.fid]
            while len(fids) < n_fids:
                a = client.assign()
                if int(a.fid.split(",")[0]) != vid:
                    continue
                size = int(rng.integers(512, 6000))
                client.upload(a.fid, rng.integers(0, 256, size, dtype=np.uint8).tobytes())
                fids.append(a.fid)
            if owner.store.get_volume(vid) is None:
                raise RuntimeError("the volume is not on the owner")
            peer_proc, peer_grpc_addr = start_peer()
            with rpc.RpcClient(owner.grpc_address) as oc:
                oc.call(VOLUME_SERVICE, "VolumeMarkReadonly", {"volume_id": vid})
                oc.call(VOLUME_SERVICE, "VolumeEcShardsGenerate",
                        {"volume_id": vid, "large_block_size": large,
                         "small_block_size": small})
            with rpc.RpcClient(peer_grpc_addr) as tc:
                tc.call(VOLUME_SERVICE, "VolumeEcShardsCopy",
                        {"volume_id": vid, "shard_ids": list(range(7, 14)),
                         "source_data_node": owner.grpc_address}, timeout=120)
            base = owner._base_path_for(vid)
            with rpc.RpcClient(owner.grpc_address) as oc:
                for s in range(7, 14):
                    os.remove(stripe.shard_file_name(base, s))
                oc.call(VOLUME_SERVICE, "VolumeDelete", {"volume_id": vid})
                oc.call(VOLUME_SERVICE, "VolumeEcShardsMount", {"volume_id": vid})
            with rpc.RpcClient(peer_grpc_addr) as pc:
                pc.call(VOLUME_SERVICE, "VolumeEcShardsMount", {"volume_id": vid})
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                if len(master.topology.lookup_ec_shards(vid)) == 14:
                    break
                time.sleep(0.05)

            ev = owner.store.get_ec_volume(vid)
            lost = 3  # deleted everywhere for the reconstruct class

            def shard_ids_of(fid: str) -> set:
                _, _, ivs = ev.locate_needle(FileId.parse(fid).key)
                return {iv.to_shard_id_and_offset(large, small)[0] for iv in ivs}

            classes: dict[str, list[str]] = {"local": [], "remote": [], "reconstruct_remote": []}
            for fid in fids:
                sids = shard_ids_of(fid)
                if lost in sids:
                    classes["reconstruct_remote"].append(fid)
                elif any(s >= 7 for s in sids):
                    classes["remote"].append(fid)
                else:
                    classes["local"].append(fid)

            def read_via_owner(fid: str) -> bytes:
                with urllib.request.urlopen(f"http://{owner.url}/{fid}", timeout=30) as r:
                    return r.read()

            def time_class(fids_: list[str]) -> Optional[dict]:
                if not fids_:
                    return None
                for f in fids_[:2]:
                    read_via_owner(f)  # warm the caches and the kernel
                ms = []
                for _ in range(3):
                    for f in fids_:
                        t0 = time.perf_counter()
                        read_via_owner(f)
                        ms.append((time.perf_counter() - t0) * 1e3)
                ms.sort()
                return {
                    "p50_ms": round(ms[len(ms) // 2], 3),
                    "p99_ms": round(ms[min(len(ms) - 1, int(0.99 * len(ms)))], 3),
                    "n_reads": len(ms),
                }

            out["local"] = time_class(classes["local"])
            out["remote"] = time_class(classes["remote"])
            # shard 3 lost everywhere: the owner holds 0-6, keeps 6 local
            # survivors and fans out for >= 4 remote ones
            p = stripe.shard_file_name(owner._base_path_for(vid), lost)
            if os.path.exists(p):
                os.remove(p)
            evv = owner.store.get_ec_volume(vid)
            if evv is not None:
                evv.drop_local_shard(lost)
            out["reconstruct_remote"] = time_class(classes["reconstruct_remote"])
            out["class_sizes"] = {k: len(v) for k, v in classes.items()}
            out["peer"] = "subprocess"
        finally:
            client.close()
            owner.stop()
            if peer_proc is not None:
                peer_proc.terminate()
                try:
                    peer_proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    peer_proc.kill()
                    peer_proc.wait(timeout=10)
            master.stop()
    return out


# ---------------------------------------------------------------------------
# stage 2e: the remote-survivor distributed rebuild
# ---------------------------------------------------------------------------


def _set_delay(ms: float) -> None:
    config.set_env("WEEDTPU_BENCH_RPC_DELAY_MS", str(ms) if ms > 0 else None)


def _default_encoder(encoder, dev: torch.device):
    from seaweedfs_tpu_torch.ops.rs_codec import new_encoder

    return encoder if encoder is not None else new_encoder(device=dev)


def mode_rebuild_remote(device: str = "cuda", smoke: bool = False) -> dict:
    """The distributed half of the rebuild: survivors on a peer volume
    server streamed through the network-overlapped pipeline while the
    target decodes; `--smoke` at the reference test's tiny shards."""
    dev = resolve_device(device)
    kw = SMOKE_REMOTE if smoke else {}
    with tempfile.TemporaryDirectory() as td:
        return _measure_rebuild_remote(td, device=dev.type, **kw)


def _measure_rebuild_remote(
    td: str,
    dat_bytes: int = 48 << 20,
    large: int = 4 << 20,
    small: int = 1 << 20,
    buffer_size: int = 128 << 10,
    max_batch_bytes: int = 4 << 20,
    prefetch_batches: int = 4,
    delay_ms: Optional[float] = None,
    encoder=None,
    device: str = "cuda",
) -> dict:
    """Two in-process volume servers and a master: the peer holds data
    shards 0-9, parity 10-13 is lost cluster-wide, and the (empty) target
    regenerates it through `VolumeEcShardsRebuild {remote: true}` on its
    encoder (`encoder`, default the factory's on `device`; the peer's is
    `device`'s too).

    A loopback fetch costs CPU, not network, so a server-side sleep per
    RPC (`WEEDTPU_BENCH_RPC_DELAY_MS`, set through `utils/config` for the
    run and restored after) models the RTT; when `delay_ms` is None it is
    tuned so the modelled network wall is about three times the measured
    transfer and decode wall, and the value is recorded."""
    from concurrent.futures import ThreadPoolExecutor

    from seaweedfs_tpu_torch import rpc
    from seaweedfs_tpu_torch.cluster.master import MasterServer
    from seaweedfs_tpu_torch.cluster.volume_server import EC_REBUILD_FETCH_WORKERS, VolumeServer
    from seaweedfs_tpu_torch.ec import stripe
    from seaweedfs_tpu_torch.ec.constants import DATA_SHARDS_COUNT
    from seaweedfs_tpu_torch.ops.rs_codec import Encoder
    from seaweedfs_tpu_torch.pb import VOLUME_SERVICE

    dev = resolve_device(device)
    vid = 7
    missing = [10, 11, 12, 13]
    out: dict = {
        "dat_mib": dat_bytes >> 20,
        "missing": missing,
        "device": str(dev),
        "card": _card(dev),
        "protocol": (
            "GB/s = data footprint (10 x shard bytes) / rebuild wall; "
            "overlap_efficiency = remote wall / max(network wall, decode "
            "wall), 1.0 = perfect overlap; serial baseline = same windowed "
            "parallel fetch, decode blocking between windows (no overlap)"
        ),
    }
    before = _launches()
    with config.override_env("WEEDTPU_BENCH_RPC_DELAY_MS", None):  # no delay during set-up
        master = MasterServer(port=0, reap_interval=3600)
        master.start()
        d_target, d_peer = os.path.join(td, "target"), os.path.join(td, "peer")
        os.makedirs(d_target)
        os.makedirs(d_peer)
        target = VolumeServer([d_target], master.address, heartbeat_interval=0.3,
                              encoder=_default_encoder(encoder, dev))
        target.start()
        peer = VolumeServer([d_peer], master.address, heartbeat_interval=0.3,
                            encoder=Encoder(10, 4, device=dev))
        peer.start()
        try:
            # -- the volume on the peer, all parity lost everywhere ------------
            base_peer = os.path.join(d_peer, str(vid))
            _write_random(base_peer + ".dat", dat_bytes, np.random.default_rng(13))
            _write_bytes(base_peer + ".idx", b"")
            stripe.write_ec_files(base_peer, large_block_size=large, small_block_size=small,
                                  encoder=target.store.encoder)
            stripe.write_sorted_file_from_idx(base_peer)
            golden = {s: _read(stripe.shard_file_name(base_peer, s)) for s in missing}
            shard_size = os.path.getsize(stripe.shard_file_name(base_peer, 0))
            data_bytes = shard_size * DATA_SHARDS_COUNT
            for s in missing:
                os.unlink(stripe.shard_file_name(base_peer, s))
            os.unlink(base_peer + ".dat")
            with rpc.RpcClient(peer.grpc_address) as pc:
                pc.call(VOLUME_SERVICE, "VolumeEcShardsMount", {"volume_id": vid})
            deadline = time.monotonic() + 15
            while time.monotonic() < deadline:
                if len(master.topology.lookup_ec_shards(vid)) >= DATA_SHARDS_COUNT:
                    break
                time.sleep(0.05)
            registered = len(master.topology.lookup_ec_shards(vid))
            if registered < DATA_SHARDS_COUNT:
                raise RuntimeError(f"only {registered} survivor shards registered at the master")

            chunks_per_batch = max(1, max_batch_bytes // (DATA_SHARDS_COUNT * buffer_size))
            span = chunks_per_batch * buffer_size
            n_batches = -(-shard_size // span)
            out["n_batches"] = n_batches

            # -- the decode wall: the same volume, every survivor local ---------
            base_local = os.path.join(td, "local", str(vid))
            os.makedirs(os.path.dirname(base_local))
            for s in range(DATA_SHARDS_COUNT):
                shutil.copy(stripe.shard_file_name(base_peer, s),
                            stripe.shard_file_name(base_local, s))
            for ext in (".ecx", ".eci"):
                shutil.copy(base_peer + ext, base_local + ext)
            t0 = time.perf_counter()
            stripe.rebuild_ec_files(base_local, encoder=target.store.encoder,
                                    buffer_size=buffer_size, max_batch_bytes=max_batch_bytes)
            decode_wall = time.perf_counter() - t0
            out["local_rebuild_gbps"] = round(data_bytes / decode_wall / 1e9, 3)
            out["decode_wall_s"] = round(decode_wall, 3)
            out["backend"] = target.store.encoder.backend

            def fetch_windows(decode: bool) -> float:
                """The windowed survivor fetch through the real slab
                sources, parallel across shards within a window; with
                `decode` each window decodes, blocking, before the next
                (the no-overlap serial baseline), without it this is the
                network wall alone."""
                ex = ThreadPoolExecutor(max_workers=EC_REBUILD_FETCH_WORKERS)
                srcs = target._remote_slab_sources(vid, list(range(DATA_SHARDS_COUNT)), ex)
                staging = np.empty((DATA_SHARDS_COUNT, span), dtype=np.uint8)
                enc = target.store.encoder
                t0 = time.perf_counter()
                try:
                    for off in range(0, shard_size, span):
                        valid = min(span, shard_size - off)
                        width = -(-valid // buffer_size) * buffer_size
                        for s in range(DATA_SHARDS_COUNT):
                            srcs[s].prefetch(off, width)
                        for s in range(DATA_SHARDS_COUNT):
                            srcs[s].read_into(off, staging[s, :width])
                        if decode:
                            np.asarray(enc.reconstruct_lazy(
                                staging[:, :width], list(range(DATA_SHARDS_COUNT)), missing))
                    return time.perf_counter() - t0
                finally:
                    for s in srcs.values():
                        s.close()
                    ex.shutdown(wait=False, cancel_futures=True)

            _set_delay(0)
            transfer_cpu_wall = fetch_windows(decode=False)
            out["transfer_cpu_wall_s"] = round(transfer_cpu_wall, 3)
            if delay_ms is None:
                # one RPC per survivor per window: `waves` sequential sleeps
                # per window for the fetch pool's size; 3x puts the run in
                # the network-dominated regime repair lives in at scale
                waves = -(-DATA_SHARDS_COUNT // EC_REBUILD_FETCH_WORKERS)
                delay_ms = max(1.0, 3e3 * (transfer_cpu_wall + decode_wall)
                               / max(1, n_batches) / waves)
            out["rpc_delay_ms"] = round(delay_ms, 2)
            _set_delay(delay_ms)
            network_wall = fetch_windows(decode=False)
            out["network_wall_s"] = round(network_wall, 3)
            # best of 2 for the gated comparison: a steal spike during one
            # phase would skew the ratio either way
            serial_wall = min(fetch_windows(decode=True) for _ in range(2))
            out["serial_fetch_then_decode_s"] = round(serial_wall, 3)
            out["serial_fetch_then_decode_gbps"] = round(data_bytes / serial_wall / 1e9, 3)

            # -- the distributed rebuild on the target ---------------------------
            base_target = target._base_path_for(vid)
            remote_wall = float("inf")
            resp: dict = {}
            for _ in range(2):
                for s in missing:  # a rerun must regenerate, not no-op
                    p = stripe.shard_file_name(base_target, s)
                    if os.path.exists(p):
                        os.unlink(p)
                t0 = time.perf_counter()
                with rpc.RpcClient(target.grpc_address) as tc:
                    resp = tc.call(
                        VOLUME_SERVICE, "VolumeEcShardsRebuild",
                        {
                            "volume_id": vid,
                            "remote": True,
                            # this section measures the SLAB overlap pipeline:
                            # its baselines model full-slab fetches
                            "trace_mode": "off",
                            # the baselines' window geometry, so both count the
                            # same modelled RTTs
                            "buffer_size": buffer_size,
                            "max_batch_bytes": max_batch_bytes,
                            "prefetch_batches": prefetch_batches,
                        },
                        timeout=600,
                    )
                remote_wall = min(remote_wall, time.perf_counter() - t0)
            match = all(_read(stripe.shard_file_name(base_target, s)) == golden[s]
                        for s in missing)
            out["rebuilt_shard_ids"] = resp.get("rebuilt_shard_ids")
            out["remote_survivors"] = resp.get("remote_survivors")
            out["match"] = match
            out["rebuilt_sha256"] = {str(s): _sha256(stripe.shard_file_name(base_target, s))
                                     for s in missing}
            out["remote_rebuild_wall_s"] = round(remote_wall, 3)
            out["remote_rebuild_gbps"] = round(data_bytes / remote_wall / 1e9, 3)
            out["overlap_efficiency"] = round(remote_wall / max(network_wall, decode_wall), 3)
            out["pipelined_vs_serial_fetch_then_decode"] = round(serial_wall / remote_wall, 2)
            out["ok"] = bool(match and resp.get("rebuilt_shard_ids") == missing)
        finally:
            target.stop()
            peer.stop()
            master.stop()
    out["launches"] = _launch_delta(before)
    return out


# ---------------------------------------------------------------------------
# stage 2f: the trace-repair rebuild, wire bytes and wall against full slabs
# ---------------------------------------------------------------------------


def mode_rebuild_trace(device: str = "cuda", smoke: bool = False) -> dict:
    """The same single-shard distributed rebuild in trace mode (holders
    ship GF-projected rows of their survivor groups) and in slab mode:
    the wire-bytes ratio and the walls under the modelled RTT."""
    dev = resolve_device(device)
    kw = SMOKE_REMOTE if smoke else {}
    with tempfile.TemporaryDirectory() as td:
        return _measure_rebuild_trace(td, device=dev.type, **kw)


def _measure_rebuild_trace(
    td: str,
    dat_bytes: int = 48 << 20,
    large: int = 4 << 20,
    small: int = 1 << 20,
    buffer_size: int = 128 << 10,
    max_batch_bytes: int = 4 << 20,
    prefetch_batches: int = 4,
    lost_shard: int = 3,
    delay_ms: Optional[float] = None,
    encoder=None,
    device: str = "cuda",
) -> dict:
    """A master, the rebuild target and TWO peer holders: peer A holds
    shards 0-6 (but the lost one), peer B 7-13, the target nothing. One
    data shard is lost cluster-wide and the target rebuilds it twice over
    the RPC path, `trace_mode=on` then `off`, with one window geometry.
    Wire bytes come from the EcRebuildResponse accounting and from the
    `weedtpu_ec_repair_network_bytes_total` counter (the in-process
    servers share the registry); the rebuilt bytes are held to the golden
    both times. Trace mode moves holder groups x repaired bytes: with
    survivors on 2 holders that is 0.2x the 10 full slabs, gated <= 0.6."""
    from seaweedfs_tpu_torch import rpc, stats
    from seaweedfs_tpu_torch.cluster.master import MasterServer
    from seaweedfs_tpu_torch.cluster.volume_server import VolumeServer
    from seaweedfs_tpu_torch.ec import stripe
    from seaweedfs_tpu_torch.ec.constants import DATA_SHARDS_COUNT
    from seaweedfs_tpu_torch.ops.rs_codec import Encoder
    from seaweedfs_tpu_torch.pb import VOLUME_SERVICE

    dev = resolve_device(device)
    vid = 11
    out: dict = {
        "dat_mib": dat_bytes >> 20,
        "lost_shard": lost_shard,
        "device": str(dev),
        "card": _card(dev),
        "protocol": (
            "same single-shard distributed rebuild, trace vs slab sources, "
            "identical window geometry and modeled RTT; wire_ratio = trace "
            "bytes-on-wire / slab bytes-on-wire (holder groups x repaired "
            "bytes vs 10 full survivor slabs); both runs byte-verified "
            "against golden"
        ),
    }
    before = _launches()
    with config.override_env("WEEDTPU_BENCH_RPC_DELAY_MS", None):  # no delay during set-up
        master = MasterServer(port=0, reap_interval=3600)
        master.start()
        dirs = [os.path.join(td, n) for n in ("target", "peer_a", "peer_b")]
        for d in dirs:
            os.makedirs(d)
        target = VolumeServer([dirs[0]], master.address, heartbeat_interval=0.3,
                              encoder=_default_encoder(encoder, dev))
        peer_a = VolumeServer([dirs[1]], master.address, heartbeat_interval=0.3,
                              encoder=Encoder(10, 4, device=dev))
        peer_b = VolumeServer([dirs[2]], master.address, heartbeat_interval=0.3,
                              encoder=Encoder(10, 4, device=dev))
        servers = [target, peer_a, peer_b]
        for vs in servers:
            vs.start()
        try:
            # -- built on peer A, survivors spread, one data shard lost ---------
            base_a = os.path.join(dirs[1], str(vid))
            _write_random(base_a + ".dat", dat_bytes, np.random.default_rng(29))
            _write_bytes(base_a + ".idx", b"")
            stripe.write_ec_files(base_a, large_block_size=large, small_block_size=small,
                                  encoder=target.store.encoder)
            stripe.write_sorted_file_from_idx(base_a)
            golden = _read(stripe.shard_file_name(base_a, lost_shard))
            shard_size = os.path.getsize(stripe.shard_file_name(base_a, 0))
            os.unlink(stripe.shard_file_name(base_a, lost_shard))
            os.unlink(base_a + ".dat")
            base_b = os.path.join(dirs[2], str(vid))
            for s in range(7, 14):
                os.replace(stripe.shard_file_name(base_a, s), stripe.shard_file_name(base_b, s))
            for ext in (".ecx", ".eci"):
                shutil.copy(base_a + ext, base_b + ext)
            for vs in (peer_a, peer_b):
                with rpc.RpcClient(vs.grpc_address) as c:
                    c.call(VOLUME_SERVICE, "VolumeEcShardsMount", {"volume_id": vid})
            deadline = time.monotonic() + 15
            while time.monotonic() < deadline:
                if len(master.topology.lookup_ec_shards(vid)) >= 13:
                    break
                time.sleep(0.05)
            if len(master.topology.lookup_ec_shards(vid)) < DATA_SHARDS_COUNT:
                raise RuntimeError("fewer than 10 survivor shards registered at the master")

            out["shard_mib"] = round(shard_size / (1 << 20), 3)
            out["slab_baseline_bytes"] = DATA_SHARDS_COUNT * shard_size
            if delay_ms is None:
                delay_ms = 2.0  # one modelled RTT per bulk window request
            out["rpc_delay_ms"] = round(delay_ms, 2)
            base_target = target._base_path_for(vid)

            def run_once(trace_mode: str) -> tuple[dict, float, bool]:
                p = stripe.shard_file_name(base_target, lost_shard)
                if os.path.exists(p):
                    os.unlink(p)  # a rerun must regenerate, not no-op
                t0 = time.perf_counter()
                with rpc.RpcClient(target.grpc_address) as tc:
                    resp = tc.call(
                        VOLUME_SERVICE, "VolumeEcShardsRebuild",
                        {
                            "volume_id": vid,
                            "remote": True,
                            "trace_mode": trace_mode,
                            "buffer_size": buffer_size,
                            "max_batch_bytes": max_batch_bytes,
                            "prefetch_batches": prefetch_batches,
                        },
                        timeout=600,
                    )
                wall = time.perf_counter() - t0
                return resp, wall, _read(p) == golden

            _set_delay(delay_ms)
            results: dict[str, dict] = {}
            for mode_name in ("trace", "slab"):
                counter = stats.EcRepairNetworkBytes.labels(mode_name)
                count_before = counter.value
                wall = float("inf")
                resp: dict = {}
                match = True
                for _ in range(2):  # best of 2 against steal spikes
                    resp, w, m = run_once("on" if mode_name == "trace" else "off")
                    wall = min(wall, w)
                    match = match and m
                results[mode_name] = {
                    "wall_s": round(wall, 3),
                    "wire_bytes": int(resp.get("wire_bytes") or 0),
                    "counter_bytes_2_runs": int(counter.value - count_before),
                    "mode_reported": resp.get("mode"),
                    "match": bool(match),
                    "rebuilt_shard_ids": resp.get("rebuilt_shard_ids"),
                    "rebuilt_sha256": _sha256(stripe.shard_file_name(base_target, lost_shard)),
                }
                if mode_name == "trace":
                    results[mode_name]["groups"] = resp.get("trace_groups")
                    results[mode_name]["fallback"] = resp.get("trace_fallback")
            out["trace"] = results["trace"]
            out["slab"] = results["slab"]
            slab_wire = results["slab"]["wire_bytes"]
            out["wire_ratio"] = (round(results["trace"]["wire_bytes"] / slab_wire, 4)
                                 if slab_wire else None)
            out["wall_ratio"] = round(results["trace"]["wall_s"] / results["slab"]["wall_s"], 3)
            out["ok"] = bool(
                results["trace"]["match"]
                and results["slab"]["match"]
                and results["trace"]["mode_reported"] == "trace"
                and results["slab"]["mode_reported"] == "slab"
                and results["trace"]["rebuilt_shard_ids"] == [lost_shard]
                and out["wire_ratio"] is not None
                and out["wire_ratio"] <= 0.6
            )
        finally:
            for vs in servers:
                vs.stop()
            master.stop()
    out["launches"] = _launch_delta(before)
    return out


# ---------------------------------------------------------------------------
# stage 2g: inline-EC ingest, and the geometry conversion
# ---------------------------------------------------------------------------

def mode_ingest(device: str = "cuda", smoke: bool = False) -> dict:
    """A volume's bytes through the encode-on-write stripe builder (a poll
    per append burst) against the warm encode, and the small-write
    delta-parity byte gate (< 0.5x for <= 1% overwrites)."""
    dev = resolve_device(device)
    kw = SMOKE_INGEST if smoke else {}
    with tempfile.TemporaryDirectory() as td:
        return _measure_ingest(td, device=dev.type, **kw)


def mode_convert(device: str = "cuda", smoke: bool = False) -> dict:
    """Geometry conversion against the decode -> re-encode oracle: byte
    identity asserted, bytes moved gated at <= 0.5x the oracle's I/O for
    each geometry pair."""
    dev = resolve_device(device)
    kw = SMOKE_CONVERT if smoke else {}
    with tempfile.TemporaryDirectory() as td:
        out = _measure_convert(td, device=dev.type, **kw)
    if smoke:
        return {"kind": "bench_convert", **out}
    return {"when": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()), "kind": "bench_convert",
            **out}


def _encoder_like(enc, family: str):
    """`family`'s encoder on `enc`'s backend, device and kernel."""
    from seaweedfs_tpu_torch.ops.rs_codec import Encoder, geometry_for

    geom = geometry_for(family)
    return Encoder(geom.data_shards, geom.parity_shards, geom.matrix_kind, backend=enc.backend,
                   device=enc.device, variant=enc.variant, tile=enc.tile)


def _measure_convert(
    td: str,
    dat_bytes: int = 192 << 20,
    large: int = 1 << 20,
    small: int = 256 << 10,
    buffer_size: int = 256 << 10,
    families: tuple = ("cauchy_12_3", "merge_20_4"),
    encoder=None,
    device: str = "cuda",
) -> dict:
    """`ec.convert`'s engine against the decode -> re-encode oracle on one
    volume, one run per target family. The conversion (`convert_ec_files`:
    staged target, journal, on-disk re-verify) reports `bytes_read` and
    `bytes_written`; the oracle (`write_dat_file` + `write_ec_files` at the
    target) has its I/O measured from the files it touches and held equal
    to the `reencode_oracle_bytes` formula. Per family: the staged output
    byte-compared with the oracle's set, and bytes_written / oracle_total
    <= 0.5 gated."""
    from seaweedfs_tpu_torch.ec import convert as convert_mod
    from seaweedfs_tpu_torch.ec import stripe
    from seaweedfs_tpu_torch.ops.rs_codec import geometry_for

    dev = resolve_device(device)
    enc = _default_encoder(encoder, dev)
    before = _launches()
    base = os.path.join(td, "src", "7")
    os.makedirs(os.path.dirname(base))
    _write_random(base + ".dat", dat_bytes, np.random.default_rng(41))
    t0 = time.perf_counter()
    stripe.write_ec_files(base, large_block_size=large, small_block_size=small,
                          buffer_size=buffer_size, encoder=enc)
    src_encode_s = time.perf_counter() - t0
    src_total = enc.total_shards
    out: dict = {
        "section": "ec_convert",
        "dat_mib": round(dat_bytes / (1 << 20), 2),
        "large_block": large,
        "small_block": small,
        "backend": enc.backend,
        "device": str(enc.device),
        "card": _card(dev),
        "src_family": "rs_10_4",
        "src_encode_s": round(src_encode_s, 3),
        "protocol": (
            "convert = convert_ec_files (staged target + .ecc journal + "
            "on-disk re-verify), bytes_written = target bytes "
            "materialized; oracle = write_dat_file + write_ec_files on "
            "the target geometry, oracle_total = measured read data "
            "shards + write .dat + re-read .dat + write target set "
            "(asserted == the deterministic reencode_oracle_bytes "
            "formula); gate: bytes_written / oracle_total <= 0.5 AND "
            "staged output byte-identical to the oracle's"
        ),
        "pairs": {},
    }
    ok = True
    for fam in families:
        geom = geometry_for(fam)
        oracle_acct = convert_mod.reencode_oracle_bytes(base, fam)
        t0 = time.perf_counter()
        res = convert_mod.convert_ec_files(base, fam, encoder=enc, buffer_size=buffer_size)
        convert_s = time.perf_counter() - t0
        # the real oracle run, its I/O measured from the files it touches
        ob = os.path.join(td, f"oracle_{fam}", "7")
        os.makedirs(os.path.dirname(ob))
        for s in range(src_total):
            shutil.copy(stripe.shard_file_name(base, s), stripe.shard_file_name(ob, s))
        shutil.copy(base + ".eci", ob + ".eci")
        t0 = time.perf_counter()
        stripe.write_dat_file(ob)
        decode_s = time.perf_counter() - t0
        oracle_dat = os.path.getsize(ob + ".dat")
        for s in range(src_total):
            os.unlink(stripe.shard_file_name(ob, s))
        t0 = time.perf_counter()
        stripe.write_ec_files(ob, large_block_size=large, small_block_size=small,
                              buffer_size=buffer_size, encoder=_encoder_like(enc, fam))
        encode_s = time.perf_counter() - t0
        oracle_tgt = sum(os.path.getsize(stripe.shard_file_name(ob, s))
                         for s in range(geom.total_shards))
        measured_total = 3 * oracle_dat + oracle_tgt
        staged = convert_mod.stage_base(base)
        match = all(_read(stripe.shard_file_name(staged, s)) == _read(stripe.shard_file_name(ob, s))
                    for s in range(geom.total_shards))
        sha = [_sha256(stripe.shard_file_name(staged, s)) for s in range(geom.total_shards)]
        ratio = (round(res["bytes_written"] / oracle_acct["total"], 4)
                 if oracle_acct["total"] else None)
        pair_ok = (match and measured_total == oracle_acct["total"]
                   and ratio is not None and ratio <= 0.5)
        ok = ok and pair_ok
        out["pairs"][fam] = {
            "target_shards": geom.total_shards,
            "convert_s": round(convert_s, 3),
            "oracle_s": round(decode_s + encode_s, 3),
            "bytes_read": res["bytes_read"],
            "bytes_written": res["bytes_written"],
            "reconstructed_bytes": res["reconstructed_bytes"],
            "oracle_total_bytes": oracle_acct["total"],
            "oracle_total_measured": measured_total,
            "moved_over_reencode": ratio,
            "convert_io_over_reencode": (
                round((res["bytes_read"] + res["bytes_written"]) / oracle_acct["total"], 4)
                if oracle_acct["total"] else None
            ),
            "match": match,
            "staged_sha256": sha,
            "ok": pair_ok,
        }
        convert_mod.discard_staged(base, keep_journal=False)
    out["gate"] = "bytes_written / oracle_total <= 0.5 per pair"
    out["launches"] = _launch_delta(before)
    out["ok"] = ok
    return out


def _measure_ingest(
    td: str,
    dat_bytes: int = 192 << 20,
    large: int = 1 << 20,
    small: int = 256 << 10,
    buffer_size: int = 256 << 10,
    append_chunk: int = 4 << 20,
    overwrite_fraction: float = 0.01,
    overwrite_count: int = 16,
    encoder=None,
    device: str = "cuda",
) -> dict:
    """Inline against warm encode on one volume's bytes.

    Inline: the .dat grows in `append_chunk` bursts with a builder poll
    after each; amortized GB/s counts data bytes over the encode time spent
    (polls + seal). Warm: one `write_ec_files` over the finished .dat. The
    outputs are byte-compared. Delta: `overwrite_count` random ranges, in
    all `overwrite_fraction` of the .dat, folded into a fully encoded
    stripe through the journaled delta path; the gate compares BYTE counts
    (changed x (2 data + 2x parity RMW) against a full re-encode's .dat
    read + 14 shard writes), and the shards after the deltas are held to a
    warm encode of the mutated .dat."""
    from seaweedfs_tpu_torch.ec import ingest, stripe
    from seaweedfs_tpu_torch.ec.constants import TOTAL_SHARDS_COUNT

    dev = resolve_device(device)
    enc = _default_encoder(encoder, dev)
    before = _launches()
    rng = np.random.default_rng(31)
    data = rng.integers(0, 256, dat_bytes, dtype=np.uint8).tobytes()
    out: dict = {
        "dat_mib": round(dat_bytes / (1 << 20), 2),
        "large_block": large,
        "small_block": small,
        "backend": enc.backend,
        "device": str(enc.device),
        "card": _card(dev),
        "protocol": (
            "inline = append in bursts + builder poll per burst + seal; "
            "amortized GB/s = data bytes / (sum of poll secs + seal secs); "
            "warm = one write_ec_files over the finished .dat; both outputs "
            "byte-compared. delta gate compares BYTE counts: changed x "
            "(2 + 2 x parity RMW) vs dat read + 14 shard writes of a full "
            "re-encode, for <=1% overwrites"
        ),
    }

    def same_set(a: str, b: str) -> bool:
        return all(_read(stripe.shard_file_name(a, s)) == _read(stripe.shard_file_name(b, s))
                   for s in range(TOTAL_SHARDS_COUNT))

    # -- inline: stream-append + poll -----------------------------------------
    base_i = os.path.join(td, "inline", "5")
    os.makedirs(os.path.dirname(base_i))
    builder = ingest.InlineStripeBuilder(base_i, enc, large, small, buffer_size=buffer_size)
    encode_s = 0.0
    polls = 0
    # weedlint: ignore[tmp-visible-name] the volume under ingest grows in place: the inline builder polls it as it grows, which is what this mode measures
    with open(base_i + ".dat", "wb") as f:
        for off in range(0, dat_bytes, append_chunk):
            f.write(data[off: off + append_chunk])
            f.flush()
            t0 = time.perf_counter()
            if builder.poll():
                polls += 1
            encode_s += time.perf_counter() - t0
    t0 = time.perf_counter()
    info = builder.seal()
    seal_s = time.perf_counter() - t0
    out["inline"] = {
        "amortized_gbps": round(dat_bytes / (encode_s + seal_s) / 1e9, 3),
        "poll_s": round(encode_s, 3),
        "seal_s": round(seal_s, 3),
        "polls_with_work": polls,
        "rows_inline": info["rows_inline"],
        "rows_total": info["rows_total"],
    }

    # -- the warm reference -----------------------------------------------------
    base_w = os.path.join(td, "warm", "5")
    os.makedirs(os.path.dirname(base_w))
    _write_bytes(base_w + ".dat", data)
    t0 = time.perf_counter()
    stripe.write_ec_files(base_w, large_block_size=large, small_block_size=small,
                          buffer_size=buffer_size, encoder=enc)
    warm_s = time.perf_counter() - t0
    out["warm"] = {"gbps": round(dat_bytes / warm_s / 1e9, 3), "wall_s": round(warm_s, 3)}
    out["amortized_over_warm"] = (round(out["inline"]["amortized_gbps"] / out["warm"]["gbps"], 4)
                                  if out["warm"]["gbps"] else None)
    match = same_set(base_i, base_w) and _read(base_i + ".eci") == _read(base_w + ".eci")
    out["match"] = bool(match)
    out["sha256"] = [_sha256(stripe.shard_file_name(base_i, s))
                     for s in range(TOTAL_SHARDS_COUNT)]

    # -- delta parity updates on a fully encoded stripe -------------------------
    base_d = os.path.join(td, "delta", "5")
    os.makedirs(os.path.dirname(base_d))
    _write_bytes(base_d + ".dat", data)
    b2 = ingest.InlineStripeBuilder(base_d, enc, large, small, buffer_size=buffer_size)
    b2.poll()
    encoded_limit = b2.encoded_limit()
    per = max(1, int(dat_bytes * overwrite_fraction) // overwrite_count)
    mutated = bytearray(data)
    t0 = time.perf_counter()
    for _ in range(overwrite_count):
        off = int(rng.integers(0, max(1, encoded_limit - per)))
        new_seg = rng.integers(0, 256, per, dtype=np.uint8).tobytes()
        old_seg = bytes(mutated[off: off + per])

        def mutate(off=off, new_seg=new_seg):
            with open(base_d + ".dat", "r+b") as f:
                f.seek(off)
                f.write(new_seg)

        b2.overwrite(off, old_seg, new_seg, mutate=mutate)
        mutated[off: off + per] = new_seg
    delta_wall = time.perf_counter() - t0
    changed = b2.delta_stats["changed_bytes"]
    delta_bytes = b2.delta_stats["accounted_bytes"]
    b2.seal()
    shard_size = os.path.getsize(stripe.shard_file_name(base_d, 0))
    reencode_bytes = dat_bytes + TOTAL_SHARDS_COUNT * shard_size
    base_m = os.path.join(td, "mut", "5")
    os.makedirs(os.path.dirname(base_m))
    _write_bytes(base_m + ".dat", bytes(mutated))
    t0 = time.perf_counter()
    stripe.write_ec_files(base_m, large_block_size=large, small_block_size=small,
                          buffer_size=buffer_size, encoder=enc)
    reencode_wall = time.perf_counter() - t0
    delta_match = same_set(base_d, base_m)
    out["delta"] = {
        "overwrites": overwrite_count,
        "overwrite_fraction": round(changed / dat_bytes, 5),
        "changed_bytes": int(changed),
        "delta_bytes": int(delta_bytes),
        "reencode_bytes": int(reencode_bytes),
        "bytes_ratio": round(delta_bytes / reencode_bytes, 5),
        "wall_s": round(delta_wall, 3),
        "reencode_wall_s": round(reencode_wall, 3),
        "wall_ratio": round(delta_wall / reencode_wall, 4) if reencode_wall else None,
        "match": bool(delta_match),
        "sha256": [_sha256(stripe.shard_file_name(base_d, s))
                   for s in range(TOTAL_SHARDS_COUNT)],
    }
    out["launches"] = _launch_delta(before)
    out["ok"] = bool(match and delta_match and out["delta"]["bytes_ratio"] < 0.5)
    return out


# ---------------------------------------------------------------------------
# stage 2h: the mesh backend, and the dp curve
# ---------------------------------------------------------------------------


def mode_mesh(device: str = "cuda", smoke: bool = False) -> dict:
    """Per-mesh-shape encode and ring/all_to_all rebuild GB/s through the
    file pipelines, byte-verified against the single-card encoder:
    `scripts/mesh_bench.measure_mesh` at the reference bench's sizes (on
    the CPU over the CPU named 8 times)."""
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as td:
        return _measure_mesh(td, dat_bytes=(4 << 20) if smoke else (96 << 20), device=dev.type)


def _measure_mesh(td: str, dat_bytes: int = 96 << 20, large: int = 1 << 20,
                  small: int = 256 << 10, buffer_size: int = 256 << 10,
                  max_batch_bytes: int = 32 << 20, shapes=None, device: str = "cuda") -> dict:
    """The GPU_MULTICHIP body of `mesh_bench.measure_mesh` for one volume
    under `td`, with launches counted."""
    from seaweedfs_tpu_torch.scripts import mesh_bench

    before = _launches()
    out = mesh_bench.measure_mesh(td, dat_bytes=dat_bytes, large=large, small=small,
                                  buffer_size=buffer_size, max_batch_bytes=max_batch_bytes,
                                  shapes=shapes, device=device)
    out["launches"] = _launch_delta(before)
    return out


def mode_dp(device: str = "cuda", smoke: bool = False) -> dict:
    """Encode GB/s over dp = 1, 2, 4, 8 meshes (`parallel.sharded.
    make_encode_fn`) at one fixed global problem, up to the number of cards
    (on the CPU, the CPU named 8 times: the curve measures the sharding
    machinery, not a speedup)."""
    from seaweedfs_tpu_torch.ops import gf8
    from seaweedfs_tpu_torch.parallel import mesh as mesh_mod
    from seaweedfs_tpu_torch.parallel import sharded

    dev = resolve_device(device)
    devices = mesh_mod.local_devices() if dev.type == "cuda" else [dev] * 8
    out: dict = {
        "device": str(dev),
        "card": _card(dev),
        "devices": len(devices),
        "host_cores": os.cpu_count(),
        "note": ("one process drives every card; the global problem is fixed" if dev.type == "cuda"
                 else "the CPU named once per position: the curve measures the sharding "
                      "machinery at a fixed global problem, not a parallel speedup"),
    }
    b, n = (8, 64 << 10) if smoke else (8, 1 << 20)
    data = np.random.default_rng(3).integers(0, 256, size=(b, 10, n), dtype=np.uint8)
    pm = gf8.parity_matrix(10, 4)
    before = _launches()
    sweep: dict = {}
    for dp in (1, 2, 4, 8):
        if dp > len(devices):
            break
        try:
            mesh = mesh_mod.device_mesh(("dp", "sp"), shape=(dp, 1), devices=devices)
            enc = sharded.make_encode_fn(mesh, pm)
            x = sharded.shard_batch(mesh, data)

            def run(enc=enc, x=x) -> None:
                enc(x)
                for d in {str(d) for d in devices[:dp]}:
                    _sync(torch.device(d))

            t = _median_time(run, iters=3, warmup=1)
            sweep[str(dp)] = round(b * 10 * n / t / 1e9, 3)
        except (RuntimeError, ValueError) as e:  # one dp point must not end the sweep
            sweep[str(dp)] = f"error: {str(e)[:120]}"
    out["encode_gbps_by_dp"] = sweep
    base = sweep.get("1")
    if isinstance(base, float) and base > 0:
        out["efficiency_vs_dp1"] = {k: round(v / base, 3) for k, v in sweep.items()
                                    if isinstance(v, float)}
    out["launches"] = _launch_delta(before)
    out["ok"] = bool(sweep) and all(isinstance(v, float) for v in sweep.values())
    return out


# ---------------------------------------------------------------------------
# stage 3: the device suite
# ---------------------------------------------------------------------------


def steady_gbps(encode_fn, data: torch.Tensor, data_bytes: int, out_rows: int = 4) -> float:
    """Steady-state GB/s of `encode_fn` on `data`. On the card the
    scan-chain slope, `measure.scan_chain_gbps` (CUDA events, CUDA graphs
    where capture works), which cancels the fixed cost of a chain. On the
    CPU, where there is no launch to cancel and a slope between two host
    clock readings is noise on a loaded host, the best of 3 chains of 8
    applies over 8: a host number for the plain version, never a card's."""
    from seaweedfs_tpu_torch.ops import measure

    if data.is_cuda:
        return measure.scan_chain_gbps(encode_fn, data, data_bytes, out_rows=out_rows)
    b, _c, n = data.shape

    def chain(k: int) -> float:
        t0 = time.perf_counter()
        acc = torch.zeros((b, out_rows, n), dtype=torch.uint8)
        for i in range(k):
            acc ^= encode_fn(data ^ i)[:, :out_rows]
        return time.perf_counter() - t0

    encode_fn(data)
    return data_bytes / (min(chain(8) for _ in range(3)) / 8) / 1e9


def mode_device(device: str = "cuda", smoke: bool = False,
                trace_dir: Optional[str] = None) -> dict:
    """The device suite: a compile check at a tiny shape (the first launch
    builds the kernels), then on one seeded (batch, 10, width) stack on the
    device ((8, 10, DEVICE_WIDTH), the reference's; `--smoke` (1, 10,
    DEVICE_WIDTH)) per-call GB/s, steady GB/s and device ms per call of the plain
    version (`rs_torch`) and of each of the five kernels, each output
    byte-compared with the int8 kernel's; the rebuild matrix for loss (0,
    5, 11, 13) through the plain version and the int8 kernel; the
    factory's selection; and, on the card, a `torch.profiler` trace of the
    best kernel into `trace_dir` (default `BENCH_TRACE_DIR`; empty: none)."""
    from seaweedfs_tpu_torch.ops import gf8, measure, rs_cuda, rs_torch
    from seaweedfs_tpu_torch.ops.rs_codec import _reconstruction_matrix, new_encoder

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    b, n = (1 if smoke else 8), DEVICE_WIDTH
    out: dict = {"platform": "gpu" if on_card else "cpu", "device": str(dev), "card": _card(dev),
                 "shape": [b, 10, n]}
    pm = gf8.parity_matrix(10, 4)
    before = _launches()

    t0 = time.perf_counter()
    try:
        tiny = torch.zeros((1, 10, 16384), dtype=torch.uint8, device=dev)
        rs_cuda.apply_matrix(pm, tiny)
        _sync(dev)
        out["compile_check_secs"] = round(time.perf_counter() - t0, 2)
    except (RuntimeError, ValueError, OSError) as e:  # still measure: another kernel may build
        out["compile_check_error"] = str(e)[:500]

    gen = torch.Generator(device=dev).manual_seed(0)
    data = torch.randint(0, 256, (b, 10, n), dtype=torch.uint8, device=dev, generator=gen)
    data_bytes = b * 10 * n
    lifted = rs_torch.lifted_matrix(pm, dev)
    fns = {"torch": lambda d: rs_torch.gf_apply(lifted, d)}
    for v in VARIANTS:
        fns[f"cuda_{v}"] = functools.partial(lambda d, v: rs_cuda.apply_matrix(pm, d, variant=v),
                                             v=v)
    reference = rs_cuda.apply_matrix(pm, data)
    kernels: dict = {}
    best_gbps, best_name = 0.0, "none"
    for name, fn in fns.items():
        rec: dict = {}
        try:
            got = fn(data)
            rec["equal"] = bool(torch.equal(got, reference))
            del got
            t = _median_time(lambda fn=fn: (fn(data), _sync(dev)), iters=10, warmup=3)
            rec["per_call_gbps"] = round(data_bytes / t / 1e9, 3)
            rec["steady_gbps"] = round(steady_gbps(fn, data, data_bytes), 3)
            if on_card:
                rec["chain"] = measure.last_method
                rec["kernel_ms"] = measure.graph_ms(lambda i, fn=fn: fn(data), launches=10,
                                                    replays=5)
            if name.startswith("cuda_"):
                rec["bound_ms"], rec["bound_by"] = measure.bound_ms(name[5:], 10, 4, n, b)
        except (RuntimeError, ValueError) as e:  # a kernel failure must not zero the run
            rec["error"] = f"{type(e).__name__}: {e}"[:300]
        kernels[name] = rec
        if name.startswith("cuda_") and rec.get("equal") and rec.get("steady_gbps", 0) > best_gbps:
            best_gbps, best_name = rec["steady_gbps"], name
    out["kernels"] = kernels
    del reference

    # the rebuild's decode on the device: one fused survivors -> missing
    # matrix (2 data + 2 parity lost), the shape `rebuild_ec_files` dispatches
    try:
        surv = tuple(s for s in range(14) if s not in REBUILD_LOST)[:10]
        dm = _reconstruction_matrix("vandermonde", 10, 4, surv, REBUILD_LOST)
        dm_lift = rs_torch.lifted_matrix(dm, dev)
        rebuild = {"torch": lambda d: rs_torch.gf_apply(dm_lift, d),
                   "cuda": lambda d: rs_cuda.apply_matrix(dm, d)}
        out["rebuild_equal"] = bool(torch.equal(rebuild["torch"](data), rebuild["cuda"](data)))
        for name, fn in rebuild.items():
            t = _median_time(lambda fn=fn: (fn(data), _sync(dev)), iters=10, warmup=3)
            out[f"rebuild_{name}_gbps"] = round(data_bytes / t / 1e9, 3)
            out[f"rebuild_{name}_steady_gbps"] = round(
                steady_gbps(fn, data, data_bytes, out_rows=len(REBUILD_LOST)), 3)
    except (RuntimeError, ValueError) as e:  # the rebuild numbers must not zero the encode's
        out["rebuild_error"] = str(e)[:300]
    out["best_gbps"] = round(best_gbps, 3)
    out["best_backend"] = best_name
    try:
        out["auto_backend"] = new_encoder(device=dev).selection
    except (RuntimeError, ValueError) as e:
        out["auto_backend_error"] = str(e)[:200]

    trace_dir = trace_dir if trace_dir is not None else config.harness_env("BENCH_TRACE_DIR")
    if trace_dir and on_card and best_name != "none":
        try:
            out["trace"] = _profile(fns[best_name], data, trace_dir)
        except (RuntimeError, OSError) as e:  # tracing must not zero the run
            out["trace_error"] = str(e)[:200]
    out["launches"] = _launch_delta(before)
    bad = [k for k, r in kernels.items() if "error" in r or not r.get("equal")]
    out["ok"] = (not bad and not _errors(out) and out.get("rebuild_equal") is True
                 and (not on_card or all(out["launches"].get(v) for v in VARIANTS)))
    if bad:
        out["failed"] = bad
    return out


def _profile(fn, data: torch.Tensor, trace_dir: str) -> dict:
    """A `torch.profiler` capture of three calls of `fn` on `data`, written
    as a Chrome trace under `trace_dir`, with the device time the profiler
    attributes to the kernel."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn(data)
        torch.cuda.synchronize(data.device)
    path = os.path.join(trace_dir, "device_trace.json")
    prof.export_chrome_trace(path)
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us:
            rows.append({"name": ev.key[:80], "calls": ev.count, "device_us": dev_us})
    rows.sort(key=lambda r: -r["device_us"])
    return {"dir": trace_dir, "file": path, "device_events": rows[:8],
            "device_us_total": sum(r["device_us"] for r in rows)}


# ---------------------------------------------------------------------------
# the parent: main
# ---------------------------------------------------------------------------


def _last_ditch_numpy() -> Optional[float]:
    """The numpy golden path measured in the parent: a host number."""
    try:
        return round(_measure_numpy_gbps(), 3)
    except (RuntimeError, ValueError, MemoryError):
        return None


#: the CPU-side suites of the staged main, in the reference's order, each
#: (mode, report key, timeout cap in seconds)
CPU_SUITES = (("remote", "remote_ladder", 300), ("rebuild_remote", "ec_rebuild_remote", 300),
              ("rebuild_trace", "ec_rebuild_trace", 300), ("ingest", "ec_ingest", 300),
              ("xor", "xor", 300), ("dp", "dp_scaling", 300), ("mesh", "ec_mesh", 300))


def main(argv=None) -> int:
    """The staged harness (see the module doc); prints one JSON line and
    returns 0 when every stage ran ok."""
    from seaweedfs_tpu_torch.ops import rs_codec

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default), or cpu")
    ap.add_argument("--smoke", action="store_true", help="every stage at its smoke size")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    watchdog = config.harness_env("BENCH_WATCHDOG_SECS")
    deadline = time.monotonic() + watchdog - 30  # the emit margin

    def left() -> int:
        return int(deadline - time.monotonic())

    result: dict = {
        "metric": "ec_encode_gbps_10p4",
        "value": 0.0,
        "unit": "GB/s",
        "vs_baseline": 0.0,
        "device": str(dev),
        "card": _card(dev),
    }
    stage_ok: dict[str, bool] = {}

    # stage 1: the device probe, in a child under a timeout
    probe, probe_err = None, "--device cpu: no device probe"
    if dev.type == "cuda":
        probe, probe_err = _run_child(
            "probe", timeout=min(config.harness_env("BENCH_PROBE_SECS"), max(10, left())))
    device_ok = bool(probe and probe.get("ok"))
    if probe:
        result["device_probe"] = {k: probe[k] for k in ("secs", "platform", "count") if k in probe}
    if dev.type == "cuda":
        stage_ok["probe"] = device_ok
        if probe_err:
            result["device_probe_error"] = probe_err

    # stage 2: the cpu suite, always
    cpu, cpu_err = _run_child("cpu", timeout=min(config.harness_env("BENCH_CPU_SECS"),
                                                 max(30, left())),
                              device=args.device, smoke=args.smoke)
    stage_ok["cpu"] = bool(cpu and cpu.get("ok"))
    if cpu:
        result["cpu"] = cpu
        if "ec_rebuild" in cpu:
            result["ec_rebuild"] = cpu["ec_rebuild"]
    else:
        result["cpu_error"] = cpu_err
        gbps = _last_ditch_numpy()
        if gbps is not None:
            result["host"] = {"numpy_gbps": gbps, "note": "parent inline: a host number"}

    for mode, key, cap in CPU_SUITES:
        if left() <= 30:
            result[f"{key}_error"] = "skipped: bench deadline exhausted"
            stage_ok[mode] = False
            continue
        rep, err = _run_child(mode, timeout=min(cap, max(30, left())), device=args.device,
                              smoke=args.smoke)
        stage_ok[mode] = bool(rep and rep.get("ok"))
        if rep:
            result[key] = rep
        else:
            result[f"{key}_error"] = err

    # stage 2b: the build proof, on the card (it builds with nvcc)
    if dev.type == "cuda":
        try:
            from seaweedfs_tpu_torch.ops import cuda_lowering

            proof = cuda_lowering.run_lowering_proof()
            result["cuda_lowering"] = {
                "ok": bool(proof) and all(r.get("ok") for r in proof),
                "entries": len(proof),
                "failed": [r.get("name") for r in proof if not r.get("ok")],
            }
        except (RuntimeError, OSError) as e:
            result["cuda_lowering"] = {"ok": False, "error": str(e)[:200]}
        stage_ok["cuda_lowering"] = result["cuda_lowering"]["ok"]

    # stage 3: the device suite, on the card the probe saw
    device = None
    if device_ok and left() > 60:
        extra = {}
        if not config.harness_env("BENCH_TRACE_DIR"):
            extra["BENCH_TRACE_DIR"] = os.path.join(tempfile.gettempdir(), "weedtpu_torch_trace")
        device, dev_err = _run_child("device", timeout=max(60, left()), device=args.device,
                                     smoke=args.smoke, extra_env=extra)
        stage_ok["device"] = bool(device and device.get("ok"))
        if device:
            result["device_suite"] = device
        else:
            result["device_suite_error"] = dev_err
    elif dev.type == "cuda":
        stage_ok["device"] = False
        result["device_suite_error"] = probe_err or "skipped: bench deadline exhausted"

    # the headline: the card's best kernel, or with --device cpu the plain
    # version's encode; never a host codec or the parent's numpy number
    if dev.type == "cuda":
        if device and device.get("best_gbps", 0) > 0:
            result["value"] = device["best_gbps"]
            result["backend"] = device.get("best_backend")
        result["platform"] = "gpu"
    else:
        result["value"] = (cpu or {}).get("device_encode_gbps") or 0.0
        result["backend"] = "torch"
        result["platform"] = "cpu"
    baseline = (cpu or {}).get("native_gbps")
    result["baseline"] = {"name": "native-avx2 single core (csrc/gf_host.cc), same run, same host",
                          "gbps": baseline}
    result["vs_baseline"] = round(result["value"] / baseline, 4) if baseline else 0.0
    try:
        result["auto_backend_on_gpu"] = rs_codec.pick_device_backend()[1]
    except (RuntimeError, ValueError, OSError) as e:
        result["auto_backend_on_gpu_error"] = str(e)[:200]
    try:
        result["auto_backend_on_cpu"] = rs_codec.pick_cpu_backend()[1]
    except (RuntimeError, ValueError, OSError) as e:
        result["auto_backend_on_cpu_error"] = str(e)[:200]
    result["stages_ok"] = stage_ok
    result["ok"] = all(stage_ok.values()) and result["value"] > 0
    _emit(result)
    return 0 if result["ok"] else 1


def run_mode(mode: str, device: str = "cuda", smoke: bool = False, out_path: Optional[str] = None,
             round_: Optional[int] = None) -> dict:
    """One mode's report (BENCH_MODE=mode)."""
    if mode == "probe":
        return mode_probe()
    if mode == "xor":
        return mode_xor(device, smoke, out_path=out_path, round_=round_)
    fn = {"cpu": mode_cpu, "rebuild_batch": mode_rebuild_batch, "remote": mode_remote,
          "rebuild_remote": mode_rebuild_remote, "rebuild_trace": mode_rebuild_trace,
          "ingest": mode_ingest, "convert": mode_convert, "mesh": mode_mesh, "dp": mode_dp,
          "device": mode_device}.get(mode)
    if fn is None:
        raise ValueError(f"unknown BENCH_MODE {mode!r} (want one of {MODES})")
    return fn(device, smoke)


def _mode_main(mode: str, argv=None) -> int:
    ap = argparse.ArgumentParser(description=f"BENCH_MODE={mode}")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default=None, help="xor: write the BENCH round file here")
    ap.add_argument("--round", type=int, default=None, help="xor: the round number of --out")
    args = ap.parse_args(argv)
    out = run_mode(mode, args.device, args.smoke, out_path=args.out, round_=args.round)
    _emit(out)
    return 0 if out.get("ok") else 1


if __name__ == "__main__":
    _mode = config.harness_env("BENCH_MODE")
    sys.exit(_mode_main(_mode) if _mode else main())
