"""The device window, and the assemblers of its evidence: fold a kernel
sweep's JSONL harvest into the GPU measurement file that
`rs_codec.pick_device_backend` reads (`artifacts/GPU_MEASUREMENT_r*.json`),
or a mesh bench body into the GPU_MULTICHIP file `pick_mesh_backend` reads.

    python -m seaweedfs_tpu_torch.scripts.device_window --window --art-dir DIR
        [--budget S] [--device cuda|cpu] [--batch B] [--width N]
        [--e2e-mib M] [--remote-mib M] [--round R]
    python -m seaweedfs_tpu_torch.scripts.device_window --sweep SWEEP.jsonl \\
        --out artifacts/GPU_MEASUREMENT_r03.json [--round 3]
    python -m seaweedfs_tpu_torch.scripts.device_window --multichip MESH.json \\
        --out GPU_MULTICHIP_r16.json [--round 16]

`--window` runs the reference window's stages, each only while the budget
(`--budget`, default `WINDOW_BUDGET_S`) has the time it needs left:
  1. a fresh steady measurement (`bench.steady_gbps`: the scan-chain slope
     on the card) on one seeded (batch, 10, width) stack on the device
     (default (8, 10, 4 MiB), 320 MiB an apply): the plain version
     (`torch_steady_gbps`, the reference's `xla`), int8 at its own tile and
     at 8192, bf16, u8,
     mplane and dma (`cuda_*`, the reference's `pallas_*`), and the rebuild
     matrix for loss (0, 5, 11, 13) through the plain version and int8;
  2. the kernel sweep (`kernel_sweep --out`, `--smoke` on the CPU), only
     with more than 600 s of the budget left, as the reference's;
  then the GPU_MEASUREMENT file, stage 1 and the sweep assembled;
  3. a 128 MiB `.dat` encoded end to end through `stripe.write_ec_files`,
     and rebuilt after the loss of (0, 5, 11, 13) at the default pipeline
     depth and at depth 1, each rebuilt shard byte-compared with the
     encode's;
  3b. the mesh bench (`bench._measure_mesh`), on a host with more than one
     card, into a GPU_MULTICHIP file;
  4. the remote-survivor rebuild (`bench._measure_rebuild_remote`, 48 MiB).
The budget each stage needs is the reference's at the reference's sizes,
in proportion to the bytes the caller asks for. Every output, the temporary
volumes included, goes under `--art-dir`; nothing is written elsewhere, and
`artifacts/` only when the caller names it. Without `--device cpu` the
window needs a card and raises without one. Prints the log lines, then one
JSON summary line.

The assemblers are the counterparts of the reference's `parse_sweep_jsonl`,
`assemble_measurement` and `assemble_multichip`. Only on-card records
become evidence: CPU and --tiny records are counted and left out.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

from seaweedfs_tpu_torch.utils import config

#: the checkout holding the package: the sweep child runs `-m` from here
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
#: the seconds of budget each stage wants left before it starts, at the
#: reference window's sizes (its own checks): 128 MiB e2e, 48 MiB remote
STAGE_NEEDS_S = {"sweep": 600.0, "e2e": 180.0, "rebuild": 120.0, "mesh": 300.0,
                 "remote": 240.0}
#: the worst loss RS(10+4) allows: 2 data + 2 parity shards
LOST = (0, 5, 11, 13)


def parse_sweep_jsonl(path: str) -> dict:
    """A `kernel_sweep --out` harvest as evidence tables: {"encode":
    {config: steady_gbps}, "rebuild": {...}, "failed": [...], "records": N,
    "platform", "when", "card"}. Tolerates a torn tail line."""
    out: dict = {
        "encode": {}, "rebuild": {}, "failed": [], "records": 0,
        "platform": None, "when": None, "card": None,
    }
    try:
        with open(path, encoding="utf-8") as f:
            lines = f.readlines()
    except OSError:
        return out
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue  # torn tail from a crash mid-write
        name = rec.get("variant")
        if not name:
            continue
        out["records"] += 1
        if rec.get("platform") != "gpu" or rec.get("tiny"):
            continue  # a sanity run: neither evidence nor an on-card failure
        if rec.get("error"):
            out["failed"].append(name)
            continue
        gbps = rec.get("steady_gbps")
        if isinstance(gbps, (int, float)):
            table = "rebuild" if name.startswith("rebuild-") else "encode"
            out[table][name] = gbps
            out["platform"] = out["platform"] or rec.get("platform")
            out["card"] = out["card"] or rec.get("card")
            if rec.get("when"):
                out["when"] = max(out["when"] or "", rec["when"])
    return out


def assemble_measurement(meas: dict, sweep_path: str) -> dict:
    """`meas` with the harvest folded in: the `sweep` tables, platform,
    card and when (the evidence gates), and `sweep_best_encode` /
    `sweep_best_rebuild` summaries. Safe to call on a growing harvest."""
    meas = dict(meas)
    sweep = parse_sweep_jsonl(sweep_path)
    if sweep["records"]:
        for key in ("platform", "card"):
            if sweep[key] and not meas.get(key):
                meas[key] = sweep[key]
        if sweep["when"]:
            meas["when"] = max(str(meas.get("when", "")), sweep["when"])
        meas["sweep"] = {"encode": sweep["encode"], "rebuild": sweep["rebuild"]}
        if sweep["failed"]:
            meas["sweep"]["failed"] = sweep["failed"]
        for key, table in (("sweep_best_encode", sweep["encode"]),
                           ("sweep_best_rebuild", sweep["rebuild"])):
            if table:
                best = max(table, key=table.get)
                meas[key] = {"variant": best, "steady_gbps": table[best]}
    return meas


def assemble_multichip(mesh_result: dict, round_: Optional[int] = None) -> dict:
    """A `mesh_bench.measure_mesh` result as the GPU_MULTICHIP evidence
    file: round, when and kind stamped, the per-mesh-shape table required
    (the input `rs_codec.pick_mesh_backend` reads), the reader-side `_file`
    tag dropped."""
    meas = dict(mesh_result)
    meas.pop("_file", None)
    meas.setdefault("when", time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()))
    meas.setdefault("kind", "multichip")
    if round_ is not None:
        meas["round"] = round_
    if not isinstance(meas.get("shapes"), dict) or not meas["shapes"]:
        raise ValueError("mesh result carries no per-mesh-shape table")
    return meas


def _write_json(path: str, obj: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _stage1(dev: torch.device, batch: int, width: int, log: Callable[[str], None]) -> dict:
    """The fresh steady measurement of every variant and of the rebuild
    matrix: {key: GB/s} or {key + "_error": why}, the reference's keys with
    `cuda` for `pallas` and `torch` (the plain version) for `xla`."""
    from seaweedfs_tpu_torch import bench
    from seaweedfs_tpu_torch.ops import gf8, rs_codec, rs_cuda, rs_torch

    pm = gf8.parity_matrix(10, 4)
    surv = tuple(s for s in range(14) if s not in LOST)[:10]
    dm = rs_codec._reconstruction_matrix("vandermonde", 10, 4, surv, LOST)
    gen = torch.Generator(device=dev).manual_seed(0)
    data = torch.randint(0, 256, (batch, 10, width), dtype=torch.uint8, device=dev, generator=gen)
    data_bytes = batch * 10 * width
    lift, dm_lift = rs_torch.lifted_matrix(pm, dev), rs_torch.lifted_matrix(dm, dev)

    def kernel(m, variant="int8", tile=None):
        return lambda x: rs_cuda.apply_matrix(m, x, tile=tile, variant=variant)

    stages = [
        ("torch_steady_gbps", lambda x: rs_torch.gf_apply(lift, x), 4),
        ("cuda_auto_steady_gbps", kernel(pm), 4),
        ("cuda_bf16_steady_gbps", kernel(pm, "bf16"), 4),
        ("cuda_u8_steady_gbps", kernel(pm, "u8"), 4),
        ("cuda_mplane_steady_gbps", kernel(pm, "mplane"), 4),
        ("cuda_dma_steady_gbps", kernel(pm, "dma"), 4),
        ("cuda_tile8192_steady_gbps", kernel(pm, tile=8192), 4),
        ("rebuild_torch_steady_gbps", lambda x: rs_torch.gf_apply(dm_lift, x), len(LOST)),
        ("rebuild_cuda_auto_steady_gbps", kernel(dm), len(LOST)),
    ]
    meas: dict = {}
    for key, fn, rows in stages:
        try:
            meas[key] = round(bench.steady_gbps(fn, data, data_bytes, out_rows=rows), 3)
            log(f"{key}: {meas[key]} GB/s")
        except (RuntimeError, ValueError) as e:  # one stage must not zero the harvest
            meas[key + "_error"] = f"{type(e).__name__}: {e}"[:300]
            log(f"{key} stage failed: {e}")
    return meas


def _stage_e2e(td: str, dev: torch.device, size: int, steady: Optional[float],
               has_time: Callable[[str], bool]) -> dict:
    """The end-to-end encode of a `size`-byte .dat through the real file
    path on the device, then the rebuild of LOST at the default depth and
    at depth 1, each rebuilt shard held to the encode's bytes."""
    from seaweedfs_tpu_torch import bench
    from seaweedfs_tpu_torch.ec import stripe
    from seaweedfs_tpu_torch.ops.rs_codec import Encoder

    base = os.path.join(td, "9")
    bench._write_random(base + ".dat", size, np.random.default_rng(5))
    bench._write_bytes(base + ".idx", b"")
    enc = Encoder(10, 4, device=dev)
    t0 = time.perf_counter()
    stripe.write_ec_files(base, encoder=enc)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    e2e_s = time.perf_counter() - t0
    rec = {
        "when": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "dat_bytes": size,
        "e2e_seconds": round(e2e_s, 3),
        "e2e_gbps": round(size / e2e_s / 1e9, 4),
        "device_steady_gbps": steady,
        "backend": enc.backend,
        "note": "e2e: disk -> device -> .ecNN writes through ec/stripe on this host; "
                "device_steady_gbps is the int8 kernel's scan-chain number from stage 1",
    }
    if has_time("rebuild"):
        golden = {s: bench._sha256(stripe.shard_file_name(base, s)) for s in LOST}
        try:
            match = True
            for key, depth in (("rebuild_e2e", None), ("rebuild_e2e_depth1", 1)):
                for s in LOST:
                    os.unlink(stripe.shard_file_name(base, s))
                t0 = time.perf_counter()
                stripe.rebuild_ec_files(base, encoder=enc, pipeline_depth=depth)
                dt = time.perf_counter() - t0
                rec[f"{key}_seconds"] = round(dt, 3)
                if depth is None:
                    rec[f"{key}_gbps"] = round(size / dt / 1e9, 4)
                match = match and all(bench._sha256(stripe.shard_file_name(base, s)) == golden[s]
                                      for s in LOST)
            rec["rebuild_match"] = match
        except (RuntimeError, ValueError, OSError) as e:  # the rebuild must not zero the encode
            rec["rebuild_e2e_error"] = str(e)[:300]
    else:
        rec["rebuild_e2e_error"] = "skipped: budget"
    return rec


def window(art_dir: str, budget: Optional[float] = None, device: str = "cuda", batch: int = 8,
           width: int = 4 << 20, e2e_mib: float = 128, remote_mib: float = 48,
           round_: int = 0) -> dict:
    """The window's stages into `art_dir` (see the module doc); returns the
    summary line."""
    from seaweedfs_tpu_torch import bench
    from seaweedfs_tpu_torch.ops.rs_codec import Encoder

    dev = bench.resolve_device(device)
    budget = config.harness_env("WINDOW_BUDGET_S") if budget is None else float(budget)
    os.makedirs(art_dir, exist_ok=True)
    t_start = time.monotonic()
    log_path = os.path.join(art_dir, "device_window.log")
    scale = {"e2e": e2e_mib / 128, "rebuild": e2e_mib / 128, "remote": remote_mib / 48}

    def left() -> float:
        return budget - (time.monotonic() - t_start)

    def has_time(stage: str) -> bool:
        return left() > max(10.0, STAGE_NEEDS_S[stage] * scale.get(stage, 1.0))

    def log(msg: str) -> None:
        line = f"{time.strftime('%Y-%m-%dT%H:%M:%SZ', time.gmtime())} {msg}"
        print(line, flush=True)
        with open(log_path, "a", encoding="utf-8") as f:
            f.write(line + "\n")

    card = bench._card(dev)
    log(f"window open: device={dev} card={card} budget={budget}s")
    before = bench._launches()
    summary: dict = {"window": "open", "art_dir": art_dir, "budget_s": budget,
                     "device": str(dev), "card": card, "stages": {}}

    # -- 1: the fresh measurement ---------------------------------------------
    meas = {
        "when": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "round": round_,
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "card": card,
        "source": "seaweedfs_tpu_torch/scripts/device_window.py --window",
        "method": ("scan-chain slope, CUDA events" if dev.type == "cuda"
                   else "chains of 8 applies, host clock (bench.steady_gbps)")
                  + f", {batch * 10 * width / (1 << 20):g} MiB/apply, device-resident",
    }
    stage1 = _stage1(dev, batch, width, log)
    meas.update(stage1)
    meas_path = os.path.join(art_dir, f"GPU_MEASUREMENT_r{round_:02d}.json")
    _write_json(meas_path, meas)
    summary["stages"]["measure"] = stage1
    summary["launches_stage1"] = bench._launch_delta(before)

    # -- 2: the sweep, resumable, only with the reference's 600 s left ---------
    sweep_path = os.path.join(art_dir, "SWEEP.jsonl")
    if has_time("sweep"):
        log("running kernel sweep (incremental, resumes prior harvest)")
        argv = [sys.executable, "-m", "seaweedfs_tpu_torch.scripts.kernel_sweep", "--out",
                sweep_path] + (["--smoke"] if dev.type == "cpu" else [])
        with open(os.path.join(art_dir, "SWEEP.log"), "a") as out, \
                open(os.path.join(art_dir, "SWEEP.err"), "a") as err:
            rc = subprocess.run(argv, cwd=ROOT, stdout=out, stderr=err).returncode
        summary["stages"]["sweep"] = {"rc": rc}
        log(f"sweep done rc={rc}")
    else:
        summary["stages"]["sweep"] = "skipped: budget"
        log("skipping sweep: budget (assembling whatever already landed)")
    meas = assemble_measurement(meas, sweep_path)
    _write_json(meas_path, meas)
    log(f"assembled {os.path.basename(meas_path)}: "
        f"sweep_best_encode={meas.get('sweep_best_encode')}")

    # -- 3: the end-to-end encode and rebuild through the real file path -------
    if has_time("e2e"):
        with tempfile.TemporaryDirectory(dir=art_dir) as td:
            rec = _stage_e2e(td, dev, int(e2e_mib * (1 << 20)),
                             meas.get("cuda_auto_steady_gbps"), has_time)
        _write_json(os.path.join(art_dir, "E2E_DEVICE.json"), rec)
        summary["stages"]["e2e"] = rec
        log(f"e2e: {rec['e2e_gbps']} GB/s ({rec['e2e_seconds']}s for {e2e_mib:g} MiB), "
            f"rebuild_match={rec.get('rebuild_match')}")
    else:
        summary["stages"]["e2e"] = "skipped: budget"
        log("skipping e2e: budget")

    # -- 3b: the mesh bench on a host with more than one card -----------------
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if n_cards > 1 and has_time("mesh"):
        try:
            with tempfile.TemporaryDirectory(dir=art_dir) as td3:
                mesh_res = bench._measure_mesh(td3, device=dev.type)
            _write_json(os.path.join(art_dir, f"GPU_MULTICHIP_r{round_:02d}.json"),
                        assemble_multichip(mesh_res, round_))
            summary["stages"]["mesh"] = {"ok": mesh_res.get("ok"),
                                         "single_device": mesh_res.get("single_device"),
                                         "shapes": mesh_res.get("shapes")}
            log(f"mesh stage: ok={mesh_res.get('ok')}")
        except (RuntimeError, ValueError, OSError) as e:  # must not zero the harvest
            summary["stages"]["mesh"] = {"ok": False, "error": str(e)[:300]}
            log(f"mesh stage failed: {e}")
    else:
        why = "budget" if n_cards > 1 else "single device"
        summary["stages"]["mesh"] = f"skipped: {why}"
        log(f"skipping mesh stage: {why}")

    # -- 4: the remote-survivor rebuild, the decode on the device ---------------
    if has_time("remote"):
        try:
            with tempfile.TemporaryDirectory(dir=art_dir) as td2:
                rr = bench._measure_rebuild_remote(td2, dat_bytes=int(remote_mib * (1 << 20)),
                                                   encoder=Encoder(10, 4, device=dev),
                                                   device=dev.type)
            _write_json(os.path.join(art_dir, "REMOTE_REBUILD.json"), rr)
            summary["stages"]["remote"] = rr
            log(f"remote rebuild: {rr.get('remote_rebuild_gbps')} GB/s remote, "
                f"overlap_efficiency={rr.get('overlap_efficiency')}, ok={rr.get('ok')}")
        except (RuntimeError, ValueError, OSError) as e:  # must not zero the harvest
            summary["stages"]["remote"] = {"ok": False, "error": str(e)[:300]}
            log(f"remote rebuild stage failed: {e}")
    else:
        summary["stages"]["remote"] = "skipped: budget"
        log("skipping remote rebuild: budget")
    log("window complete")

    st = summary["stages"]
    e2e, remote = st["e2e"], st["remote"]
    summary.update(
        window="complete",
        seconds=round(time.monotonic() - t_start, 3),
        files=sorted(os.listdir(art_dir)),
        launches=bench._launch_delta(before),
        ok=(not any(k.endswith("_error") for k in stage1)
            and (not isinstance(e2e, dict) or e2e.get("rebuild_match") is True)
            and (not isinstance(remote, dict) or remote.get("ok") is True)
            and (not isinstance(st["mesh"], dict) or st["mesh"].get("ok") is True)),
    )
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--window", action="store_true", help="run the window's stages")
    src.add_argument("--sweep", help="kernel_sweep --out JSONL")
    src.add_argument("--multichip", help="mesh_bench --out JSON")
    ap.add_argument("--out", help="the evidence file to write (--sweep, --multichip)")
    ap.add_argument("--round", type=int, default=None)
    ap.add_argument("--art-dir", help="--window: where every output goes")
    ap.add_argument("--budget", type=float, default=None,
                    help="--window: seconds (default WINDOW_BUDGET_S)")
    ap.add_argument("--device", default="cuda", help="--window: cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=8, help="--window: stage 1's batch")
    ap.add_argument("--width", type=int, default=4 << 20, help="--window: stage 1's width")
    ap.add_argument("--e2e-mib", type=float, default=128, help="--window: stage 3's .dat")
    ap.add_argument("--remote-mib", type=float, default=48, help="--window: stage 4's .dat")
    args = ap.parse_args(argv)
    if args.window:
        if not args.art_dir:
            ap.error("--window needs --art-dir")
        summary = window(args.art_dir, args.budget, args.device, args.batch, args.width,
                         args.e2e_mib, args.remote_mib, args.round or 0)
        print(json.dumps(summary), flush=True)
        return 0 if summary["ok"] else 1
    if not args.out:
        ap.error("--sweep and --multichip need --out")
    if args.multichip:
        with open(args.multichip, encoding="utf-8") as f:
            assembled = assemble_multichip(json.load(f), args.round)
    else:
        meas = {"when": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()), "round": args.round,
                "source": "seaweedfs_tpu_torch/scripts/kernel_sweep.py"}
        assembled = assemble_measurement(meas, args.sweep)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    _write_json(args.out, assembled)
    print(json.dumps(assembled))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
