"""Kernel sweep on the card: every kernel variant of `rs_cuda.apply_matrix`
at its own tile and at explicit tiles, on the encode and the rebuild
shape, each gated byte-exact against the `gf8` golden and timed.

    python -m seaweedfs_tpu_torch.scripts.kernel_sweep [--quick|--tiny|--smoke]
                                                       [--out PATH] [--no-resume]

Configurations (names follow the reference sweep, `cuda` in the place of
`pallas`, parsed by `rs_codec.parse_fused_variant`):
  cuda[-variant]-T      variant in int8 (no tag), bf16, u8, mplane, dma;
                        T a tile or `auto` (`rs_cuda.auto_tile`)
  rebuild-cuda-...      the same kernels with the worst-case decode matrix
                        (lost 0, 5, 11, 13), as the rebuild dispatches it.
There is no `xla` row: the reference's XLA path has no counterpart on the
card (the port's plain version is a reference, never served there), so
`rs_codec.pick_device_backend` anchors on the int8 kernel instead.

Method: the scan-chain slope (`ops/measure.scan_chain_gbps`) on a (8, 10,
4 MiB) batch made on the card from `--seed`, plus the median CUDA-event
time of one call (`per_call_gbps`).

With `--out PATH` each configuration's record is appended to PATH as one
JSON line the moment it lands (flushed and fsynced), and a re-run against
the same PATH resumes past the configurations already there; `--no-resume`
starts afresh. `seaweedfs_tpu_torch/scripts/device_window.py` folds the
file into the `GPU_MEASUREMENT` evidence the encoder factory reads.

  --quick  two explicit tiles instead of four
  --tiny   toy sizes on the card: correctness and timing
  --smoke  the CPU gate: device pinned to the CPU, toy sizes, correctness
           only, every variant's plain version; exits nonzero if any
           configuration fails its byte-exact check.
Without --smoke it needs a CUDA card and raises without one. Prints one
JSON line per configuration and a summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import numpy as np
import torch

from seaweedfs_tpu_torch.ops import gf8, measure, rs_codec, rs_cuda

#: the kernel family, in the reference sweep's order
MXUS = rs_codec.FUSED_VARIANTS
#: the decode shape's loss: 2 data + 2 parity shards
LOST = (0, 5, 11, 13)


def load_done(
    path: str, platform: str | None = None, tiny: bool | None = None
) -> dict[str, dict]:
    """Records a previous (interrupted) run persisted. Only complete
    records are in the file (each is written after its configuration
    finished), so presence means done; a torn tail is skipped and retried.
    Records of another run mode (platform, tiny) never count as done."""
    done: dict[str, dict] = {}
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # a torn tail line from a crash mid-write
                name = rec.get("variant")
                if not name:
                    continue
                if platform is not None and rec.get("platform") != platform:
                    continue
                if tiny is not None and bool(rec.get("tiny")) != tiny:
                    continue
                done[name] = rec
    except OSError:
        pass
    return done


def open_resume_out(out_path: str, resume: bool):
    """Open the harvest file. On resume, a crash mid-write leaves a torn
    tail with no newline; terminate it first, so the next record is not
    glued onto the fragment."""
    out_f = open(out_path, "a" if resume else "w", encoding="utf-8")
    if resume and out_f.tell() > 0:
        with open(out_path, "rb") as chk:
            chk.seek(-1, os.SEEK_END)
            if chk.read(1) != b"\n":
                out_f.write("\n")
                out_f.flush()
    return out_f


def persist_record(out_f, rec: dict) -> None:
    """One line per configuration, flushed and fsynced as it lands."""
    out_f.write(json.dumps(rec) + "\n")
    out_f.flush()
    os.fsync(out_f.fileno())


def build_variants(quick: bool, smoke: bool = False) -> list[tuple]:
    """-> [(name, variant, tile, gf_matrix)] in harvest-priority order:
    every variant at its own tile, then the explicit-tile grid."""
    pm = gf8.parity_matrix(10, 4)
    surv = tuple(s for s in range(14) if s not in LOST)[:10]
    dm = rs_codec._reconstruction_matrix("vandermonde", 10, 4, surv, LOST)
    out = []
    for v in MXUS:
        out.append(("cuda-auto" if v == "int8" else f"cuda-{v}-auto", v, None, pm))
    out.append(("rebuild-cuda-auto", "int8", None, dm))
    out.append(("rebuild-cuda-dma-auto", "dma", None, dm))
    tiles = [8192] if smoke else [8192, 16384] if quick else [8192, 16384, 32768, 65536]
    for t in tiles:
        for v in MXUS:
            out.append((f"cuda-{t}" if v == "int8" else f"cuda-{v}-{t}", v, t, pm))
        out.append((f"rebuild-cuda-{t}", "int8", t, dm))
    return out


def _median_seconds(fn, iters: int = 5, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / 1e3)
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--quick", action="store_true")
    mode.add_argument("--tiny", action="store_true")
    mode.add_argument("--smoke", action="store_true")
    ap.add_argument("--out")
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.smoke:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda")
    else:
        raise RuntimeError("the sweep times the card and there is no CUDA device; "
                           "--smoke checks the plain versions on the CPU")
    platform = "gpu" if device.type == "cuda" else "cpu"
    card = measure.card_line() if platform == "gpu" else None
    tiny = args.smoke or args.tiny
    b, n = (2, 32768) if tiny else (8, 4 << 20)  # toy, or the reference bench's stage 3
    data_bytes = b * 10 * n
    print(json.dumps({"platform": platform, "card": card, "smoke": args.smoke,
                      "batch": [b, 10, n], "out": args.out}), flush=True)

    resume = args.out is not None and not args.no_resume
    done = load_done(args.out, platform=platform, tiny=tiny) if resume else {}
    out_f = None
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        out_f = open_resume_out(args.out, resume)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    data = None
    if not args.smoke:
        data = torch.randint(0, 256, (b, 10, n), dtype=torch.uint8, device=device, generator=gen)
    small = np.random.default_rng(args.seed + 1).integers(0, 256, (1, 10, 8192), dtype=np.uint8)
    small_t = torch.from_numpy(small).to(device)

    configs = build_variants(args.quick, args.smoke)
    results, failed, skipped = {}, [], []
    for name, variant, tile, gm in configs:
        if name in done:
            skipped.append(name)
            if isinstance(done[name].get("steady_gbps"), (int, float)):
                results[name] = done[name]["steady_gbps"]
            print(json.dumps({"variant": name, "resumed": True}), flush=True)
            continue
        rec = {"variant": name, "kernel": variant, "tile": tile, "platform": platform,
               "card": card, "tiny": tiny,
               "when": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())}

        def fn(d, gm=gm, variant=variant, tile=tile):
            return rs_cuda.apply_matrix(gm, d, tile=tile, variant=variant)

        try:
            golden = gf8.gf_mat_mul(gm, small[0])
            got = fn(small_t)[0].cpu().numpy()
            rec["exact"] = bool(np.array_equal(got, golden))
            if not rec["exact"]:
                raise ValueError("output mismatch vs gf8 golden")
            if not args.smoke:
                t = _median_seconds(lambda: fn(data))
                rec["per_call_gbps"] = data_bytes / t / 1e9
                rec["steady_gbps"] = measure.scan_chain_gbps(fn, data, data_bytes,
                                                             out_rows=gm.shape[0])
                rec["chain"] = measure.last_method
                results[name] = rec["steady_gbps"]
        except Exception as e:  # noqa: BLE001 - a failing config is recorded, not fatal
            rec["error"] = f"{type(e).__name__}: {e}"[:300]
            failed.append(name)
        print(json.dumps(rec), flush=True)
        if out_f is not None:
            persist_record(out_f, rec)

    if out_f is not None:
        out_f.close()
    if args.smoke:
        print(json.dumps({"smoke_ok": not failed, "variants": len(configs),
                          "kernels": sorted({c[1] for c in configs}), "failed": failed,
                          "skipped": len(skipped)}), flush=True)
        return 1 if failed else 0
    summary = {"failed": failed, "skipped": len(skipped)}
    if results:
        best = max(results, key=results.get)
        summary.update(best=best, steady_gbps=results[best])
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
