"""Time the GF(2^8) kernels of one checkout on the card, graph-timed.

    python seaweedfs_tpu_torch/scripts/kernel_times.py [--root DIR]
        [--variants int8,dma,...] [--tile T] [--label L] [--out FILE]

Imports `seaweedfs_tpu_torch` from DIR (default: this checkout), so that
the kernels of another commit, unpacked with `git archive` into DIR, are
timed by this checkout's timer (`ops/measure.py:graph_ms`, loaded by file
path): two runs in one call, parent and change in turns, compare the two
on one card. For each variant and each of the main path's three shapes
(encode (4,10) x (10, 6 553 600), rebuild of 4 and of 1 lost shard at
(10, 4 194 304)) it checks the kernel against its plain version on the
card byte for byte (at the variant's own tile, or `--tile`) and prints
one JSON line: `kernel_ms` (graph time per
launch), `call_ms` (one eager call of the wrapper, host time included),
`bound_ms` with `bound_by` (`measure.bound_ms`: bytes, or the
variant's own tensor-core rate) and the card line. Exits 1 on a mismatch or without a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
OWN_ROOT = os.path.dirname(os.path.dirname(HERE))


def _own_measure():
    """This checkout's `ops/measure.py`, whichever package --root imports."""
    spec = importlib.util.spec_from_file_location(
        "_kernel_times_measure", os.path.join(OWN_ROOT, "seaweedfs_tpu_torch", "ops", "measure.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=OWN_ROOT)
    ap.add_argument("--variants", default="int8,dma,mplane,u8,bf16")
    ap.add_argument("--tile", type=int, default=None, help="columns per block (default: auto_tile)")
    ap.add_argument("--label", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="append the JSON lines to this file too")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from seaweedfs_tpu_torch.ops import gf8, rs_codec, rs_cuda

    measure = _own_measure()
    card = measure.card_line()
    label = args.label or root
    par = gf8.parity_matrix(10, 4)
    enc = rs_codec.Encoder(10, 4, device="cuda")
    lost = (0, 5, 10, 13)
    shapes = [
        ("encode", par, 6_553_600),
        ("rebuild4", enc.reconstruction_matrix([s for s in range(14) if s not in lost][:10], lost),
         4_194_304),
        ("rebuild1", enc.reconstruction_matrix([s for s in range(14) if s != 5][:10], (5,)),
         4_194_304),
    ]
    rng = np.random.default_rng(args.seed)
    bad = []
    out = open(args.out, "a") if args.out else None
    try:
        for shape, m, n in shapes:
            data = torch.from_numpy(rng.integers(0, 256, (m.shape[1], n), dtype=np.uint8)).cuda()
            bufs = (data, data.clone())  # launches alternate: together > the 50 MB L2
            for v in args.variants.split(","):
                tile = args.tile
                got = rs_cuda.apply_matrix(m, data, tile, variant=v)
                equal = bool(torch.equal(got, rs_cuda.plain_apply(m, data, tile, variant=v)))
                del got
                rec = {
                    "label": label, "variant": v, "shape": shape, "tile": tile,
                    "matrix": list(m.shape), "data": list(data.shape), "equal": equal,
                    "kernel_ms": measure.graph_ms(
                        lambda i: rs_cuda.apply_matrix(m, bufs[i % 2], tile, variant=v)),
                    "call_ms": measure.eager_ms(lambda: rs_cuda.apply_matrix(m, data, tile, variant=v), 50),
                    "card": card,
                }
                rec["bound_ms"], rec["bound_by"] = measure.bound_ms(v, m.shape[1], m.shape[0], n)
                line = json.dumps(rec)
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                if not equal:
                    bad.append((v, shape))
            del data, bufs
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    if bad:
        print(f"kernel_times: kernels differ from their plain versions at {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
