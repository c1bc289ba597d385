"""Per-mesh-shape encode and rebuild GB/s through the real file pipelines,
byte-verified against the single-card encoder (the counterpart of the
reference bench's `mode_mesh` / `_measure_mesh`).

    python -m seaweedfs_tpu_torch.scripts.mesh_bench [--dat-gib 4]
        [--shapes 4x1,2x2,1x4] [--devices cuda:0,...] [--repeat K]
        [--workdir DIR] [--out FILE] [--device cuda|cpu]

For each dp x sp shape it encodes one seeded volume through
`stripe.write_ec_files` with a mesh encoder and rebuilds the worst allowed
loss (four shards) through `stripe.rebuild_ec_files` with both rebuild
formulations (ring, alltoall); every shard file is byte-compared with the
single-card encoder's. Encode GB/s counts `.dat` bytes in, rebuild GB/s
rebuilt shard bytes out. The output is the GPU_MULTICHIP body that
`rs_codec.pick_mesh_backend` reads (`platform` "gpu", `card` the
nvidia-smi name and power limit), with each shape's kernel launches by
device; on a host with more than one card also `nvidia-smi topo -m` and
the `torch.cuda.can_device_access_peer` matrix. It is written to `--out`
(default: the system temp directory), never under `artifacts/`: a
committed file moves `new_encoder()` on multi-card hosts.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

from seaweedfs_tpu_torch.ec import stripe
from seaweedfs_tpu_torch.ops import measure, rs_codec, rs_cuda
from seaweedfs_tpu_torch.parallel import backend as mesh_backend
from seaweedfs_tpu_torch.parallel import mesh as mesh_mod

LOST = (0, 5, 11, 13)


def default_shapes(n_devices: int) -> list[tuple[int, int]]:
    """(n x 1), (n/2 x 2), (n/4 x 4): every shape that uses all devices
    with sp up to 4."""
    return [s for s in ((n_devices, 1), (n_devices // 2, 2), (n_devices // 4, 4))
            if s[0] >= 1 and s[0] * s[1] == n_devices]


def _write_dat(path: str, dat_bytes: int, seed: int) -> None:
    rng = np.random.default_rng(seed)
    chunk = 256 << 20
    with open(path, "wb") as f:
        for off in range(0, dat_bytes, chunk):
            f.write(rng.integers(0, 256, min(chunk, dat_bytes - off), dtype=np.uint8).tobytes())


def same_file(a: str, b: str) -> bool:
    """Whether two files hold the same bytes."""
    if os.path.getsize(a) != os.path.getsize(b):
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x, y = fa.read(64 << 20), fb.read(64 << 20)
            if x != y:
                return False
            if not x:
                return True


def _launches() -> dict:
    return dict(rs_cuda.launches_by_device)


def _delta(before: dict) -> dict:
    now = _launches()
    return {k: v - before.get(k, 0) for k, v in sorted(now.items()) if v > before.get(k, 0)}


def host_topology(n_cards: int) -> dict:
    """`nvidia-smi topo -m` and the peer-access matrix of the host's cards.
    Where nvidia-smi cannot read the topology (it exits 255 with "Failed
    to run topology matrix" on some hosts) `topology` is None and
    `topology_error` says why; the peer-access matrix is read either way."""
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True, text=True,
                          timeout=60)
    peers = [[i == j or torch.cuda.can_device_access_peer(i, j) for j in range(n_cards)]
             for i in range(n_cards)]
    if topo.returncode != 0:
        return {"topology": None, "peer_access": peers,
                "topology_error": f"exit {topo.returncode}: "
                                  f"{(topo.stdout + topo.stderr).strip()[:200]}"}
    return {"topology": topo.stdout, "peer_access": peers}


def measure_mesh(
    td: str,
    dat_bytes: int = 4 << 30,
    large: int = 1 << 30,
    small: int = 1 << 20,
    buffer_size: int = 4 << 20,
    max_batch_bytes: int = 64 << 20,
    shapes: Optional[Sequence[tuple[int, int]]] = None,
    lost: Sequence[int] = LOST,
    devices: Optional[Sequence] = None,
    device: str = "cuda",
    seed: int = 23,
) -> dict:
    """The GPU_MULTICHIP body for one volume under `td` (see the module
    doc). `devices` is the mesh's device list (default: every card; on the
    CPU the CPU once per position); `device` is where the single-card
    oracle and each mesh encoder live."""
    on_card = torch.device(device).type == "cuda"
    if devices is None:
        devices = mesh_mod.local_devices() if on_card else [torch.device("cpu")] * 8
    devices = [torch.device(d) for d in devices]
    if shapes is None:
        shapes = default_shapes(len(devices))
    out: dict = {
        "when": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "kind": "multichip",
        "n_devices": len(devices),
        "devices": [str(d) for d in devices],
        "platform": "gpu" if on_card else "cpu",
        "card": measure.card_line() if on_card else None,
        "source": "seaweedfs_tpu_torch/scripts/mesh_bench.py",
        "protocol": (
            "per-shape encode/rebuild through the ec/stripe file pipelines with the mesh "
            "backend; encode GB/s = .dat bytes / wall, rebuild GB/s = rebuilt shard bytes "
            "/ wall; every shard file byte-compared with the single-card encoder's "
            "(match=false disqualifies the shape as promotion evidence)"
        ),
        "dat_mib": dat_bytes / (1 << 20),
        "blocks": {"large": large, "small": small, "buffer": buffer_size,
                   "max_batch": max_batch_bytes},
        "lost_shards": list(lost),
        "shapes": {},
    }
    dat = os.path.join(td, "volume.dat")
    _write_dat(dat, dat_bytes, seed)
    kw = dict(buffer_size=buffer_size, max_batch_bytes=max_batch_bytes)

    oracle_enc = rs_codec.new_encoder(device=device)
    if oracle_enc.backend == "mesh":  # a promoted factory is not a single-card baseline
        oracle_enc = rs_codec.Encoder(10, 4, device=device, variant=oracle_enc.variant,
                                      tile=oracle_enc.tile)
    base_o = os.path.join(td, "oracle", "7")
    os.makedirs(os.path.dirname(base_o))
    os.link(dat, base_o + ".dat")
    t0 = time.perf_counter()
    stripe.write_ec_files(base_o, large, small, encoder=oracle_enc, **kw)
    enc_wall = time.perf_counter() - t0
    shard_size = os.path.getsize(stripe.shard_file_name(base_o, 0))
    rebuilt_bytes = len(lost) * shard_size
    saved = os.path.join(td, "oracle_lost")
    os.makedirs(saved)
    for s in lost:
        os.rename(stripe.shard_file_name(base_o, s), os.path.join(saved, str(s)))
    t0 = time.perf_counter()
    stripe.rebuild_ec_files(base_o, encoder=oracle_enc, **kw)
    reb_wall = time.perf_counter() - t0
    oracle_match = all(same_file(stripe.shard_file_name(base_o, s), os.path.join(saved, str(s)))
                       for s in lost)
    shutil.rmtree(saved)
    out["single_device"] = {
        "backend": oracle_enc.backend, "variant": oracle_enc.variant,
        "encode_gbps": dat_bytes / enc_wall / 1e9,
        "rebuild_gbps": rebuilt_bytes / reb_wall / 1e9,
        "encode_s": enc_wall, "rebuild_s": reb_wall, "match": oracle_match,
    }

    all_match = oracle_match
    for dp, sp in shapes:
        label = f"{dp}x{sp}"
        base_m = os.path.join(td, label, "7")
        os.makedirs(os.path.dirname(base_m))
        os.link(dat, base_m + ".dat")
        rec: dict = {}
        try:
            enc = rs_codec.Encoder(10, 4, backend="mesh", device=device, mesh_shape=(dp, sp),
                                   mesh_devices=devices, variant=oracle_enc.variant,
                                   tile=oracle_enc.tile)
            before = _launches()
            t0 = time.perf_counter()
            stripe.write_ec_files(base_m, large, small, encoder=enc, **kw)
            rec["encode_s"] = time.perf_counter() - t0
            rec["encode_gbps"] = dat_bytes / rec["encode_s"] / 1e9
            rec["encode_launches"] = _delta(before)
            match = all(same_file(stripe.shard_file_name(base_m, s),
                                   stripe.shard_file_name(base_o, s)) for s in range(14))
            for variant in mesh_backend.REBUILD_VARIANTS:
                for s in lost:
                    os.unlink(stripe.shard_file_name(base_m, s))
                enc_v = rs_codec.Encoder(10, 4, backend="mesh", device=device,
                                         mesh_shape=(dp, sp), mesh_rebuild=variant,
                                         mesh_devices=devices, variant=oracle_enc.variant,
                                         tile=oracle_enc.tile)
                before = _launches()
                t0 = time.perf_counter()
                stripe.rebuild_ec_files(base_m, encoder=enc_v, **kw)
                wall = time.perf_counter() - t0
                rec[f"rebuild_{variant}_s"] = wall
                rec[f"rebuild_{variant}_gbps"] = rebuilt_bytes / wall / 1e9
                rec[f"rebuild_{variant}_launches"] = _delta(before)
                match = match and all(same_file(stripe.shard_file_name(base_m, s),
                                                 stripe.shard_file_name(base_o, s)) for s in lost)
            rec["match"] = bool(match)
            all_match = all_match and match
        except (RuntimeError, ValueError, OSError) as e:  # one shape must not end the sweep
            rec["error"] = f"{type(e).__name__}: {e}"[:300]
            all_match = False
        shutil.rmtree(os.path.dirname(base_m))
        out["shapes"][label] = rec
    out["ok"] = bool(all_match and out["shapes"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dat-gib", type=float, default=4.0)
    ap.add_argument("--shapes", default=None, help="comma-separated DPxSP (default: all devices)")
    ap.add_argument("--devices", default=None, help="comma-separated (default: every card)")
    ap.add_argument("--repeat", type=int, default=1, help="name the device list this many times")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for the plain version")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        devices = args.devices.split(",") if args.devices else mesh_mod.local_devices()
    else:
        devices = args.devices.split(",") if args.devices else ["cpu"] * 8
    devices = [torch.device(d) for d in devices] * max(1, args.repeat)
    shapes = ([mesh_backend.parse_mesh_shape(s) for s in args.shapes.split(",")]
              if args.shapes else None)
    td = tempfile.mkdtemp(prefix="mesh_bench_", dir=args.workdir)
    try:
        res = measure_mesh(td, dat_bytes=int(args.dat_gib * (1 << 30)), shapes=shapes,
                           devices=devices, device=args.device)
    finally:
        shutil.rmtree(td, ignore_errors=True)
    n_cards = torch.cuda.device_count() if res["platform"] == "gpu" else 0
    if n_cards > 1:
        res.update(host_topology(n_cards))
    out = args.out or os.path.join(tempfile.gettempdir(), "GPU_MULTICHIP.json")
    with open(out, "w", encoding="utf-8") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
