"""Multi-card dry run: the full EC step over a mesh, at a wiring scale and
at a real one (the counterpart of the reference's
`__graft_entry__.dryrun_multichip`).

    python -m seaweedfs_tpu_torch.parallel.dryrun [--devices cuda:0,cuda:1,...]
        [--repeat K] [--large-mib 64] [--out FILE]

builds an (n/2 x 2) dp x sp mesh (n x 1 below 4 entries) over the device
list (default: every card of the host; `--repeat K` names the list K times,
as a mesh may name one device several times), runs encode -> 4-shard loss
-> reconstruct -> global integrity count once on tiny shapes, then the
all_to_all and ring rebuilds; then the same at `large_mib` MiB of shard
data (0 skips it) with both rebuilds timed; then, with 8 or more entries,
the ('dcn', 'dp', 'sp') pass. It raises unless the mismatch count is 0,
the sharded parity equals the host's (`gf8.gf_mat_vec`) and the ring
rebuild equals the all_to_all one. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from seaweedfs_tpu_torch.ops import gf8, rs_codec, rs_cuda
from seaweedfs_tpu_torch.parallel import mesh as mesh_mod
from seaweedfs_tpu_torch.parallel import ring as ring_mod
from seaweedfs_tpu_torch.parallel import sharded

LOST = (0, 3, 11, 13)
SURVIVORS = tuple(i for i in range(14) if i not in LOST)


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _sync(mesh: mesh_mod.Mesh) -> None:
    for dev in {d for d in mesh.devices.flat if d.type == "cuda"}:
        torch.cuda.synchronize(dev)


def entry(device="cuda"):
    """The single-device forward step: (B, 10, N) uint8 stripe tiles ->
    (B, 14, N) shards, one launch, and its example input (the reference's
    `entry()` shape: B = 4, N = 64 KiB)."""
    parity = gf8.parity_matrix(10, 4)

    def forward(data: torch.Tensor) -> torch.Tensor:
        return torch.cat([data, rs_cuda.apply_matrix(parity, data)], dim=1)

    rng = np.random.default_rng(0)
    example = torch.from_numpy(rng.integers(0, 256, size=(4, 10, 1 << 16), dtype=np.uint8))
    return forward, (example.to(device),)


def dryrun(devices: Optional[Sequence] = None, large_mib: int = 64) -> dict:
    """Run the dry run over `devices` (default: every card) and return what
    it measured; raises on any failed assertion."""
    devices = [torch.device(d) for d in (devices if devices is not None
                                         else mesh_mod.local_devices())]
    n_devices = len(devices)
    shape = (n_devices // 2, 2) if n_devices >= 4 and n_devices % 2 == 0 else (n_devices, 1)
    mesh = mesh_mod.device_mesh(("dp", "sp"), shape=shape, devices=devices)
    pm = gf8.parity_matrix(10, 4)
    recon = rs_codec._reconstruction_matrix("vandermonde", 10, 4, SURVIVORS, LOST)
    step = sharded.make_ec_cycle_fn(mesh, pm, recon, LOST, SURVIVORS)
    rebuild = sharded.make_distributed_rebuild_fn(mesh, recon)
    ring_fn = ring_mod.make_ring_rebuild_fn(mesh, recon)
    out: dict = {"devices": [str(d) for d in devices], "mesh": dict(mesh.shape)}

    b, n = shape[0] * 2, shape[1] * 256  # tiny, divisible by the mesh axes
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, size=(b, 10, n), dtype=np.uint8)
    placed, bad = step(sharded.shard_batch(mesh, data))
    shards = np.asarray(placed)
    _require(shards.shape == (b, 14, n), f"shards {shards.shape}")
    _require(int(bad) == 0, f"integrity check failed: {int(bad)} mismatches")
    _require(np.array_equal(shards[0, 10:], gf8.gf_mat_vec(pm, data[0])),
             "sharded parity != host golden")
    rebuilt = np.asarray(rebuild(shards[:, SURVIVORS, :]))
    _require(np.array_equal(rebuilt, shards[:, LOST, :]), "distributed rebuild != encoded shards")
    _require(np.array_equal(np.asarray(ring_fn(shards[:, SURVIVORS, :])), rebuilt),
             "ring rebuild != all_to_all rebuild")
    out["small"] = {"shards": list(shards.shape), "mismatches": 0}
    if large_mib <= 0:
        return out

    # the real scale: >= large_mib MiB of shard data through the same step
    # and both rebuilds; b divisible by dp, n by sp
    big_b = shape[0] * 3
    big_n = max(shape[1] * 256, (large_mib << 20) // (14 * big_b) // shape[1] * shape[1])
    big = rng.integers(0, 256, size=(big_b, 10, big_n), dtype=np.uint8)
    t0 = time.perf_counter()
    placed, bad = step(sharded.shard_batch(mesh, big))
    bad = int(bad)
    shards = np.asarray(placed)
    t_cycle = time.perf_counter() - t0
    del placed
    _require(bad == 0, f"large-shape integrity: {bad} mismatches")
    _require(np.array_equal(shards[0, 10:], gf8.gf_mat_vec(pm, big[0])),
             "large-shape parity mismatch")
    # both rebuilds timed with the same protocol: one untimed run each
    # first, then host to host (placement, collective and decode, gather),
    # then on survivors already placed (the collective and decode alone)
    surv = np.ascontiguousarray(shards[:, SURVIVORS, :])
    s_pad = sharded.pad_survivor_matrix(recon, shape[1]).shape[1]
    timed = {}
    for name, fn in (("alltoall", rebuild), ("ring", ring_fn)):
        np.asarray(fn(surv))
        t0 = time.perf_counter()
        got = np.asarray(fn(surv))
        wall = time.perf_counter() - t0
        st = sharded.place_survivors(mesh, surv, len(SURVIVORS), s_pad)
        _sync(mesh)
        t0 = time.perf_counter()
        res = fn.on_mesh(st)
        _sync(mesh)
        on_mesh = time.perf_counter() - t0
        _require(np.array_equal(np.asarray(res), got), f"{name}: placed run differs")
        timed[name] = (got, wall, on_mesh)
    _require(np.array_equal(timed["alltoall"][0], shards[:, LOST, :]), "large-shape rebuild mismatch")
    _require(np.array_equal(timed["ring"][0], timed["alltoall"][0]), "large-shape ring != all_to_all")
    out["large"] = {
        "shard_mib": shards.nbytes / (1 << 20), "b": big_b, "n": big_n,
        "encode_cycle_s": t_cycle,
        "alltoall_s": timed["alltoall"][1], "ring_s": timed["ring"][1],
        "alltoall_on_mesh_s": timed["alltoall"][2], "ring_on_mesh_s": timed["ring"][2],
    }
    del surv, timed

    # the ('dcn', 'dp', 'sp') pass: slices own disjoint volume sub-batches
    # and one integrity scalar per slice crosses 'dcn'
    if n_devices >= 8:
        dcn_mesh = mesh_mod.device_mesh(("dcn", "dp", "sp"), shape=(2, 2, n_devices // 4),
                                        devices=devices)
        ms_step = sharded.make_multislice_ec_cycle_fn(dcn_mesh, pm, recon, LOST, SURVIVORS)
        ms_b = max(big_b // 4 * 4, 4)
        ms_n = big_n // (n_devices // 4) * (n_devices // 4)
        ms_data = np.ascontiguousarray(big[:ms_b, :, :ms_n])
        t0 = time.perf_counter()
        ms_placed, ms_bad = ms_step(ms_data)
        ms_bad = int(ms_bad)
        ms_shards = np.asarray(ms_placed)
        t_ms = time.perf_counter() - t0
        _require(ms_bad == 0, f"multislice integrity: {ms_bad} mismatches")
        _require(np.array_equal(ms_shards[0, 10:], gf8.gf_mat_vec(pm, ms_data[0])),
                 "multislice parity != host golden")
        out["dcn"] = {"mesh": dict(dcn_mesh.shape), "shard_mib": ms_shards.nbytes / (1 << 20),
                      "encode_cycle_s": t_ms, "mismatches": 0}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", default=None,
                    help="comma-separated devices (default: every card of the host)")
    ap.add_argument("--repeat", type=int, default=1, help="name the device list this many times")
    ap.add_argument("--large-mib", type=int, default=64)
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)
    devices = args.devices.split(",") if args.devices else mesh_mod.local_devices()
    t0 = time.perf_counter()
    res = dryrun(list(devices) * max(1, args.repeat), large_mib=args.large_mib)
    res["seconds"] = time.perf_counter() - t0
    line = json.dumps(res)
    if args.out:
        with open(args.out, "a", encoding="utf-8") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
