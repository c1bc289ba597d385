"""benchmark / upload / download commands, mirroring
weed/command/benchmark.go, upload.go and download.go.

`benchmark` is the built-in load generator: C concurrent writers push N
files of S bytes through assign+POST, then readers fetch them back;
prints throughput and latency percentiles like the reference's
"Unscientific benchmark" output.

They are clients of a cluster: they run no kernel, so they take no
`--device`, and they reach the transport (and so grpc) only when one of
them runs.
"""

from __future__ import annotations

import argparse
import os
import threading
import time

from seaweedfs_tpu_torch.command import Command, register


def _percentile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[i]


def _bench_conf(p: argparse.ArgumentParser) -> None:
    p.add_argument("-master", default="127.0.0.1:9333")
    p.add_argument("-n", type=int, default=1000, help="number of files")
    p.add_argument("-size", type=int, default=1024, help="file size in bytes")
    p.add_argument("-c", type=int, default=16, help="concurrent workers")
    p.add_argument("-collection", default="")
    p.add_argument("-write", action="store_true", default=True)
    p.add_argument("-read", action="store_true", default=True)


def _bench_run(args: argparse.Namespace) -> int:
    from seaweedfs_tpu_torch.cluster.client import MasterClient

    client = MasterClient(args.master)
    payload = os.urandom(args.size)
    fids: list[str] = []
    fid_lock = threading.Lock()
    lat_w: list[float] = []
    lat_r: list[float] = []
    errors = [0]

    def writer(count: int) -> None:
        for _ in range(count):
            t0 = time.monotonic()
            try:
                res = client.submit(payload, collection=args.collection)
                with fid_lock:
                    fids.append(res.fid)
                    lat_w.append(time.monotonic() - t0)
            except Exception:  # noqa: BLE001
                with fid_lock:
                    errors[0] += 1

    def run_phase(fn, total: int) -> float:
        per = [total // args.c] * args.c
        for i in range(total % args.c):
            per[i] += 1
        threads = [threading.Thread(target=fn, args=(n,)) for n in per if n]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return time.monotonic() - t0

    print(f"benchmark: {args.n} files x {args.size} B, {args.c} workers, master {args.master}")
    wall_w = run_phase(writer, args.n)
    lat_w.sort()
    mb = len(fids) * args.size / 1e6
    print(
        f"write: {len(fids)} ok, {errors[0]} err in {wall_w:.2f}s "
        f"= {len(fids) / max(wall_w, 1e-9):.0f} req/s, {mb / max(wall_w, 1e-9):.1f} MB/s"
    )
    print(
        f"write latency ms: p50 {1e3 * _percentile(lat_w, 0.50):.1f} "
        f"p90 {1e3 * _percentile(lat_w, 0.90):.1f} p99 {1e3 * _percentile(lat_w, 0.99):.1f}"
    )

    if fids:
        idx = [0]

        def reader(count: int) -> None:
            for _ in range(count):
                with fid_lock:
                    if idx[0] >= len(fids):
                        return
                    fid = fids[idx[0] % len(fids)]
                    idx[0] += 1
                t0 = time.monotonic()
                try:
                    data = client.read(fid)
                    assert len(data) == args.size
                    with fid_lock:
                        lat_r.append(time.monotonic() - t0)
                except Exception:  # noqa: BLE001
                    with fid_lock:
                        errors[0] += 1

        wall_r = run_phase(reader, len(fids))
        lat_r.sort()
        mb = len(lat_r) * args.size / 1e6
        print(
            f"read:  {len(lat_r)} ok in {wall_r:.2f}s "
            f"= {len(lat_r) / max(wall_r, 1e-9):.0f} req/s, {mb / max(wall_r, 1e-9):.1f} MB/s"
        )
        print(
            f"read latency ms:  p50 {1e3 * _percentile(lat_r, 0.50):.1f} "
            f"p90 {1e3 * _percentile(lat_r, 0.90):.1f} p99 {1e3 * _percentile(lat_r, 0.99):.1f}"
        )
    client.close()
    return 0


register(Command("benchmark", "write/read load generator against a cluster", _bench_conf, _bench_run))


def _upload_conf(p: argparse.ArgumentParser) -> None:
    p.add_argument("-master", default="127.0.0.1:9333")
    p.add_argument("-collection", default="")
    p.add_argument("-replication", default="")
    p.add_argument("files", nargs="+", help="local files to upload")


def _upload_run(args: argparse.Namespace) -> int:
    import json as _json
    import mimetypes

    from seaweedfs_tpu_torch.cluster.client import MasterClient

    client = MasterClient(args.master)
    out = []
    for path in args.files:
        with open(path, "rb") as f:
            data = f.read()
        mime = mimetypes.guess_type(path)[0] or "application/octet-stream"
        res = client.submit(
            data, collection=args.collection, replication=args.replication, mime=mime
        )
        out.append({"fileName": os.path.basename(path), "fid": res.fid, "size": res.size})
    print(_json.dumps(out, indent=2))
    client.close()
    return 0


register(Command("upload", "upload local files, printing their fids", _upload_conf, _upload_run))


def _download_conf(p: argparse.ArgumentParser) -> None:
    p.add_argument("-master", default="127.0.0.1:9333")
    p.add_argument("-dir", default=".", help="output directory")
    p.add_argument("fids", nargs="+", help="file ids to download")


def _download_run(args: argparse.Namespace) -> int:
    from seaweedfs_tpu_torch.cluster.client import MasterClient

    client = MasterClient(args.master)
    os.makedirs(args.dir, exist_ok=True)
    for fid in args.fids:
        data = client.read(fid)
        out = os.path.join(args.dir, fid.replace(",", "_"))
        with open(out, "wb") as f:
            f.write(data)
        print(f"{fid} -> {out} ({len(data)} bytes)")
    client.close()
    return 0


register(Command("download", "download files by fid", _download_conf, _download_run))
