"""Sync/backup commands, after upstream's weed/command/filer_sync.go,
filer_backup.go, filer_meta_tail.go and filer_copy.go. None of them takes
a device: they are clients of the filer.

  filer.sync   — continuous one-way replication filer A -> filer B
  filer.backup — drain pending metadata events into a local directory
"""

from __future__ import annotations

import argparse
import signal
import threading

from seaweedfs_tpu_torch.command import Command, register


def _sync_conf(p: argparse.ArgumentParser) -> None:
    p.add_argument("-from", dest="src_grpc", required=True, help="source filer grpc host:port")
    p.add_argument("-to", dest="dst_http", required=True, help="target filer http host:port")
    p.add_argument("-prefix", default="/", help="only sync this subtree")
    p.add_argument("-targetPath", default="/", help="root on the target filer")
    p.add_argument("-id", default="", help="checkpoint id (default: sink kind)")


def _sync_run(args: argparse.Namespace) -> int:
    from seaweedfs_tpu_torch.replication import FilerSink, Replicator

    sink = FilerSink(args.dst_http, target_root=args.targetPath)
    rep = Replicator(
        args.src_grpc, sink, prefix=args.prefix,
        sink_id=args.id or f"filer.{args.dst_http}",
    )
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(sig, lambda *_: stop.set())
        except ValueError:
            break
    print(f"filer.sync {args.src_grpc} -> {args.dst_http} (prefix {args.prefix})")
    rep.run(stop)
    rep.close()
    return 0


register(Command("filer.sync", "continuously replicate one filer into another", _sync_conf, _sync_run))


def _backup_conf(p: argparse.ArgumentParser) -> None:
    p.add_argument("-filerGrpc", required=True, help="source filer grpc host:port")
    p.add_argument("-dir", required=True, help="local backup directory")
    p.add_argument("-prefix", default="/")
    p.add_argument("-id", default="", help="checkpoint id (default: local.<dir>)")


def _backup_run(args: argparse.Namespace) -> int:
    from seaweedfs_tpu_torch.replication import LocalSink, Replicator

    sink = LocalSink(args.dir)
    rep = Replicator(
        args.filerGrpc, sink, prefix=args.prefix,
        sink_id=args.id or f"local.{args.dir}",
    )
    n = rep.run_once()
    print(f"applied {n} events into {args.dir}")
    rep.close()
    return 0


register(Command("filer.backup", "apply pending filer events to a local directory", _backup_conf, _backup_run))


def _meta_tail_conf(p: argparse.ArgumentParser) -> None:
    p.add_argument("-filerGrpc", required=True, help="filer grpc host:port")
    p.add_argument("-prefix", default="/", help="only events under this subtree")
    p.add_argument("-sinceNs", type=int, default=0, help="replay from this event ts")
    p.add_argument(
        "-maxIdleSeconds",
        type=float,
        default=0,
        help="exit after this much quiet (0 = follow forever)",
    )


def _meta_tail_run(args: argparse.Namespace) -> int:
    """Stream the filer metadata event log to stdout as JSON lines
    (filer.meta.tail analog) — the operator's live view of namespace
    mutations, and the same feed replication/mq consume."""
    import json

    from seaweedfs_tpu_torch.filer.client import FilerClient

    with FilerClient(args.filerGrpc) as fc:
        try:
            for ev in fc.subscribe(
                since_ns=args.sinceNs,
                path_prefix=args.prefix,
                max_idle_s=args.maxIdleSeconds,
            ):
                print(json.dumps(ev.to_dict()), flush=True)
        except KeyboardInterrupt:
            pass
    return 0


register(Command("filer.meta.tail", "stream filer metadata events as JSON lines", _meta_tail_conf, _meta_tail_run))


def _filer_copy_conf(p: argparse.ArgumentParser) -> None:
    p.add_argument("-filer", required=True, help="filer http host:port")
    p.add_argument("-collection", default="")
    p.add_argument("-replication", default="")
    p.add_argument("-ttl", default="")
    p.add_argument("sources", nargs="+", help="local files/directories to copy")
    p.add_argument("target", help="filer directory (must end with /)")


def _filer_copy_run(args: argparse.Namespace) -> int:
    """Bulk-copy local trees into the filer over HTTP (filer.copy analog)."""
    import os
    import urllib.parse
    import urllib.request

    if not args.target.endswith("/"):
        print("target must be a filer DIRECTORY path ending with /")
        return 1
    q = {}
    for k in ("collection", "replication", "ttl"):
        if getattr(args, k):
            q[k] = getattr(args, k)
    query = ("?" + urllib.parse.urlencode(q)) if q else ""
    copied = failed = 0

    def put(local: str, remote: str) -> None:
        nonlocal copied, failed
        try:  # one unreadable source must not abort the bulk copy
            size = os.path.getsize(local)
            with open(local, "rb") as f:
                # stream the file object (constant memory on multi-GB
                # files); explicit Content-Length — the filer refuses
                # chunked uploads with 411
                req = urllib.request.Request(
                    f"http://{args.filer}{urllib.parse.quote(remote)}{query}",
                    data=f,
                    method="PUT",
                    headers={"Content-Length": str(size)},
                )
                with urllib.request.urlopen(req, timeout=600) as r:
                    r.read()
            copied += 1
            print(f"{local} -> {remote} ({size} bytes)")
        except Exception as e:  # noqa: BLE001 — keep copying the rest
            failed += 1
            print(f"FAILED {local}: {e}")

    for src in args.sources:
        if os.path.isdir(src):
            base = os.path.basename(os.path.abspath(src))
            for root, _dirs, files in os.walk(src):
                rel_root = os.path.relpath(root, src)
                for name in sorted(files):
                    rel = name if rel_root == "." else f"{rel_root}/{name}"
                    put(os.path.join(root, name), f"{args.target}{base}/{rel}")
        else:
            put(src, f"{args.target}{os.path.basename(src)}")
    print(f"filer.copy: {copied} copied, {failed} failed")
    return 0 if failed == 0 else 1


register(Command("filer.copy", "bulk-copy local files/directories into the filer", _filer_copy_conf, _filer_copy_run))
