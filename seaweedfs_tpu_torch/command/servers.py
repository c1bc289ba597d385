"""Process-level commands — version, master, volume, server, filer, s3,
webdav, iam, mount, mq.broker and shell, mirroring weed/command/{master,
volume,server,filer,s3,webdav,iam,mount,mq_broker,shell}.go. `server` runs
a master and a volume server in one process, as `weed server` does
(`-filer` adds a filer, `-s3` and `-webdav` a filer and that gateway);
`filer` runs the namespace server alone against a master; `s3`, `webdav`
and `iam` run a gateway alone against a filer; `mq.broker` runs a topic
broker on a filer; `mount` serves a filer through kernel FUSE where a
fusepy module is importable; `shell` is the operator shell (REPL, or `-c`
for a `;`-separated script). The volume server's EC work, and what the
shell builds locally, runs on the card (`--device`, default cuda);
`--device cpu` gives the plain version. The filer, the gateways, the mount
and the broker run no kernel, so their commands take no `--device` and
never touch the card. `master -peers a,b,c -raftDir D` joins a raft
quorum; `scaffold` prints a commented TOML template. The transport (and so
grpc) is imported only when a server or shell command runs, so the local
commands that share the registry need none of it."""

from __future__ import annotations

import argparse
import signal
import sys
import threading

from seaweedfs_tpu_torch.command import Command, register
from seaweedfs_tpu_torch.utils.config import get_nested, load_configuration


def _version_conf(p: argparse.ArgumentParser) -> None:
    pass


def _version_run(args: argparse.Namespace) -> int:
    import seaweedfs_tpu_torch

    print(f"seaweedfs_tpu_torch {seaweedfs_tpu_torch.__version__}")
    return 0


register(Command("version", "print version", _version_conf, _version_run))


def _wait_forever() -> None:
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(sig, lambda *_: stop.set())
        except ValueError:  # not the main thread (tests)
            break
    stop.wait()


def _security() -> dict:
    """security.toml, with its [grpc] TLS made process-wide before any
    server binds a socket or dials a peer."""
    from seaweedfs_tpu_torch.security import tls

    conf = load_configuration("security")
    tls.configure_from_conf(conf)
    return conf


def _load_guard(conf: dict):
    """A security.Guard from security.toml (None = security off)."""
    from seaweedfs_tpu_torch.security import Guard

    key = str(get_nested(conf, "jwt.signing.key", "") or "")
    read_key = str(get_nested(conf, "jwt.signing.read.key", "") or "")
    wl = list(get_nested(conf, "guard.white_list", []) or [])
    exp = int(get_nested(conf, "jwt.signing.expires_after_seconds", 10) or 10)
    if not (key or read_key or wl):
        return None
    return Guard(
        signing_key=key.encode() or None,
        read_signing_key=read_key.encode() or None,
        white_list=wl,
        expires_seconds=exp,
    )


def _encoder(device):
    """The volume server's encoder: the factory's on `device` (the card by
    default; new_encoder raises without one)."""
    from seaweedfs_tpu_torch.ops.rs_codec import new_encoder

    return new_encoder(device=device)


def _maybe_metrics(port: int):
    if port:
        from seaweedfs_tpu_torch.stats import start_metrics_server

        start_metrics_server(port)
        print(f"metrics on :{port}")


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--device", default=None,
        help="torch device the EC work runs on (default: cuda; cpu runs the plain version)",
    )


def _master_conf(p: argparse.ArgumentParser) -> None:
    p.add_argument("-port", type=int, default=9333)
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-volumeSizeLimitMB", type=int, default=30 * 1024)
    p.add_argument("-defaultReplication", default="000")
    p.add_argument("-peers", default="", help="comma-separated master quorum (raft HA)")
    p.add_argument("-garbageThreshold", type=float, default=0.3,
                   help="auto-vacuum volumes whose dead fraction exceeds this")
    p.add_argument("-vacuumInterval", type=float, default=900.0,
                   help="seconds between automatic vacuum sweeps")
    p.add_argument("-raftDir", default="", help="raft term/vote persistence directory")
    p.add_argument("-httpPort", type=int, default=0,
                   help="HTTP API port (/dir/assign, /dir/lookup, ...); 0 = auto")
    p.add_argument("-metricsPort", type=int, default=0)


def _master_run(args: argparse.Namespace) -> int:
    from seaweedfs_tpu_torch.cluster.master import MasterServer

    conf = _security()
    peers = [a.strip() for a in args.peers.split(",") if a.strip()]
    m = MasterServer(
        port=args.port,
        host=args.ip,
        volume_size_limit=args.volumeSizeLimitMB * 1024 * 1024,
        default_replication=args.defaultReplication,
        guard=_load_guard(conf),
        peers=peers or None,
        raft_dir=args.raftDir,
        garbage_threshold=args.garbageThreshold,
        vacuum_interval=args.vacuumInterval,
        http_port=args.httpPort,
    )
    m.start()
    _maybe_metrics(args.metricsPort)
    print(f"master listening on {m.address} (http :{m.http_port})", flush=True)
    _wait_forever()
    m.stop()
    return 0


register(Command("master", "run a master server", _master_conf, _master_run))


def _volume_conf(p: argparse.ArgumentParser) -> None:
    p.add_argument("-port", type=int, default=8080)
    p.add_argument("-grpcPort", type=int, default=0)
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-dir", action="append", default=None, help="storage directory (repeatable)")
    p.add_argument("-mserver", default="127.0.0.1:9333")
    p.add_argument("-dataCenter", default="DefaultDataCenter")
    p.add_argument("-rack", default="DefaultRack")
    p.add_argument("-max", type=int, default=8, help="max volume count")
    p.add_argument("-metricsPort", type=int, default=0)
    p.add_argument(
        "-index",
        default="memory",
        choices=["memory", "sorted_file"],
        help="needle map kind: memory rebuilds the id map in RAM each "
        "mount; sorted_file binary-searches a persistent .sdx sidecar",
    )
    _add_device(p)


def _volume_run(args: argparse.Namespace) -> int:
    from seaweedfs_tpu_torch.cluster.volume_server import VolumeServer

    conf = _security()
    vs = VolumeServer(
        args.dir or ["./data"],
        args.mserver,
        port=args.port,
        grpc_port=args.grpcPort,
        host=args.ip,
        data_center=args.dataCenter,
        rack=args.rack,
        max_volume_count=args.max,
        encoder=_encoder(args.device),
        guard=_load_guard(conf),
        needle_map_kind=args.index,
    )
    vs.start()
    _maybe_metrics(args.metricsPort)
    print(f"volume server on http {vs.url} grpc {vs.grpc_address}", flush=True)
    _wait_forever()
    vs.stop()
    return 0


register(Command("volume", "run a volume server", _volume_conf, _volume_run))


def _server_conf(p: argparse.ArgumentParser) -> None:
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-masterPort", type=int, default=9333)
    p.add_argument("-masterHttpPort", type=int, default=0,
                   help="master HTTP API port (/dir/assign, ...); 0 = auto")
    p.add_argument("-port", type=int, default=8080, help="volume server http port")
    p.add_argument("-dir", action="append", default=None)
    p.add_argument("-volumeSizeLimitMB", type=int, default=30 * 1024)
    p.add_argument("-filer", action="store_true", help="also run a filer")
    p.add_argument("-filerPort", type=int, default=8888)
    p.add_argument("-s3", action="store_true", help="also run the S3 gateway (implies -filer)")
    p.add_argument("-s3Port", type=int, default=8333)
    p.add_argument("-webdav", action="store_true", help="also run WebDAV (implies -filer)")
    p.add_argument("-webdavPort", type=int, default=7333)
    p.add_argument(
        "-allowedHosts",
        default="",
        help="comma-separated advertised host:port names accepted as the "
        "signed Host header by the S3 gateway besides the bind address",
    )
    _add_device(p)


def _hosts(arg: str) -> set[str]:
    return {h.strip() for h in arg.split(",") if h.strip()}


def _server_run(args: argparse.Namespace) -> int:
    from seaweedfs_tpu_torch.cluster.master import MasterServer
    from seaweedfs_tpu_torch.cluster.volume_server import VolumeServer

    _security()
    enc = _encoder(args.device)
    m = MasterServer(
        port=args.masterPort,
        host=args.ip,
        volume_size_limit=args.volumeSizeLimitMB * 1024 * 1024,
        http_port=args.masterHttpPort,
    )
    m.start()
    vs = VolumeServer(args.dir or ["./data"], m.address, port=args.port, host=args.ip,
                      encoder=enc)
    vs.start()
    parts = [f"master {m.address} (http :{m.http_port})",
             f"volume http {vs.url} grpc {vs.grpc_address}"]
    extras = []
    try:
        if args.filer or args.s3 or args.webdav:
            from seaweedfs_tpu_torch.filer import FilerServer

            f = FilerServer(m.address, port=args.filerPort, host=args.ip)
            f.start()
            extras.append(f)
            parts.append(f"filer http {f.url} grpc {f.grpc_address}")
            if args.s3:
                from seaweedfs_tpu_torch.s3api import S3ApiServer

                s3 = S3ApiServer(f.url, f.grpc_address, port=args.s3Port, host=args.ip,
                                 extra_hosts=_hosts(args.allowedHosts))
                s3.start()
                extras.append(s3)
                parts.append(f"s3 {s3.url}")
            if args.webdav:
                from seaweedfs_tpu_torch.webdav import WebDavServer

                w = WebDavServer(f.url, f.grpc_address, port=args.webdavPort, host=args.ip)
                w.start()
                extras.append(w)
                parts.append(f"webdav {w.url}")
        print("server: " + ", ".join(parts), flush=True)
        _wait_forever()
    finally:
        for srv in reversed(extras):
            srv.stop()
        vs.stop()
        m.stop()
    return 0


register(Command("server", "run master + volume server in one process", _server_conf, _server_run))


def _filer_conf(p: argparse.ArgumentParser) -> None:
    p.add_argument("-port", type=int, default=8888)
    p.add_argument("-grpcPort", type=int, default=0)
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-master", default="127.0.0.1:9333")
    p.add_argument("-store", default="memory", help="memory|sqlite|log|log3 (log3 = per-bucket store separation)")
    p.add_argument("-dir", default="", help="store/meta-log directory (sqlite/log stores)")
    p.add_argument("-collection", default="")
    p.add_argument("-defaultReplicaPlacement", default="")
    p.add_argument("-maxMB", type=int, default=4, help="chunk size in MiB")
    p.add_argument("-metricsPort", type=int, default=0)


def _filer_run(args: argparse.Namespace) -> int:
    import os

    from seaweedfs_tpu_torch.filer import FilerServer, make_store

    # share the cluster's jwt keys so chunk deletes/reads work secured
    guard = _load_guard(_security())
    if args.store == "sqlite":
        store_path = os.path.join(args.dir, "filer.db") if args.dir else ""
    else:  # log-structured store takes its directory
        store_path = args.dir
    f = FilerServer(
        args.master,
        store=make_store(args.store, store_path),
        port=args.port,
        grpc_port=args.grpcPort,
        host=args.ip,
        chunk_size=args.maxMB * 1024 * 1024,
        log_dir=args.dir,
        collection=args.collection,
        replication=args.defaultReplicaPlacement,
        signing_key=guard.signing_key if guard else None,
        read_signing_key=guard.read_signing_key if guard else None,
    )
    f.start()
    _maybe_metrics(args.metricsPort)
    print(f"filer on http {f.url} grpc {f.grpc_address}", flush=True)
    try:
        _wait_forever()
    finally:
        f.stop()
    return 0


register(Command("filer", "run a filer (namespace) server", _filer_conf, _filer_run))


def _s3_conf(p: argparse.ArgumentParser) -> None:
    p.add_argument("-port", type=int, default=8333)
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-filer", default="127.0.0.1:8888", help="filer http host:port")
    p.add_argument("-filerGrpc", default="", help="filer grpc host:port")
    p.add_argument("-config", default="", help="identities JSON file (upstream's -s3.config shape)")
    p.add_argument("-metricsPort", type=int, default=0)
    p.add_argument(
        "-allowedHosts",
        default="",
        help="comma-separated advertised host:port names (DNS/LB fronts) "
        "accepted as the signed Host header besides the bind address",
    )


def _s3_run(args: argparse.Namespace) -> int:
    import json

    from seaweedfs_tpu_torch.s3api import Iam, S3ApiServer

    if not args.filerGrpc:
        raise SystemExit("-filerGrpc is required")
    _security()
    iam = Iam()
    if args.config:
        with open(args.config, encoding="utf-8") as f:
            iam = Iam.from_config(json.load(f))
    if not iam.identities:
        # no static config: pick up identities the IAM API persisted in
        # the filer KV store (and _auth re-reads on unknown access keys)
        from seaweedfs_tpu_torch.filer.client import FilerClient
        from seaweedfs_tpu_torch.s3api.auth import load_identities

        try:
            with FilerClient(args.filerGrpc) as fc:
                stored = load_identities(fc)
            if stored is not None:
                iam = stored
        except Exception:  # noqa: BLE001 — filer may not be up yet
            pass
    s3 = S3ApiServer(args.filer, args.filerGrpc, port=args.port, host=args.ip, iam=iam,
                     extra_hosts=_hosts(args.allowedHosts))
    s3.start()
    _maybe_metrics(args.metricsPort)
    print(f"s3 gateway on {s3.url} -> filer {args.filer}", flush=True)
    try:
        _wait_forever()
    finally:
        s3.stop()
    return 0


register(Command("s3", "run an S3-compatible gateway against a filer", _s3_conf, _s3_run))


def _webdav_conf(p: argparse.ArgumentParser) -> None:
    p.add_argument("-port", type=int, default=7333)
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-filer", default="127.0.0.1:8888")
    p.add_argument("-filerGrpc", default="")
    p.add_argument("-root", default="/", help="filer directory to expose")


def _webdav_run(args: argparse.Namespace) -> int:
    from seaweedfs_tpu_torch.webdav import WebDavServer

    if not args.filerGrpc:
        raise SystemExit("-filerGrpc is required")
    _security()
    w = WebDavServer(args.filer, args.filerGrpc, port=args.port, host=args.ip, root=args.root)
    w.start()
    print(f"webdav on {w.url} -> filer {args.filer}", flush=True)
    try:
        _wait_forever()
    finally:
        w.stop()
    return 0


register(Command("webdav", "run a WebDAV gateway against a filer", _webdav_conf, _webdav_run))


def _iam_conf(p: argparse.ArgumentParser) -> None:
    p.add_argument("-port", type=int, default=8111)
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-filerGrpc", default="", help="filer grpc host:port")
    p.add_argument(
        "-bootstrapToken",
        default="",
        help="pre-shared token allowing the first admin to be minted on a "
        "fresh cluster; without it the API stays closed until identities "
        "are seeded via config or the S3 gateway",
    )
    p.add_argument(
        "-allowedHosts",
        default="",
        help="comma-separated advertised host:port names accepted as the "
        "signed Host header besides the bind address",
    )


def _iam_run(args: argparse.Namespace) -> int:
    from seaweedfs_tpu_torch.iamapi import IamApiServer

    if not args.filerGrpc:
        raise SystemExit("-filerGrpc is required")
    _security()
    srv = IamApiServer(args.filerGrpc, port=args.port, host=args.ip,
                       bootstrap_token=args.bootstrapToken or None,
                       extra_hosts=_hosts(args.allowedHosts))
    srv.start()
    print(f"iam api on {srv.url}", flush=True)
    try:
        _wait_forever()
    finally:
        srv.stop()
    return 0


register(Command("iam", "run an AWS-IAM-compatible identity API", _iam_conf, _iam_run))


def _mount_conf(p: argparse.ArgumentParser) -> None:
    p.add_argument("-filerGrpc", default="", help="filer grpc host:port")
    p.add_argument("-dir", default="", help="mountpoint directory")


def _mount_run(args: argparse.Namespace) -> int:
    from seaweedfs_tpu_torch.mount.fuse_adapter import fuse_available, mount_and_serve

    if not args.filerGrpc or not args.dir:
        raise SystemExit("-filerGrpc and -dir are required")
    if not fuse_available():
        print(
            "kernel FUSE unavailable (no fusepy//dev/fuse); use the WFS API "
            "(seaweedfs_tpu_torch.mount.WFS) for in-process access",
            file=sys.stderr,
        )
        return 2
    _security()
    mount_and_serve(args.filerGrpc, args.dir)
    return 0


register(Command("mount", "mount the filer as a FUSE filesystem", _mount_conf, _mount_run))


def _mq_conf(p: argparse.ArgumentParser) -> None:
    p.add_argument("-port", type=int, default=17777)
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-filer", default="127.0.0.1:8888")
    p.add_argument("-filerGrpc", default="")


def _mq_run(args: argparse.Namespace) -> int:
    from seaweedfs_tpu_torch.mq import Broker

    if not args.filerGrpc:
        raise SystemExit("-filerGrpc is required")
    _security()
    b = Broker(args.filer, args.filerGrpc, port=args.port, host=args.ip)
    b.start()
    print(f"mq broker on {b.address} -> filer {args.filer}", flush=True)
    try:
        _wait_forever()
    finally:
        b.stop()
    return 0


register(Command("mq.broker", "run a message-queue broker on the filer", _mq_conf, _mq_run))


def _shell_conf(p: argparse.ArgumentParser) -> None:
    p.add_argument("-master", default="127.0.0.1:9333")
    p.add_argument("-c", dest="script", default="", help="run `;`-separated commands and exit")
    _add_device(p)


def _shell_run(args: argparse.Namespace) -> int:
    from seaweedfs_tpu_torch.shell import CommandEnv, repl, run_script

    _security()
    with CommandEnv(args.master, device=args.device) as env:
        if args.script:
            run_script(env, args.script, sys.stdout)
        else:
            repl(env, sys.stdin, sys.stdout)
    return 0


register(Command("shell", "operator shell (REPL or -c script)", _shell_conf, _shell_run))


def _scaffold_conf(p: argparse.ArgumentParser) -> None:
    p.add_argument("-config", default="security", help="security|master|shell|filer")


def _scaffold_run(args: argparse.Namespace) -> int:
    from seaweedfs_tpu_torch.utils.config import SCAFFOLDS, scaffold

    text = scaffold(args.config)
    if text is None:
        print(f"unknown config {args.config!r}; one of {sorted(SCAFFOLDS)}", file=sys.stderr)
        return 1
    print(text, end="")
    return 0


register(Command("scaffold", "print a commented TOML config template", _scaffold_conf, _scaffold_run))
