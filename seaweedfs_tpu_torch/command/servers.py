"""Process-level commands — version, master, volume, server and shell,
mirroring weed/command/{master,volume,server,shell}.go. `server` runs a
master and a volume server in one process, as `weed server` does; `shell`
is the operator shell (REPL, or `-c` for a `;`-separated script). The
volume server's EC work, and what the shell builds locally, runs on the
card (`--device`, default cuda); `--device cpu` gives the plain version.
The filer, S3 and WebDAV front ends of `server` are not in this package
yet and raise. The transport (and so grpc) is imported only when a server
or shell command runs, so the local commands that share the registry
need none of it."""

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
    p.add_argument("-peers", default="", help="comma-separated master quorum (raft HA: not ported)")
    p.add_argument("-garbageThreshold", type=float, default=0.3,
                   help="auto-vacuum volumes whose dead fraction exceeds this")
    p.add_argument("-vacuumInterval", type=float, default=900.0,
                   help="seconds between automatic vacuum sweeps")
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
    p.add_argument("-filer", action="store_true", help="also run a filer (not ported)")
    p.add_argument("-s3", action="store_true", help="also run the S3 gateway (not ported)")
    p.add_argument("-webdav", action="store_true", help="also run WebDAV (not ported)")
    _add_device(p)


def _server_run(args: argparse.Namespace) -> int:
    from seaweedfs_tpu_torch.cluster.master import MasterServer
    from seaweedfs_tpu_torch.cluster.volume_server import VolumeServer

    fronts = [f for f in ("filer", "s3", "webdav") if getattr(args, f)]
    if fronts:
        raise NotImplementedError(
            f"-{', -'.join(fronts)}: the filer, S3 and WebDAV servers are not ported "
            "yet (ROADMAP Queue 1 item 5)"
        )
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
    print(f"server: master {m.address} (http :{m.http_port}), "
          f"volume http {vs.url} grpc {vs.grpc_address}", flush=True)
    try:
        _wait_forever()
    finally:
        vs.stop()
        m.stop()
    return 0


register(Command("server", "run master + volume server in one process", _server_conf, _server_run))


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
