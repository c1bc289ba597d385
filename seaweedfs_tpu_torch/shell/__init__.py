"""Operator shell — mirror of weed/shell (`weed shell` REPL). EC
lifecycle orchestration lives HERE, not in the master: the
shell drives encode/rebuild/balance over gRPC while holding a
cluster-wide exclusive lock leased from the master
(wdclient/exclusive_locks analog).

Each command is a `ShellCommand(name, help, do)` where
`do(args: list[str], env: CommandEnv, writer)` mirrors the reference's
`Do(args, commandEnv, writer)` signature.

The fs.*, s3.* and mq.* commands stand on the filer, the S3 gateway and
the message queue, which this package does not have yet (ROADMAP Queue 1
item 5): `commands()` registers the cluster, ec.* and volume.* families,
and `CommandEnv.filer_client()` raises.
"""

from __future__ import annotations

import shlex
import threading
from dataclasses import dataclass
from typing import Callable, Iterable, Optional, TextIO

import grpc

from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.cluster.client import MasterClient
from seaweedfs_tpu_torch.pb import VOLUME_SERVICE

LOCK_NAME = "admin"
_RENEW_INTERVAL = 10.0


class ShellError(Exception):
    pass


@dataclass
class ShellCommand:
    name: str
    help: str
    do: Callable[[list[str], "CommandEnv", TextIO], None]


_REGISTRY: dict[str, ShellCommand] = {}


def register(cmd: ShellCommand) -> ShellCommand:
    _REGISTRY[cmd.name] = cmd
    return cmd


def commands() -> dict[str, ShellCommand]:
    # import for registration side effects
    from seaweedfs_tpu_torch.shell import command_cluster  # noqa: F401
    from seaweedfs_tpu_torch.shell import command_ec  # noqa: F401
    from seaweedfs_tpu_torch.shell import command_volume  # noqa: F401

    return dict(_REGISTRY)


class CommandEnv:
    """Shared command environment (commandEnv analog): master client, the
    exclusive-lock lease, and per-node gRPC helpers. `device` is where what
    the shell builds locally runs (ec.backend's encoder): None means the
    card, "cpu" the plain version."""

    def __init__(self, master_address: str, client_name: str = "shell", device=None):
        self.master_address = master_address
        self.device = device
        self.client = MasterClient(master_address)
        self.client_name = client_name
        self._lock_token = 0
        self._renew_stop: Optional[threading.Event] = None
        self._renew_thread: Optional[threading.Thread] = None

    def close(self) -> None:
        if self.is_locked:
            try:
                self.unlock()
            except Exception:  # noqa: BLE001 — master may be gone
                pass
        self.client.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- master helpers ------------------------------------------------------

    def master_call(self, method: str, req: dict, timeout: float = 30) -> dict:
        """Master RPC via MasterClient's single failover/redirect path
        (thread-safe: the lock renewer calls this concurrently)."""
        return self.client.master_call(method, req, timeout=timeout)

    def filer_client(self):
        """The filer client of the fs.* commands and volume.fsck's walk: the
        filer is not in this package yet, so this raises."""
        raise NotImplementedError(
            "the filer client (filer/client.py) is not ported yet (ROADMAP Queue 1 item 5)"
        )

    def volume_list(self) -> dict:
        return self.master_call("VolumeList", {})

    def topology_nodes(self) -> list[dict]:
        """Flatten VolumeList's dc -> rack -> node tree, annotating each
        node dict with its dc/rack."""
        out = []
        for dc, racks in self.volume_list().get("data_centers", {}).items():
            for rack, nodes in racks.items():
                for nd in nodes:
                    nd = dict(nd)
                    nd["data_center"] = dc
                    nd["rack"] = rack
                    out.append(nd)
        return out

    def vs_call(self, grpc_address: str, method: str, req: dict, timeout: float = 300) -> dict:
        with rpc.RpcClient(grpc_address) as c:
            return c.call(VOLUME_SERVICE, method, req, timeout=timeout)

    # -- exclusive lock ("acquire cluster exclusive lock") -------------------

    @property
    def is_locked(self) -> bool:
        return self._lock_token != 0

    def confirm_locked(self) -> None:
        if not self.is_locked:
            raise ShellError("lock the cluster first: run `lock`")

    def lock(self) -> None:
        resp = self.master_call(
            "LeaseAdminToken",
            {
                "lock_name": LOCK_NAME,
                "previous_token": self._lock_token,
                "client_name": self.client_name,
            },
        )
        self._lock_token = int(resp["token"])
        # a second `lock` while already locked is a renewal, not a second
        # renew thread
        if self._renew_thread is None or not self._renew_thread.is_alive():
            self._renew_stop = threading.Event()
            self._renew_thread = threading.Thread(target=self._renew_loop, daemon=True)
            self._renew_thread.start()

    def unlock(self) -> None:
        if self._renew_stop is not None:
            self._renew_stop.set()
        token, self._lock_token = self._lock_token, 0
        if token:
            self.master_call(
                "ReleaseAdminToken", {"lock_name": LOCK_NAME, "previous_token": token}
            )

    def _renew_once(self) -> bool:
        """One lease renewal. Returns False — and drops the token, so the
        next confirm_locked() aborts — when the master says someone else
        holds the lock (our lease expired and was stolen)."""
        try:
            resp = self.master_call(
                "LeaseAdminToken",
                {
                    "lock_name": LOCK_NAME,
                    "previous_token": self._lock_token,
                    "client_name": self.client_name,
                },
            )
            # a freshly promoted leader may reissue the token (lock table
            # replication lags by one heartbeat): adopt it, or the next
            # renewal's stale previous_token aborts the running command
            self._lock_token = int(resp.get("token", self._lock_token))
            return True
        except grpc.RpcError as e:
            if e.code() == grpc.StatusCode.FAILED_PRECONDITION:
                self._lock_token = 0  # lock lost — stop pretending we hold it
                return False
            return True  # transient failure: retry next tick (TTL is 30s)
        except Exception:  # noqa: BLE001 — transient; retry next tick
            return True

    def _renew_loop(self) -> None:
        stop = self._renew_stop
        while not stop.wait(_RENEW_INTERVAL):
            if not self._lock_token or not self._renew_once():
                return


# -- argument helpers (flag.FlagSet analog for `-name=value` style) ----------


def grpc_addr(node: dict) -> str:
    """gRPC address of a topology node dict (shared by all commands)."""
    host = node["url"].rsplit(":", 1)[0]
    return f"{host}:{node['grpc_port']}"


def iter_entries(fc, path: str, page: int = 1024):
    """Fully paged filer directory listing (exclusive start_from resume)
    — the one pagination loop every fs/s3 command shares."""
    start = ""
    while True:
        batch = fc.list(path, start_from=start, limit=page)
        if not batch:
            return
        yield from batch
        start = batch[-1].name


def parse_flags(args: Iterable[str], **defaults):
    """Parse `-name value` / `-name=value` flags with typed defaults.
    Returns an attribute namespace; unknown flags raise ShellError."""

    class NS:
        pass

    ns = NS()
    for k, v in defaults.items():
        setattr(ns, k, v)
    it = iter(list(args))
    for tok in it:
        if not tok.startswith("-"):
            raise ShellError(f"unexpected argument {tok!r}")
        body = tok.lstrip("-")
        if "=" in body:
            name, val = body.split("=", 1)
        else:
            name = body
            val = None
        key = name.replace(".", "_").replace("-", "_")
        if key not in defaults:
            raise ShellError(f"unknown flag -{name}")
        default = defaults[key]
        if isinstance(default, bool):
            setattr(ns, key, True if val is None else val.lower() in ("1", "true", "yes"))
            continue
        if val is None:
            try:
                val = next(it)
            except StopIteration:
                raise ShellError(f"flag -{name} needs a value") from None
        if isinstance(default, int):
            setattr(ns, key, int(val))
        elif isinstance(default, float):
            setattr(ns, key, float(val))
        else:
            setattr(ns, key, val)
    return ns


# -- driver ------------------------------------------------------------------


def run_command(env: CommandEnv, line: str, writer: TextIO) -> None:
    """Parse and run one command line; raises ShellError on failure."""
    parts = shlex.split(line.strip())
    if not parts or parts[0].startswith("#"):
        return
    name, args = parts[0], parts[1:]
    cmds = commands()
    if name in ("help", "?"):
        if args and args[0] in cmds:
            writer.write(f"{args[0]}\n\t{cmds[args[0]].help}\n")
        else:
            for c in sorted(cmds):
                writer.write(f"  {c:<28} {cmds[c].help.splitlines()[0]}\n")
        return
    cmd = cmds.get(name)
    if cmd is None:
        raise ShellError(f"unknown command {name!r} (try `help`)")
    # the shell is a trace ROOT: every RPC a command fans out carries
    # this id in its metadata, so one ec.rebuild/ec.convert run can be
    # reconstructed across every server it touched (ec.trace, glog grep)
    from seaweedfs_tpu_torch.obs import trace as _trace

    with _trace.start("shell.command", klass="shell"):
        _trace.annotate(command=name)
        cmd.do(args, env, writer)


def run_script(env: CommandEnv, script: str, writer: TextIO) -> None:
    """Run `;`-separated commands (the `weed shell -c` path)."""
    for line in script.split(";"):
        if line.strip():
            run_command(env, line, writer)


def repl(env: CommandEnv, stdin, writer: TextIO) -> None:
    writer.write(f"seaweedfs_tpu shell — connected to {env.master_address}\n")
    while True:
        writer.write("> ")
        writer.flush()
        line = stdin.readline()
        if not line or line.strip() in ("exit", "quit"):
            return
        try:
            run_command(env, line, writer)
        except (ShellError, rpc.RpcFault) as e:
            writer.write(f"error: {e}\n")
        except Exception as e:  # noqa: BLE001 — REPL survives command crashes
            writer.write(f"error: {type(e).__name__}: {e}\n")
