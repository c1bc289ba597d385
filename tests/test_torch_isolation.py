"""The port stands alone: no module of `seaweedfs_tpu_torch/`, nor
`chip_smoke.py`, imports `jax` or anything of the JAX package, and
importing the whole port leaves neither in `sys.modules`. The EC and
storage path needs neither `grpc` nor `google.protobuf`: only the
transport (`rpc`, `pb.wire`, `security.tls`) and what stands on it (the
master, its raft node, the volume server, their client, the operator
shell, the fleet repair scheduler and the `server` and `shell` commands)
import them, and `chip_smoke.py` imports none of those at module level;
the tiering path (the remote vendors, the tier moves, the remote backend,
the SigV4 signer) imports without them, and the master reaches raft only
when it is given peers. The filer stands on the transport too (its
package imports its server); its entries, rules and stores import no wire
module themselves, and a filer server opens no CUDA context. So do the
filer's clients (replication, the sync commands, the message-queue broker
and the mount): they stand on the transport, their pure parts (the log
buffer, the notification queues, the mount's dirty pages) import no wire
module, and none of them opens a CUDA context."""

import ast
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "seaweedfs_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "seaweedfs_tpu")


def _sources() -> list[str]:
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, dirnames, filenames in os.walk(PORT):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__", "_build")]
        out += [os.path.join(dirpath, f) for f in sorted(filenames) if f.endswith(".py")]
    return out


def _imported_roots(path: str) -> set[str]:
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_port_has_modules_for_every_layer():
    rel = {os.path.relpath(p, PORT) for p in _sources()}
    for want in ("ops/gf8.py", "ops/rs_torch.py", "ops/rs_cuda.py", "ops/rs_codec.py",
                 "ops/_build.py", "ec/stripe.py", "ec/constants.py", "storage/idx.py",
                 "storage/needle_map.py", "storage/types.py", "command/local.py",
                 "utils/config.py", "obs/trace.py", "__main__.py", "ops/measure.py",
                 "scripts/kernel_sweep.py", "scripts/device_window.py", "ec/ec_volume.py",
                 "ec/read_planner.py", "ec/locate.py", "ec/suspicion.py", "ec/convert.py",
                 "ec/ingest.py", "ec/scrub.py", "ec/shard_bits.py", "storage/needle.py",
                 "storage/super_block.py", "storage/file_id.py", "storage/scan.py",
                 "storage/volume.py", "storage/store.py", "utils/glog.py", "utils/native.py",
                 "stats/__init__.py", "utils/httpd.py", "security/__init__.py",
                 "security/jwt.py", "security/guard.py", "security/tls.py", "pb/__init__.py",
                 "pb/wire.py", "rpc.py", "cluster/sequence.py", "cluster/topology.py",
                 "cluster/client.py", "cluster/master.py", "cluster/volume_server.py",
                 "ec/placement.py", "ec/spread.py", "command/servers.py",
                 "shell/__init__.py", "shell/command_cluster.py", "shell/command_ec.py",
                 "shell/command_volume.py", "ec/fleet.py", "ec/slo.py",
                 "command/bench_tools.py", "scripts/weedload.py", "scripts/chaos_soak.py",
                 "cluster/raft.py", "storage/backend.py", "remote_storage/__init__.py",
                 "remote_storage/tier.py", "s3api/__init__.py", "s3api/auth.py",
                 "filer/__init__.py", "filer/entry.py", "filer/filer_conf.py", "filer/store.py",
                 "filer/logstore.py", "filer/bucketstore.py", "filer/chunks.py",
                 "filer/filer.py", "filer/server.py", "filer/client.py",
                 "utils/chunk_cache.py", "shell/command_fs.py", "s3api/policy.py",
                 "s3api/server.py", "iamapi/__init__.py", "iamapi/server.py",
                 "webdav/__init__.py", "webdav/server.py", "shell/command_s3.py",
                 "utils/log_buffer.py", "notification/__init__.py",
                 "replication/__init__.py", "replication/replicator.py",
                 "replication/sinks.py", "command/sync.py", "mq/__init__.py",
                 "mq/broker.py", "shell/command_mq.py", "mount/__init__.py",
                 "mount/page_writer.py", "mount/wfs.py", "mount/fuse_adapter.py",
                 "analysis/__init__.py", "analysis/__main__.py", "analysis/graph.py",
                 "analysis/resources.py", "analysis/envreg.py", "analysis/durability.py",
                 "analysis/donation.py", "analysis/lock_order.py", "analysis/wire_drift.py",
                 "analysis/obs_drift.py", "analysis/lockrec.py", "analysis/fsrec.py",
                 "ops/cuda_lowering.py", "ops/xorsched.py", "bench.py"):
        assert want in rel, want
    for src in ("gf_bitplane.cu", "gf_dma.cu", "gf_mma.cu", "gf_common.cuh", "crc32c.cc",
                "gf_host.cc"):
        assert os.path.exists(os.path.join(PORT, "csrc", src)), src
    for art in ("contracts.proto", "contracts.desc"):
        assert os.path.exists(os.path.join(PORT, "pb", art)), art
    assert not os.path.exists(os.path.join(PORT, "stats.py"))  # the package replaced the shim


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_import_of_jax_or_the_reference(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_neither():
    mods = sorted(
        "seaweedfs_tpu_torch." + os.path.relpath(p, PORT)[:-3].replace(os.sep, ".")
        for p in _sources()[1:]
    )
    mods = [m.removesuffix(".__init__") for m in mods]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


#: the port's only importers of grpc / google.protobuf
WIRE_MODULES = ("seaweedfs_tpu_torch.rpc", "seaweedfs_tpu_torch.pb.wire",
                "seaweedfs_tpu_torch.security.tls")
#: the modules that stand on the transport: each fails to import without grpc
SERVER_MODULES = ("seaweedfs_tpu_torch.cluster.client", "seaweedfs_tpu_torch.cluster.master",
                  "seaweedfs_tpu_torch.cluster.raft",
                  "seaweedfs_tpu_torch.cluster.volume_server", "seaweedfs_tpu_torch.ec.fleet",
                  "seaweedfs_tpu_torch.shell", "seaweedfs_tpu_torch.shell.command_cluster",
                  "seaweedfs_tpu_torch.shell.command_ec",
                  "seaweedfs_tpu_torch.shell.command_volume",
                  "seaweedfs_tpu_torch.shell.command_fs", "seaweedfs_tpu_torch.filer",
                  "seaweedfs_tpu_torch.filer.chunks", "seaweedfs_tpu_torch.filer.filer",
                  "seaweedfs_tpu_torch.filer.server", "seaweedfs_tpu_torch.filer.client",
                  "seaweedfs_tpu_torch.s3api.server", "seaweedfs_tpu_torch.iamapi",
                  "seaweedfs_tpu_torch.iamapi.server", "seaweedfs_tpu_torch.webdav",
                  "seaweedfs_tpu_torch.webdav.server", "seaweedfs_tpu_torch.shell.command_s3",
                  "seaweedfs_tpu_torch.replication", "seaweedfs_tpu_torch.replication.replicator",
                  "seaweedfs_tpu_torch.replication.sinks", "seaweedfs_tpu_torch.mq",
                  "seaweedfs_tpu_torch.mq.broker", "seaweedfs_tpu_torch.shell.command_mq",
                  "seaweedfs_tpu_torch.mount", "seaweedfs_tpu_torch.mount.wfs",
                  "seaweedfs_tpu_torch.mount.fuse_adapter")
#: the filer's entries, rules and stores: no wire module of their own (their
#: package's `__init__` imports the server, so they import only with grpc)
FILER_PLAIN_MODULES = ("seaweedfs_tpu_torch.filer.entry", "seaweedfs_tpu_torch.filer.filer_conf",
                       "seaweedfs_tpu_torch.filer.store", "seaweedfs_tpu_torch.filer.logstore",
                       "seaweedfs_tpu_torch.filer.bucketstore")
#: the mount's dirty pages: no wire module of its own (its package's
#: `__init__` imports the WFS, so it imports only with grpc)
MOUNT_PLAIN_MODULES = ("seaweedfs_tpu_torch.mount.page_writer",)
#: the server commands: they share the CLI registry with the local
#: commands, so they reach the transport only when one of them runs
SERVER_COMMANDS = "seaweedfs_tpu_torch.command.servers"
#: the filer clients' commands (filer.sync, filer.backup, filer.meta.tail,
#: filer.copy): the same, as the server commands
SYNC_COMMANDS = "seaweedfs_tpu_torch.command.sync"
#: chip_smoke.py's cluster, ha, filer, s3, sync, shell, fleet, load and rack phases:
#: the only functions there that reach them
CLUSTER_PHASE = ("run_cluster", "_cluster", "run_storm", "_storm", "run_load", "run_rack",
                 "run_ha", "_ha", "run_filer", "_filer", "run_s3", "run_sync")
#: the load harnesses: they reach the transport only inside their functions
HARNESSES = ("seaweedfs_tpu_torch.scripts.weedload", "seaweedfs_tpu_torch.scripts.chaos_soak")
#: the servers' pure planners and data structures, and the tiering path
#: (the vendors, the tier moves, the remote backend, the SigV4 signer and
#: verifier, the bucket policies):
#: they import without it
PLAIN_SERVER_MODULES = ("seaweedfs_tpu_torch.ec.spread", "seaweedfs_tpu_torch.ec.placement",
                        "seaweedfs_tpu_torch.cluster.sequence",
                        "seaweedfs_tpu_torch.cluster.topology", "seaweedfs_tpu_torch.ec.slo",
                        "seaweedfs_tpu_torch.remote_storage",
                        "seaweedfs_tpu_torch.remote_storage.tier",
                        "seaweedfs_tpu_torch.storage.backend",
                        "seaweedfs_tpu_torch.s3api.auth", "seaweedfs_tpu_torch.s3api.policy",
                        "seaweedfs_tpu_torch.utils.chunk_cache",
                        "seaweedfs_tpu_torch.utils.log_buffer",
                        "seaweedfs_tpu_torch.notification")


def _port_imports(path: str, top_level: bool = False, skip: tuple = ()) -> set[str]:
    """Every `seaweedfs_tpu_torch...` module a file imports, at any depth
    of its code but inside the module-level functions whose names start
    with one of `skip`, or only in its module-level statements when
    `top_level` (`from pkg import mod` counts as pkg.mod)."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    body = [n for n in tree.body
            if not (skip and isinstance(n, ast.FunctionDef) and n.name.startswith(skip))]
    nodes = body if top_level else [n for top in body for n in ast.walk(top)]
    out = set()
    for node in nodes:
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names if a.name.startswith("seaweedfs_tpu_torch")}
        elif (isinstance(node, ast.ImportFrom) and node.level == 0 and node.module
              and node.module.startswith("seaweedfs_tpu_torch")):
            for a in node.names:
                sub = f"{node.module}.{a.name}"
                is_mod = os.path.exists(os.path.join(ROOT, *sub.split(".")) + ".py") or \
                    os.path.isdir(os.path.join(ROOT, *sub.split(".")))
                out.add(sub if is_mod else node.module)
    return out


def test_chip_smoke_imports_no_wire_module():
    """chip_smoke.py reaches the transport, the servers and the shell (and
    so grpc) only inside its `cluster`, `shell` and `fleet` phases'
    functions (`run_cluster`, `_cluster_*`, `run_storm`, `_storm_*`); its
    module-level imports and every other phase stay free of them."""
    path = os.path.join(ROOT, "chip_smoke.py")
    got = _port_imports(path, skip=CLUSTER_PHASE)
    assert "seaweedfs_tpu_torch.obs.trace" in got and "seaweedfs_tpu_torch.stats" in got
    wire = set(WIRE_MODULES + SERVER_MODULES)
    assert not got & wire, sorted(got & wire)
    assert _port_imports(path) & wire  # the cluster phase does reach them
    assert not _imported_roots(path) & {"grpc", "google"}


def test_card_path_imports_without_grpc_or_protobuf():
    """With `grpc` and `google.protobuf` unimportable, every port module
    `chip_smoke.py` imports at module level, the trace ring, the stats
    registry, the HTTP plumbing, JWT/guard, the command registry with
    every command in it and the servers' planners (`ec.spread`,
    `ec.placement`, the sequencers, the topology) still import, and so
    does `chip_smoke.py`; the CLI still parses its local commands; the
    wire modules and everything that stands on them (the client, master
    and volume server, the shell and the fleet scheduler) fail loudly, and
    so does running `master`, `volume`, `server` or `shell`."""
    mods = sorted(_port_imports(os.path.join(ROOT, "chip_smoke.py"), skip=CLUSTER_PHASE) | {
        "seaweedfs_tpu_torch.obs.trace", "seaweedfs_tpu_torch.stats",
        "seaweedfs_tpu_torch.utils.httpd", "seaweedfs_tpu_torch.security",
        "seaweedfs_tpu_torch.security.jwt", "seaweedfs_tpu_torch.security.guard",
        "seaweedfs_tpu_torch.pb", "seaweedfs_tpu_torch.command",
        "seaweedfs_tpu_torch.command.local", "seaweedfs_tpu_torch.__main__",
        SERVER_COMMANDS, SYNC_COMMANDS, *PLAIN_SERVER_MODULES, *HARNESSES})
    failing = [WIRE_MODULES[0], WIRE_MODULES[2], *SERVER_MODULES]
    code = (
        "import importlib, sys\n"
        "for blocked in ('grpc', 'google.protobuf'):\n"
        "    sys.modules[blocked] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "from seaweedfs_tpu_torch.pb import wire\n"
        "try:\n"
        "    wire.WireCodec()\n"
        "    sys.exit('the codec built without protobuf')\n"
        "except ImportError:\n"
        "    pass\n"
        f"for m in {failing!r}:\n"
        "    try:\n"
        "        importlib.import_module(m)\n"
        "        sys.exit(m + ' imported without grpc')\n"
        "    except ImportError:\n"
        "        pass\n"
        "from seaweedfs_tpu_torch.__main__ import main\n"
        "from seaweedfs_tpu_torch.command import commands\n"
        "assert set(commands()) >= {'export', 'encode', 'rebuild', 'master', 'server',\n"
        "    'shell', 'benchmark', 'upload', 'download', 'filer', 's3', 'webdav', 'iam',\n"
        "    'filer.sync', 'filer.backup', 'filer.meta.tail', 'filer.copy', 'mount',\n"
        "    'mq.broker'}\n"
        "try:\n"
        "    main(['export', '--help'])\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "for argv in (['master', '-port', '0'], ['volume', '-dir', '.'],\n"
        "             ['server', '--device', 'cpu', '-dir', '.'],\n"
        "             ['shell', '-master', '127.0.0.1:1', '--device', 'cpu', '-c', 'lock'],\n"
        "             ['filer', '-port', '0', '-master', '127.0.0.1:1'],\n"
        "             ['s3', '-port', '0', '-filerGrpc', '127.0.0.1:1'],\n"
        "             ['webdav', '-port', '0', '-filerGrpc', '127.0.0.1:1'],\n"
        "             ['iam', '-port', '0', '-filerGrpc', '127.0.0.1:1'],\n"
        "             ['mq.broker', '-port', '0', '-filerGrpc', '127.0.0.1:1'],\n"
        "             ['filer.sync', '-from', '127.0.0.1:1', '-to', '127.0.0.1:1'],\n"
        "             ['filer.backup', '-filerGrpc', '127.0.0.1:1', '-dir', '.'],\n"
        "             ['filer.meta.tail', '-filerGrpc', '127.0.0.1:1'],\n"
        "             ['mount', '-filerGrpc', '127.0.0.1:1', '-dir', '.'],\n"
        "             ['benchmark', '-master', '127.0.0.1:1', '-n', '1'],\n"
        "             ['download', '-master', '127.0.0.1:1', '1,1']):\n"
        "    try:\n"
        "        main(argv)\n"
        "        sys.exit(argv[0] + ' ran without grpc')\n"
        "    except ImportError:\n"
        "        pass\n"
        "bad = [m for m in sys.modules if (m.split('.')[0] == 'grpc'\n"
        "       or m.startswith('google.protobuf')) and sys.modules[m] is not None]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_servers_import_grpc_and_the_planners_do_not():
    """The AST view of the same split: each server module reaches grpc
    (directly, through `rpc`/`security.tls`, or through another server
    module: the shell's commands through the shell), the server commands
    reach them only inside their run functions, and neither planner nor
    the sequencers, the topology and the SLO recorder imports a wire
    module at all."""
    def path(mod):
        base = os.path.join(ROOT, *mod.split("."))
        return os.path.join(base, "__init__.py") if os.path.isdir(base) else base + ".py"

    for mod in SERVER_MODULES:
        direct = "grpc" in _imported_roots(path(mod))
        through = _port_imports(path(mod), top_level=True) & set(WIRE_MODULES + SERVER_MODULES)
        assert direct or through - {mod}, mod
    wire = set(WIRE_MODULES + SERVER_MODULES)
    for commands in (SERVER_COMMANDS, SYNC_COMMANDS):
        assert not _imported_roots(path(commands)) & {"grpc", "google"}, commands
        assert not _port_imports(path(commands), top_level=True) & wire, commands
        assert _port_imports(path(commands)) & wire, commands
    for mod in PLAIN_SERVER_MODULES + FILER_PLAIN_MODULES + MOUNT_PLAIN_MODULES:
        assert not _imported_roots(path(mod)) & {"grpc", "google"}, mod
        assert not _port_imports(path(mod)) & set(WIRE_MODULES + SERVER_MODULES), mod
    # the master reaches raft only when it is given peers (inside __init__)
    master = path("seaweedfs_tpu_torch.cluster.master")
    raft = "seaweedfs_tpu_torch.cluster.raft"
    assert raft not in _port_imports(master, top_level=True)
    assert raft in _port_imports(master)
    # a Volume reaches the tier module only when it opens a tiered .dat
    vol = path("seaweedfs_tpu_torch.storage.volume")
    assert "seaweedfs_tpu_torch.remote_storage.tier" not in _port_imports(vol, top_level=True)
    assert "seaweedfs_tpu_torch.remote_storage.tier" in _port_imports(vol)


def test_a_generator_worker_opens_no_cuda_context(tmp_path):
    """A generator worker is a client: importing the harness and running
    `run_worker` to its end (an empty spec) leaves torch unimported, or at
    least CUDA uninitialised, so `--procs N` opens no context of its own."""
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({
        "master": "127.0.0.1:1", "client_timeout": 1.0, "rps": 1.0, "zipf": 1.1,
        "concurrency": 1, "seed": 1, "phases": [], "start_at": 0.0, "fids": {}}))
    code = (
        "import sys\n"
        "from seaweedfs_tpu_torch.scripts import weedload\n"
        f"rc = weedload.main(['--gen-worker', {str(spec)!r}, '--worker-out', "
        f"{str(tmp_path / 'out.json')!r}])\n"
        "torch = sys.modules.get('torch')\n"
        "print(rc, torch is not None)\n"
        "sys.exit(rc or (torch is not None and torch.cuda.is_initialized()))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.split() == ["0", "False"]
    assert json.loads((tmp_path / "out.json").read_text())["issued"] == 0


def test_a_filer_server_opens_no_cuda_context(tmp_path):
    """The filer runs no kernel: a process that starts a `FilerServer` on
    the log store, serves a listing and a failed upload over HTTP (no
    master answers) and stops, never imports torch."""
    code = (
        "import sys, urllib.request, urllib.error\n"
        "from seaweedfs_tpu_torch.filer import FilerServer, make_store\n"
        f"fs = FilerServer('127.0.0.1:1', store=make_store('log', {str(tmp_path)!r}))\n"
        "fs.start()\n"
        "with urllib.request.urlopen(f'http://{fs.url}/', timeout=10) as r:\n"
        "    assert r.status == 200\n"
        "req = urllib.request.Request(f'http://{fs.url}/a.bin', data=b'x', method='PUT')\n"
        "try:\n"
        "    urllib.request.urlopen(req, timeout=30)\n"
        "    sys.exit('the upload went through with no master')\n"
        "except urllib.error.HTTPError as e:\n"
        "    assert e.code == 500, e.code\n"
        "fs.stop()\n"
        "print('torch' in sys.modules)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.split() == ["False"]


def test_the_gateways_open_no_cuda_context(tmp_path):
    """The S3, WebDAV and IAM gateways run no kernel: a process that starts
    a `FilerServer` on the log store and the three gateways on it, creates
    a bucket by signed S3 request, lists it, answers a WebDAV PROPFIND and
    an unsigned IAM call (403), and stops, never imports torch."""
    code = (
        "import sys, urllib.request, urllib.error\n"
        "from seaweedfs_tpu_torch.filer import FilerServer, make_store\n"
        "from seaweedfs_tpu_torch.iamapi import IamApiServer\n"
        "from seaweedfs_tpu_torch.s3api import Iam, Identity, S3ApiServer, sign_request\n"
        "from seaweedfs_tpu_torch.webdav import WebDavServer\n"
        f"fs = FilerServer('127.0.0.1:1', store=make_store('log', {str(tmp_path)!r}))\n"
        "fs.start()\n"
        "s3 = S3ApiServer(fs.url, fs.grpc_address, iam=Iam([Identity('a', 'ak', 'sk')]))\n"
        "s3.start()\n"
        "dav = WebDavServer(fs.url, fs.grpc_address)\n"
        "dav.start()\n"
        "iam = IamApiServer(fs.grpc_address)\n"
        "iam.start()\n"
        "def call(url, method='GET', headers=None, data=None):\n"
        "    req = urllib.request.Request(url, data=data, method=method, headers=headers or {})\n"
        "    try:\n"
        "        with urllib.request.urlopen(req, timeout=30) as r:\n"
        "            return r.status\n"
        "    except urllib.error.HTTPError as e:\n"
        "        return e.code\n"
        "for method in ('PUT', 'GET'):\n"
        "    url = f'http://{s3.url}/bkt'\n"
        "    assert call(url, method, sign_request('ak', 'sk', method, url)) == 200\n"
        "assert call(f'http://{dav.url}/buckets/', 'PROPFIND', {'Depth': '1'}) == 207\n"
        "assert call(f'http://{iam.url}/', 'POST', data=b'Action=ListUsers') == 403\n"
        "for srv in (iam, dav, s3, fs):\n"
        "    srv.stop()\n"
        "print('torch' in sys.modules)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.split() == ["False"]


def test_the_broker_the_sync_and_the_mount_open_no_cuda_context(tmp_path):
    """The filer's clients run no kernel: a process that starts a
    `FilerServer` on the log store (no master answers), a `Broker` on it
    (a topic configured, a record published and read back), a `Replicator`
    pass into a `LocalSink` and a `WFS` that makes and lists a directory,
    and stops them, never imports torch."""
    code = (
        "import sys\n"
        "from seaweedfs_tpu_torch.filer import FilerServer, make_store\n"
        "from seaweedfs_tpu_torch.mount import WFS\n"
        "from seaweedfs_tpu_torch.mq import Broker, BrokerClient\n"
        "from seaweedfs_tpu_torch.replication import LocalSink, Replicator\n"
        f"fs = FilerServer('127.0.0.1:1', store=make_store('log', {str(tmp_path / 'store')!r}))\n"
        "fs.start()\n"
        "b = Broker(fs.url, fs.grpc_address)\n"
        "b.start()\n"
        "with BrokerClient(b.address) as c:\n"
        "    c.configure_topic('t', partition_count=1)\n"
        "    c.publish('t', b'k', b'v')\n"
        "    assert [r.value for r in c.subscribe('t', max_idle_s=0.3)] == [b'v']\n"
        "b.stop()\n"
        f"rep = Replicator(fs.grpc_address, LocalSink({str(tmp_path / 'sink')!r}))\n"
        "assert rep.run_once(max_idle_s=0.3) >= 1\n"
        "rep.close()\n"
        "with WFS(fs.grpc_address) as w:\n"
        "    w.mkdir('/m')\n"
        "    assert '/m' in [a.path for a in w.readdir('/')]\n"
        "fs.stop()\n"
        "print('torch' in sys.modules)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.split() == ["False"]
