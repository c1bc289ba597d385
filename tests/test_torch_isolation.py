"""The port stands alone: no module of `seaweedfs_tpu_torch/`, nor
`chip_smoke.py`, imports `jax` or anything of the JAX package, and
importing the whole port leaves neither in `sys.modules`. The EC and
storage path needs neither `grpc` nor `google.protobuf`: only the
transport (`rpc`, `pb.wire`, `security.tls`) and what stands on it (the
master, the volume server, their client, the operator shell, the fleet
repair scheduler and the `server` and `shell` commands) import them, and
`chip_smoke.py` imports none of those at module level."""

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
                 "command/bench_tools.py", "scripts/weedload.py", "scripts/chaos_soak.py"):
        assert want in rel, want
    for src in ("gf_bitplane.cu", "gf_dma.cu", "gf_mma.cu", "gf_common.cuh", "crc32c.cc"):
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
                  "seaweedfs_tpu_torch.cluster.volume_server", "seaweedfs_tpu_torch.ec.fleet",
                  "seaweedfs_tpu_torch.shell", "seaweedfs_tpu_torch.shell.command_cluster",
                  "seaweedfs_tpu_torch.shell.command_ec",
                  "seaweedfs_tpu_torch.shell.command_volume")
#: the server commands: they share the CLI registry with the local
#: commands, so they reach the transport only when one of them runs
SERVER_COMMANDS = "seaweedfs_tpu_torch.command.servers"
#: chip_smoke.py's cluster, shell, fleet, load and rack phases: the only
#: functions there that reach them
CLUSTER_PHASE = ("run_cluster", "_cluster", "run_storm", "_storm", "run_load", "run_rack")
#: the load harnesses: they reach the transport only inside their functions
HARNESSES = ("seaweedfs_tpu_torch.scripts.weedload", "seaweedfs_tpu_torch.scripts.chaos_soak")
#: the servers' pure planners and data structures: they import without it
PLAIN_SERVER_MODULES = ("seaweedfs_tpu_torch.ec.spread", "seaweedfs_tpu_torch.ec.placement",
                        "seaweedfs_tpu_torch.cluster.sequence",
                        "seaweedfs_tpu_torch.cluster.topology", "seaweedfs_tpu_torch.ec.slo")


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
        SERVER_COMMANDS, *PLAIN_SERVER_MODULES, *HARNESSES})
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
        "assert {'export', 'encode', 'rebuild', 'master', 'server', 'shell', 'benchmark',\n"
        "        'upload', 'download'} <= set(commands())\n"
        "try:\n"
        "    main(['export', '--help'])\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "for argv in (['master', '-port', '0'], ['volume', '-dir', '.'],\n"
        "             ['server', '--device', 'cpu', '-dir', '.'],\n"
        "             ['shell', '-master', '127.0.0.1:1', '--device', 'cpu', '-c', 'lock'],\n"
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
    assert not _imported_roots(path(SERVER_COMMANDS)) & {"grpc", "google"}
    assert not _port_imports(path(SERVER_COMMANDS), top_level=True) & wire
    assert _port_imports(path(SERVER_COMMANDS)) & wire
    for mod in PLAIN_SERVER_MODULES:
        assert not _imported_roots(path(mod)) & {"grpc", "google"}, mod
        assert not _port_imports(path(mod)) & set(WIRE_MODULES + SERVER_MODULES), mod


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
