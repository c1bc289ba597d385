"""The port stands alone: no module of `seaweedfs_tpu_torch/`, nor
`chip_smoke.py`, imports `jax` or anything of the JAX package, and
importing the whole port leaves neither in `sys.modules`."""

import ast
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
                 "stats.py"):
        assert want in rel, want
    for src in ("gf_bitplane.cu", "gf_dma.cu", "gf_mma.cu", "gf_common.cuh", "crc32c.cc"):
        assert os.path.exists(os.path.join(PORT, "csrc", src)), src


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
