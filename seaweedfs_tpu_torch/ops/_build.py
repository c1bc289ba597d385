"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc`
into `_build/lib<name>-<hash>.so` at first use, then loaded with ctypes.
The hash covers the source, the shared headers (`csrc/*.cuh`) and the
flags, so an edited source is rebuilt rather than a stale library loaded. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

#: kernel sources by library name
SOURCES = {
    "gf_bitplane": "gf_bitplane.cu", "gf_bf16": "gf_bf16.cu", "gf_dma": "gf_dma.cu",
    "gf_mma": "gf_mma.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")
    return path


def lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for f in [SOURCES[name], *headers]:
        with open(os.path.join(CSRC_DIR, f), "rb") as src:
            h.update(src.read())
    digest = h.hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:12]}.so")


def build(names=None) -> dict[str, dict]:
    """Compile every named library that is not built yet, one nvcc process
    per source, all started together. Returns {name: {"path", "seconds",
    "ptxas"}} (seconds 0.0 and no ptxas report for an existing library).
    Raises RuntimeError with the compiler's output when a build fails."""
    names = list(SOURCES if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    out: dict[str, dict] = {}
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        path = lib_path(name)
        if os.path.exists(path):
            out[name] = {"path": path, "seconds": 0.0, "ptxas": ""}
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, SOURCES[name])]
        procs[name] = (path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failures = []
    for name, (path, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, path)  # atomic: a concurrent build never loads a torn .so
        out[name] = {"path": path, "seconds": time.perf_counter() - t0, "ptxas": log}
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return out


def ptxas_report(log: str) -> dict[str, dict]:
    """Per kernel of an `nvcc -Xptxas=-v` log: {mangled name: {"registers",
    "spill_stores", "spill_loads", "smem"}} (smem: static shared bytes;
    the kernels here take theirs dynamically, so 0)."""
    out: dict[str, dict] = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {"registers": 0, "spill_stores": 0,
                                              "spill_loads": 0, "smem": 0})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            cur["smem"] = int(m.group(1))
    return out


def load(name: str) -> ctypes.CDLL:
    """The named kernel library, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(build([name])[name]["path"])
        return lib
