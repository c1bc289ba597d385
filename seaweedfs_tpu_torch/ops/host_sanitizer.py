"""Build and run the host codecs' sanitizer driver.

`csrc/xs_san_driver.cc` drives the threaded entry points of
`csrc/gf_host.cc` (the XOR-schedule executor's tile pool and the two
split-table pools) at the thread counts it is given, against a byte
oracle. It is linked with `gf_host.cc` under `-fsanitize=thread` ("tsan")
and `-fsanitize=address` ("asan"), with the reference's sanitizer flags
(`native/Makefile`), into `_build/xs_<kind>-<hash>` at first use; the
hash covers the flags, the compiler and both sources. These binaries are
not kernel libraries and stay out of `_build.SOURCES`.

The compiler is the first of `COMPILERS` on the PATH that builds and runs
a threaded probe with the sanitizer (having the flag is not enough: the
runtime library can be missing). Nothing falls back: where no compiler
passes, `build` raises and names the compilers and the flag. Nothing here
runs at import time.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
import time

from seaweedfs_tpu_torch.ops import _build

#: kind -> the -fsanitize value
SANITIZERS = {"tsan": "thread", "asan": "address"}
FLAGS = ("-O1", "-g", "-std=c++17", "-pthread")
COMPILERS = ("clang++", "g++")
DRIVER = os.path.join(_build.CSRC_DIR, "xs_san_driver.cc")
HOST = os.path.join(_build.CSRC_DIR, "gf_host.cc")
THREADS = (1, 2, 4, 8)
CLEAN = "xs sanitizer driver: all clean"

_PROBE = (
    "#include <thread>\n"
    "int x=0;\n"
    "int main(){ std::thread t([]{ x=1; }); t.join(); return x-1; }\n"
)


def sanitizer_cxx(flag: str) -> str | None:
    """The first compiler of `COMPILERS` that builds and runs a threaded
    probe under `-fsanitize=<flag>`, else None."""
    for name in COMPILERS:
        cxx = shutil.which(name)
        if cxx is None:
            continue
        with tempfile.TemporaryDirectory() as td:
            src, exe = os.path.join(td, "p.cc"), os.path.join(td, "p")
            with open(src, "w", encoding="utf-8") as f:
                f.write(_PROBE)
            try:
                built = subprocess.run([cxx, f"-fsanitize={flag}", *FLAGS, "-o", exe, src],
                                       capture_output=True, timeout=120)
                if built.returncode == 0 and subprocess.run(
                        [exe], capture_output=True, timeout=60).returncode == 0:
                    return cxx
            except (OSError, subprocess.TimeoutExpired):
                continue
    return None


def binary_path(kind: str, cxx: str) -> str:
    h = hashlib.sha256(" ".join((cxx, SANITIZERS[kind], *FLAGS)).encode())
    for src in (DRIVER, HOST):
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(_build.BUILD_DIR, f"xs_{kind}-{h.hexdigest()[:12]}")


def build(kinds=tuple(SANITIZERS)) -> dict[str, dict]:
    """Build the driver for each kind that is not built yet, one compiler
    process per kind, all started together. Returns {kind: {"path",
    "compiler", "seconds", "cached"}}. Raises RuntimeError where no
    compiler passes the probe, or with the compiler's output where a build
    fails."""
    t0 = time.perf_counter()
    compilers = {}
    for kind in kinds:
        compilers[kind] = sanitizer_cxx(SANITIZERS[kind])
        if compilers[kind] is None:
            raise RuntimeError(f"no compiler of {COMPILERS} builds and runs a program with "
                               f"-fsanitize={SANITIZERS[kind]}")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out: dict[str, dict] = {}
    procs = {}
    for kind, cxx in compilers.items():
        flag = SANITIZERS[kind]
        path = binary_path(kind, cxx)
        if os.path.exists(path):
            out[kind] = {"path": path, "compiler": cxx, "seconds": 0.0, "cached": True}
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [cxx, *FLAGS, f"-fsanitize={flag}", "-o", tmp, DRIVER, HOST]
        procs[kind] = (path, tmp, cxx, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    for kind, (path, tmp, cxx, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            failures.append(f"{kind}: {cxx} -fsanitize={SANITIZERS[kind]} exited "
                            f"{proc.returncode}\n{log}")
            continue
        os.replace(tmp, path)  # atomic: a concurrent build never runs a torn binary
        out[kind] = {"path": path, "compiler": cxx, "seconds": time.perf_counter() - t0,
                     "cached": False}
    if failures:
        raise RuntimeError("sanitizer build failed:\n" + "\n".join(failures))
    return out


def run(path: str, threads=THREADS, timeout: float = 300.0) -> dict:
    """Run one built driver at the thread counts. Returns {"rc",
    "seconds", "lines" (its stdout), "last_line", "clean" (rc 0 and the
    last line the driver's all-clean line), "stderr" (the sanitizer's
    reports, where any)}."""
    t0 = time.perf_counter()
    proc = subprocess.run([path, *map(str, threads)], capture_output=True, text=True,
                          timeout=timeout)
    lines = proc.stdout.splitlines()
    last = lines[-1] if lines else ""
    return {"rc": proc.returncode, "seconds": time.perf_counter() - t0, "lines": lines,
            "last_line": last, "clean": proc.returncode == 0 and last == CLEAN,
            "stderr": proc.stderr}
