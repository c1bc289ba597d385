"""The port's host libraries, built at first use with the host C++
compiler into `_build/lib<name>-<hash>.so` and loaded by ctypes:

  * `csrc/crc32c.cc`, the needle checksum, or, where no compiler or
    library is at hand, a pure-Python table (`crc32c_impl()` says which);
  * `csrc/gf_host.cc`, the GF(2^8) host codecs: the split-table
    multiply-accumulate (AVX2 where the host has it) behind
    `gf_matrix_apply_native` and the "native" backend, and the compiled
    XOR-schedule executor behind `ops.xorsched`. Where it cannot be built
    these return None; nothing serves in their place here.

The hash covers the source and the flags, and a build is installed by an
atomic rename, so concurrent first uses never load a torn library.
Nothing here runs at import time."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, Optional

from seaweedfs_tpu_torch.ops import _build

SOURCE = os.path.join(_build.CSRC_DIR, "crc32c.cc")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
GF_SOURCE = os.path.join(_build.CSRC_DIR, "gf_host.cc")
# no -mavx2: the SIMD bodies carry target attributes and dispatch at run time
GF_CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_ptrs = ctypes.POINTER(ctypes.c_void_p)  # an array of slice pointers


def _bind_crc32c(lib: ctypes.CDLL) -> None:
    lib.weedtpu_torch_crc32c.restype = ctypes.c_uint32
    lib.weedtpu_torch_crc32c.argtypes = [ctypes.c_uint32, ctypes.c_char_p, ctypes.c_uint64]


def _bind_gf(lib: ctypes.CDLL) -> None:
    u32, u64 = ctypes.c_uint32, ctypes.c_uint64
    signatures = {
        "weedtpu_torch_gf_matrix_apply": (None, [_u8p, u32, u32, _ptrs, _ptrs, u64]),
        "weedtpu_torch_gf_matrix_apply_mt": (None, [_u8p, u32, u32, _ptrs, _ptrs, u64, u32]),
        "weedtpu_torch_gf_matrix_apply_batch": (
            None, [_u8p, u32, u32, _ptrs, _ptrs, u64, u32, u32]),
        "weedtpu_torch_has_avx2": (ctypes.c_int, []),
        "weedtpu_torch_xorsched_level": (ctypes.c_int, []),
        "weedtpu_torch_xor_schedule_apply": (
            ctypes.c_int, [_i32p, u64, u32, u32, u32, u32, _ptrs, _ptrs, u64, u64]),
        "weedtpu_torch_xor_schedule_apply_blocks": (
            ctypes.c_int, [_i32p, _u64p, _u64p, _u32p, _u32p, _u32p, _u32p, _ptrs, _u64p,
                           _ptrs, _u64p, _u64p, u32, u64, u32]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


class _HostLib:
    """One `csrc/<name>.cc` library: its content-hashed path, its build and
    its loaded handle (None once a build or load has failed)."""

    def __init__(self, name: str, source: str, flags: tuple,
                 bind: Callable[[ctypes.CDLL], None]):
        self.name, self.source, self.flags, self.bind = name, source, flags, bind
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self._failed = False

    def path(self) -> str:
        h = hashlib.sha256(" ".join(self.flags).encode())
        with open(self.source, "rb") as f:
            h.update(f.read())
        return os.path.join(_build.BUILD_DIR, f"lib{self.name}-{h.hexdigest()[:12]}.so")

    def build(self, path: str) -> bool:
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            return False
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            subprocess.run([cxx, *self.flags, "-o", tmp, self.source], check=True,
                           capture_output=True, timeout=120)
            os.replace(tmp, path)  # atomic: a concurrent build never loads a torn .so
            return True
        except (OSError, subprocess.SubprocessError):
            if os.path.exists(tmp):
                os.remove(tmp)
            return False

    def load(self) -> Optional[ctypes.CDLL]:
        """The loaded library, built on first use; None where it cannot be."""
        with self._lock:
            if self._lib is not None or self._failed:
                return self._lib
            path = self.path()
            if not os.path.exists(path) and not self.build(path):
                self._failed = True
                return None
            try:
                lib = ctypes.CDLL(path)
                self.bind(lib)
                self._lib = lib
            except (OSError, AttributeError):
                self._failed = True
            return self._lib


_CRC = _HostLib("crc32c", SOURCE, CXX_FLAGS, _bind_crc32c)
_GF = _HostLib("gf_host", GF_SOURCE, GF_CXX_FLAGS, _bind_gf)


def lib_path() -> str:
    return _CRC.path()


def gf_lib_path() -> str:
    return _GF.path()


def load() -> Optional[ctypes.CDLL]:
    """The CRC32C library, built on first use; None where it cannot be."""
    return _CRC.load()


def load_gf() -> Optional[ctypes.CDLL]:
    """The GF host-codec library, built on first use; None where it cannot
    be (no C++ compiler, or a failed build)."""
    return _GF.load()


# -- CRC32C ----------------------------------------------------------------------


def crc32c_impl() -> str:
    """"library" when the compiled CRC32C runs, "python" for the table."""
    return "library" if load() is not None else "python"


_CRC_TABLE: Optional[list[int]] = None


def _py_table() -> list[int]:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        tbl = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
            tbl.append(crc)
        _CRC_TABLE = tbl
    return _CRC_TABLE


def crc32c_table(data: bytes, crc: int = 0) -> int:
    """CRC32C by the pure-Python table."""
    tbl = _py_table()
    c = crc ^ 0xFFFFFFFF
    for b in data:
        c = (c >> 8) ^ tbl[(c ^ b) & 0xFF]
    return c ^ 0xFFFFFFFF


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32C (Castagnoli) of `data`, continuing from `crc`."""
    lib = load()
    if lib is not None:
        return lib.weedtpu_torch_crc32c(crc, bytes(data), len(data))
    return crc32c_table(data, crc)


# -- GF(2^8) matrix apply (the "native" backend) -----------------------------------


def _pointers(addrs: list[int]) -> ctypes.Array:
    return (ctypes.c_void_p * len(addrs))(*addrs)


def gf_matrix_apply_native(matrix, inputs, length: int, threads: int = 1):
    """Native (AVX2 when available) GF matrix apply over byte slices.

    matrix: (R, C) uint8 numpy array; inputs: list of C bytes-like of `length`.
    threads: 1 = single core; 0 = all cores; N = exactly N workers (the
    multithreaded split mirrors the reference codec's WithAutoGoroutines).
    Returns list of R arrays, or None if the library is unavailable.
    """
    import numpy as np

    lib = load_gf()
    if lib is None:
        return None
    matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
    rows, cols = matrix.shape
    in_bufs = [np.ascontiguousarray(np.frombuffer(i, dtype=np.uint8)) for i in inputs]
    if len(in_bufs) != cols or any(b.shape[0] < length for b in in_bufs):
        raise ValueError(f"matrix wants {cols} inputs of {length} bytes")
    out_bufs = [np.zeros(length, dtype=np.uint8) for _ in range(rows)]
    ins = _pointers([i.ctypes.data for i in in_bufs])
    outs = _pointers([o.ctypes.data for o in out_bufs])
    mat_ptr = matrix.ctypes.data_as(_u8p)
    if threads == 1:
        lib.weedtpu_torch_gf_matrix_apply(mat_ptr, rows, cols, ins, outs, length)
    else:
        lib.weedtpu_torch_gf_matrix_apply_mt(mat_ptr, rows, cols, ins, outs, length, threads)
    return out_bufs


def gf_matrix_apply_batch_native(matrix, shards, threads: int = 0):
    """Batched native apply: shards (B, C, N) uint8 -> (B, R, N), one
    library call (one worker pool over batch elements, zero repacking —
    the per-element slice pointers index straight into `shards`).
    Returns None when the library is unavailable."""
    import numpy as np

    lib = load_gf()
    if lib is None:
        return None
    matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
    rows, cols = matrix.shape
    shards = np.ascontiguousarray(shards, dtype=np.uint8)
    batch, c, n = shards.shape
    if c != cols:
        raise ValueError(f"matrix wants {cols} inputs, stack has {c}")
    out = np.zeros((batch, rows, n), dtype=np.uint8)
    base_in, base_out = shards.ctypes.data, out.ctypes.data
    ins = _pointers([base_in + (b * cols + ci) * n for b in range(batch) for ci in range(cols)])
    outs = _pointers([base_out + (b * rows + r) * n for b in range(batch) for r in range(rows)])
    lib.weedtpu_torch_gf_matrix_apply_batch(
        matrix.ctypes.data_as(_u8p), rows, cols, ins, outs, n, batch, threads)
    return out


def has_avx2() -> bool:
    lib = load_gf()
    return bool(lib and lib.weedtpu_torch_has_avx2())


def has_mt() -> bool:
    """True when the loaded library exports the multithreaded apply."""
    lib = load_gf()
    return bool(lib and hasattr(lib, "weedtpu_torch_gf_matrix_apply_mt"))
