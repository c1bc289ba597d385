"""CRC32C, the needle checksum: `csrc/crc32c.cc` built at first use with
the host C++ compiler into `_build/libcrc32c-<hash>.so` and loaded by
ctypes, or, where no compiler or library is at hand, a pure-Python table.
`crc32c_impl()` says which one runs. Nothing here runs at import time."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

from seaweedfs_tpu_torch.ops import _build

SOURCE = os.path.join(_build.CSRC_DIR, "crc32c.cc")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def lib_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(_build.BUILD_DIR, f"libcrc32c-{h.hexdigest()[:12]}.so")


def _build_lib(path: str) -> bool:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return False
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, path)  # atomic: a concurrent build never loads a torn .so
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def load() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None where it cannot be."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        path = lib_path()
        if not os.path.exists(path) and not _build_lib(path):
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(path)
            lib.weedtpu_torch_crc32c.restype = ctypes.c_uint32
            lib.weedtpu_torch_crc32c.argtypes = [ctypes.c_uint32, ctypes.c_char_p,
                                                 ctypes.c_uint64]
            _lib = lib
        except (OSError, AttributeError):
            _load_failed = True
        return _lib


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
