"""Build proof for the CUDA kernels: every `csrc/*.cu` library built for
`sm_90a`, its `ptxas -v` resources recorded, and every variant launched at
every proof shape, byte for byte against its plain version.

The JAX package proves its fused Pallas kernel by lowering it for the TPU
target (`ops/tpu_lowering.py`). Here the compiler that can refuse a
kernel is `nvcc`/`ptxas`, and a kernel that compiles can still fail to
launch (too much shared memory, a bad grid) or compute the wrong bytes at
a shape no other check reaches, so the proof builds, launches and
compares. `PROOF_SHAPES` are the reference's shape classes: a matrix
applied to (batch, cols, 2 * tile) bytes, the matrix built as the
reference's proof builds it (`proof_matrix`).

    run_lowering_proof()              the card: build, launch, compare
    run_lowering_proof(device="cpu")  the plain route only, nothing built

There is no fallback: a library that does not build or a launch that
fails is an entry with `ok` false and its error, never a pass.
"""

from __future__ import annotations

import hashlib
import time
from typing import Optional

import numpy as np
import torch

from seaweedfs_tpu_torch.ops import _build, gf8, rs_cuda

#: the reference's shape classes (`tpu_lowering.PROOF_SHAPES`, its `mxu`
#: named `variant` here): the encode at the tiles the tile picker and the
#: sweep reach, the reconstructs of 4 and 10 shards from 10 survivors, and
#: the one-interval degraded read at the smallest tile
PROOF_SHAPES = (
    {"name": "encode_10p4_tile8192", "rows": 4, "cols": 10, "tile": 8192, "batch": 4,
     "variant": "int8"},
    {"name": "encode_10p4_tile32768", "rows": 4, "cols": 10, "tile": 32768, "batch": 4,
     "variant": "int8"},
    {"name": "encode_10p4_tile24576_bf16", "rows": 4, "cols": 10, "tile": 24576,
     "batch": 4, "variant": "bf16"},
    {"name": "encode_10p4_tile32768_u8", "rows": 4, "cols": 10, "tile": 32768,
     "batch": 4, "variant": "u8"},
    {"name": "encode_10p4_tile32768_mplane", "rows": 4, "cols": 10, "tile": 32768,
     "batch": 4, "variant": "mplane"},
    {"name": "encode_10p4_tile65536_dma", "rows": 4, "cols": 10, "tile": 65536,
     "batch": 4, "variant": "dma"},
    {"name": "reconstruct_4from10_tile32768_dma", "rows": 4, "cols": 10,
     "tile": 32768, "batch": 1, "variant": "dma"},
    {"name": "reconstruct_4from10_tile8192", "rows": 4, "cols": 10, "tile": 8192, "batch": 1,
     "variant": "int8"},
    {"name": "reconstruct_10from10_tile8192", "rows": 10, "cols": 10, "tile": 8192,
     "batch": 1, "variant": "int8"},
    {"name": "small_read_tile128", "rows": 4, "cols": 10, "tile": 128, "batch": 1,
     "variant": "int8"},
)

#: every variant is launched at every shape, int8 first: the others are
#: held against its output
VARIANTS = tuple(rs_cuda.KERNELS)


def proof_matrix(rows: int, cols: int) -> np.ndarray:
    """The (rows, cols) GF(2^8) matrix of a proof shape: the parity matrix
    where it has that shape, else a seeded random one, as the reference's
    proof builds it."""
    m = gf8.parity_matrix(cols, rows) if rows <= cols else None
    if m is None or m.shape != (rows, cols):
        rng = np.random.default_rng(1)
        m = rng.integers(1, 256, size=(rows, cols), dtype=np.uint8)
    return m


def proof_input(spec: dict, seed: int = 0) -> np.ndarray:
    """The (batch, cols, 2 * tile) uint8 bytes a proof shape applies its
    matrix to, made from `seed` and the shape's name."""
    salt = int.from_bytes(hashlib.sha256(spec["name"].encode()).digest()[:4], "little")
    rng = np.random.default_rng([seed, salt])
    return rng.integers(0, 256, size=(spec["batch"], spec["cols"], 2 * spec["tile"]),
                        dtype=np.uint8)


def proof_tile(variant: str, spec: dict) -> Optional[int]:
    """The shape's tile where the variant takes it, else None (its own
    tile picker): bf16's products cover whole trips of `rs_cuda.SPAN`
    columns, so at a tile that is not a whole number of those it runs at
    its own."""
    return None if variant == "bf16" and spec["tile"] % rs_cuda.SPAN else spec["tile"]


def _library_entry(name: str, built: dict) -> dict:
    kernels = _build.ptxas_report(built["ptxas"])
    entry = {
        "kind": "library", "library": name, "path": built["path"],
        "seconds": built["seconds"], "cached": built["cached"],
        "instantiations": len(kernels),
        "max_registers": max((k["registers"] for k in kernels.values()), default=None),
        "spill_bytes": sum(k["spill_stores"] + k["spill_loads"] for k in kernels.values()),
        "max_smem": max((k["smem"] for k in kernels.values()), default=None),
        "kernels": kernels,
    }
    entry["ok"] = bool(kernels)
    if not kernels:
        entry["error"] = "the build's ptxas log names no kernel"
    return entry


def _build_libraries() -> list[dict]:
    """One entry per library, all built together; a library that fails
    carries its own compiler output as its error."""
    built = _build.build_each()
    out = []
    for name in _build.SOURCES:
        b = built[name]
        if isinstance(b, Exception):
            out.append({"kind": "library", "library": name, "ok": False, "error": str(b)})
        else:
            out.append(_library_entry(name, b))
    return out


def _sha256(t: torch.Tensor) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def run_lowering_proof(device: str = "cuda", seed: int = 0) -> list[dict]:
    """The proof on `device`: one entry per library (card only), then one
    per (shape, variant), each with `ok`. On the card every launch is one
    `rs_cuda.apply_matrix` call that must count exactly one launch, and its
    output must equal the variant's plain version on the card and the int8
    kernel's output. On the CPU the same calls take the plain route and
    are held against int8's; nothing is built. Raises when `device` is
    the card and `nvcc` or the card is missing."""
    dev = torch.device(device)
    entries: list[dict] = []
    failed_libraries: set[str] = set()
    if dev.type == "cuda":
        _build.nvcc()  # raises, naming nvcc, where there is none
        if not torch.cuda.is_available():
            raise RuntimeError("the build proof launches on a CUDA card and there is none; "
                               "device='cpu' runs the plain route")
        libraries = _build_libraries()
        entries += libraries
        failed_libraries = {e["library"] for e in libraries if not e["ok"]}
    elif dev.type != "cpu":
        raise ValueError(f"no build proof for device {device!r}")
    for spec in PROOF_SHAPES:
        m = proof_matrix(spec["rows"], spec["cols"])
        data = torch.from_numpy(proof_input(spec, seed)).to(dev)
        int8_out = None
        for v in VARIANTS:
            tile = proof_tile(v, spec)
            entry = {"kind": "launch", "shape": spec["name"], "variant": v, "tile": tile,
                     "matrix": [spec["rows"], spec["cols"]], "data": list(data.shape)}
            library = rs_cuda.KERNELS[v][0]
            if library in failed_libraries:
                entries.append({**entry, "ok": False, "error": f"{library} did not build"})
                continue
            t0 = time.perf_counter()
            try:
                before = rs_cuda.launches
                got = rs_cuda.apply_matrix(m, data, tile, variant=v)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                    entry["launches"] = rs_cuda.launches - before
                    want = rs_cuda.plain_apply(m, data, tile, variant=v)
                    entry["equal"] = bool(torch.equal(got, want))
                    entry["max_abs_err"] = int((got.int() - want.int()).abs().max())
                    del want
                if v == "int8":
                    int8_out = got
                entry["agrees"] = int8_out is not None and bool(torch.equal(got, int8_out))
                entry["sha256"] = _sha256(got)
            except Exception as e:  # noqa: BLE001 - a failed launch is recorded, never passed
                entry["error"] = f"{type(e).__name__}: {e}"[:500]
            entry["seconds"] = time.perf_counter() - t0
            entry["ok"] = ("error" not in entry and entry["agrees"]
                           and entry.get("equal", True) and entry.get("launches", 1) == 1)
            entries.append(entry)
        del data, int8_out
    return entries
