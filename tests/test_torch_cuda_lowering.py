"""The build proof (`seaweedfs_tpu_torch/ops/cuda_lowering.py`) without a
card: its shapes are the reference's TPU lowering shapes; its plain route
is byte-exact at every shape and variant against the reference's
`rs_pallas.apply_matrix` (the Pallas kernel in interpret mode, each shape
at its own `mxu`) and the `gf8` table golden (tolerance 0: GF arithmetic
is exact); the card route raises where there is no `nvcc`; and `_build`
reports the `ptxas -v` log it kept for a library that is already built."""

import hashlib
import os

import numpy as np
import pytest

from seaweedfs_tpu.ops import tpu_lowering
from seaweedfs_tpu_torch.ops import _build, cuda_lowering, gf8, rs_cuda

SPEC_KEYS = ("name", "rows", "cols", "tile", "batch")


def test_proof_shapes_are_the_reference_ones():
    ref = [{**{k: s[k] for k in SPEC_KEYS}, "variant": s.get("mxu", "int8")}
           for s in tpu_lowering.PROOF_SHAPES]
    mine = [{k: s[k] for k in (*SPEC_KEYS, "variant")} for s in cuda_lowering.PROOF_SHAPES]
    assert mine == ref
    assert set(cuda_lowering.VARIANTS) == set(rs_cuda.KERNELS)
    assert cuda_lowering.VARIANTS[0] == "int8"


@pytest.mark.parametrize("spec", cuda_lowering.PROOF_SHAPES, ids=lambda s: s["name"])
def test_proof_matrix_is_the_reference_construction(spec):
    """The reference's `export_fused_kernel` builds its matrix so: the
    parity matrix where it has the shape, else a seeded random one."""
    from seaweedfs_tpu.ops import gf8 as ref_gf8

    rows, cols = spec["rows"], spec["cols"]
    want = ref_gf8.parity_matrix(cols, rows) if rows <= cols else None
    if want is None or want.shape != (rows, cols):
        want = np.random.default_rng(1).integers(1, 256, size=(rows, cols), dtype=np.uint8)
    assert np.array_equal(cuda_lowering.proof_matrix(rows, cols), want)


@pytest.fixture(scope="module")
def cpu_proof():
    return cuda_lowering.run_lowering_proof(device="cpu")


def test_cpu_proof_is_all_ok_and_builds_nothing(cpu_proof, monkeypatch):
    assert [e["kind"] for e in cpu_proof] == ["launch"] * (
        len(cuda_lowering.PROOF_SHAPES) * len(cuda_lowering.VARIANTS))
    assert all(e["ok"] and e["agrees"] for e in cpu_proof), [e for e in cpu_proof if not e["ok"]]
    assert {(e["shape"], e["variant"]) for e in cpu_proof} == {
        (s["name"], v) for s in cuda_lowering.PROOF_SHAPES for v in cuda_lowering.VARIANTS}

    def no_build(*a, **k):
        raise AssertionError("the CPU proof built a library")

    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "nvcc", no_build)
    again = cuda_lowering.run_lowering_proof(device="cpu")
    assert [e["sha256"] for e in again] == [e["sha256"] for e in cpu_proof]


def test_cpu_proof_tiles_are_the_shapes_own():
    """Every variant runs at the shape's tile, but bf16 at the 128-column
    read, whose products need whole 2048-column trips (its own pick)."""
    for spec in cuda_lowering.PROOF_SHAPES:
        for v in cuda_lowering.VARIANTS:
            want = None if (v == "bf16" and spec["tile"] % rs_cuda.SPAN) else spec["tile"]
            assert cuda_lowering.proof_tile(v, spec) == want, (spec["name"], v)


@pytest.mark.parametrize("spec", cuda_lowering.PROOF_SHAPES, ids=lambda s: s["name"])
def test_cpu_proof_equals_reference_pallas_and_golden(cpu_proof, spec):
    """All five variants' bytes at the shape equal the reference's fused
    Pallas kernel at the shape's own `mxu` (interpret mode, as the JAX
    package's CPU tests run it) and the table golden, tolerance 0."""
    import jax.numpy as jnp

    from seaweedfs_tpu.ops import rs_pallas

    m = cuda_lowering.proof_matrix(spec["rows"], spec["cols"])
    data = cuda_lowering.proof_input(spec)
    ref = np.asarray(rs_pallas.apply_matrix(m, jnp.asarray(data), tile=spec["tile"],
                                            mxu=spec["variant"]))
    golden = np.stack([gf8.gf_mat_vec(m, d) for d in data])
    assert np.array_equal(ref, golden)
    want = hashlib.sha256(golden.tobytes()).hexdigest()
    got = {e["variant"]: e["sha256"] for e in cpu_proof if e["shape"] == spec["name"]}
    assert got == {v: want for v in cuda_lowering.VARIANTS}


def test_proof_input_is_seeded():
    spec = cuda_lowering.PROOF_SHAPES[0]
    a, b = cuda_lowering.proof_input(spec, 0), cuda_lowering.proof_input(spec, 0)
    assert np.array_equal(a, b) and a.shape == (4, 10, 2 * spec["tile"]) and a.dtype == np.uint8
    assert not np.array_equal(a, cuda_lowering.proof_input(spec, 1))


def test_card_route_without_nvcc_raises_naming_nvcc(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists",
                        lambda p, _e=os.path.exists: False if p.endswith("nvcc") else _e(p))
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_lowering.run_lowering_proof()


def test_unknown_device_raises():
    with pytest.raises(ValueError):
        cuda_lowering.run_lowering_proof(device="meta")


PTXAS_LOG = """ptxas info    : Compiling entry function '_Z13gf_dma_kernelILi3ELi4EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z13gf_dma_kernelILi3ELi4EEvv
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 96 registers, 16 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z13gf_dma_kernelILi3ELi1EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z13gf_dma_kernelILi3ELi1EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, 400 bytes cmem[0]
"""


def _no_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")

    monkeypatch.setattr(_build, "nvcc", no_nvcc)


def test_build_returns_the_kept_ptxas_log_of_a_cached_library(monkeypatch, tmp_path):
    _no_compiler(monkeypatch, tmp_path)
    os.makedirs(_build.BUILD_DIR)
    lib = _build.lib_path("gf_dma")
    assert os.path.dirname(lib) == _build.BUILD_DIR
    assert _build.log_path(lib) == lib[: -len(".so")] + ".ptxas.log"
    with open(lib, "wb") as f:
        f.write(b"\x7fELF not really")
    with open(_build.log_path(lib), "w", encoding="utf-8") as f:
        f.write(PTXAS_LOG)
    out = _build.build(["gf_dma"])
    assert out == {"gf_dma": {"path": lib, "seconds": 0.0, "ptxas": PTXAS_LOG, "cached": True}}
    report = _build.ptxas_report(out["gf_dma"]["ptxas"])
    assert report["_Z13gf_dma_kernelILi3ELi4EEvv"] == {
        "registers": 96, "spill_stores": 8, "spill_loads": 4, "smem": 16}
    assert report["_Z13gf_dma_kernelILi3ELi1EEvv"]["registers"] == 64


def test_a_library_without_its_log_is_rebuilt(monkeypatch, tmp_path):
    """No log beside the library: it is built again (here: no compiler,
    so the build raises), never reported with an empty log."""
    _no_compiler(monkeypatch, tmp_path)
    os.makedirs(_build.BUILD_DIR)
    with open(_build.lib_path("gf_mma"), "wb") as f:
        f.write(b"\x7fELF not really")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(["gf_mma"])


def test_library_entry_reads_the_report():
    entry = cuda_lowering._library_entry(
        "gf_dma", {"path": "x.so", "seconds": 0.0, "cached": True, "ptxas": PTXAS_LOG})
    assert entry["ok"] and entry["instantiations"] == 2
    assert (entry["max_registers"], entry["spill_bytes"], entry["max_smem"]) == (96, 12, 16)
    empty = cuda_lowering._library_entry(
        "gf_dma", {"path": "x.so", "seconds": 0.0, "cached": True, "ptxas": ""})
    assert not empty["ok"] and "names no kernel" in empty["error"]


def test_failed_build_is_an_entry_that_is_not_ok(monkeypatch):
    """A library that does not build is an entry with its error, and every
    variant on it is not ok: no failure is caught into a pass."""
    def build_each(names=None):
        names = list(_build.SOURCES if names is None else names)
        calls.append(names)
        return {n: RuntimeError("gf_mma: nvcc exited 2") if n == "gf_mma" else
                {"path": f"{n}.so", "seconds": 1.0, "cached": False, "ptxas": PTXAS_LOG}
                for n in names}

    calls = []
    monkeypatch.setattr(_build, "build_each", build_each)
    entries = cuda_lowering._build_libraries()
    by_name = {e["library"]: e for e in entries}
    assert set(by_name) == set(_build.SOURCES)
    assert not by_name["gf_mma"]["ok"] and "nvcc exited 2" in by_name["gf_mma"]["error"]
    assert all(by_name[n]["ok"] for n in _build.SOURCES if n != "gf_mma")
    assert calls == [list(_build.SOURCES)], "a failing library was sent to nvcc again"


def test_build_each_keeps_each_failure_its_own(monkeypatch, tmp_path):
    """One compiler run per library: a library that fails is an error of
    its own, the others are built and kept, and `build` raises naming it."""
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        "for a; do src=$a; done\n"
        "while [ $# -gt 0 ]; do [ \"$1\" = -o ] && out=$2; shift; done\n"
        "echo \"compiled $src\" >> \"$(dirname \"$0\")/calls\"\n"
        "case $src in *gf_mma.cu) echo 'error: no'; exit 2;; esac\n"
        "echo \"ptxas info    : Compiling entry function 'k' for 'sm_90a'\"\n"
        "echo 'ptxas info    : Used 32 registers'\n"
        "printf ELF > \"$out\"\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    built = _build.build_each()
    assert isinstance(built["gf_mma"], RuntimeError)
    assert "gf_mma: nvcc exited 2" in str(built["gf_mma"]) and "error: no" in str(built["gf_mma"])
    for name in set(_build.SOURCES) - {"gf_mma"}:
        assert built[name]["cached"] is False and os.path.exists(built[name]["path"])
        assert _build.ptxas_report(built[name]["ptxas"]) == {
            "k": {"registers": 32, "spill_stores": 0, "spill_loads": 0, "smem": 0}}
    assert (tmp_path / "calls").read_text().count("compiled") == len(_build.SOURCES)
    with pytest.raises(RuntimeError, match="gf_mma: nvcc exited 2"):
        _build.build()
    calls = (tmp_path / "calls").read_text().splitlines()
    assert len(calls) == len(_build.SOURCES) + 1 and calls[-1].endswith("gf_mma.cu")  # others kept
