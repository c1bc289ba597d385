"""The twin of `tests/test_native.py::test_xorsched_apply_blocks_under_sanitizer`:
the port's sanitizer driver (`csrc/xs_san_driver.cc`, linked with
`csrc/gf_host.cc`) under ThreadSanitizer and AddressSanitizer at 1 2 4 8
threads, beside the reference's driver (`native/xs_tsan_driver.cc` with
`native/weedtpu.cc`) built the way its own test builds it. Both must be
clean, and the port's XOR-schedule lines must equal the reference's. The
port's driver also runs `gf_matrix_apply_mt` and `gf_matrix_apply_batch`
against the single-thread apply."""

import os
import re
import subprocess

import pytest

from seaweedfs_tpu_torch.ops import host_sanitizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THREAD_LINE = re.compile(r"threads=\d+ ok")


@pytest.mark.parametrize("kind", sorted(host_sanitizer.SANITIZERS))
def test_xorsched_apply_blocks_under_sanitizer(tmp_path, kind):
    flag = host_sanitizer.SANITIZERS[kind]
    cxx = host_sanitizer.sanitizer_cxx(flag)
    if cxx is None:
        pytest.skip(f"no {flag}-sanitizer-capable C++ compiler on this image")

    built = host_sanitizer.build([kind])[kind]
    assert built["compiler"] == cxx
    port = host_sanitizer.run(built["path"])
    assert port["clean"], f"{kind} run failed (rc={port['rc']}):\n{port['lines']}\n{port['stderr']}"
    threads = host_sanitizer.THREADS
    for entry in ("", "gf_matrix_apply_mt ", "gf_matrix_apply_batch "):
        assert [ln for ln in port["lines"] if ln.startswith(f"{entry}threads=")] == [
            f"{entry}threads={t} ok" for t in threads]

    make = subprocess.run(
        ["make", "-C", os.path.join(ROOT, "native"), kind, f"BUILD={tmp_path}",
         f"SAN_CXX={cxx}"], capture_output=True, text=True, timeout=300)
    assert make.returncode == 0, f"reference sanitizer build failed:\n{make.stderr}"
    ref = host_sanitizer.run(os.path.join(str(tmp_path), f"xs_{kind}"), threads)
    assert ref["clean"], f"reference {kind} run failed (rc={ref['rc']}):\n{ref['stderr']}"
    assert ([ln for ln in port["lines"] if THREAD_LINE.fullmatch(ln)]
            == [ln for ln in ref["lines"] if THREAD_LINE.fullmatch(ln)])


def test_sanitizer_build_names_the_compiler_and_flag(monkeypatch):
    monkeypatch.setattr(host_sanitizer, "COMPILERS", ("no-such-c++",))
    with pytest.raises(RuntimeError, match=r"no-such-c\+\+.*-fsanitize=thread"):
        host_sanitizer.build(["tsan"])

