"""The port's device window (`scripts/device_window.py --window`) and the
harness's staged main (`python -m seaweedfs_tpu_torch.bench`) on the CPU.

The window runs as a child with `--device cpu`, a budget under 180 s and
small sizes, from an empty working directory with an empty TMPDIR: its
stage-1 record carries the reference window's stage keys (`cuda` in the
place of `pallas`, `torch`, the plain version, in the place of `xla`),
read from the reference's source, its e2e record the reference's keys,
its remote rebuild ok and byte-equal; it skips the sweep and the mesh
stage as the reference does (budget; one device), and it writes nothing
outside `--art-dir`. The main, `--device cpu --smoke`, prints exactly one
JSON line with the reference's headline keys."""

import ast
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_WINDOW = os.path.join(ROOT, "scripts", "device_window.py")


def reference_window_keys() -> tuple[set, set]:
    """(stage-1 keys, e2e record keys) of the reference window, from its
    source: the `stage("<key>", ...)` calls and the `rec` dict's keys (but
    the `*_error` key a failed rebuild sets instead of its numbers)."""
    with open(REF_WINDOW, encoding="utf-8") as f:
        src = f.read()
    stage1 = set(re.findall(r'stage\(\s*"([a-z0-9_]+)"', src))
    e2e: set = set()
    for node in ast.walk(ast.parse(src)):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "rec" for t in node.targets)):
            e2e |= {k.value for k in node.value.keys}
        if (isinstance(node, ast.Subscript) and getattr(node.value, "id", None) == "rec"
                and isinstance(node.ctx, ast.Store) and isinstance(node.slice, ast.Constant)):
            e2e.add(node.slice.value)
    return stage1, {k for k in e2e if not k.endswith("_error")}


def test_reference_window_keys_are_read():
    stage1, e2e = reference_window_keys()
    assert len(stage1) == 9 and "xla_steady_gbps" in stage1 and "pallas_dma_steady_gbps" in stage1
    assert {"e2e_gbps", "rebuild_e2e_depth1_seconds", "device_steady_gbps"} <= e2e


def test_window_on_the_cpu_has_the_reference_records_and_writes_only_its_art_dir(tmp_path):
    art, cwd, tmp = tmp_path / "art", tmp_path / "cwd", tmp_path / "tmp"
    cwd.mkdir()
    tmp.mkdir()
    artifacts = sorted(os.listdir(os.path.join(ROOT, "artifacts")))
    proc = subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch.scripts.device_window", "--window",
         "--art-dir", str(art), "--device", "cpu", "--budget", "170", "--batch", "1",
         "--width", "65536", "--e2e-mib", "8", "--remote-mib", "1"],
        cwd=str(cwd), env=dict(os.environ, PYTHONPATH=ROOT, TMPDIR=str(tmp)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, timeout=170)
    assert proc.returncode == 0, proc.stderr.decode()[-3000:]
    summary = json.loads(proc.stdout.decode().strip().splitlines()[-1])
    assert summary["ok"] is True and summary["window"] == "complete"
    stage1, e2e_keys = reference_window_keys()
    want = {k.replace("pallas", "cuda").replace("xla", "torch") for k in stage1}
    meas = summary["stages"]["measure"]
    assert set(meas) == want, set(meas) ^ want
    assert all(v > 0 for v in meas.values())
    assert summary["stages"]["sweep"] == "skipped: budget"
    assert summary["stages"]["mesh"] == "skipped: single device"
    e2e = summary["stages"]["e2e"]
    assert e2e_keys <= set(e2e), e2e_keys - set(e2e)
    assert e2e["rebuild_match"] is True and e2e["dat_bytes"] == 8 << 20
    assert e2e["device_steady_gbps"] == meas["cuda_auto_steady_gbps"]
    remote = summary["stages"]["remote"]
    assert remote["ok"] is True and remote["match"] is True
    assert remote["rebuilt_shard_ids"] == [10, 11, 12, 13]
    # what it wrote: the measurement, the e2e and remote records, the log
    assert sorted(os.listdir(art)) == summary["files"] == [
        "E2E_DEVICE.json", "GPU_MEASUREMENT_r00.json", "REMOTE_REBUILD.json",
        "device_window.log"]
    with open(art / "GPU_MEASUREMENT_r00.json", encoding="utf-8") as f:
        written = json.load(f)
    assert {k: written[k] for k in meas} == meas and written["platform"] == "cpu"
    assert os.listdir(cwd) == [] and os.listdir(tmp) == []
    assert sorted(os.listdir(os.path.join(ROOT, "artifacts"))) == artifacts


def test_main_on_the_cpu_prints_one_json_line_with_the_headline():
    proc = subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch.bench", "--device", "cpu", "--smoke"],
        cwd=ROOT, env=dict(os.environ, BENCH_MODE=""), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, timeout=240)
    lines = [x for x in proc.stdout.decode().splitlines() if x.strip().startswith("{")]
    assert len(lines) == 1, proc.stdout.decode()[-2000:]
    out = json.loads(lines[0])
    for key in ("metric", "value", "unit", "vs_baseline"):
        assert key in out, key
    assert (out["metric"], out["unit"], out["device"], out["platform"]) == (
        "ec_encode_gbps_10p4", "GB/s", "cpu", "cpu")
    assert proc.returncode == 0 and out["ok"] is True, out.get("stages_ok")
    assert out["value"] == out["cpu"]["device_encode_gbps"] > 0
    assert out["vs_baseline"] == round(out["value"] / out["cpu"]["native_gbps"], 4)
    assert set(out["stages_ok"]) == {"cpu", "remote", "rebuild_remote", "rebuild_trace",
                                     "ingest", "xor", "dp", "mesh"}
