"""The port's chaos soak (`seaweedfs_tpu_torch/scripts/chaos_soak.py`)
against the reference's `scripts/chaos_soak.py`: the shared corruption
primitives on copies of one shard file under one seeded `random.Random`
(the resulting bytes and the healed verdicts against the `.eci` CRCs must
be equal, tolerance 0), the volume server command line `Node` spawns, and
the entry point's refusal to start without a card unless told
`--device cpu`. The rack and wedge scenarios themselves run for minutes,
with seven and three server processes: they are `slow` here (run them
with `-m slow`); on the card, `chip_smoke.py`'s `rack` phase runs the rack
scenario."""

import importlib.util
import json
import os
import random
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from seaweedfs_tpu_torch.scripts import chaos_soak as port_soak

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference(name: str):
    spec = importlib.util.spec_from_file_location(
        f"ref_{name}", os.path.join(ROOT, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref_soak = _reference("chaos_soak")
PACKAGES = {"ref": ref_soak, "port": port_soak}
VID = 7


def _shard_dir(root, seed: int) -> tuple[str, list]:
    """A directory holding shard files 0-13 of volume VID (random bytes of
    a few sizes) and the whole-file CRC32s an `.eci` would record."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    crcs = []
    for s in range(14):
        data = rng.integers(0, 256, 3000 + 17 * s, dtype=np.uint8).tobytes()
        with open(os.path.join(root, f"{VID}.ec{s:02d}"), "wb") as f:
            f.write(data)
        crcs.append(zlib.crc32(data))
    return str(root), crcs


@pytest.mark.parametrize("kind", ["bitflip", "truncate", "delete"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_inject_shard_fault_and_clean_verdict_equal_the_reference(tmp_path, kind, seed):
    out = {}
    for name, mod in PACKAGES.items():
        d, crcs = _shard_dir(tmp_path / name, 3)
        assert mod.ec_shard_path(d, VID, 4) == os.path.join(d, f"{VID}.ec04")
        assert all(mod.ec_shard_clean(d, VID, s, crcs) for s in range(14))
        rng = random.Random(seed)
        shard = rng.randrange(14)
        injected = mod.inject_shard_fault(mod.ec_shard_path(d, VID, shard), kind, rng)
        path = mod.ec_shard_path(d, VID, shard)
        out[name] = {
            "injected": injected, "shard": shard,
            "bytes": open(path, "rb").read() if os.path.exists(path) else None,
            "clean": [mod.ec_shard_clean(d, VID, s, crcs) for s in range(14)],
            "next_draw": rng.random(),
        }
        assert out[name]["injected"]
        assert out[name]["clean"].count(False) == 1
    assert out["port"] == out["ref"]


def test_inject_on_a_vanished_file_is_false_on_both(tmp_path):
    for mod in PACKAGES.values():
        gone = str(tmp_path / "nope.ec03")
        for kind in ("bitflip", "truncate", "delete"):
            assert mod.inject_shard_fault(gone, kind, random.Random(0)) is False
        assert mod.ec_shard_clean(str(tmp_path), 99, 3, [0] * 14) is False


def test_node_command_line_names_the_port_and_the_device(tmp_path, monkeypatch):
    """`Node` spawns `python -m seaweedfs_tpu_torch volume` with the
    reference's flags plus `--device`, from the directory that holds the
    package, and adds no jax variable to the environment it inherits."""
    seen = {}

    class FakePopen:
        def __init__(self, argv, **kw):
            seen.update(argv=argv, **kw)

        def poll(self):
            return None

    monkeypatch.setattr(port_soak.subprocess, "Popen", FakePopen)
    n = port_soak.Node(2, str(tmp_path), "127.0.0.1:9333", rack="rk1", device="cpu")
    n.start()
    argv = seen["argv"]
    assert argv[:4] == [sys.executable, "-m", "seaweedfs_tpu_torch", "volume"]
    assert argv[4:] == ["-port", str(n.http), "-grpcPort", str(n.grpc), "-dir", str(tmp_path),
                        "-mserver", "127.0.0.1:9333", "-max", "30", "-rack", "rk1",
                        "--device", "cpu"]
    assert os.path.isdir(os.path.join(seen["cwd"], "seaweedfs_tpu_torch"))
    assert "env" not in seen  # inherits os.environ as it is
    assert n.alive
    ref_n = ref_soak.Node(2, str(tmp_path), "127.0.0.1:9333", rack="rk1")
    assert ref_n.rack == n.rack and ref_n.dir == n.dir
    default = port_soak.Node(0, str(tmp_path), "127.0.0.1:9333")
    assert default.command()[-2:] == ["--device", "cuda"]
    assert "-rack" not in default.command()


def test_a_restarted_node_keeps_its_ports(tmp_path):
    """A killed server comes back on the same ports (the master and the
    peers know it by them), and its log file is closed with it."""
    n = port_soak.Node(0, str(tmp_path), "127.0.0.1:1", device="cpu")
    ports = (n.http, n.grpc)
    n.proc = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(30)"])
    n.log = open(os.path.join(str(tmp_path), "server.log"), "ab")
    n.wedge()
    assert n.wedged
    n.unwedge()
    n.kill(hard=True)
    assert not n.alive and not n.wedged and n.log.closed
    assert (n.http, n.grpc) == ports


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("argv", [["--rack"], ["--wedge", "--seconds", "1"], []])
def test_without_a_card_the_soak_raises_before_any_server(argv, monkeypatch):
    started = []
    monkeypatch.setattr(port_soak.Node, "start", lambda self: started.append(self))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_soak.main(argv)
    assert not started


def test_flags_are_the_references(tmp_path):
    """The port's argparse takes the reference's flag names, plus --device
    and --out."""
    args = port_soak.parse_args(["--seconds", "20", "--wedge", "--latency", "--inline",
                                 "--corrupt", "--convert", "--rack", "--device", "cpu",
                                 "--out", str(tmp_path / "r.json")])
    assert (args.seconds, args.wedge, args.latency, args.inline, args.corrupt, args.convert,
            args.rack, args.device) == (20, True, True, True, True, True, True, "cpu")
    ref_src = open(os.path.join(ROOT, "scripts", "chaos_soak.py")).read()
    for flag in ("--seconds", "--rack", "--wedge", "--latency", "--inline", "--corrupt",
                 "--convert"):
        assert f'"{flag}"' in ref_src
    assert port_soak.parse_args([]).device == "cuda"
    assert not port_soak._default_out("rack").startswith(os.path.join(ROOT, "artifacts"))


def _soak(tmp_path, argv) -> dict:
    out = tmp_path / "soak.json"
    saved = dict(os.environ)
    try:
        rc = port_soak.main([*argv, "--device", "cpu", "--out", str(out)])
    finally:
        os.environ.clear()
        os.environ.update(saved)
    report = json.loads(out.read_text())
    assert rc == 0 and report["ok"] and report["lost"] == [], report
    return report


@pytest.mark.slow
def test_rack_mode_on_the_cpu_meets_the_reference_gates(tmp_path):
    from seaweedfs_tpu_torch.cluster import topology

    dead_s = topology.DEAD_NODE_SECONDS
    try:
        r = _soak(tmp_path, ["--rack", "--seconds", "30"])
    finally:
        topology.DEAD_NODE_SECONDS = dead_s
    for ph in ("phase1_node", "phase2_rack"):
        assert r[ph]["priority_ok"] and r[ph]["coverage_complete"]
    assert r["placement_violations"] == [] and r["fusion"]["collapsed"]
    assert any(b["volumes"] >= 2 and b["dispatch_groups"] == 1
               for ph in ("phase1_node", "phase2_rack") for b in r[ph]["batches"])
    assert all(g == ["torch"] for gens in r["server_backends"].values() for g in gens)


@pytest.mark.slow
def test_wedge_mode_on_the_cpu_loses_nothing(tmp_path):
    r = _soak(tmp_path, ["--wedge", "--seconds", "20"])
    assert r["mode"] == "wedge" and r["wedges"] > 0 and r["writes"] > 0
