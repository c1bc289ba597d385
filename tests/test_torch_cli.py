"""`python -m seaweedfs_tpu_torch encode|rebuild|decode|verify --device cpu`
and `fix|compact|export` against `python -m seaweedfs_tpu` on one small
volume: identical files and identical JSON, command by command."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from seaweedfs_tpu.__main__ import main as ref_main
from seaweedfs_tpu.storage.needle import Needle
from seaweedfs_tpu.storage.volume import Volume
from seaweedfs_tpu_torch.__main__ import main as port_main
from seaweedfs_tpu_torch.ec import stripe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LARGE, SMALL = 4096, 512
GEOMETRY = ["--large-block", str(LARGE), "--small-block", str(SMALL)]
EXTS = [stripe.to_ext(s) for s in range(14)] + [".eci", ".ecx", ".dat", ".idx"]


@pytest.fixture
def twin(tmp_path):
    """One needle volume (with a deletion) in two directories."""
    (tmp_path / "ref").mkdir()
    v = Volume(str(tmp_path / "ref"), 7, "")
    for i in range(1, 12):
        v.write_needle(Needle(cookie=0x1000 + i, id=i, data=bytes([i]) * (700 * i)))
    v.delete_needle(3)
    v.close()
    (tmp_path / "port").mkdir()
    for ext in (".dat", ".idx"):
        shutil.copy(tmp_path / "ref" / f"7{ext}", tmp_path / "port" / f"7{ext}")
    return str(tmp_path / "port" / "7"), str(tmp_path / "ref" / "7")


def _run(main, argv, capsys) -> tuple[int, dict]:
    rc = main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if out else {})


def _both(port, ref, capsys, cmd, *extra):
    rc_p, out_p = _run(port_main, [cmd, port, *extra, "--device", "cpu"], capsys)
    rc_r, out_r = _run(ref_main, [cmd, ref, *extra], capsys)
    assert rc_p == rc_r == 0, (cmd, rc_p, rc_r)
    assert sorted(out_p) == sorted(out_r), (cmd, out_p, out_r)
    return out_p, out_r


def _files(base: str) -> dict:
    out = {}
    for ext in EXTS:
        if os.path.exists(base + ext):
            with open(base + ext, "rb") as f:
                out[ext] = f.read()
    return out


def test_encode_verify_rebuild_decode_identical(twin, capsys):
    port, ref = twin
    with open(port + ".dat", "rb") as f:
        original = f.read()
    out_p, out_r = _both(port, ref, capsys, "encode", *GEOMETRY)
    assert {k: v for k, v in out_p.items() if k != "encoded"} == {
        k: v for k, v in out_r.items() if k != "encoded"
    }
    assert _files(port) == _files(ref)

    out_p, out_r = _both(port, ref, capsys, "verify")
    assert out_p == out_r == {"verified": True, "shard_bytes": out_r["shard_bytes"]}

    for s in (0, 5, 11, 13):
        os.remove(stripe.shard_file_name(port, s))
        os.remove(stripe.shard_file_name(ref, s))
    out_p, out_r = _both(port, ref, capsys, "rebuild")
    assert out_p == out_r == {"rebuilt_shards": [0, 5, 11, 13]}
    assert _files(port) == _files(ref)

    for s in (2, 7):
        os.remove(stripe.shard_file_name(port, s))
        os.remove(stripe.shard_file_name(ref, s))
    os.remove(port + ".dat")
    os.remove(ref + ".dat")
    out_p, out_r = _both(port, ref, capsys, "decode")
    assert out_p["bytes"] == out_r["bytes"] == len(original)
    files = _files(port)
    assert files == _files(ref)
    assert files[".dat"] == original


def test_verify_flags_corrupt_parity(twin, capsys):
    port, _ = twin
    assert _run(port_main, ["encode", port, *GEOMETRY, "--device", "cpu"], capsys)[0] == 0
    with open(stripe.shard_file_name(port, 12), "r+b") as f:
        f.write(b"\xff\x00\xff")
    rc, out = _run(port_main, ["verify", port, "--device", "cpu"], capsys)
    assert rc == 1 and out == {"verified": False, "bad_chunk_offset": 0}


def test_errors_exit_1_like_the_reference(twin, capsys):
    port, ref = twin
    missing = port + "_none"
    assert port_main(["encode", missing, "--device", "cpu"]) == 1
    assert ref_main(["encode", ref + "_none"]) == 1
    assert _run(port_main, ["encode", port, *GEOMETRY, "--device", "cpu"], capsys)[0] == 0
    for s in range(5):
        os.remove(stripe.shard_file_name(port, s))
    assert port_main(["decode", port, "--device", "cpu"]) == 1
    assert port_main(["verify", port, "--device", "cpu"]) == 1
    capsys.readouterr()


def test_python_dash_m_entry_point(twin):
    port, _ = twin
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "encode", port, *GEOMETRY,
         "--device", "cpu"],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["shards"] == 14 and out["encoded"] == port
    assert len(stripe.find_local_shards(port)) == 14


# -- fix, compact, export ---------------------------------------------------------


def _lines(main, argv, capsys) -> tuple[int, list]:
    rc = main(argv)
    return rc, [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]


def _maintenance(port, ref, capsys, cmd, *extra) -> list:
    """Run `cmd` through both CLIs; the JSON lines must be equal once the
    base path is named alike, and so must the volume's files."""
    rc_p, got = _lines(port_main, [cmd, port, *extra], capsys)
    rc_r, want = _lines(ref_main, [cmd, ref, *extra], capsys)
    assert rc_p == rc_r == 0, (cmd, rc_p, rc_r)
    assert json.dumps(got).replace(port, "B") == json.dumps(want).replace(ref, "B")
    assert _files(port) == _files(ref)
    return got


@pytest.mark.parametrize("steps", [
    ("fix",), ("compact",), ("export",), ("export --data",), ("fix", "compact", "export --data"),
    ("compact", "fix", "export"),
])
def test_fix_compact_export_identical(twin, capsys, steps):
    port, ref = twin
    for step in steps:
        cmd, *extra = step.split()
        if cmd == "fix":
            os.remove(port + ".idx")
            os.remove(ref + ".idx")
        out = _maintenance(port, ref, capsys, cmd, *extra)
        if cmd == "fix":
            assert out == [{"fixed": port + ".idx", "records": out[0]["records"]}]
        elif cmd == "compact":
            assert out[0]["bytes_after"] < out[0]["bytes_before"]
        else:
            assert {int(r["id"], 16) for r in out} == set(range(1, 12)) - {3}
            assert all(("data" in r) == bool(extra) for r in out)


def _volume_pair(tmp_path, build) -> tuple[str, str]:
    for side in ("port", "ref"):
        os.makedirs(tmp_path / side)
        v = Volume(str(tmp_path / side), 9, "")
        build(v)
        v.close()
    with open(tmp_path / "ref" / "9.dat", "rb") as f:
        dat = f.read()
    with open(tmp_path / "port" / "9.dat", "wb") as f:
        f.write(dat)  # one history: the append stamps of the reference's
    shutil.copy(tmp_path / "ref" / "9.idx", tmp_path / "port" / "9.idx")
    return str(tmp_path / "port" / "9"), str(tmp_path / "ref" / "9")


def test_fix_keeps_a_live_empty_needle_like_the_reference(tmp_path, capsys):
    def build(v):
        v.write_needle(Needle(cookie=0xAA, id=1, data=b""))
        v.write_needle(Needle(cookie=0xBB, id=2, data=b"live"))
        v.delete_needle(2)

    port, ref = _volume_pair(tmp_path, build)
    os.remove(port + ".idx")
    os.remove(ref + ".idx")
    assert _maintenance(port, ref, capsys, "fix")[0]["records"] == 3
    out = _maintenance(port, ref, capsys, "export", "--data")
    assert out == [{"id": "1", "cookie": "000000aa", "offset": 8, "size": 5, "name": "",
                    "mime": "", "data_size": 0, "data": ""}]


def test_compact_of_a_fully_deleted_volume_reclaims_like_the_reference(tmp_path, capsys):
    def build(v):
        for i in (1, 2, 3):
            v.write_needle(Needle(cookie=i, id=i, data=b"z" * 500))
        for i in (1, 2, 3):
            v.delete_needle(i)

    port, ref = _volume_pair(tmp_path, build)
    out = _maintenance(port, ref, capsys, "compact")
    assert out[0]["bytes_after"] == 8
    assert _maintenance(port, ref, capsys, "export") == []


def test_compact_heals_a_lost_index_instead_of_wiping_like_the_reference(twin, capsys):
    port, ref = twin
    os.remove(port + ".idx")
    os.remove(ref + ".idx")
    out = _maintenance(port, ref, capsys, "compact")
    assert out[0]["bytes_after"] > 8


def test_maintenance_errors_exit_1_like_the_reference(twin, capsys, tmp_path):
    port, ref = twin
    for side, main in ((port, port_main), (ref, ref_main)):
        assert main(["compact", os.path.join(os.path.dirname(side), "nope")]) == 1
        with open(side + ".dat", "r+b") as f:  # a size field that overruns the file
            f.seek(8 + 12)
            f.write((0x7FFF0000).to_bytes(4, "big"))
        assert main(["fix", side]) == 1
        assert not os.path.exists(side + ".idx.tmp")
    capsys.readouterr()
