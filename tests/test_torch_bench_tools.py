"""The port's `benchmark`, `upload` and `download` commands
(`seaweedfs_tpu_torch/command/bench_tools.py`) against the reference's:
the twin of `tests/test_tiering.py`'s command case, run on a one-server
cluster of each package (the port's on `Encoder(10, 4, device="cpu")`).
Each side makes the reference case's assertions; the downloaded bytes
must equal the uploaded file, and the printed lines must be equal with
fids, addresses, timings and rates masked (tolerance 0 on the rest)."""

import argparse
import json
import re

import pytest

from seaweedfs_tpu.command import commands as ref_commands
from seaweedfs_tpu_torch.command import commands as port_commands

from test_torch_cluster import blob, cluster, twin

COMMANDS = {"ref": ref_commands, "port": port_commands}


def _run(pkg, name: str, argv: list) -> int:
    cmd = COMMANDS[pkg.name]()[name]
    p = argparse.ArgumentParser()
    cmd.configure(p)
    return cmd.run(p.parse_args(argv))


def _mask(text: str, master: str) -> str:
    text = text.replace(master, "<master>")
    text = re.sub(r"\d+,[0-9a-f]+", "<fid>", text)
    text = re.sub(r"\d+\.\d+", "<x>", text)
    return re.sub(r"= \d+ req/s", "= <n> req/s", text)


def _commands(pkg, root, capsys):
    with cluster(pkg, root, n=1) as (master, _servers, _client):
        src = root / "up.bin"
        src.write_bytes(blob(5, 500))
        assert _run(pkg, "upload", ["-master", master.address, str(src)]) == 0
        up = capsys.readouterr().out
        entry = json.loads(up)[0]
        fid = entry["fid"]
        dl_dir = root / "dl"
        assert _run(pkg, "download", ["-master", master.address, "-dir", str(dl_dir), fid]) == 0
        down = capsys.readouterr().out
        got = (dl_dir / fid.replace(",", "_")).read_bytes()
        assert got == src.read_bytes()
        assert _run(pkg, "benchmark",
                    ["-master", master.address, "-n", "20", "-size", "256", "-c", "4"]) == 0
        bench = capsys.readouterr().out
        assert "write:" in bench and "read:" in bench and "p99" in bench
        assert "write: 20 ok, 0 err" in bench and "read:  20 ok" in bench
        return {
            "upload": {k: v for k, v in entry.items() if k != "fid"},
            "download": _mask(down.replace(str(dl_dir / fid.replace(",", "_")), "<path>"),
                              master.address),
            "downloaded": got,
            "benchmark": _mask(bench, master.address).splitlines(),
        }


def test_benchmark_upload_download_commands(tmp_path, monkeypatch, capsys):
    out = twin(_commands, tmp_path, monkeypatch, capsys=capsys)
    assert out["upload"] == {"fileName": "up.bin", "size": 500}


def test_commands_are_registered():
    got = port_commands()
    for name in ("benchmark", "upload", "download"):
        assert got[name].help == ref_commands()[name].help


@pytest.mark.parametrize("argv", [["-n", "1"], ["-size", "8"], ["-c", "2"]])
def test_benchmark_flags_parse_as_the_reference(argv):
    parsed = {}
    for name, cmds in COMMANDS.items():
        p = argparse.ArgumentParser()
        cmds()["benchmark"].configure(p)
        parsed[name] = vars(p.parse_args(argv))
    assert parsed["port"] == parsed["ref"]
