"""The port's black-box multi-process suite, the twin of
`tests/test_blackbox.py`: two stacks of real server processes (a master, a
volume server, a filer on the log store), one from `python -m
seaweedfs_tpu` (JAX on the CPU) and one from `python -m
seaweedfs_tpu_torch` (the volume server with `--device cpu`), each on
loopback ports picked free at start (the reference's suite holds fixed
ports, and may run at the same time). Each case runs the reference case's
steps against both stacks through their public surfaces (HTTP and the
shell CLI), requires the two lists of (status, body) to be equal, and makes
the reference case's assertions on the port's. Bodies are compared with
each stack's addresses replaced by their role and, in JSON, the stamp and
fid fields masked (`test_torch_filer.mask`): the masters draw cookies at
random. The filer crash-restart finds its process by the handle that
started it, not by scanning /proc."""

import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from test_torch_filer import mask

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"ref": "seaweedfs_tpu", "port": "seaweedfs_tpu_torch"}


def _free_ports(n: int) -> list[int]:
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _env(pkg: str) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if pkg == "seaweedfs_tpu":  # as the reference's suite starts it
        env["JAX_PLATFORMS"] = "cpu"
        env.pop("XLA_FLAGS", None)
    return env


def _http(method, url, data=None, headers=None, timeout=15):
    req = urllib.request.Request(url, data=data, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()
    except (urllib.error.URLError, TimeoutError, ConnectionError) as e:
        return 0, str(e).encode()  # not up (yet): readiness loops retry on 0


def _payload(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).bytes(n)


class Stack:
    """One package's processes, their ports and their scratch directory."""

    def __init__(self, name: str, tmp):
        self.name, self.pkg, self.tmp = name, PACKAGES[name], tmp
        (tmp / "v0").mkdir()
        (tmp / "meta").mkdir()
        ports = _free_ports(6)
        self.ports = dict(zip(("master", "master_http", "volume", "volume_grpc", "filer",
                               "filer_grpc"), ports))
        self.procs = {}

    def url(self, role: str) -> str:
        return f"http://127.0.0.1:{self.ports[role]}"

    def spawn(self, role: str, args: list) -> None:
        # logs go to a file, never an undrained pipe: a server that outgrew
        # the pipe buffer would block on a log write and hang every test
        log = open(self.tmp / f"{role}.log", "ab")
        self.procs[role] = subprocess.Popen(
            [sys.executable, "-m", self.pkg, *args], cwd=str(self.tmp), env=_env(self.pkg),
            stdout=log, stderr=subprocess.STDOUT)
        log.close()  # the child holds its own descriptor

    def spawn_filer(self) -> None:
        self.spawn("filer", ["filer", "-port", str(self.ports["filer"]), "-grpcPort",
                             str(self.ports["filer_grpc"]), "-master",
                             f"127.0.0.1:{self.ports['master']}", "-store", "log",
                             "-dir", "./meta"])

    def volume_files(self, vid: int) -> int | None:
        """The file count of volume `vid` in the master's view (its last
        heartbeat from the volume server)."""
        code, body = _http("GET", self.url("master_http") + "/dir/status")
        if code != 200:
            return None
        dcs = json.loads(body)["Topology"]["data_centers"]
        return next((v["file_count"] for racks in dcs.values() for nodes in racks.values()
                     for n in nodes for v in n["volumes"] if v["id"] == vid), None)

    def logs(self) -> str:
        return "".join(f"\n== {self.name} {p.name} ==\n" + p.read_text()[-1500:]
                       for p in sorted(self.tmp.glob("*.log")))

    def unport(self, text: str) -> str:
        """`text` with each of this stack's ports named by its role."""
        for role, port in self.ports.items():
            text = re.sub(rf"\b{port}\b", f"<{role}>", text)
        return text

    def seen(self, status: int, body: bytes) -> tuple:
        """(status, body) as the two stacks' replies are compared."""
        try:
            obj = json.loads(body)
        except ValueError:
            obj = None
        if isinstance(obj, (dict, list)):
            return status, self.unport(json.dumps(mask(obj), sort_keys=True))
        try:
            return status, self.unport(body.decode())
        except UnicodeDecodeError:
            return status, body

    def stop(self) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in self.procs.values():
            try:
                p.wait(10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def _until(stacks, ready, timeout: float, what: str) -> None:
    deadline = time.monotonic() + timeout
    waiting = list(stacks)
    while waiting:
        waiting = [s for s in waiting if not ready(s)]
        if waiting and (time.monotonic() > deadline
                        or any(p.poll() is not None for s in waiting for p in s.procs.values())):
            raise AssertionError(f"{what} never came up:" + "".join(s.logs() for s in waiting))
        if waiting:
            time.sleep(0.3)


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    both = [Stack(name, tmp_path_factory.mktemp(f"blackbox_{name}")) for name in PACKAGES]
    try:
        for s in both:
            s.spawn("master", ["master", "-port", str(s.ports["master"]), "-httpPort",
                               str(s.ports["master_http"])])
        # a volume server's first heartbeat must reach the master: wait for it
        _until(both, lambda s: _http("GET", s.url("master_http") + "/cluster/healthz")[0] == 200,
               60, "the masters")
        for s in both:
            device = ["--device", "cpu"] if s.name == "port" else []
            s.spawn("volume", ["volume", *device, "-port", str(s.ports["volume"]), "-grpcPort",
                               str(s.ports["volume_grpc"]), "-dir", "./v0", "-mserver",
                               f"127.0.0.1:{s.ports['master']}"])
            s.spawn_filer()
        # readiness = a real write probe, not an HTTP 200: the filer answers
        # reads before the volume tier has heartbeated in
        _until(both, lambda s: _http("PUT", s.url("filer") + "/probe.txt", b"ready")[0] == 201,
               120, "the stacks")
        yield dict(zip(PACKAGES, both))
    finally:
        for s in both:
            s.stop()


def _twin(stacks, steps):
    """`steps(stack)` -> [(status, body)] on each stack: the two compared
    lists must be equal. Returns the port's raw list."""
    got = {name: steps(s) for name, s in stacks.items()}
    seen = {name: [stacks[name].seen(*r) for r in got[name]] for name in got}
    assert seen["port"] == seen["ref"]
    return got["port"]


def test_filer_file_lifecycle_over_http(stacks):
    payload = _payload(0, 9000)

    def steps(s):
        base = s.url("filer")
        return [
            _http("PUT", base + "/proj/a/report.bin", payload),
            _http("GET", base + "/proj/a/report.bin"),
            _http("GET", base + "/proj/a/report.bin", headers={"Range": "bytes=100-299"}),
            _http("POST", base + "/proj/a/final.bin?mv.from=/proj/a/report.bin"),
            _http("GET", base + "/proj/a/final.bin"),
            _http("GET", base + "/proj/a/report.bin"),
            _http("GET", base + "/proj/a"),
            _http("DELETE", base + "/proj/a/final.bin"),
        ]

    put, get, rng, mv, moved, old, listing, delete = _twin(stacks, steps)
    assert put[0] == 201, put
    assert json.loads(put[1])["size"] == len(payload)
    assert get == (200, payload)
    assert rng == (206, payload[100:300])
    assert mv[0] == 200
    assert moved == (200, payload)
    assert old[0] == 404
    assert listing[0] == 200
    assert [e["path"] for e in json.loads(listing[1])["Entries"]] == ["/proj/a/final.bin"]
    assert delete[0] == 204


def test_shell_cli_ec_lifecycle(stacks):
    """The operator surface as an operator drives it: the shell command
    with a -c script against the live processes."""

    def steps(s):
        base = s.url("filer")
        puts = [_http("PUT", f"{base}/bulk/f{i:02d}.bin", _payload(100 + i, 1500))
                for i in range(12)]
        # volume.list prints the master's view: wait for the heartbeat that
        # carries the writes (every 5 s), so that both stacks print the same
        deadline = time.monotonic() + 30
        while s.volume_files(1) != 13 and time.monotonic() < deadline:
            time.sleep(0.3)
        device = ["--device", "cpu"] if s.name == "port" else []
        proc = subprocess.run(
            [sys.executable, "-m", s.pkg, "shell", "-master", f"127.0.0.1:{s.ports['master']}",
             *device, "-c", "lock; volume.list; ec.encode -volumeId 1; ec.rebuild; unlock"],
            cwd=str(s.tmp), env=_env(s.pkg), capture_output=True, timeout=120)
        return [*puts, (proc.returncode, proc.stdout + proc.stderr),
                _http("GET", f"{base}/bulk/f00.bin")]

    *puts, (rc, out), got = _twin(stacks, steps)
    assert all(code == 201 for code, _ in puts)
    assert rc == 0, out.decode()
    assert "ec.encode volume 1" in out.decode(), out.decode()
    assert got == (200, _payload(100, 1500))


def test_filer_restart_preserves_namespace(stacks):
    """SIGKILL the filer and restart it on the same log store: the namespace
    replays (crash recovery, not a graceful shutdown)."""
    payload = b"survives-a-filer-crash"

    def steps(s):
        base = s.url("filer")
        put = _http("PUT", base + "/crash/file.txt", payload)
        s.procs["filer"].send_signal(signal.SIGKILL)
        s.procs["filer"].wait(10)
        s.spawn_filer()
        deadline = time.monotonic() + 60
        while True:
            got = _http("GET", base + "/crash/file.txt")
            if got[0] == 200 or time.monotonic() > deadline:
                return [put, got]
            time.sleep(0.5)

    put, got = _twin(stacks, steps)
    assert put[0] == 201
    assert got == (200, payload), "namespace lost across crash-restart"


def test_master_http_api_across_processes(stacks):
    """The curl workflow against a real master process: /dir/assign, POST
    the blob to the assigned volume server, /dir/lookup resolves it,
    /cluster/healthz answers."""

    def steps(s):
        mh = s.url("master_http")
        assign = _http("GET", mh + "/dir/assign")
        a = json.loads(assign[1])
        vid = a["fid"].split(",", 1)[0]
        return [assign,
                _http("POST", f"http://{a['url']}/{a['fid']}", b"curl workflow"),
                _http("GET", f"{mh}/dir/lookup?volumeId={vid}"),
                _http("GET", f"http://{a['url']}/{a['fid']}"),
                _http("GET", mh + "/cluster/healthz")]

    assign, post, lookup, get, health = _twin(stacks, steps)
    assert assign[0] == 200, assign
    a = json.loads(assign[1])
    assert a["fid"] and a["url"]
    assert post[0] in (200, 201)
    assert lookup[0] == 200 and a["url"] in lookup[1].decode()
    assert get == (200, b"curl workflow")
    assert health[0] == 200


def test_the_filer_command_takes_no_device(tmp_path):
    """The filer runs no kernel: its command has no --device option."""
    proc = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch", "filer", "--device",
                           "cpu"], cwd=str(tmp_path), env=_env("seaweedfs_tpu_torch"),
                          capture_output=True, timeout=120)
    assert proc.returncode == 2 and b"unrecognized arguments: --device" in proc.stderr
