"""The port's storage backends and remote-storage tiering against the
reference's: twins of the six tiering tests in `tests/test_tiering.py`
(its seventh, the benchmark/upload/download commands, has its twin in
`test_torch_bench_tools.py`), each making the reference case's assertions
on both packages with the same seeded needles and the needle clock pinned,
and requiring equal results; a volume tier-moved by either package opened
and read, fetched back and moved again by the other, with the `.tierinfo`
and the remote object byte-equal (tolerance 0); and the S3 vendor: the
port's SigV4 headers equal the reference's under a pinned clock, and both
packages' `S3RemoteStorage` round-trip (and a port volume tiers) against
a stub S3 endpoint served in the test."""

import hashlib
import http.server
import io
import os
import shutil
import threading
import time
import urllib.parse

import numpy as np
import pytest

from seaweedfs_tpu import remote_storage as ref_remote
from seaweedfs_tpu.remote_storage import tier as ref_tier
from seaweedfs_tpu.s3api import auth as ref_auth
from seaweedfs_tpu.shell import CommandEnv as RefCommandEnv
from seaweedfs_tpu.shell import run_command as ref_run_command
from seaweedfs_tpu.storage import backend as ref_backend
from seaweedfs_tpu.storage import needle as ref_needle
from seaweedfs_tpu.storage import volume as ref_volume
from seaweedfs_tpu_torch import remote_storage as port_remote
from seaweedfs_tpu_torch.remote_storage import tier as port_tier
from seaweedfs_tpu_torch.s3api import auth as port_auth
from seaweedfs_tpu_torch.shell import CommandEnv as PortCommandEnv
from seaweedfs_tpu_torch.shell import run_command as port_run_command
from seaweedfs_tpu_torch.storage import backend as port_backend
from seaweedfs_tpu_torch.storage import needle as port_needle
from seaweedfs_tpu_torch.storage import volume as port_volume

from test_torch_cluster import PORT, REF, cluster, strip

PKGS = {
    "ref": dict(remote=ref_remote, tier=ref_tier, backend=ref_backend, needle=ref_needle,
                volume=ref_volume, env=RefCommandEnv, run=ref_run_command, auth=ref_auth,
                cluster=REF),
    "port": dict(remote=port_remote, tier=port_tier, backend=port_backend, needle=port_needle,
                 volume=port_volume, env=PortCommandEnv, run=port_run_command, auth=port_auth,
                 cluster=PORT),
}
T0 = 1_700_000_000_000_000_000


@pytest.fixture
def clock(monkeypatch):
    """Both needle modules stamp from one counter; `reset()` restarts it."""
    state = {}

    def reset():
        state["t"] = iter(range(T0, T0 + (1 << 40), 1_000))

    reset()
    monkeypatch.setattr(ref_needle.time, "time_ns", lambda: next(state["t"]))
    return reset


def twin(scenario, tmp_path, clock=None, **kw):
    """`scenario(p, root, **kw)` on the reference, then on the port, from
    the same root path (emptied between them) and a restarted clock: both
    results must be equal."""
    out = {}
    root = tmp_path / "case"
    for name in ("ref", "port"):
        if root.exists():
            shutil.rmtree(root)
        root.mkdir()
        if clock is not None:
            clock()
        out[name] = scenario(PKGS[name], root, **kw)
    assert out["port"] == out["ref"]
    return out["port"]


def _needles(seed: int = 3, n: int = 19) -> dict:
    rng = np.random.default_rng(seed)
    return {i: rng.integers(0, 256, 100 + i, dtype=np.uint8).tobytes() for i in range(1, n + 1)}


def _write_volume(p, d, vid: int = 7) -> dict:
    needles = _needles()
    v = p["volume"].Volume(str(d), vid)
    for i, data in needles.items():
        v.write_needle(p["needle"].Needle(cookie=0x1234, id=i, data=data))
    v.close()
    return needles


def _sha(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


# -- tests/test_tiering.py twins ----------------------------------------------------------


def _local_vendor(p, root):
    c = p["remote"].LocalRemoteStorage(str(root / "vendor"))
    c.write_file("a/b.dat", b"0123456789")
    size = c.size("a/b.dat")
    assert size == 10
    part = c.read_range("a/b.dat", 2, 4)
    assert part == b"2345"
    c2 = p["remote"].make_remote_client(c.location())
    whole = c2.read_range("a/b.dat", 0, 10)
    assert whole == b"0123456789"
    c.write_stream("big", io.BytesIO(bytes(range(256)) * 5), 1280)
    c.read_to_file("big", str(root / "big.out"), 1280)
    c.delete("a/b.dat")
    c.delete("a/b.dat")  # absent: no error
    with pytest.raises(FileNotFoundError):
        c.size("a/b.dat")
    with pytest.raises(ValueError):
        c.write_file("../escape", b"x")
    with pytest.raises(ValueError, match="unknown remote storage vendor"):
        p["remote"].make_remote_client({"vendor": "gcs"})
    return {"size": size, "part": part, "whole": whole, "location": c.location(),
            "big": (root / "big.out").read_bytes(), "files": sorted(os.listdir(root / "vendor"))}


def test_local_vendor_roundtrip(tmp_path):
    twin(_local_vendor, tmp_path)


def _memory_mapped(p, root):
    path = root / "m.bin"
    path.write_bytes(b"abcdefgh")
    mm = p["backend"].MemoryMappedFile(str(path))
    mm.seek(2)
    first = mm.read(3)
    assert first == b"cde"
    assert mm.tell() == 5
    mm.seek(-2, os.SEEK_END)
    tail = mm.read()
    assert tail == b"gh"
    mm.seek(1, os.SEEK_SET)
    mm.seek(2, os.SEEK_CUR)
    mid = mm.read(2)
    with pytest.raises(IOError):
        mm.write(b"x")
    mm.close()
    disk = p["backend"].DiskFile(str(root / "d.bin"))
    disk.write(b"xyz")
    disk.seek(1)
    on_disk = disk.read()
    disk.close()
    return [first, tail, mid, on_disk]


def test_memory_mapped_backend(tmp_path):
    twin(_memory_mapped, tmp_path)


def _remote_dat(p, root):
    c = p["remote"].LocalRemoteStorage(str(root / "v"))
    c.write_file("k", b"0123456789")
    r = p["backend"].RemoteDatFile(c, "k")
    r.seek(0, os.SEEK_END)
    end = r.tell()
    assert end == 10
    r.seek(3)
    mid = r.read(4)
    assert mid == b"3456"
    rest = r.read(100)
    assert rest == b"789"  # clamped at EOF
    assert r.read(5) == b""
    with pytest.raises(IOError):
        r.write(b"x")
    return [end, mid, rest]


def test_remote_dat_file(tmp_path):
    twin(_remote_dat, tmp_path)


def _tier_roundtrip(p, root):
    needles = _write_volume(p, root)
    dat = (root / "7.dat").read_bytes()
    vendor = p["remote"].LocalRemoteStorage(str(root / "cold"))
    info = p["tier"].tier_move(os.path.join(str(root), "7"), vendor)
    assert not os.path.exists(root / "7.dat")
    assert os.path.exists(root / "7.tierinfo")
    assert vendor.size(info["key"]) == info["size"]
    with pytest.raises(IOError, match="already tiered"):
        p["tier"].tier_move(os.path.join(str(root), "7"), vendor)
    tv = p["volume"].Volume(str(root), 7)
    assert tv.tiered and tv.read_only
    for i, data in needles.items():
        assert tv.read_needle(i).data == data
    snapshot = tv.stats_snapshot()
    with pytest.raises(p["volume"].VolumeReadOnly):
        tv.write_needle(p["needle"].Needle(cookie=1, id=99, data=b"x"))
    with pytest.raises(IOError):
        tv.compact()
    expired = tv.is_expired()
    tv.close()
    p["tier"].tier_fetch(os.path.join(str(root), "7"))
    assert os.path.exists(root / "7.dat")
    assert not os.path.exists(root / "7.tierinfo")
    lv = p["volume"].Volume(str(root), 7)
    assert not lv.tiered
    assert lv.read_needle(5).data == needles[5]
    lv.close()
    return {"info": info, "dat": dat, "remote": (root / "cold" / info["key"]).read_bytes(),
            "fetched": (root / "7.dat").read_bytes(), "snapshot": snapshot,
            "expired": expired}


def test_volume_tier_move_and_read_back(tmp_path, clock):
    out = twin(_tier_roundtrip, tmp_path, clock)
    assert out["remote"] == out["dat"] == out["fetched"]


def _tier_rpc(p, root):
    pkg = p["cluster"]
    with cluster(pkg, root, n=1, heartbeat=0.4) as (master, (vs,), client):
        res = client.submit(b"tiered needle payload")
        vid = int(res.fid.split(",")[0])
        with pkg.rpc.RpcClient(vs.grpc_address) as c:
            c.call(pkg.VOLUME_SERVICE, "VolumeMarkReadonly", {"volume_id": vid})
            moved = c.call(pkg.VOLUME_SERVICE, "VolumeTierMove", {
                "volume_id": vid,
                "destination": {"vendor": "local", "root": str(root / "cold")}})
            assert moved["size"] > 0
        tiered = client.read(res.fid)
        assert tiered == b"tiered needle payload"
        with pkg.rpc.RpcClient(vs.grpc_address) as c:
            fetched = c.call(pkg.VOLUME_SERVICE, "VolumeTierFetch", {"volume_id": vid})
        back = client.read(res.fid)
        assert back == b"tiered needle payload"
        return {"moved": moved, "fetched": fetched, "reads": [tiered, back]}


def test_tier_move_rpc_and_cluster_read(tmp_path):
    twin(_tier_rpc, tmp_path)


def _shell_tier(p, root):
    pkg = p["cluster"]
    with cluster(pkg, root, n=1, heartbeat=0.4) as (master, _servers, client):
        res = client.submit(b"shell tier data")
        vid = int(res.fid.split(",")[0])
        with p["env"](master.address) as env:
            out = io.StringIO()
            p["run"](env, "lock", out)
            p["run"](env, f"volume.tier.move -volumeId {vid} -dest local:{root}/cold2", out)
            assert "bytes ->" in out.getvalue()
            tiered = client.read(res.fid)
            assert tiered == b"shell tier data"
            p["run"](env, f"volume.tier.fetch -volumeId {vid}", out)
            assert "local again" in out.getvalue()
            back = client.read(res.fid)
            assert back == b"shell tier data"
            return {"out": strip(out.getvalue()), "reads": [tiered, back]}


def test_shell_tier_commands(tmp_path):
    twin(_shell_tier, tmp_path)


# -- a volume tiered by one package, served by the other ----------------------------------


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_tiered_volume_crosses_packages(tmp_path, clock, writer, reader):
    """The writer builds and tier-moves volume 7; the reader opens it through
    its RemoteDatFile and reads every needle byte-equal, fetches the .dat
    back byte-equal, and moves it again: the same key, the same remote
    bytes and the same `.tierinfo` bytes as the writer's; the writer then
    serves the reader's tiered volume."""
    w, r = PKGS[writer], PKGS[reader]
    base = os.path.join(str(tmp_path), "7")
    needles = _write_volume(w, tmp_path)
    dat = (tmp_path / "7.dat").read_bytes()
    info = w["tier"].tier_move(base, w["remote"].LocalRemoteStorage(str(tmp_path / "cold")))
    tierinfo = (tmp_path / "7.tierinfo").read_bytes()
    assert info["key"] == "volumes/7.dat" and (tmp_path / "cold" / info["key"]).read_bytes() == dat
    tv = r["volume"].Volume(str(tmp_path), 7)
    assert tv.tiered and tv.read_only
    assert isinstance(tv._dat, r["backend"].RemoteDatFile)
    for i, data in needles.items():
        assert tv.read_needle(i).data == data
    tv.close()
    r["tier"].tier_fetch(base)
    assert (tmp_path / "7.dat").read_bytes() == dat
    os.remove(tmp_path / "cold" / info["key"])
    again = r["tier"].tier_move(base, r["remote"].LocalRemoteStorage(str(tmp_path / "cold")))
    assert again == info
    assert (tmp_path / "7.tierinfo").read_bytes() == tierinfo
    assert (tmp_path / "cold" / again["key"]).read_bytes() == dat
    back = w["volume"].Volume(str(tmp_path), 7)
    assert back.tiered
    assert {i: back.read_needle(i).data for i in needles} == needles
    back.close()


# -- the S3 vendor -------------------------------------------------------------------------


@pytest.fixture
def pinned_gmtime(monkeypatch):
    fixed = time.gmtime(1_700_000_000)
    monkeypatch.setattr(time, "gmtime", lambda *a: fixed)
    return fixed


@pytest.mark.parametrize("method,url,payload,extra", [
    ("GET", "http://127.0.0.1:8333/bucket/volumes/7.dat", b"", None),
    ("PUT", "http://127.0.0.1:8333/bucket/volumes/a%20b%2Bc.dat", b"needle bytes" * 99,
     {"Content-Type": "application/octet-stream"}),
    ("HEAD", "http://s3.example:9000/b/k?versionId=3&list-type=2&prefix=a+b", b"", None),
    ("DELETE", "http://s3.example:9000/b/dir/%E2%9C%93", b"", {"X-Amz-Meta-K": "v  w"}),
])
def test_sign_request_headers_equal_the_reference(pinned_gmtime, method, url, payload, extra):
    for ak, sk in (("AKIDEXAMPLE", "wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY"), ("", "")):
        got = port_auth.sign_request(ak, sk, method, url, payload, extra_headers=extra)
        want = ref_auth.sign_request(ak, sk, method, url, payload, extra_headers=extra)
        assert got == want
        assert got["x-amz-date"] == "20231114T221320Z"
    assert port_auth._canonical_query("b=2&a=1&a=0") == ref_auth._canonical_query("b=2&a=1&a=0")


class _StubS3(http.server.BaseHTTPRequestHandler):
    """PUT/GET (with Range)/HEAD/DELETE over a dict; every request's headers
    are kept, so the test can check what was signed."""

    objects: dict = {}
    seen: list = []

    def log_message(self, *a):
        pass

    def _key(self):
        return urllib.parse.unquote(self.path.split("?", 1)[0])

    def do_PUT(self):
        n = int(self.headers.get("Content-Length", 0))
        self.seen.append(("PUT", self._key(), dict(self.headers)))
        self.objects[self._key()] = self.rfile.read(n)
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def do_GET(self):
        self.seen.append(("GET", self._key(), dict(self.headers)))
        data = self.objects.get(self._key())
        if data is None:
            self.send_error(404)
            return
        rng = self.headers.get("Range")
        if rng:
            lo, hi = (int(x) for x in rng.split("=", 1)[1].split("-"))
            data = data[lo:hi + 1]
        self.send_response(206 if rng else 200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_HEAD(self):
        self.seen.append(("HEAD", self._key(), dict(self.headers)))
        data = self.objects.get(self._key())
        if data is None:
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()

    def do_DELETE(self):
        self.seen.append(("DELETE", self._key(), dict(self.headers)))
        if self.objects.pop(self._key(), None) is None:
            self.send_error(404)
            return
        self.send_response(204)
        self.end_headers()


@pytest.fixture
def stub_s3():
    _StubS3.objects, _StubS3.seen = {}, []
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _StubS3)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"127.0.0.1:{srv.server_address[1]}", _StubS3
    srv.shutdown()
    srv.server_close()


def _s3_roundtrip(p, root, endpoint, stub):
    stub.objects.clear()
    stub.seen.clear()
    c = p["remote"].S3RemoteStorage(endpoint, "bucket", "AKID", "SECRET")
    data = bytes(range(256)) * 40
    c.write_file("volumes/a b.dat", data)
    size = c.size("volumes/a b.dat")
    part = c.read_range("volumes/a b.dat", 100, 300)
    c2 = p["remote"].make_remote_client(c.location())
    c2.read_to_file("volumes/a b.dat", str(root / "got.bin"), size)
    c.delete("volumes/a b.dat")
    c.delete("volumes/a b.dat")  # 404: not an error
    with pytest.raises(Exception):
        c.size("volumes/a b.dat")
    # what the stub saw: the signed headers of each request, with the
    # SigV4 client's own names
    signed = [(m, k, {h.lower(): v for h, v in hs.items()
                      if h.lower() in ("authorization", "x-amz-date", "x-amz-content-sha256",
                                       "range")})
              for m, k, hs in stub.seen]
    return {"size": size, "part": part, "got": (root / "got.bin").read_bytes() == data,
            "location": c.location(), "signed": signed}


def test_s3_vendor_roundtrip_against_a_stub_endpoint(tmp_path, pinned_gmtime, stub_s3):
    endpoint, stub = stub_s3
    out = twin(_s3_roundtrip, tmp_path, endpoint=endpoint, stub=stub)
    assert out["size"] == 10240 and out["part"] == (bytes(range(256)) * 40)[100:400]
    assert out["signed"][0][0] == "PUT" and out["signed"][0][1] == "/bucket/volumes/a b.dat"
    assert all(s["authorization"].startswith("AWS4-HMAC-SHA256 Credential=AKID/20231114/")
               for _, _, s in out["signed"])


def test_volume_tiers_to_the_s3_vendor(tmp_path, clock, stub_s3):
    """A port volume moved to the stub S3 endpoint: the object is the .dat,
    the `.tierinfo` is the reference's for the same move, and both packages
    read every needle through it."""
    endpoint, stub = stub_s3
    base = os.path.join(str(tmp_path), "7")
    needles = _write_volume(PKGS["port"], tmp_path)
    dat = (tmp_path / "7.dat").read_bytes()
    info = port_tier.tier_move(base, port_remote.S3RemoteStorage(endpoint, "cold", "ak", "sk"))
    assert stub.objects["/cold/volumes/7.dat"] == dat
    tierinfo = (tmp_path / "7.tierinfo").read_bytes()
    for p in (PKGS["port"], PKGS["ref"]):
        v = p["volume"].Volume(str(tmp_path), 7)
        assert v.tiered and {i: v.read_needle(i).data for i in needles} == needles
        v.close()
    ref_tier.tier_fetch(base)
    stub.objects.clear()
    again = ref_tier.tier_move(base, ref_remote.S3RemoteStorage(endpoint, "cold", "ak", "sk"))
    assert again == info and (tmp_path / "7.tierinfo").read_bytes() == tierinfo
    assert _sha(tmp_path / "7.tierinfo") == hashlib.sha256(tierinfo).hexdigest()
