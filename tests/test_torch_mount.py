"""The port's mount (WFS and its dirty pages) against the reference's: a
twin of each of the 7 cases of `tests/test_mount.py`, with the reference
case's own steps and assertions run on the port (the WFS cases on a port
stack: master, one volume server on `Encoder(10, 4, device="cpu")`,
filer with 64 KiB chunks); then cross-package cases (at the end),
tolerance 0: `DirtyPages` gives an equal overlay and drain for a seeded
write and truncate script, one seeded WFS script gives equal bytes and
entries on a stack of each package (mtime and the other stamps, and fids,
masked), and without a fusepy module both `mount` commands exit 2 with
the same message."""

import os

import numpy as np
import pytest

from seaweedfs_tpu_torch.cluster.master import MasterServer
from seaweedfs_tpu_torch.cluster.volume_server import VolumeServer
from seaweedfs_tpu_torch.filer import FilerServer
from seaweedfs_tpu_torch.mount import WFS, DirtyPages
from seaweedfs_tpu_torch.ops.rs_codec import Encoder

import seaweedfs_tpu.mount as ref_mount
import seaweedfs_tpu_torch.mount as port_mount

from test_torch_cluster import stop_all
from test_torch_filer import PORT as PORT_FILER
from test_torch_filer import REF as REF_FILER
from test_torch_filer import mask

PKGS = {"ref": (ref_mount, REF_FILER), "port": (port_mount, PORT_FILER)}


# -- page writer (pure) -------------------------------------------------------


def test_dirty_pages_merge_and_overlay():
    dp = DirtyPages()
    dp.write(0, b"aaaa")
    dp.write(10, b"bbbb")
    assert dp.byte_count == 8 and dp.max_extent() == 14
    # bridge the gap: everything coalesces into one run
    dp.write(4, b"cccccc")
    assert len(dp._runs) == 1 and dp._runs[0] == (0, bytearray(b"aaaaccccccbbbb"))
    # overlap: latest write wins
    dp.write(2, b"XX")
    buf = bytearray(14)
    dp.read_overlay(0, buf)
    assert bytes(buf[:10]) == b"aaXXcccccc"
    runs = dp.drain()
    assert not dp.dirty
    assert runs[0][0] == 0 and runs[0][1][:10] == b"aaXXcccccc"


def test_dirty_pages_adjacent_coalesce():
    dp = DirtyPages()
    dp.write(0, b"1111")
    dp.write(4, b"2222")  # adjacent -> single run
    assert len(dp._runs) == 1 and dp._runs[0][1] == bytearray(b"11112222")
    dp.truncate(6)
    assert dp.max_extent() == 6


# -- WFS over a live stack ----------------------------------------------------


@pytest.fixture(scope="module")
def wfs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mnt")
    master = MasterServer(port=0, reap_interval=3600)
    master.start()
    (tmp / "vol").mkdir()
    vs = VolumeServer([str(tmp / "vol")], master.address, heartbeat_interval=0.4,
                      encoder=Encoder(10, 4, device="cpu"))
    vs.start()
    fs = FilerServer(master.address, chunk_size=64 * 1024)
    fs.start()
    w = WFS(fs.grpc_address, auto_flush_bytes=256 * 1024)
    yield w
    w.close()
    stop_all([fs, vs, master])


def test_wfs_create_write_read(wfs):
    fh = wfs.create("/docs/hello.txt")
    fh.write(0, b"hello ")
    fh.write(6, b"world")
    assert fh.read(0, 100) == b"hello world"  # read-your-writes pre-flush
    fh.flush()
    fh.release()
    a = wfs.getattr("/docs/hello.txt")
    assert a is not None and a.size == 11 and not a.is_dir
    fh2 = wfs.open("/docs/hello.txt")
    assert fh2.read(0, 11) == b"hello world"
    assert fh2.read(6, 5) == b"world"
    fh2.release()


def test_wfs_random_writes_and_big_file(wfs):
    payload = bytearray(os.urandom(300 * 1024))  # crosses chunk + autoflush
    fh = wfs.create("/docs/big.bin")
    for off in range(0, len(payload), 50 * 1024):
        fh.write(off, bytes(payload[off : off + 50 * 1024]))
    # overwrite a window in the middle (random write)
    patch = os.urandom(10_000)
    payload[123_456 : 123_456 + len(patch)] = patch
    fh.write(123_456, patch)
    fh.flush()
    fh.release()
    fh = wfs.open("/docs/big.bin")
    assert fh.size == len(payload)
    got = fh.read(0, len(payload))
    assert got == bytes(payload)
    assert fh.read(123_000, 11_000) == bytes(payload[123_000:134_000])
    fh.release()


def test_wfs_truncate(wfs):
    fh = wfs.create("/docs/trunc.bin")
    fh.write(0, b"0123456789")
    fh.flush()
    fh.truncate(4)
    fh.flush()
    fh.release()
    fh = wfs.open("/docs/trunc.bin")
    assert fh.size == 4 and fh.read(0, 10) == b"0123"
    # extend-past-truncate via sparse write
    fh.write(8, b"ZZ")
    fh.flush()
    assert fh.read(0, 10) == b"0123\x00\x00\x00\x00ZZ"
    fh.release()


def test_wfs_dirs_and_rename(wfs):
    wfs.mkdir("/d1")
    fh = wfs.create("/d1/f.txt")
    fh.write(0, b"x")
    fh.release()
    names = [a.path for a in wfs.readdir("/d1")]
    assert names == ["/d1/f.txt"]
    with pytest.raises(OSError):
        wfs.rmdir("/d1")  # not empty
    wfs.rename("/d1/f.txt", "/d1/g.txt")
    assert wfs.getattr("/d1/f.txt") is None
    assert wfs.open("/d1/g.txt").read(0, 1) == b"x"
    wfs.unlink("/d1/g.txt")
    wfs.rmdir("/d1")
    assert wfs.getattr("/d1") is None


def test_wfs_open_semantics(wfs):
    with pytest.raises(FileNotFoundError):
        wfs.open("/nope")
    wfs.mkdir("/adir")
    with pytest.raises(IsADirectoryError):
        wfs.open("/adir")
    wfs.rmdir("/adir")


# -- across the packages ------------------------------------------------------


def _dirty_pages_script(mount) -> list:
    """Seeded writes (overlapping, adjacent, disjoint) and truncates through
    the package's DirtyPages -> every overlay, extent and drain."""
    rng = np.random.default_rng(17)
    dp = mount.DirtyPages()
    out = []
    for step in range(400):
        op = rng.integers(0, 10)
        if op < 7:
            off = int(rng.integers(0, 1 << 16))
            dp.write(off, rng.bytes(int(rng.integers(0, 3000))))
        elif op < 9:
            dp.truncate(int(rng.integers(0, 1 << 16)))
        else:
            out.append(("drain", dp.drain()))
        buf = bytearray(int(rng.integers(1, 8000)))
        start = int(rng.integers(0, 1 << 16))
        dp.read_overlay(start, buf)
        out.append((step, dp.dirty, dp.byte_count, dp.max_extent(), start, bytes(buf),
                    [(o, bytes(b)) for o, b in dp._runs]))
    out.append(("drain", dp.drain()))
    return out


def test_dirty_pages_give_equal_overlays_and_drains():
    out = {name: _dirty_pages_script(mount) for name, (mount, _) in PKGS.items()}
    assert out["port"] == out["ref"]
    assert sum(1 for rec in out["port"] if rec[0] == "drain" and rec[1]) > 5


def _wfs_script(mount, f, root) -> dict:
    """One seeded WFS script (directories, seeded writes across chunks and
    the auto-flush, an overwrite, a truncate, a sparse extend, renames, an
    unlink) on a stack of the package -> the bytes read back and every
    entry, stamps and fids masked."""
    c = f.cluster
    master = c.MasterServer(port=0, reap_interval=3600)
    master.start()
    (root / "vol").mkdir()
    vs = c.VolumeServer([str(root / "vol")], master.address, heartbeat_interval=0.4,
                        encoder=c.encoder())
    vs.start()
    fs = f.FilerServer(master.address, chunk_size=64 * 1024)
    fs.start()
    rng = np.random.default_rng(23)
    reads = []
    try:
        with mount.WFS(fs.grpc_address, auto_flush_bytes=96 * 1024) as w:
            w.mkdir("/m")
            w.mkdir("/m/sub")
            for i in range(4):
                fh = w.create(f"/m/sub/f{i}.bin")
                size = int(rng.integers(1, 200_000))
                for _ in range(int(rng.integers(1, 12))):
                    off = int(rng.integers(0, size))
                    fh.write(off, rng.bytes(int(rng.integers(1, 40_000))))
                reads.append(fh.read(0, 1 << 20))
                fh.flush()
                if i % 2:
                    fh.truncate(int(rng.integers(0, size)))
                    fh.write(int(rng.integers(0, size)), rng.bytes(500))
                fh.release()
            w.rename("/m/sub/f1.bin", "/m/f1-moved.bin")
            w.unlink("/m/sub/f2.bin")
            for path in ("/m/sub/f0.bin", "/m/f1-moved.bin", "/m/sub/f3.bin"):
                fh = w.open(path)
                reads.append(fh.read(0, fh.size))
                reads.append(fh.read(int(rng.integers(0, max(fh.size, 1))), 70_000))
                fh.release()
            listing = [(a.path, a.is_dir, a.size, a.mode) for a in w.readdir("/m")]
            listing += [(a.path, a.is_dir, a.size, a.mode) for a in w.readdir("/m/sub")]
            entries = [mask(fs.filer.find_entry(p).to_dict())
                       for p in ("/m", "/m/sub", "/m/sub/f0.bin", "/m/f1-moved.bin",
                                 "/m/sub/f3.bin")]
    finally:
        stop_all([fs, vs, master])
    return {"reads": reads, "listing": listing, "entries": entries}


def test_one_wfs_script_gives_equal_bytes_and_entries(tmp_path):
    out = {}
    for name, (mount, f) in PKGS.items():
        (tmp_path / name).mkdir()
        out[name] = _wfs_script(mount, f, tmp_path / name)
    assert out["port"] == out["ref"]
    assert sum(len(r) for r in out["port"]["reads"]) > 300_000


def test_the_mount_command_without_fuse_exits_2_as_the_reference(tmp_path, capsys):
    """Without a fusepy module (none here) both packages' `mount` command
    print how to use the in-process WFS API instead and exit 2."""
    from seaweedfs_tpu.__main__ import main as ref_main
    from seaweedfs_tpu_torch.__main__ import main as port_main
    from seaweedfs_tpu_torch.mount.fuse_adapter import fuse_available

    assert not fuse_available()
    said = {}
    for name, main in (("ref", ref_main), ("port", port_main)):
        assert main(["mount", "-filerGrpc", "127.0.0.1:1", "-dir", str(tmp_path)]) == 2
        said[name] = capsys.readouterr().err
    assert said["port"] == said["ref"].replace("seaweedfs_tpu.", "seaweedfs_tpu_torch.")
    assert "kernel FUSE unavailable" in said["port"]
