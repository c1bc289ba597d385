"""The port's fs.* and s3.* shell commands, its filer's registration with
the master and its TTL enforcement against the reference's: a twin of each
filer case of `tests/test_fs_shell.py` (`fs_commands_roundtrip`,
`filer_ttl_expiry`, `fs_tree`, `fs_configure_rules`, `volume_fsck`, both
`fs_configure_readonly_*`, `fs_cd_pwd_relative_paths`, `s3_bucket_commands`,
`fs_meta_cat_and_s3_clean_uploads`, `filer_meta_tail_cli` and
`filer_copy_cli`), each running
the reference case's steps and assertions on a stack of each package (a
master, a volume server on the package's CPU encoder, a filer) and
requiring the shell's output, the HTTP codes and the namespace to be equal
(tolerance 0); and `fs.meta.save` across the packages: the dump of the
same namespace is byte-equal, and a dump saved by either package loads
into the other's filer and saves back to the same bytes; and both
packages' `filer.meta.tail` on one filer print identical lines.

Stamps: the cluster twins compare the namespace with stamps and fids
masked (`test_torch_filer.mask`; `fs.ls -l` prints a local time, masked
the same way); the byte-equal dumps pin both packages' filer clocks
(`test_torch_filer.pin_clock`) and seed both masters' cookies."""

import contextlib
import io
import json
import random
import re
import time
import types
import urllib.error
import urllib.request

import grpc
import pytest

import seaweedfs_tpu.shell as ref_shell
import seaweedfs_tpu_torch.shell as port_shell
from seaweedfs_tpu.__main__ import main as ref_main
from seaweedfs_tpu_torch.__main__ import main as port_main

from test_torch_cluster import stop_all
from test_torch_filer import PORT as PORT_FILER
from test_torch_filer import REF as REF_FILER
from test_torch_filer import mask, pin_clock

REF = types.SimpleNamespace(name="ref", shell=ref_shell, f=REF_FILER, c=REF_FILER.cluster,
                            main=ref_main)
PORT = types.SimpleNamespace(name="port", shell=port_shell, f=PORT_FILER, c=PORT_FILER.cluster,
                             main=port_main)


def _listed_filers(p, master) -> list:
    with p.c.rpc.RpcClient(master.address) as c:
        return c.call(p.c.MASTER_SERVICE, "ListClusterNodes", {}).get("filers", [])


@contextlib.contextmanager
def stack(p, root, **fs_kw):
    """The reference case's `stack` fixture for one package: a master (its
    cookies seeded), a volume server and a filer that has announced itself
    to the master."""
    master = p.c.MasterServer(port=0, reap_interval=3600)
    master._rng = random.Random(11)
    master.start()
    (root / "vol").mkdir()
    vs = p.c.VolumeServer([str(root / "vol")], master.address, heartbeat_interval=0.4,
                          encoder=p.c.encoder())
    vs.start()
    fs = p.f.FilerServer(master.address, **fs_kw)
    fs.start()
    try:
        deadline = time.monotonic() + 10
        while not _listed_filers(p, master):
            assert time.monotonic() < deadline, "the filer never announced itself"
            time.sleep(0.05)
        yield master, vs, fs
    finally:
        stop_all([fs, vs, master])


def twin(scenario, tmp_path, **kw):
    out = {}
    for p in (REF, PORT):
        root = tmp_path / p.name
        root.mkdir()
        with stack(p, root) as (master, vs, fs):
            out[p.name] = scenario(p, root, master, vs, fs, **kw)
    assert out["port"] == out["ref"]
    return out["port"]


def _run(p, env, line):
    out = io.StringIO()
    p.shell.run_command(env, line, out)
    return out.getvalue()


def _local_times(text: str) -> str:
    return re.sub(r"\d{4}-\d\d-\d\d \d\d:\d\d", "<mtime>", text)


def _tree(fs) -> list:
    return mask([e.to_dict() for e in fs.filer.walk("/")])


def _code(method, url, data=None) -> int:
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


# -- tests/test_fs_shell.py twins -----------------------------------------------------------


def _fs_commands_roundtrip(p, root, master, vs, fs):
    fs.write_file("/fsdemo/a/hello.txt", io.BytesIO(b"hello fs"))
    fs.write_file("/fsdemo/b.bin", io.BytesIO(b"12345"))
    out = {}
    with p.shell.CommandEnv(master.address) as env:
        out["ls"] = _run(p, env, "fs.ls /fsdemo")
        assert "a/" in out["ls"]
        listing = _run(p, env, "fs.ls -l /fsdemo")
        assert "b.bin" in listing and "5" in listing
        out["ls_l"] = _local_times(listing)
        assert _run(p, env, "fs.cat /fsdemo/a/hello.txt") == "hello fs"
        out["mkdir"] = _run(p, env, "fs.mkdir /fsdemo/newdir")
        assert "newdir/" in _run(p, env, "fs.ls /fsdemo")
        out["mv"] = _run(p, env, "fs.mv /fsdemo/b.bin /fsdemo/newdir/b.bin")
        assert "b.bin" in _run(p, env, "fs.ls /fsdemo/newdir")
        out["du"] = _run(p, env, "fs.du /fsdemo")
        assert "2 files" in out["du"] and "13 bytes" in out["du"]
        dump = str(root / "meta.jsonl")
        out["save"] = _run(p, env, f"fs.meta.save -o {dump} /fsdemo").replace(str(root), "<root>")
        assert "saved" in out["save"]
        with open(dump) as f:
            out["dump"] = [mask(json.loads(line)) for line in f]
        env.filer_client().delete("/fsdemo", recursive=True, delete_data=False)
        assert _run(p, env, "fs.ls /fsdemo") == ""
        out["load"] = _run(p, env, f"fs.meta.load -i {dump}").replace(str(root), "<root>")
        assert "loaded" in out["load"]
        assert _run(p, env, "fs.cat /fsdemo/a/hello.txt") == "hello fs"
    out["tree"] = _tree(fs)
    return out


def test_fs_commands_roundtrip(tmp_path):
    twin(_fs_commands_roundtrip, tmp_path)


def _filer_ttl_expiry(p, root, master, vs, fs):
    entry = fs.write_file("/ttl/ephemeral.txt", io.BytesIO(b"short-lived"))
    entry.attributes.ttl_sec = 1
    entry.attributes.mtime = time.time() - 10
    fs.filer.update_entry(entry)
    with pytest.raises(p.f.EntryNotFound):
        fs.filer.find_entry("/ttl/ephemeral.txt")
    listed = fs.filer.list_entries("/ttl")
    assert all(e.name != "ephemeral.txt" for e in listed)
    fid = entry.chunks[0].fid
    with pytest.raises(p.c.ClusterError):  # the reaper reclaimed its chunk
        fs.master.read(fid)
    return {"listed": [e.name for e in listed], "tree": _tree(fs)}


def test_filer_ttl_expiry(tmp_path):
    twin(_filer_ttl_expiry, tmp_path)


def _fs_tree(p, root, master, vs, fs):
    fs.write_file("/treedemo/x/one.txt", io.BytesIO(b"1"))
    fs.write_file("/treedemo/x/y/two.txt", io.BytesIO(b"22"))
    fs.write_file("/treedemo/three.txt", io.BytesIO(b"333"))
    with p.shell.CommandEnv(master.address) as env:
        out = _run(p, env, "fs.tree /treedemo")
        assert "x/" in out and "one.txt" in out and "two.txt" in out
        assert "2 directories, 3 files" in out
        return out


def test_fs_tree(tmp_path):
    twin(_fs_tree, tmp_path)


def _fs_configure_rules(p, root, master, vs, fs):
    out = {}
    with p.shell.CommandEnv(master.address) as env:
        out["empty"] = _run(p, env, "fs.configure")
        assert "no rules" in out["empty"]
        out["dry"] = _run(p, env, "fs.configure -locationPrefix /confdemo/hot/ -collection hotcoll")
        assert "dry" in out["dry"]
        out["set"] = [
            _run(p, env, "fs.configure -locationPrefix /confdemo/hot/ -collection hotcoll -apply"),
            _run(p, env, "fs.configure -locationPrefix /confdemo/frozen/ -readOnly -apply")]
        listing = _run(p, env, "fs.configure")
        assert "/confdemo/hot/" in listing and "hotcoll" in listing
        assert "readOnly=True" in listing
        out["listing"] = listing
        assert _code("PUT", f"http://{fs.url}/confdemo/hot/a.bin", b"x" * 100) == 201
        entry = fs.filer.find_entry("/confdemo/hot/a.bin")
        assert entry.chunks
        vid = int(entry.chunks[0].fid.split(",", 1)[0])
        v = vs.store.get_volume(vid)
        assert v is not None and v.collection == "hotcoll"
        out["collection"] = (entry.attributes.collection, v.collection)
        out["frozen"] = [_code("PUT", f"http://{fs.url}/confdemo/frozen/b.bin", b"nope"),
                         _code("DELETE", f"http://{fs.url}/confdemo/frozen/b.bin")]
        assert out["frozen"] == [403, 403]
        out["delete"] = _run(p, env, "fs.configure -locationPrefix /confdemo/frozen/ -delete -apply")
        assert _code("PUT", f"http://{fs.url}/confdemo/frozen/b.bin", b"now ok") == 201
        reloaded = p.f.FilerConf.from_json(fs.filer.store.kv_get(p.f.conf.CONF_KEY))
        assert [r.location_prefix for r in reloaded.rules] == ["/confdemo/hot/"]
        assert reloaded.match("/confdemo/hot/x").collection == "hotcoll"
        out["kv"] = fs.filer.store.kv_get(p.f.conf.CONF_KEY)
    out["tree"] = _tree(fs)
    return out


def test_fs_configure_rules(tmp_path):
    """The rule set's KV value is byte-equal."""
    twin(_fs_configure_rules, tmp_path)


def _volume_fsck(p, root, master, vs, fs):
    fs.write_file("/fsckdemo/keep.bin", io.BytesIO(b"k" * 500))
    mc = p.c.MasterClient(master.address)
    try:
        orphan = mc.submit(b"o" * 300)
        lost = fs.write_file("/fsckdemo/lost.bin", io.BytesIO(b"l" * 400))
        lost_fid = lost.chunks[0].fid
        mc.delete(lost_fid)
    finally:
        mc.close()
    out = {}
    with p.shell.CommandEnv(master.address) as env:
        _run(p, env, "lock")
        text = _run(p, env, "volume.fsck")
        assert "spared" in text and "found 0 orphan" in text
        l_vid = lost_fid.split(",", 1)[0]
        l_nid = int(lost_fid.split(",", 1)[1][:-8], 16)
        assert f"volume {l_vid}: needle {l_nid:x} referenced but MISSING" in text
        out["report"] = text
        text = _run(p, env, "volume.fsck -reallyDeleteFromVolume")
        assert "spared" in text and "deleted 0 orphan" in text
        out["spared"] = text
        text = _run(p, env, "volume.fsck -cutoffTimeAgo 0")
        assert "orphan needles" in text and "found 0" not in text
        o_vid, o_hex = orphan.fid.split(",", 1)
        assert f"needle {int('0x' + o_hex[:-8], 16):x}" not in text
        out["counted"] = text
        out["purge"] = _run(p, env, "volume.fsck -reallyDeleteFromVolume -cutoffTimeAgo 0")
        assert "deleted" in out["purge"]
        out["clean"] = _run(p, env, "volume.fsck")
        assert "found 0 orphan needles" in out["clean"]
        _run(p, env, "unlock")
    assert fs.read_file(fs.filer.find_entry("/fsckdemo/keep.bin")) == b"k" * 500
    return out


def test_volume_fsck(tmp_path):
    twin(_volume_fsck, tmp_path)


def _readonly_enforced_on_grpc_surface(p, root, master, vs, fs):
    fs.write_file("/grpclock/keep.txt", io.BytesIO(b"safe"))
    codes = []
    with p.shell.CommandEnv(master.address) as env:
        _run(p, env, "fs.configure -locationPrefix /grpclock/ -readOnly -apply")
        with p.f.FilerClient(fs.grpc_address) as fc:
            with pytest.raises(grpc.RpcError) as ei:
                fc.delete("/grpclock/keep.txt")
            assert ei.value.code() == grpc.StatusCode.PERMISSION_DENIED
            codes.append(ei.value.code())
            for call in (lambda: fc.create(p.f.Entry(path="/grpclock/new.txt")),
                         lambda: fc.rename("/grpclock/keep.txt", "/elsewhere/keep.txt"),
                         lambda: fc.rename("/probe.txt", "/grpclock/stolen.txt")):
                with pytest.raises(grpc.RpcError) as ei:
                    call()
                codes.append(ei.value.code())
        assert fs.read_file(fs.filer.find_entry("/grpclock/keep.txt")) == b"safe"
        _run(p, env, "fs.configure -locationPrefix /grpclock/ -delete -apply")
        with p.f.FilerClient(fs.grpc_address) as fc:
            fc.delete("/grpclock/keep.txt")
    return {"codes": [c.name for c in codes], "tree": _tree(fs)}


def test_fs_configure_readonly_enforced_on_grpc_surface(tmp_path):
    twin(_readonly_enforced_on_grpc_surface, tmp_path)


def _readonly_protects_ancestor_ops(p, root, master, vs, fs):
    fs.write_file("/anc/frozen/keep.txt", io.BytesIO(b"x"))
    errors = []
    with p.shell.CommandEnv(master.address) as env:
        _run(p, env, "fs.configure -locationPrefix /anc/frozen/ -readOnly -apply")
        try:
            for op in (lambda: fs.filer.delete_entry("/anc/frozen", recursive=True),
                       lambda: fs.filer.delete_entry("/anc", recursive=True),
                       lambda: fs.filer.rename("/anc/frozen", "/thawed"),
                       lambda: fs.filer.rename("/anc", "/moved")):
                with pytest.raises(PermissionError) as ei:
                    op()
                errors.append(str(ei.value))
            assert fs.filer.find_entry("/anc/frozen/keep.txt")
        finally:
            _run(p, env, "fs.configure -locationPrefix /anc/frozen/ -delete -apply")
    return {"errors": errors, "tree": _tree(fs)}


def test_fs_configure_readonly_protects_ancestor_ops(tmp_path):
    twin(_readonly_protects_ancestor_ops, tmp_path)


def _fs_cd_pwd_relative_paths(p, root, master, vs, fs):
    fs.write_file("/nav/inner/deep.txt", io.BytesIO(b"navigate"))
    out = []
    with p.shell.CommandEnv(master.address) as env:
        assert _run(p, env, "fs.pwd") == "/\n"
        out.append(_run(p, env, "fs.cd /nav"))
        assert _run(p, env, "fs.pwd") == "/nav\n"
        assert "inner/" in _run(p, env, "fs.ls")
        assert _run(p, env, "fs.cat inner/deep.txt") == "navigate"
        out.append(_run(p, env, "fs.cd inner"))
        assert _run(p, env, "fs.pwd") == "/nav/inner\n"
        assert _run(p, env, "fs.cat deep.txt") == "navigate"
        out.append(_run(p, env, "fs.cd .."))
        assert _run(p, env, "fs.pwd") == "/nav\n"
        with pytest.raises(p.shell.ShellError, match="not a directory") as ei:
            _run(p, env, "fs.cd inner/deep.txt")
        out.append(str(ei.value))
        out.append(_run(p, env, "fs.cd"))
        assert _run(p, env, "fs.pwd") == "/\n"
    return out


def test_fs_cd_pwd_relative_paths(tmp_path):
    twin(_fs_cd_pwd_relative_paths, tmp_path)


def _s3_bucket_commands(p, root, master, vs, fs):
    out = {}
    with p.shell.CommandEnv(master.address) as env:
        out["create"] = _run(p, env, "s3.bucket.create -name shellbkt")
        assert "created bucket shellbkt" in out["create"]
        out["list"] = _run(p, env, "s3.bucket.list")
        assert "shellbkt" in out["list"] and "total" in out["list"]
        with pytest.raises(p.shell.ShellError, match="already exists") as dup:
            _run(p, env, "s3.bucket.create -name shellbkt")
        fs.write_file("/buckets/shellbkt/obj", io.BytesIO(b"data"))
        with pytest.raises(p.shell.ShellError, match="not empty") as full:
            _run(p, env, "s3.bucket.delete -name shellbkt")
        out["delete"] = _run(p, env, "s3.bucket.delete -name shellbkt -force")
        assert "deleted bucket" in out["delete"]
        out["after"] = _run(p, env, "s3.bucket.list")
        assert "shellbkt" not in out["after"]
        with pytest.raises(p.shell.ShellError, match="not found") as gone:
            _run(p, env, "s3.bucket.delete -name shellbkt")
        out["errors"] = [str(e.value) for e in (dup, full, gone)]
    out["tree"] = _tree(fs)
    return out


def test_s3_bucket_commands(tmp_path):
    """The shell's output and errors are equal, and so is the namespace
    after the forced delete (which drops the bucket's collection)."""
    twin(_s3_bucket_commands, tmp_path)


def _fs_meta_cat_and_s3_clean_uploads(p, root, master, vs, fs):
    out = {}
    fs.write_file("/catdemo/x.bin", io.BytesIO(b"z" * 123))
    with p.shell.CommandEnv(master.address) as env:
        meta = json.loads(_run(p, env, "fs.meta.cat /catdemo/x.bin"))
        assert meta["chunks"] and meta["attributes"]["file_size"] == 123
        out["meta"] = mask(meta)
        with pytest.raises(p.shell.ShellError, match="not found"):
            _run(p, env, "fs.meta.cat /catdemo/ghost")
        # stale multipart staging dirs get aborted; fresh ones survive
        fs.write_file("/buckets/.uploads/bkt/stale123/0001.part", io.BytesIO(b"p"))
        fs.write_file("/buckets/.uploads/bkt/fresh456/0001.part", io.BytesIO(b"p"))
        # age the dir AND its newest part: liveness is judged by the
        # latest activity under the staging dir, not dir creation time
        for path in ("/buckets/.uploads/bkt/stale123",
                     "/buckets/.uploads/bkt/stale123/0001.part"):
            e = fs.filer.find_entry(path)
            e.attributes.mtime = time.time() - 7200
            fs.filer.update_entry(e)
        # a fresh part keeps an otherwise-old upload alive
        old_dir = fs.filer.find_entry("/buckets/.uploads/bkt/fresh456")
        old_dir.attributes.mtime = time.time() - 7200
        fs.filer.update_entry(old_dir)
        _run(p, env, "lock")
        out["clean"] = _run(p, env, "s3.clean.uploads -timeAgoSeconds 3600")
        assert "aborted stale upload bkt/stale123" in out["clean"]
        assert "1 aborted, 1 kept" in out["clean"]
        with pytest.raises(p.f.EntryNotFound):
            fs.filer.find_entry("/buckets/.uploads/bkt/stale123")
        assert fs.filer.find_entry("/buckets/.uploads/bkt/fresh456")
        _run(p, env, "unlock")
    out["tree"] = _tree(fs)
    return out


def test_fs_meta_cat_and_s3_clean_uploads(tmp_path):
    twin(_fs_meta_cat_and_s3_clean_uploads, tmp_path)


def _filer_meta_tail_cli(p, root, master, vs, fs, capsys):
    fs.write_file("/taildemo/a.txt", io.BytesIO(b"event me"))
    capsys.readouterr()
    rc = p.main(["filer.meta.tail", "-filerGrpc", fs.grpc_address, "-prefix", "/taildemo",
                 "-maxIdleSeconds", "0.5"])
    assert rc == 0
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert any("/taildemo" == json.loads(l)["directory"] for l in lines), lines
    return mask([json.loads(l) for l in lines])


def test_filer_meta_tail_cli(tmp_path, capsys):
    twin(_filer_meta_tail_cli, tmp_path, capsys=capsys)


def _filer_copy_cli(p, root, master, vs, fs, capsys):
    src = root / "copytree"
    (src / "sub").mkdir(parents=True)
    (src / "top.txt").write_bytes(b"root file")
    (src / "sub" / "leaf.bin").write_bytes(b"x" * 2048)
    capsys.readouterr()
    rc = p.main(["filer.copy", "-filer", fs.url, str(src), "/copied/"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "2 copied, 0 failed" in out
    assert fs.read_file(fs.filer.find_entry("/copied/copytree/top.txt")) == b"root file"
    assert fs.read_file(fs.filer.find_entry("/copied/copytree/sub/leaf.bin")) == b"x" * 2048
    return out.replace(str(root), "<root>"), _tree(fs)


def test_filer_copy_cli(tmp_path, capsys):
    twin(_filer_copy_cli, tmp_path, capsys=capsys)


def test_both_packages_meta_tail_print_identical_lines(tmp_path, capsys):
    """The reference's and the port's `filer.meta.tail` over one filer's
    history (creates, an overwrite, a rename, a delete) print the same
    lines, stamps included."""
    with stack(PORT, tmp_path) as (master, vs, fs):
        rng = random.Random(3)
        for i in range(6):
            fs.write_file(f"/tail/d{i % 2}/f{i}.bin", io.BytesIO(rng.randbytes(rng.randrange(1, 9000))))
        fs.write_file("/tail/d0/f0.bin", io.BytesIO(b"again"))
        fs.filer.rename("/tail/d1/f1.bin", "/tail/moved.bin")
        fs.filer.delete_entry("/tail/d0/f2.bin")
        out = {}
        for p in (REF, PORT):
            capsys.readouterr()
            assert p.main(["filer.meta.tail", "-filerGrpc", fs.grpc_address, "-prefix", "/tail",
                           "-maxIdleSeconds", "0.5"]) == 0
            out[p.name] = capsys.readouterr().out.splitlines()
    assert out["port"] == out["ref"]
    assert len(out["port"]) == 11 and all(l.startswith("{") for l in out["port"])


# -- fs.meta.save across the packages -------------------------------------------------------


def _write_and_save(p, root, master, vs, fs, monkeypatch):
    """Seeded files in a small tree (clock pinned from here), then
    fs.meta.save of the whole namespace -> the dump's bytes."""
    pin_clock(monkeypatch, p.f)
    rng = random.Random(5)
    for i in range(12):
        data = rng.randbytes(rng.randrange(1, 3 << 20))
        fs.write_file(f"/meta/d{i % 3}/f{i:02d}.bin", io.BytesIO(data),
                      mime="application/x-bin" if i % 2 else "")
    dump = root / "meta.jsonl"
    with p.shell.CommandEnv(master.address) as env:
        assert "saved 16 entries" in _run(p, env, f"fs.meta.save -o {dump} /")
    return dump.read_bytes()


def test_fs_meta_save_of_the_same_namespace_is_byte_equal(tmp_path, monkeypatch):
    """Both packages write the same seeded files through their filers with
    the filer clock pinned and the master's cookies seeded: the two
    fs.meta.save dumps are equal byte for byte (fids included)."""
    dump = twin(_write_and_save, tmp_path, monkeypatch=monkeypatch)
    assert dump.count(b"\n") == 16 and b'"is_chunk_manifest": false' in dump


@pytest.mark.parametrize("saver", ["ref", "port"])
def test_fs_meta_dump_loads_into_the_other_package(tmp_path, monkeypatch, saver):
    """A dump saved by one package's shell loads into the other package's
    filer through its shell (fs.meta.load) and saves back from there to the
    same bytes; the restored entries read their files from the chunks the
    saver's volume tier holds, so the loader's filer points at the saver's
    master."""
    pkgs = {"ref": REF, "port": PORT}
    s, l = pkgs[saver], pkgs["port" if saver == "ref" else "ref"]
    root = tmp_path / "saver"
    root.mkdir()
    with stack(s, root) as (master, vs, fs):
        dump = _write_and_save(s, root, master, vs, fs, monkeypatch)
        files = {e.path: fs.read_file(e) for e in fs.filer.walk("/") if not e.is_directory}
        loader = l.f.FilerServer(master.address)
        loader.start()
        try:
            lm = l.c.MasterServer(port=0, reap_interval=3600)
            lm.start()
            try:
                deadline = time.monotonic() + 10
                while True:  # announce the loader's filer to a master of its own
                    with l.c.rpc.RpcClient(lm.address) as c:
                        c.call(l.c.MASTER_SERVICE, "FilerHeartbeat",
                               {"http_address": loader.url, "grpc_address": loader.grpc_address})
                    if _listed_filers(l, lm):
                        break
                    assert time.monotonic() < deadline
                with l.shell.CommandEnv(lm.address) as env:
                    src = root / "meta.jsonl"
                    assert "loaded 16 entries" in _run(l, env, f"fs.meta.load -i {src}")
                    again = root / "again.jsonl"
                    _run(l, env, f"fs.meta.save -o {again} /")
                assert again.read_bytes() == dump
                for path, data in files.items():
                    assert loader.read_file(loader.filer.find_entry(path)) == data
            finally:
                lm.stop()
        finally:
            loader.stop()
