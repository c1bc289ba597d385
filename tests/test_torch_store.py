"""The port's `Store` against the JAX package's: the reference's store
flows (volumes and EC volumes, reload discovery, TTL reaping) run on both
with a CPU encoder (the port's `Encoder(10, 4, device="cpu")`, the
reference's numpy backend) and `time.time_ns` pinned. Volume and EC volume
infos must be equal as dicts, needles byte-identical, a degraded EC read
the reference's bytes, and an EC volume whose .eci contradicts its shards
is skipped, not served."""

import itertools
import logging
import os
import time

import pytest

from seaweedfs_tpu.ec import stripe as ref_stripe
from seaweedfs_tpu.ops import rs_codec as ref_codec
from seaweedfs_tpu.storage import needle as ref_needle
from seaweedfs_tpu.storage import store as ref_store
from seaweedfs_tpu_torch.ec import read_planner, stripe, suspicion
from seaweedfs_tpu_torch.ops import rs_codec
from seaweedfs_tpu_torch.storage import needle, store

ENC = rs_codec.Encoder(10, 4, device="cpu")
REF_ENC = ref_codec.Encoder(10, 4, backend="numpy")
PACKAGES = {
    "port": (store, needle, stripe, ENC),
    "ref": (ref_store, ref_needle, ref_stripe, REF_ENC),
}
LOST = (0, 5, 10, 13)


@pytest.fixture(autouse=True)
def _fresh_port_state():
    yield
    read_planner.CACHE.clear()
    suspicion.GLOBAL.reset()


@pytest.fixture
def clock(monkeypatch):
    """`time.time_ns` pinned to a counter; calling the fixture's value
    starts it again, so both packages stamp the same needles alike."""
    state = {}

    def reset():
        state["it"] = itertools.count(1_700_000_000_000_000_000, 1_000)

    reset()
    monkeypatch.setattr(needle.time, "time_ns", lambda: next(state["it"]))
    return reset


def _fill(st, nd, vid: int, n: int = 40) -> dict:
    data = {}
    for i in range(1, n + 1):
        blob = bytes([i % 251]) * (53 * i % 700 + 1)
        st.write_needle(vid, nd.Needle(cookie=0x100 + i, id=i, data=blob, name=b"f%d" % i))
        data[i] = blob
    for i in range(3, n + 1, 9):
        st.delete_needle(vid, i)
        del data[i]
    return data


def _same_mtime(*paths: str) -> None:
    """One last-append time for both packages' files (their infos carry it)."""
    t = 1_700_000_000
    for p in paths:
        os.utime(p, (t, t))


def test_store_volumes_and_ec_equal_reference(tmp_path, clock):
    """The reference's test_store_volumes_and_ec flow on both packages:
    a volume on the second of two locations, EC-encoded in place (tiny
    blocks), served through the store, then read degraded with four
    shards lost. Infos equal as dicts, every needle the reference's."""
    seen = {}
    for name, (st_mod, nd, stp, enc) in PACKAGES.items():
        clock()
        d1, d2 = str(tmp_path / name / "d1"), str(tmp_path / name / "d2")
        st = st_mod.Store([d1, d2], encoder=enc)
        st.load()
        st.create_volume(1)
        v = st.create_volume(5, collection="img", replication="001")
        data = _fill(st, nd, 5)
        _same_mtime(v.dat_path, st.get_volume(1).dat_path)
        infos = st.volume_infos()
        base = v.base_path
        stp.write_ec_files(base, large_block_size=1024, small_block_size=64, buffer_size=64,
                           encoder=enc)
        stp.write_sorted_file_from_idx(base)
        st.mount_ec_volume(5, base)
        ec_infos = [i.to_dict() for i in st.ec_volume_infos()]
        v.close()
        for loc in st.locations:
            loc.volumes.pop(5, None)
        healthy = {i: st.read_needle(5, i, cookie=0x100 + i).data for i in data}
        for s in LOST:
            os.remove(stp.shard_file_name(base, s))
        st.unmount_ec_volume(5)
        ev = st.mount_ec_volume(5, base)
        if ev.warm_thread is not None:
            ev.warm_thread.join(30)
        degraded = {i: st.read_needle(5, i, cookie=0x100 + i) for i in data}
        with pytest.raises(PermissionError):
            st.read_needle(5, 1, cookie=1)
        with pytest.raises(KeyError):
            st.read_needle(6, 1)
        assert st.delete_needle(5, 1)
        seen[name] = {
            "infos": infos, "ec_infos": ec_infos,
            "ec_infos_degraded": [i.to_dict() for i in st.ec_volume_infos()],
            "healthy": healthy,
            "degraded": {i: (n.cookie, n.data, n.name, n.append_at_ns)
                         for i, n in degraded.items()},
            "after_volume_infos": [i["id"] for i in st.volume_infos()],
        }
        assert healthy == data
        st.close()
    assert seen["port"] == seen["ref"]
    assert seen["port"]["ec_infos"][0]["shard_bits"] == (1 << 14) - 1
    assert seen["port"]["ec_infos_degraded"][0]["shard_bits"] == sum(
        1 << s for s in range(14) if s not in LOST)


@pytest.mark.parametrize("kind", ["memory", "sorted_file"])
def test_store_reload_discovers_equal_reference(tmp_path, clock, kind):
    """Volumes and EC volumes come back from disk at `load()`, with either
    needle-map kind, in both packages; the EC volume serves its needles
    through the EC fall-through."""
    seen = {}
    for name, (st_mod, nd, stp, enc) in PACKAGES.items():
        clock()
        d = str(tmp_path / name)
        s1 = st_mod.Store([d], encoder=enc, needle_map_kind=kind)
        s1.create_volume(3)
        data3 = _fill(s1, nd, 3, 20)
        v7 = s1.create_volume(7, collection="pics", ttl="3d")
        data7 = _fill(s1, nd, 7, 30)
        s1.close()
        stp.write_ec_files(v7.base_path, large_block_size=1024, small_block_size=64,
                           buffer_size=64, encoder=enc)
        stp.write_sorted_file_from_idx(v7.base_path)
        for ext in (".dat", ".idx", ".sdx", ".sdx.meta"):
            if os.path.exists(v7.base_path + ext):
                os.remove(v7.base_path + ext)
        os.remove(stp.shard_file_name(v7.base_path, 2))
        s2 = st_mod.Store([d], encoder=enc, needle_map_kind=kind)
        s2.load()
        _same_mtime(s2.get_volume(3).dat_path)
        seen[name] = (
            s2.volume_infos(), [i.to_dict() for i in s2.ec_volume_infos()],
            {i: s2.read_needle(3, i).data for i in data3},
            {i: s2.read_needle(7, i).data for i in data7},
        )
        assert seen[name][2] == data3 and seen[name][3] == data7
        s2.close()
    assert seen["port"] == seen["ref"]


def test_contradicting_eci_is_skipped_not_served(tmp_path, clock, caplog):
    """A shard id past the .eci's recorded geometry (a crash mid-cut-over)
    makes both packages skip the EC volume at load, with a warning, and
    keep loading the rest."""
    seen = {}
    for name, (st_mod, nd, stp, enc) in PACKAGES.items():
        clock()
        d = str(tmp_path / name)
        s1 = st_mod.Store([d], encoder=enc)
        v = s1.create_volume(4)
        _fill(s1, nd, 4, 10)
        s1.create_volume(8)
        _fill(s1, nd, 8, 5)
        s1.close()
        stp.write_ec_files(v.base_path, large_block_size=1024, small_block_size=64,
                           buffer_size=64, encoder=enc)
        stp.write_sorted_file_from_idx(v.base_path)
        os.remove(v.base_path + ".dat")
        with open(stp.shard_file_name(v.base_path, 14), "wb") as f:
            f.write(b"\0" * 16)
        s2 = st_mod.Store([d], encoder=enc)
        logger = logging.getLogger("seaweedfs_tpu_torch" if name == "port" else "seaweedfs_tpu")
        logger.addHandler(caplog.handler)
        try:
            s2.load()
        finally:
            logger.removeHandler(caplog.handler)
        assert s2.get_ec_volume(4) is None
        with pytest.raises(KeyError):
            s2.read_needle(4, 1)
        seen[name] = (s2.ec_volume_infos(), sorted(i["id"] for i in s2.volume_infos()),
                      s2.read_needle(8, 2).data)
        s2.close()
    assert seen["port"] == seen["ref"] == ([], [8], seen["ref"][2])
    warned = [r.getMessage() for r in caplog.records if "skipping ec volume 4" in r.getMessage()]
    assert len(warned) == 2


def test_ttl_needles_and_volume_reaping_equal_reference(tmp_path):
    seen = {}
    for name, (st_mod, nd, _stp, enc) in PACKAGES.items():
        st = st_mod.Store([str(tmp_path / name)], encoder=enc)
        st.load()
        v = st.create_volume(20, ttl="1m")
        st.write_needle(20, nd.Needle(cookie=1, id=10, data=b"fresh", append_at_ns=time.time_ns()))
        st.write_needle(20, nd.Needle(cookie=1, id=11, data=b"stale",
                                      append_at_ns=time.time_ns() - 120 * 10**9))
        with pytest.raises(KeyError, match="expired"):
            st.read_needle(20, 11)
        st.create_volume(21)
        st.write_needle(21, nd.Needle(cookie=1, id=12, data=b"x", append_at_ns=1))
        first = st.reap_expired_volumes()
        past = time.time() - 120
        os.utime(v.dat_path, (past, past))
        expired = st.expired_volume_ids()
        reaped = st.reap_expired_volumes()
        seen[name] = (first, expired, reaped, st.get_volume(20) is None,
                      os.path.exists(v.dat_path), st.read_needle(21, 12).data)
        st.close()
    assert seen["port"] == seen["ref"] == ([], [20], [20], True, False, b"x")


def test_unmount_mount_remove_and_the_write_hook(tmp_path, clock):
    seen = {}
    for name, (st_mod, nd, _stp, enc) in PACKAGES.items():
        clock()
        st = st_mod.Store([str(tmp_path / name)], encoder=enc)
        calls = []
        st.on_write = calls.append
        st.create_volume(2, collection="c")
        st.write_needle(2, nd.Needle(cookie=1, id=1, data=b"a"))
        st.delete_needle(2, 1)
        st.write_needle(2, nd.Needle(cookie=1, id=2, data=b"b"))
        with pytest.raises(ValueError):
            st.create_volume(2)
        with pytest.raises(KeyError):
            st.write_needle(9, nd.Needle(cookie=1, id=1, data=b"a"))
        steps = [st.unmount_volume(2), st.get_volume(2) is None, st.mount_volume(2),
                 st.read_needle(2, 2).data, st.mount_volume(2), st.mount_volume(3),
                 st.remove_volume(2), st.remove_volume(2), os.listdir(str(tmp_path / name))]
        seen[name] = (calls, steps)
        st.close()
    assert seen["port"] == seen["ref"]
    assert seen["port"][0] == [2, 2, 2]
    assert store.parse_base_name("a_b_9") == ref_store.parse_base_name("a_b_9") == ("a_b", 9)
    assert store.parse_base_name("nope") is ref_store.parse_base_name("nope") is None


def test_store_default_encoder_is_the_card(monkeypatch, tmp_path):
    """`Store(dirs)` takes the factory's encoder, on the card: without one
    it raises rather than running the plain version."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        store.Store([str(tmp_path)])
