"""The fused fleet rebuild in the port against the JAX package's:
`Encoder.reconstruct_block` (mixed 10+4 vandermonde, 12+3 and 20+4 cauchy
blocks side by side) equal per block to the reference's numpy, jax and
interpret-mode pallas backends on the rows a block specifies, its
validation, and `rebuild_ec_files_batch` with mixed signatures (one
dispatch group fused, one per signature unfused) equal to the golden
shards, to the serial oracle and to the reference's returned dict, with a
mid-batch failure unlinking only the failed group. Byte-exact."""

import os
import shutil

import numpy as np
import pytest

from seaweedfs_tpu.ec import stripe as ref_stripe
from seaweedfs_tpu.ops import rs_codec as ref_codec
from seaweedfs_tpu_torch.ec import stripe
from seaweedfs_tpu_torch.obs import trace
from seaweedfs_tpu_torch.ops import gf8, rs_codec

LARGE, SMALL = 16384, 4096
#: (data, parity, matrix kind) of the three geometries
GEOMETRIES = {10: (10, 4, "vandermonde"), 12: (12, 3, "cauchy"), 20: (20, 4, "cauchy")}


def _port(k: int) -> rs_codec.Encoder:
    d, p, kind = GEOMETRIES[k]
    return rs_codec.Encoder(d, p, kind, device="cpu")


def _ref(k: int, backend: str = "numpy") -> ref_codec.Encoder:
    d, p, kind = GEOMETRIES[k]
    return ref_codec.Encoder(d, p, backend=backend, matrix_kind=kind)


def _block(enc, missing, col_start, width):
    survivors = [s for s in range(enc.total_shards) if s not in missing][: enc.data_shards]
    return {"encoder": enc, "survivors": survivors, "wanted": list(missing),
            "col_start": col_start, "width": width}


@pytest.mark.parametrize("ref_backend", ["numpy", "jax", "pallas"])
@pytest.mark.parametrize("widths", [(513, 7, 4096), (1, 4097, 300)], ids=["odd", "edge"])
def test_reconstruct_block_mixed_geometries_equals_reference(ref_backend, widths):
    """Three blocks (10+4 losing two, 12+3 one, 20+4 two) at odd, sub-tile
    and tile-edge widths, starting at column 3 so no block is aligned: on
    each block's wanted rows the port equals the reference backend and
    the gf8 golden."""
    specs = ((10, [12, 13]), (12, [5]), (20, [20, 23]))
    col = 3
    mine, ref = [], []
    for (k, missing), w in zip(specs, widths):
        mine.append(_block(_port(k), missing, col, w))
        ref.append(_block(_ref(k, ref_backend), missing, col, w))
        col += w
    staging = np.random.default_rng(sum(widths)).integers(0, 256, (20, col + 5), np.uint8)
    got = _port(10).reconstruct_block(staging, mine)
    want = np.asarray(_ref(10, ref_backend).reconstruct_block(staging, ref))
    assert got.parts == [(len(b["wanted"]), b["col_start"], b["width"]) for b in mine]
    got = np.asarray(got)
    assert got.shape == want.shape == (2, col + 5) and got.dtype == np.uint8
    for b in mine:
        enc, c0, w, rows = b["encoder"], b["col_start"], b["width"], len(b["wanted"])
        golden = gf8.gf_mat_vec(enc.reconstruction_matrix(b["survivors"], b["wanted"]),
                                staging[: enc.data_shards, c0 : c0 + w])
        assert np.array_equal(got[:rows, c0 : c0 + w], golden)
        assert np.array_equal(got[:rows, c0 : c0 + w], want[:rows, c0 : c0 + w])


def test_reconstruct_block_rejects_as_reference():
    e10, r10 = _port(10), _ref(10)
    staging = np.zeros((10, 100), dtype=np.uint8)
    bad = {
        "empty": [],
        "overlap": [(13, 0, 60), (12, 50, 50)],
        "past_end": [(13, 60, 50)],
        "negative": [(13, -1, 10)],
        "zero_width": [(13, 0, 0)],
    }
    for name, spec in bad.items():
        for enc in (e10, r10):
            with pytest.raises(ValueError):
                enc.reconstruct_block(staging, [_block(enc, [m], c0, w) for m, c0, w in spec])
    for enc, wide in ((e10, _port(20)), (r10, _ref(20))):  # k_g > rows of the staging
        with pytest.raises(ValueError, match="survivor rows"):
            enc.reconstruct_block(staging, [_block(wide, [0], 0, 10)])
        with pytest.raises(ValueError):
            enc.reconstruct_block(np.zeros(100, np.uint8), [_block(enc, [13], 0, 10)])


# -- rebuild_ec_files_batch -------------------------------------------------------

#: (volume id, .dat size, lost shards, geometry): odd sizes, 2- and 1-shard
#: losses, two volumes sharing a geometry
MIXED = [
    (41, 123_457, [12, 13], 10),
    (42, 88_001, [3], 10),
    (43, 97_003, [0, 12], 12),
    (44, 64_005, [20, 23], 20),
    (45, 71_999, [7], 20),
]


def _storm(tmp_path, specs):
    """Each volume written by the port into `port/` and copied to `ref/`,
    its lost shards deleted in both; -> {vid: (golden, missing, k)}."""
    for d in ("port", "ref"):
        (tmp_path / d).mkdir(exist_ok=True)
    goldens = {}
    for vid, size, missing, k in specs:
        base = os.path.join(str(tmp_path / "port"), str(vid))
        rng = np.random.default_rng(vid)
        with open(base + ".dat", "wb") as f:
            f.write(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
        enc = _port(k)
        stripe.write_ec_files(base, LARGE, SMALL, encoder=enc)
        os.unlink(base + ".dat")
        golden = {}
        for s in range(enc.total_shards):
            with open(stripe.shard_file_name(base, s), "rb") as f:
                golden[s] = f.read()
        goldens[vid] = (golden, missing, k)
        for s in missing:
            os.unlink(stripe.shard_file_name(base, s))
        for name in os.listdir(tmp_path / "port"):
            if name.startswith(f"{vid}."):
                shutil.copy(tmp_path / "port" / name, tmp_path / "ref" / name)
    return goldens


def _jobs(mod, d, specs, encoders):
    jobs = []
    for vid, _, missing, k in specs:
        base = os.path.join(str(d), str(vid))
        enc = encoders(k)
        present = [s for s in range(enc.total_shards) if s not in missing]
        jobs.append({
            "base": base, "missing": missing, "encoder": enc,
            "shard_size": os.path.getsize(mod.shard_file_name(base, present[0])),
            "sources": {s: mod.LocalSlabSource(mod.shard_file_name(base, s)) for s in present},
        })
    return jobs


def _close(jobs):
    for job in jobs:
        for src in job["sources"].values():
            src.close()


def _run(mod, d, specs, encoders, **kw):
    jobs = _jobs(mod, d, specs, encoders)
    try:
        return mod.rebuild_ec_files_batch(jobs, **kw)
    finally:
        _close(jobs)


def _relative(res: dict, d) -> dict:
    """A result dict with its bases named by volume id alone."""
    name = lambda b: os.path.relpath(b, str(d))  # noqa: E731
    return {
        **res,
        "rebuilt": {name(b): v for b, v in res["rebuilt"].items()},
        "errors": {name(b): v for b, v in res["errors"].items()},
        "block_order": [name(b) for b in res["block_order"]],
    }


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_batch_mixed_signatures_equals_reference_and_serial(tmp_path, fuse):
    goldens = _storm(tmp_path, MIXED)
    kw = dict(buffer_size=16384, max_batch_bytes=163_840, fuse=fuse)
    with trace.collect() as spans:
        res = _run(stripe, tmp_path / "port", MIXED, _port, **kw)
    want = _run(ref_stripe, tmp_path / "ref", MIXED, _ref, **kw)
    assert _relative(res, tmp_path / "port") == _relative(want, tmp_path / "ref")
    assert not res["errors"]
    assert res["signature_groups"] == res["volumes_fused"] == len(MIXED)
    assert res["dispatch_groups"] == (1 if fuse else len(MIXED))
    assert [os.path.basename(b) for b in res["block_order"]] == [str(v[0]) for v in MIXED]
    assert {s["name"] for s in spans} == {"rebuild.stage", "rebuild.drain"}
    for vid, (golden, missing, k) in goldens.items():
        base = os.path.join(str(tmp_path / "port"), str(vid))
        ref_base = os.path.join(str(tmp_path / "ref"), str(vid))
        got = {}
        for s in missing:
            with open(stripe.shard_file_name(base, s), "rb") as f:
                got[s] = f.read()
            with open(ref_stripe.shard_file_name(ref_base, s), "rb") as f:
                assert f.read() == got[s] == golden[s], (vid, s)
            os.unlink(stripe.shard_file_name(base, s))
        assert stripe.rebuild_ec_files_serial(base, encoder=_port(k)) == missing
        for s in missing:
            with open(stripe.shard_file_name(base, s), "rb") as f:
                assert f.read() == got[s], (vid, s)


def test_batch_fuses_by_default_and_the_knob_turns_it_off(tmp_path, monkeypatch):
    _storm(tmp_path, MIXED[:3])
    kw = dict(buffer_size=16384, max_batch_bytes=163_840)
    monkeypatch.delenv("WEEDTPU_REBUILD_FUSE", raising=False)
    assert _run(stripe, tmp_path / "port", MIXED[:3], _port, **kw)["dispatch_groups"] == 1
    monkeypatch.setenv("WEEDTPU_REBUILD_FUSE", "off")
    res = _run(stripe, tmp_path / "port", MIXED[:3], _port, **kw)
    assert res["dispatch_groups"] == res["signature_groups"] == 3 and not res["errors"]


def test_batch_same_signature_shares_one_block_and_packs_volumes(tmp_path):
    """Two volumes of one signature: one group, and a batch packs the first
    volume's tail beside the second's head."""
    specs = [(61, 50_001, [1, 12], 10), (62, 70_003, [1, 12], 10)]
    goldens = _storm(tmp_path, specs)
    for fuse in (True, False):
        with trace.collect() as spans:
            res = _run(stripe, tmp_path / "port", specs, _port, buffer_size=4096,
                       max_batch_bytes=10 * 3 * 4096, fuse=fuse)
        assert res["signature_groups"] == res["dispatch_groups"] == 1 and not res["errors"]
        sizes = [len(goldens[v][0][0]) for v, *_ in specs]
        assert sum(s["name"] == "rebuild.stage" for s in spans) == -(-sum(sizes) // (3 * 4096))
        for vid, (golden, missing, _) in goldens.items():
            base = os.path.join(str(tmp_path / "port"), str(vid))
            for s in missing:
                with open(stripe.shard_file_name(base, s), "rb") as f:
                    assert f.read() == golden[s]


def test_batch_mid_failure_unlinks_only_the_failed_group(tmp_path):
    class Dying(stripe.SlabSource):
        def __init__(self, path):
            self._inner = stripe.LocalSlabSource(path)
            self._calls = 0

        def read_into(self, offset, out):
            self._calls += 1
            if self._calls > 1:
                raise IOError("holder died")
            self._inner.read_into(offset, out)

        def close(self):
            self._inner.close()

    specs = [(51, 90_000, [13], 10), (52, 80_000, [12, 13], 10), (53, 70_000, [0, 12], 12)]
    goldens = _storm(tmp_path, specs)
    for fuse in (True, False):
        jobs = _jobs(stripe, tmp_path / "port", specs, _port)
        dying = jobs[1]["base"]
        jobs[1]["sources"][0].close()
        jobs[1]["sources"][0] = Dying(stripe.shard_file_name(dying, 0))
        try:
            res = stripe.rebuild_ec_files_batch(jobs, buffer_size=4096, max_batch_bytes=40_960,
                                                fuse=fuse)
        finally:
            _close(jobs)
        assert res["dispatch_groups"] == (1 if fuse else 3)
        assert list(res["errors"]) == [dying] and "holder died" in res["errors"][dying]
        for s in (12, 13):
            assert not os.path.exists(stripe.shard_file_name(dying, s))
        for vid, (golden, missing, _) in goldens.items():
            base = os.path.join(str(tmp_path / "port"), str(vid))
            if base == dying:
                continue
            assert res["rebuilt"][base] == missing
            for s in missing:
                with open(stripe.shard_file_name(base, s), "rb") as f:
                    assert f.read() == golden[s]
                os.unlink(stripe.shard_file_name(base, s))


def test_batch_reports_short_and_healed_volumes(tmp_path):
    """A volume with fewer than k survivors is an error before any
    pipeline; one with nothing missing comes back rebuilt=[]; the rest
    rebuild. The reference reports the same."""
    specs = [(71, 40_000, [2], 10)]
    _storm(tmp_path, specs)
    for mod, d, encs in ((stripe, "port", _port), (ref_stripe, "ref", _ref)):
        base = os.path.join(str(tmp_path / d), "71")
        jobs = _jobs(mod, tmp_path / d, specs, encs)
        short = dict(jobs[0], base=base + "short",
                     sources=dict(list(jobs[0]["sources"].items())[:9]))
        healed = dict(jobs[0], base=base + "healed", missing=[])
        try:
            res = mod.rebuild_ec_files_batch([short, healed, jobs[0]], buffer_size=4096)
        finally:
            _close(jobs)
        assert res["rebuilt"] == {base + "healed": [], base: [2]}
        assert list(res["errors"]) == [base + "short"] and "need 10" in res["errors"][base + "short"]
        assert res["signature_groups"] == res["dispatch_groups"] == 1
