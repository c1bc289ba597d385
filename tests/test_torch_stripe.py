"""The port's stripe engine against the JAX package's, on scaled
geometries (tile-edge, odd, tiny, both tiers present): `write_ec_files`
gives identical .ecNN/.eci/.ecx files, `rebuild_ec_files` after losing data
and parity shards equals the originals and the reference's serial oracle,
shard sets cross between the packages in both directions, and
`write_dat_file` gives back the original .dat. All comparisons byte-exact."""

import os
import shutil

import numpy as np
import pytest

from seaweedfs_tpu.ec import stripe as ref_stripe
from seaweedfs_tpu.ops import rs_codec as ref_codec
from seaweedfs_tpu_torch.ec import stripe
from seaweedfs_tpu_torch.obs import trace
from seaweedfs_tpu_torch.ops import rs_codec

LARGE, SMALL, BUFFER = 16384, 4096, 4096

#: .dat sizes: tiny, odd, exactly two large rows + one small row's worth
#: (tile edge), and both tiers present
SIZES = {"tiny": 1, "odd": 123_457, "tile_edge": 2 * 10 * LARGE + 1, "two_tiers": 655_360}


def _encoders(family: str):
    g = rs_codec.CODE_FAMILIES[family]
    mine = rs_codec.new_encoder(family=family, device="cpu")
    ref = ref_codec.Encoder(g.data_shards, g.parity_shards, g.matrix_kind, backend="numpy")
    return mine, ref


def _write_volume(d, name: str, size: int, seed: int = 1) -> str:
    base = os.path.join(str(d), name)
    rng = np.random.default_rng(seed)
    with open(base + ".dat", "wb") as f:
        f.write(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
    n = max(1, size // 512)
    with open(base + ".idx", "wb") as f:  # shuffled ids, one overwrite, one delete
        for i, key in enumerate(rng.permutation(n) + 1):
            f.write(int(key).to_bytes(8, "big") + (1 + i).to_bytes(4, "big")
                    + (500).to_bytes(4, "big", signed=True))
        f.write((1).to_bytes(8, "big") + (7).to_bytes(4, "big") + (9).to_bytes(4, "big"))
        f.write((2).to_bytes(8, "big") + (0).to_bytes(4, "big")
                + (-1).to_bytes(4, "big", signed=True))
    return base


def _files(base: str, total: int, exts=(".eci", ".ecx")) -> dict:
    out = {}
    for name in [stripe.to_ext(s) for s in range(total)] + list(exts):
        if os.path.exists(base + name):
            with open(base + name, "rb") as f:
                out[name] = f.read()
    return out


def _twin(tmp_path, size: int, seed: int = 1):
    """The same volume in two directories: (port base, reference base)."""
    a, b = tmp_path / "port", tmp_path / "ref"
    a.mkdir()
    b.mkdir()
    pa = _write_volume(a, "7", size, seed)
    pb = os.path.join(str(b), "7")
    for ext in (".dat", ".idx"):
        shutil.copy(pa + ext, pb + ext)
    return pa, pb


@pytest.mark.parametrize("family", sorted(rs_codec.CODE_FAMILIES))
@pytest.mark.parametrize("size", sorted(SIZES), ids=str)
def test_write_ec_files_identical_to_reference(tmp_path, family, size):
    mine, ref = _encoders(family)
    pa, pb = _twin(tmp_path, SIZES[size])
    kw = dict(large_block_size=LARGE, small_block_size=SMALL, buffer_size=BUFFER,
              max_batch_bytes=mine.data_shards * 3 * BUFFER)
    stripe.generate_ec_files(pa, encoder=mine, **kw)
    ref_stripe.generate_ec_files(pb, encoder=ref, **kw)
    got, want = _files(pa, mine.total_shards), _files(pb, mine.total_shards)
    assert sorted(got) == sorted(want) and len(got) == mine.total_shards + 2
    for name in want:
        assert got[name] == want[name], name


@pytest.mark.parametrize("depth", [1, 3])
def test_pipeline_depths_byte_identical(tmp_path, depth):
    mine, _ = _encoders("rs_10_4")
    base = _write_volume(tmp_path, "v", SIZES["two_tiers"])
    kw = dict(large_block_size=LARGE, small_block_size=SMALL, buffer_size=BUFFER,
              max_batch_bytes=10 * 3 * BUFFER, encoder=mine)
    stripe.write_ec_files(base, pipeline_depth=depth, **kw)
    first = _files(base, 14)
    stripe.write_ec_files(base, pipeline_depth=1, **kw)
    assert _files(base, 14) == first


LOST = {"rs_10_4": [0, 5, 11, 13], "cauchy_12_3": [2, 7, 13], "merge_20_4": [0, 19, 20, 23]}


@pytest.mark.parametrize("family", sorted(rs_codec.CODE_FAMILIES))
@pytest.mark.parametrize("size", ["odd", "two_tiers"])
def test_rebuild_matches_originals_and_reference_serial(tmp_path, family, size):
    mine, ref = _encoders(family)
    pa, pb = _twin(tmp_path, SIZES[size])
    kw = dict(large_block_size=LARGE, small_block_size=SMALL)
    stripe.write_ec_files(pa, encoder=mine, **kw)
    ref_stripe.write_ec_files(pb, encoder=ref, **kw)
    golden = _files(pa, mine.total_shards)
    lost = LOST[family]
    for s in lost:
        os.unlink(stripe.shard_file_name(pa, s))
        os.unlink(stripe.shard_file_name(pb, s))
    # several batches plus a ragged tail: 8 KiB chunks, two per batch
    rebuilt = stripe.rebuild_ec_files(
        pa, encoder=mine, buffer_size=8192,
        max_batch_bytes=mine.data_shards * 2 * 8192, pipeline_depth=2,
    )
    assert rebuilt == lost
    assert ref_stripe.rebuild_ec_files_serial(pb, encoder=ref, buffer_size=8192) == lost
    assert _files(pa, mine.total_shards) == golden == _files(pb, mine.total_shards)


def test_port_serial_oracle_matches_pipeline(tmp_path):
    mine, _ = _encoders("rs_10_4")
    base = _write_volume(tmp_path, "v", 200_000)
    stripe.write_ec_files(base, encoder=mine, large_block_size=LARGE, small_block_size=SMALL)
    golden = _files(base, 14)
    for s in (1, 10):
        os.unlink(stripe.shard_file_name(base, s))
    assert stripe.rebuild_ec_files_serial(base, encoder=mine, buffer_size=8192) == [1, 10]
    assert _files(base, 14) == golden


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
@pytest.mark.parametrize("family", ["rs_10_4", "cauchy_12_3"])
def test_cross_state_rebuild_and_decode(tmp_path, direction, family):
    """Shards one package wrote, the other rebuilds and decodes back to the
    original .dat and an .idx identical to the writer's own decode."""
    mine, ref = _encoders(family)
    base = _write_volume(tmp_path, "9", SIZES["two_tiers"], seed=4)
    with open(base + ".dat", "rb") as f:
        original = f.read()
    kw = dict(large_block_size=LARGE, small_block_size=SMALL)
    writer_mod, writer = (ref_stripe, ref) if direction == "reference_to_port" else (stripe, mine)
    reader_mod, reader = (stripe, mine) if direction == "reference_to_port" else (ref_stripe, ref)
    writer_mod.generate_ec_files(base, encoder=writer, **kw)
    golden = _files(base, writer.total_shards)
    lost = LOST[family][:3]
    for s in lost:
        os.unlink(stripe.shard_file_name(base, s))
    os.unlink(base + ".dat")
    enc = reader_mod.encoder_for_base(base, reader)
    assert reader_mod.rebuild_ec_files(base, encoder=enc, buffer_size=8192) == lost
    assert _files(base, writer.total_shards) == golden
    reader_mod.write_dat_file(base)
    reader_mod.write_idx_file_from_ec_index(base)
    with open(base + ".dat", "rb") as f:
        assert f.read() == original
    with open(base + ".idx", "rb") as f:
        port_idx = f.read()
    writer_mod.write_idx_file_from_ec_index(base)
    with open(base + ".idx", "rb") as f:
        assert f.read() == port_idx


@pytest.mark.parametrize("size", sorted(SIZES), ids=str)
def test_write_dat_file_restores_original(tmp_path, size):
    mine, _ = _encoders("rs_10_4")
    base = _write_volume(tmp_path, "v", SIZES[size])
    with open(base + ".dat", "rb") as f:
        original = f.read()
    stripe.write_ec_files(base, encoder=mine, large_block_size=LARGE, small_block_size=SMALL)
    os.unlink(base + ".dat")
    stripe.write_dat_file(base)
    with open(base + ".dat", "rb") as f:
        assert f.read() == original
    assert not os.path.exists(base + ".dat.tmp")


def test_encoder_for_info_keeps_device_and_backend(tmp_path):
    default = rs_codec.new_encoder(device="cpu")
    assert stripe.encoder_for_info(None, default) is default
    sib = stripe.encoder_for_info(
        {"large_block_size": 1, "small_block_size": 1, "dat_size": 1,
         "data_shards": 12, "parity_shards": 3, "matrix_kind": "cauchy"},
        default,
    )
    assert (sib.data_shards, sib.family, sib.backend) == (12, "cauchy_12_3", "torch")
    assert sib.device == default.device and sib.selection["source"] == "geometry-sibling"
    with pytest.raises(ValueError):
        stripe.geometry_from_info({"data_shards": 30, "parity_shards": 4})


def test_geometry_mismatched_encoder_fails_and_leaves_no_shards(tmp_path):
    base = _write_volume(tmp_path, "v", 50_000)
    enc = rs_codec.new_encoder(10, 4, device="cpu")
    enc.parity_matrix = enc.parity_matrix[:3]  # produces 3 parity rows for a 14-shard layout
    with pytest.raises(ValueError, match="parity shards"):
        stripe.write_ec_files(base, encoder=enc, large_block_size=LARGE, small_block_size=SMALL)
    assert stripe.find_local_shards(base) == []


def test_rebuild_crc_gate_unlinks_partials(tmp_path):
    mine, _ = _encoders("rs_10_4")
    base = _write_volume(tmp_path, "v", 200_000)
    stripe.write_ec_files(base, encoder=mine, large_block_size=LARGE, small_block_size=SMALL)
    os.unlink(stripe.shard_file_name(base, 3))
    with open(stripe.shard_file_name(base, 1), "r+b") as f:
        f.seek(100)
        b = f.read(1)
        f.seek(100)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(IOError, match="CRC mismatch"):
        stripe.rebuild_ec_files(base, encoder=mine, buffer_size=8192)
    assert 3 not in stripe.find_local_shards(base)


def test_rebuild_preflight_errors(tmp_path):
    mine, _ = _encoders("rs_10_4")
    base = _write_volume(tmp_path, "v", 65_536)
    stripe.write_ec_files(base, encoder=mine, large_block_size=LARGE, small_block_size=SMALL)
    assert stripe.rebuild_ec_files(base, encoder=mine) == []
    with open(stripe.shard_file_name(base, 2), "r+b") as f:
        f.truncate(10)
    os.unlink(stripe.shard_file_name(base, 0))
    with pytest.raises(IOError, match="disagree"):
        stripe.rebuild_ec_files(base, encoder=mine)
    for s in range(1, 6):
        os.unlink(stripe.shard_file_name(base, s))
    with pytest.raises(ValueError, match="cannot rebuild"):
        stripe.rebuild_ec_files(base, encoder=mine)


@pytest.mark.parametrize("size", [0, 1, 163_840, 163_841, 10_000_000])
def test_stripe_layout_matches_reference(size):
    assert stripe.stripe_layout(size, LARGE, SMALL) == ref_stripe.stripe_layout(size, LARGE, SMALL)
    assert stripe.stripe_layout(size, LARGE, SMALL, 20) == ref_stripe.stripe_layout(
        size, LARGE, SMALL, 20)


def test_spans_record_stage_and_drain(tmp_path):
    mine, _ = _encoders("rs_10_4")
    base = _write_volume(tmp_path, "v", SIZES["two_tiers"])
    with trace.collect() as spans:
        stripe.write_ec_files(base, encoder=mine, large_block_size=LARGE, small_block_size=SMALL)
        os.unlink(stripe.shard_file_name(base, 4))
        stripe.rebuild_ec_files(base, encoder=mine, buffer_size=8192)
    names = {s["name"] for s in spans}
    assert names == {"encode.stage", "encode.drain", "rebuild.stage", "rebuild.drain"}
    assert names <= set(trace.SPAN_NAMES)
    assert all(s["seconds"] >= 0 and s["width"] > 0 for s in spans)
    with trace.span("encode.stage") as sp:  # no ambient trace: a no-op
        assert sp is None
    with trace.collect() as spans, trace.span("encode.unknown"):
        pass  # an unregistered name records, as the reference's does
    assert [s["name"] for s in spans] == ["encode.unknown"]
