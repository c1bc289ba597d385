"""The CUDA kernels on a card: each variant (`gf_bitplane.cu`, `gf_bf16.cu`,
`gf_dma.cu`, `gf_mma.cu`) through `rs_cuda.apply_matrix` against its plain PyTorch
version (`rs_cuda.plain_apply`) on the same device, byte-exact (tolerance
0: GF arithmetic is exact), and the stripe engine and the degraded read
(`EcVolume`, the bucketed `reconstruct_batch`) on the card against the
port's own CPU path. The kernel has no CPU mode, so
every test here carries the `cuda` marker and takes the `card` fixture,
which skips without a card. These
tests import no JAX; on a machine with a card and no JAX, run them with

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from seaweedfs_tpu_torch.ec import stripe
from seaweedfs_tpu_torch.ops import gf8, rs_codec, rs_cuda, rs_torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the GF kernel has no CPU mode")
    return torch.device("cuda")


def _decode_matrix(kind: str, k: int, m: int, lost: tuple) -> np.ndarray:
    enc = rs_codec.Encoder(k, m, kind, device="cpu")
    survivors = [s for s in range(k + m) if s not in lost][:k]
    return enc.reconstruction_matrix(survivors, lost)


MATRICES = {
    "rs_10_4": lambda: gf8.parity_matrix(10, 4),
    "cauchy_12_3": lambda: gf8.parity_matrix(12, 3, "cauchy"),
    "merge_20_4": lambda: gf8.parity_matrix(20, 4, "cauchy"),
    "decode_4_of_10": lambda: _decode_matrix("vandermonde", 10, 4, (1, 6, 12, 13)),
    "decode_1_lost": lambda: _decode_matrix("vandermonde", 10, 4, (3,)),
    "decode_merge_20_4": lambda: _decode_matrix("cauchy", 20, 4, (0, 1, 22, 23)),
    "random_32x32": lambda: np.random.default_rng(5).integers(0, 256, (32, 32), np.uint8),
    "random_1x1": lambda: np.array([[0x8E]], dtype=np.uint8),
}
WIDTHS = [1, 15, 16, 17, 100, 8321, 65536]


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("width", WIDTHS)
def test_kernel_equals_plain_version(card, name, width):
    m = MATRICES[name]()
    data = np.random.default_rng(width).integers(0, 256, (m.shape[1], width), np.uint8)
    x = torch.from_numpy(data).to(card)
    before = rs_cuda.launches
    got = rs_cuda.apply_matrix(m, x)
    want = rs_torch.gf_apply(rs_torch.lifted_matrix(m, card), x)
    torch.cuda.synchronize()
    assert rs_cuda.launches == before + 1
    assert got.device.type == "cuda" and got.shape == (m.shape[0], width)
    assert torch.equal(got, want)
    assert np.array_equal(got.cpu().numpy(), gf8.gf_mat_vec(m, data))


@pytest.mark.parametrize("batch", [1, 2, 5])
def test_kernel_batched_and_strided(card, batch):
    m = MATRICES["rs_10_4"]()
    rng = np.random.default_rng(batch)
    slot = torch.from_numpy(rng.integers(0, 256, (batch, 10, 4112), np.uint8)).to(card)
    for view in (slot, slot[..., :4001], slot[..., 3:4001]):
        got = rs_cuda.apply_matrix(m, view)
        want = rs_torch.gf_apply(rs_torch.lifted_matrix(m, card), view.contiguous())
        assert torch.equal(got, want)
    flat = rs_cuda.apply_matrix(m, slot[0, :, :1000])
    assert torch.equal(flat, rs_cuda.apply_matrix(m, slot[:1, :, :1000])[0])


def test_kernel_wrapper_rejects_on_card(card):
    m = MATRICES["rs_10_4"]()
    with pytest.raises(TypeError):
        rs_cuda.apply_matrix(m, torch.zeros((10, 64), dtype=torch.int32, device=card))
    with pytest.raises(ValueError, match="contiguous"):
        rs_cuda.apply_matrix(m, torch.zeros((64, 10), dtype=torch.uint8, device=card).t())
    with pytest.raises(ValueError, match="R, C"):
        rs_cuda.apply_matrix(np.ones((33, 10), np.uint8),
                             torch.zeros((10, 64), dtype=torch.uint8, device=card))


def test_stripe_engine_on_card_matches_cpu(card, tmp_path):
    """Encode, lose four shards, rebuild and decode with a CUDA encoder: the
    files equal the CPU encoder's, and the kernel ran in encode and rebuild."""
    size, large, small = 3 * 10 * 65536 + 12345, 65536, 16384
    data = np.random.default_rng(1).integers(0, 256, size, np.uint8).tobytes()
    bases = {}
    for dev in ("cpu", "cuda"):
        os.makedirs(tmp_path / dev)
        base = str(tmp_path / dev / "3")
        with open(base + ".dat", "wb") as f:
            f.write(data)
        enc = rs_codec.new_encoder(device=dev)
        n0 = rs_cuda.launches
        stripe.write_ec_files(base, large, small, buffer_size=16384, encoder=enc,
                              max_batch_bytes=10 * 3 * 16384)
        encode_launches = rs_cuda.launches - n0
        for s in (0, 5, 10, 13):
            os.unlink(stripe.shard_file_name(base, s))
        n0 = rs_cuda.launches
        assert stripe.rebuild_ec_files(base, encoder=enc, buffer_size=65536,
                                       max_batch_bytes=10 * 65536) == [0, 5, 10, 13]
        rebuild_launches = rs_cuda.launches - n0
        if dev == "cuda":
            assert encode_launches > 0 and rebuild_launches > 0
        os.unlink(base + ".dat")
        stripe.write_dat_file(base)
        bases[dev] = base
    for ext in [stripe.to_ext(s) for s in range(14)] + [".eci", ".dat"]:
        with open(bases["cpu"] + ext, "rb") as a, open(bases["cuda"] + ext, "rb") as b:
            assert a.read() == b.read(), ext
    with open(bases["cuda"] + ".dat", "rb") as f:
        assert f.read() == data


def test_new_encoder_defaults_to_the_card(card):
    enc = rs_codec.new_encoder()
    assert enc.backend == "cuda" and enc.device.type == "cuda"
    assert enc.selection["source"] == "default"
    data = np.random.default_rng(2).integers(0, 256, (10, 777), np.uint8)
    shards = enc.encode(list(data))
    assert enc.verify(shards)
    lost = [None if i in (2, 11) else s for i, s in enumerate(shards)]
    assert all(np.array_equal(a, b) for a, b in zip(enc.reconstruct(lost), shards))


NEW_VARIANTS = ("dma", "mplane", "u8", "bf16")
VARIANT_CASES = {
    # case: (matrix name, data shape, tile)
    "ragged1": ("rs_10_4", (1, 10, 1), None),
    "ragged100": ("rs_10_4", (1, 10, 100), None),
    "ragged8321": ("rs_10_4", (1, 10, 8321), None),
    "batched": ("rs_10_4", (3, 10, 8321), None),
    "cauchy_12_3": ("cauchy_12_3", (1, 12, 65543), None),
    "merge_20_4": ("merge_20_4", (2, 20, 65543), None),
    "decode_merge_20_4": ("decode_merge_20_4", (1, 20, 8321), None),
    "decode_4_of_10": ("decode_4_of_10", (1, 10, 100000), None),
    "decode_1_lost": ("decode_1_lost", (1, 10, 4097), None),
    "tile8192": ("rs_10_4", (2, 10, 100003), 8192),
    "tile16384_merge": ("merge_20_4", (1, 20, 70001), 16384),
    "random_32x32": ("random_32x32", (1, 32, 5000), None),
    "random_1x1": ("random_1x1", (1, 1, 3000), None),
}


@pytest.mark.parametrize("variant", ("int8",) + NEW_VARIANTS)
@pytest.mark.parametrize("case", sorted(VARIANT_CASES))
def test_variant_kernel_equals_plain_version(card, variant, case):
    name, shape, tile = VARIANT_CASES[case]
    m = MATRICES[name]()
    data = np.random.default_rng(len(case)).integers(0, 256, shape, np.uint8)
    x = torch.from_numpy(data).to(card)
    before = dict(rs_cuda.launches_by_variant)
    got = rs_cuda.apply_matrix(m, x, tile=tile, variant=variant)
    want = rs_cuda.plain_apply(m, x, tile=tile, variant=variant)
    torch.cuda.synchronize()
    assert rs_cuda.launches_by_variant[variant] == before.get(variant, 0) + 1
    assert got.shape == (shape[0], m.shape[0], shape[-1])
    assert torch.equal(got, want)
    assert np.array_equal(got[0].cpu().numpy(), gf8.gf_mat_vec(m, data[0]))


@pytest.mark.parametrize("tile", [128, 384, 2176])
@pytest.mark.parametrize("name", ["rs_10_4", "random_32x32"])
def test_int8_kernel_tiles_below_and_off_the_span(card, tile, name):
    """int8 takes any multiple of 128 as its tile, below and between the
    2048-column trips of its blocks."""
    m = MATRICES[name]()
    data = np.random.default_rng(tile).integers(0, 256, (2, m.shape[1], 10007), np.uint8)
    x = torch.from_numpy(data).to(card)
    got = rs_cuda.apply_matrix(m, x, tile=tile, variant="int8")
    want = rs_cuda.plain_apply(m, x, tile=tile, variant="int8")
    assert torch.equal(got, want)
    assert np.array_equal(got[1].cpu().numpy(), gf8.gf_mat_vec(m, data[1]))


@pytest.mark.parametrize("tile", [128, 384, 1024, 4096, 65536])
@pytest.mark.parametrize("name", ["rs_10_4", "random_32x32", "random_1x1"])
def test_dma_kernel_stage_widths_and_work_items(card, tile, name):
    """dma's stages are rs_cuda._dma_chunk(tile) columns wide (128 to 2048)
    and its persistent blocks walk (batch element, tile) items: from many
    small items per block to fewer items than blocks; (32, 32) takes its
    stages in narrow passes."""
    m = MATRICES[name]()
    data = np.random.default_rng(tile).integers(0, 256, (3, m.shape[1], 70001), np.uint8)
    x = torch.from_numpy(data).to(card)
    got = rs_cuda.apply_matrix(m, x, tile=tile, variant="dma")
    want = rs_cuda.plain_apply(m, x, tile=tile, variant="dma")
    assert torch.equal(got, want)
    assert np.array_equal(got[2].cpu().numpy(), gf8.gf_mat_vec(m, data[2]))


@pytest.mark.parametrize("c, rows", [(10, 4), (10, 1), (12, 3), (20, 4), (32, 32), (1, 1), (32, 5)])
@pytest.mark.parametrize("chunk", [128, 512, 2048])
def test_dma_kernel_plan_is_rs_cuda_plan(card, c, rows, chunk):
    got = rs_cuda.dma_device_plan(c, rows, chunk)
    want = rs_cuda.dma_plan(c, rows, chunk)
    assert (got["stages"], got["pass_cols"], got["smem"]) == (want.stages, want.pass_cols, want.smem)
    assert 1 <= got["blocks_per_sm"] <= want.blocks_per_sm
    assert got["sms"] == torch.cuda.get_device_properties(0).multi_processor_count


@pytest.mark.parametrize("variant", NEW_VARIANTS)
def test_variant_kernel_strided_views(card, variant):
    m = MATRICES["rs_10_4"]()
    slot = torch.from_numpy(
        np.random.default_rng(4).integers(0, 256, (2, 10, 12288), np.uint8)).to(card)
    for view in (slot[..., :10001], slot[..., 3:10001], slot[1, :, 5:9000]):
        got = rs_cuda.apply_matrix(m, view, variant=variant)
        want = rs_cuda.plain_apply(m, view.contiguous(), variant=variant)
        assert torch.equal(got, want)


@pytest.mark.parametrize("variant", rs_cuda.KERNELS)
def test_all_variants_agree_and_cpu_tensors_launch_nothing(card, variant):
    m = MATRICES["rs_10_4"]()
    data = np.random.default_rng(6).integers(0, 256, (10, 33333), np.uint8)
    got = rs_cuda.apply_matrix(m, torch.from_numpy(data).to(card), variant=variant)
    assert np.array_equal(got.cpu().numpy(), gf8.gf_mat_vec(m, data))
    total, mine = rs_cuda.launches, rs_cuda.launches_by_variant.get(variant, 0)
    cpu = rs_cuda.apply_matrix(m, torch.from_numpy(data), variant=variant)
    assert rs_cuda.launches == total and rs_cuda.launches_by_variant.get(variant, 0) == mine
    assert torch.equal(cpu, got.cpu())


def test_variant_wrapper_rejects_on_card(card):
    m = MATRICES["rs_10_4"]()
    x = torch.zeros((10, 4096), dtype=torch.uint8, device=card)
    with pytest.raises(ValueError, match="unknown variant"):
        rs_cuda.apply_matrix(m, x, variant="fp8")
    with pytest.raises(ValueError, match="multiple of 2048"):
        rs_cuda.apply_matrix(m, x, tile=1024, variant="bf16")
    with pytest.raises(ValueError, match="multiple of 128"):
        rs_cuda.apply_matrix(m, x, tile=100, variant="dma")


@pytest.mark.parametrize("variant", NEW_VARIANTS)
def test_variant_encoder_stripe_round_trip_on_card(card, variant, tmp_path):
    size = 2 * 10 * 65536 + 999
    data = np.random.default_rng(3).integers(0, 256, size, np.uint8).tobytes()
    base = str(tmp_path / "7")
    with open(base + ".dat", "wb") as f:
        f.write(data)
    enc = rs_codec.Encoder(10, 4, variant=variant, device=card)
    n0 = rs_cuda.launches_by_variant.get(variant, 0)
    stripe.write_ec_files(base, 65536, 16384, buffer_size=16384, encoder=enc,
                          max_batch_bytes=10 * 3 * 16384)
    n1 = rs_cuda.launches_by_variant.get(variant, 0)
    for s in (0, 5, 10, 13):
        os.unlink(stripe.shard_file_name(base, s))
    assert stripe.rebuild_ec_files(base, encoder=enc) == [0, 5, 10, 13]
    assert n1 > n0 and rs_cuda.launches_by_variant[variant] > n1
    os.unlink(base + ".dat")
    stripe.write_dat_file(base)
    with open(base + ".dat", "rb") as f:
        assert f.read() == data


@pytest.mark.parametrize("rows", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("cols", [1, 10, 20, 32])
def test_bf16_kernel_rows_and_columns(card, rows, cols):
    """bf16 at R = 1..4 (B in registers where R * ceil(C/4) <= 16), R = 5
    and 8 (B read per product), over C from one word to eight: byte-exact
    against `rs_torch.gf_apply_bf16` and the int8 kernel, ragged width."""
    rng = np.random.default_rng(100 * rows + cols)
    m = rng.integers(0, 256, (rows, cols), np.uint8)
    data = rng.integers(0, 256, (2, cols, 20001), np.uint8)
    x = torch.from_numpy(data).to(card)
    before = rs_cuda.launches_by_variant.get("bf16", 0)
    got = rs_cuda.apply_matrix(m, x, variant="bf16")
    torch.cuda.synchronize()
    assert rs_cuda.launches_by_variant["bf16"] == before + 1
    assert torch.equal(got, rs_torch.gf_apply_bf16(rs_cuda.plane_major_matrix(m), x))
    assert torch.equal(got, rs_cuda.apply_matrix(m, x, variant="int8"))
    assert np.array_equal(got[1].cpu().numpy(), gf8.gf_mat_vec(m, data[1]))


@pytest.mark.parametrize("tile", [None, 2048, 6144])
def test_bf16_kernel_strided_views_and_tiles(card, tile):
    m = MATRICES["rs_10_4"]()
    slot = torch.from_numpy(
        np.random.default_rng(8).integers(0, 256, (3, 10, 12288), np.uint8)).to(card)
    for view in (slot, slot[..., :10001], slot[..., 3:10001], slot[1, :, 5:9000]):
        got = rs_cuda.apply_matrix(m, view, tile=tile, variant="bf16")
        assert torch.equal(got, rs_cuda.apply_matrix(m, view.contiguous(), variant="int8"))
        assert torch.equal(got, rs_torch.gf_apply_bf16(rs_cuda.plane_major_matrix(m), view.contiguous()))


@pytest.mark.parametrize("variant", ["u8", "mplane"])
@pytest.mark.parametrize("rows", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("cols", [1, 4, 10, 20, 32])
def test_s8_kernels_rows_and_columns(card, variant, rows, cols):
    """u8 and mplane at R = 1..4 (B in registers), R = 5 and 8 (B in shared
    memory), over C from one word to eight: byte-exact against their plain
    versions and the int8 kernel, ragged width."""
    rng = np.random.default_rng(100 * rows + cols)
    m = rng.integers(0, 256, (rows, cols), np.uint8)
    data = rng.integers(0, 256, (2, cols, 20001), np.uint8)
    x = torch.from_numpy(data).to(card)
    before = rs_cuda.launches_by_variant.get(variant, 0)
    got = rs_cuda.apply_matrix(m, x, variant=variant)
    torch.cuda.synchronize()
    assert rs_cuda.launches_by_variant[variant] == before + 1
    assert torch.equal(got, rs_cuda.plain_apply(m, x, variant=variant))
    assert torch.equal(got, rs_cuda.apply_matrix(m, x, variant="int8"))
    assert np.array_equal(got[1].cpu().numpy(), gf8.gf_mat_vec(m, data[1]))


@pytest.mark.parametrize("tile", [128, 1024, 2176])
@pytest.mark.parametrize("variant", ["u8", "mplane"])
@pytest.mark.parametrize("name", ["rs_10_4", "random_32x32"])
def test_s8_kernels_tiles_below_and_off_the_span(card, name, variant, tile):
    """u8 and mplane take any multiple of 128 as their tile, below and
    between the 2048-column trips of their blocks."""
    m = MATRICES[name]()
    data = np.random.default_rng(tile).integers(0, 256, (2, m.shape[1], 10007), np.uint8)
    x = torch.from_numpy(data).to(card)
    got = rs_cuda.apply_matrix(m, x, tile=tile, variant=variant)
    assert torch.equal(got, rs_cuda.plain_apply(m, x, tile=tile, variant=variant))
    assert np.array_equal(got[1].cpu().numpy(), gf8.gf_mat_vec(m, data[1]))


# -- the degraded read on the card ------------------------------------------------


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("width", [100, 4096, 4097, 65536, 70001, 1 << 20, (1 << 20) + 5])
def test_bucketed_reconstruct_batch_on_card(card, monkeypatch, batch, width):
    """`reconstruct_batch(bucketed=True)` on the card pads to the next
    bucket (none past 1 MiB), launches once, and equals the plain version."""
    gpu, cpu = rs_codec.Encoder(10, 4, device=card), rs_codec.Encoder(10, 4, device="cpu")
    survivors, wanted = [1, 2, 3, 4, 6, 7, 8, 9, 11, 12], [5]
    stack = np.random.default_rng(width + batch).integers(0, 256, (batch, 10, width), np.uint8)
    shapes = []
    real = rs_cuda.apply_matrix

    def spy(m, shards, tile=None, variant="int8"):
        shapes.append(tuple(shards.shape))
        return real(m, shards, tile, variant)

    monkeypatch.setattr(rs_cuda, "apply_matrix", spy)
    before = rs_cuda.launches_by_variant.get("int8", 0)
    got = gpu.reconstruct_batch(stack, survivors, wanted, bucketed=True)
    assert rs_cuda.launches_by_variant["int8"] == before + 1
    bucket = next((b for b in gpu.RECONSTRUCT_BUCKETS if width <= b), width)
    assert shapes == [(batch, 10, bucket)]
    want = cpu.reconstruct_batch(stack, survivors, wanted)
    assert got.shape == (batch, 1, width) and np.array_equal(got, want)


def _card_volume(d, records_seed: int = 9):
    """A volume of 40 needles of 1 B to 40 KiB (small blocks of 4 KiB, so
    the larger records cross rows and put several intervals on one shard)
    with shards 0, 5, 10 and 13 lost; -> (base, {needle id: record})."""
    from seaweedfs_tpu_torch.storage import idx, types

    rng = np.random.default_rng(records_seed)
    base = os.path.join(str(d), "11")
    records, offset, blobs = {}, 8, [b"\x03" + bytes(7)]
    for nid in rng.permutation(1000)[:40] + 1:
        body = int(rng.integers(1, 40 << 10))
        rec = rng.integers(0, 256, types.actual_size(body), np.uint8).tobytes()
        records[int(nid)] = (offset, body, rec)
        blobs.append(rec)
        offset += len(rec)
    with open(base + ".dat", "wb") as f:
        f.write(b"".join(blobs))
    idx.write_entries([(k, off // 8, size) for k, (off, size, _) in records.items()], base + ".idx")
    stripe.write_ec_files(base, 65536, 4096, buffer_size=4096,
                          encoder=rs_codec.Encoder(10, 4, device="cpu"))
    stripe.write_sorted_file_from_idx(base)
    for s in (0, 5, 10, 13):
        os.unlink(stripe.shard_file_name(base, s))
    return base, {k: rec for k, (_, _, rec) in records.items()}


def _reconstruct_count() -> float:
    from seaweedfs_tpu_torch import stats

    return next(float(line.split()[-1]) for line in stats.REGISTRY.expose().splitlines()
                if line.startswith("weedtpu_ec_reconstruct_seconds_count "))


def test_traced_degraded_read_on_card_records_a_decode_span_per_launch(card, tmp_path,
                                                                        monkeypatch):
    """Every read of a degraded volume on the card inside the `http.read`
    root the volume server opens: the ring keeps every root, each degraded
    one with `ec.recover` over `ec.gather` and `ec.decode`; the `ec.decode`
    spans equal the kernel launches, and the exposition's reconstruct count
    rises by as many; the stages sum to each root's duration."""
    from seaweedfs_tpu_torch.ec import ec_volume
    from seaweedfs_tpu_torch.obs import trace

    base, records = _card_volume(tmp_path)
    monkeypatch.setenv("WEEDTPU_READ_CACHE_MB", "0")  # every read decodes
    monkeypatch.setenv("WEEDTPU_TRACE", "on")
    ring = trace.TraceRing(capacity=64, slowest_n=64, sample=1.0, seed=0)
    with ec_volume.EcVolume(base, encoder=rs_codec.new_encoder()) as ev:
        ev.warm_thread.join()
        n0, c0 = rs_cuda.launches, _reconstruct_count()
        for k, rec in records.items():
            with trace.start("http.read", klass="healthy", ring=ring):
                assert ev.read_needle_blob(k)[: len(rec)] == rec
        launches, rise = rs_cuda.launches - n0, _reconstruct_count() - c0
    snap = ring.snapshot(limit=1000)
    assert len(snap) == len(records) == ring.stats()["kept"]
    spans = [s for t in snap for s in trace.iter_spans(t)]
    assert launches > 0 and sum(s["name"] == "ec.decode" for s in spans) == launches == rise
    degraded = [t for t in snap if t["class"] == "degraded"]
    assert degraded
    for t in degraded:
        recovers = [s for s in trace.iter_spans(t) if s["name"] == "ec.recover"]
        assert recovers and all({c["name"] for c in s["spans"]} == {"ec.gather", "ec.decode"}
                                for s in recovers)
    for t in snap:
        assert abs(sum(trace.attribute_stages(t).values()) - t["duration_s"]) < 1e-9


def test_card_ec_volume_reads_equal_cpu_serially_and_from_threads(card, tmp_path, monkeypatch):
    import threading

    from seaweedfs_tpu_torch.ec import ec_volume

    base, records = _card_volume(tmp_path)
    monkeypatch.setenv("WEEDTPU_READ_CACHE_MB", "0")  # every pass decodes
    with ec_volume.EcVolume(base, encoder=rs_codec.Encoder(10, 4, device="cpu")) as ev:
        want = {k: ev.read_needle_blob(k) for k in records}
    for k, rec in records.items():
        assert want[k][: len(rec)] == rec
    with ec_volume.EcVolume(base, encoder=rs_codec.new_encoder()) as ev:
        ev.warm_thread.join()
        n0 = rs_cuda.launches_by_variant.get("int8", 0)
        serial = {k: ev.read_needle_blob(k) for k in records}
        n1 = rs_cuda.launches_by_variant.get("int8", 0)
        threaded, lock = {}, threading.Lock()
        keys = list(records)

        def reader(i):
            for k in keys[i::8]:
                blob = ev.read_needle_blob(k)
                with lock:
                    threaded[k] = blob

        threads = [threading.Thread(target=reader, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        n2 = rs_cuda.launches_by_variant.get("int8", 0)
    assert serial == want and threaded == want
    assert n1 > n0 and n2 - n1 == n1 - n0  # every decode launched, in both passes


def test_ec_volume_with_no_encoder_runs_on_the_card(card, tmp_path):
    from seaweedfs_tpu_torch.ec import ec_volume

    base, records = _card_volume(tmp_path, 4)
    with ec_volume.EcVolume(base) as ev:
        assert ev.encoder.backend == "cuda" and ev.encoder.device.type == "cuda"
        n0 = rs_cuda.launches
        for k, rec in records.items():
            assert ev.read_needle_blob(k)[: len(rec)] == rec
        assert rs_cuda.launches > n0


@pytest.mark.parametrize("variant", rs_cuda.KERNELS)
def test_kernels_launch_from_threads_with_different_shared_memory(card, variant):
    """Reader threads launch one kernel (C = 32: the same column words)
    with different shared memory at once: R = 5, 8 and 32 (the R > 4
    kernels size it by R), and for dma two chunk widths. Each opt-in only
    rises, so no launch finds its shared memory undercut; all are exact."""
    import threading

    rng = np.random.default_rng(12)
    jobs = []
    for rows in (5, 8, 32):
        for tile in ((None, 512) if variant == "dma" else (None,)):
            m = rng.integers(0, 256, (rows, 32), np.uint8)
            x = torch.from_numpy(rng.integers(0, 256, (2, 32, 30001), np.uint8)).to(card)
            jobs.append((m, x, tile, rs_cuda.plain_apply(m, x, tile=tile, variant=variant)))
    torch.cuda.synchronize()
    errors = []
    start = threading.Barrier(8)

    def worker(i):
        try:
            start.wait()
            for k in range(24):
                m, x, tile, want = jobs[(i + k) % len(jobs)]
                got = rs_cuda.apply_matrix(m, x, tile=tile, variant=variant)
                torch.cuda.current_stream().synchronize()
                if not torch.equal(got, want):
                    errors.append((i, k))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors, errors[:5]


# -- the remote, trace and fused rebuilds on the card -------------------------------


@pytest.mark.parametrize("rows", [1, 4])
@pytest.mark.parametrize("local", [1, 3, 4, 10, 14])
def test_project_on_card_equals_cpu(card, rows, local):
    """A holder's projection: an (R, L) matrix over its L local survivors,
    one launch, equal to the CPU encoder's."""
    rng = np.random.default_rng(rows * 100 + local)
    coeffs = rng.integers(0, 256, (rows, local), np.uint8)
    stack = rng.integers(0, 256, (local, 70_001), np.uint8)
    gpu, cpu = rs_codec.Encoder(10, 4, device=card), rs_codec.Encoder(10, 4, device="cpu")
    before = rs_cuda.launches
    got = gpu.project(coeffs, stack)
    assert rs_cuda.launches == before + 1
    assert np.array_equal(got, cpu.project(coeffs, stack))
    assert np.array_equal(got, gf8.gf_project(coeffs, stack))


@pytest.mark.parametrize("groups", [1, 3, 14])
def test_trace_combine_on_a_short_strided_batch(card, groups):
    """The combine's input is a column slice of a pinned ring slot, not
    contiguous when the batch is short: the all-ones (1 x G) launch equals
    the CPU's on it, and equals the XOR of the rows."""
    gpu, cpu = rs_codec.Encoder(10, 4, device=card), rs_codec.Encoder(10, 4, device="cpu")
    ring = stripe._ring_for(None, gpu, 3, (groups, 2 * 65536))
    for fill in range(3):  # every slot once, each a short batch
        slot = ring.take()
        slot[:] = np.random.default_rng(groups * 10 + fill).integers(0, 256, slot.shape, np.uint8)
        view = slot[:, : 2 * 40_001]
        assert view.flags.c_contiguous == (groups == 1)  # one row is contiguous
        combine = np.ones((1, groups), dtype=np.uint8)
        lazy = gpu.project_lazy(combine, view)
        want = np.bitwise_xor.reduce(view, axis=0)[None]
        assert np.array_equal(np.asarray(lazy), want)
        assert np.array_equal(cpu.project(combine, view), want)


@pytest.mark.parametrize("variant", rs_cuda.KERNELS)
@pytest.mark.parametrize("offset", [0, 3, 4097])
def test_reconstruct_block_on_card_equals_cpu(card, variant, offset):
    """Three geometries side by side from column `offset` of one (20, W)
    staging batch: one launch per block on a device column view (rows at
    any byte), equal to the CPU on every block's wanted rows."""
    encs = {k: rs_codec.Encoder(k, m, kind, device=card, variant=variant)
            for k, m, kind in ((10, 4, "vandermonde"), (12, 3, "cauchy"), (20, 4, "cauchy"))}
    cpus = {k: rs_codec.Encoder(e.data_shards, e.parity_shards, e.matrix_kind, device="cpu")
            for k, e in encs.items()}
    specs = ((10, [0, 5, 13]), (12, [14]), (20, [1, 2, 20, 23]))
    staging = np.random.default_rng(offset).integers(0, 256, (20, offset + 3 * 65_537 + 9), np.uint8)

    def blocks(table):
        out, col = [], offset
        for k, missing in specs:
            enc = table[k]
            surv = [s for s in range(enc.total_shards) if s not in missing][:k]
            out.append({"encoder": enc, "survivors": surv, "wanted": missing,
                        "col_start": col, "width": 65_537})
            col += 65_537
        return out

    before = rs_cuda.launches_by_variant.get(variant, 0)
    got = np.asarray(encs[10].reconstruct_block(staging, blocks(encs)))
    assert rs_cuda.launches_by_variant[variant] == before + 3
    want = np.asarray(cpus[10].reconstruct_block(staging, blocks(cpus)))
    assert got.shape == want.shape == (4, staging.shape[1])
    for b in blocks(cpus):
        rows, c0 = len(b["wanted"]), b["col_start"]
        assert np.array_equal(got[:rows, c0 : c0 + 65_537], want[:rows, c0 : c0 + 65_537])


def _card_shard_set(d, size: int = 4_000_000):
    """A 10+4 shard set of a .dat whose shards (409 600 bytes) are no
    multiple of the rebuilds' spans; -> (base, {shard: bytes})."""
    base = os.path.join(str(d), "21")
    with open(base + ".dat", "wb") as f:
        f.write(np.random.default_rng(21).integers(0, 256, size, np.uint8).tobytes())
    stripe.write_ec_files(base, 65536, 16384, buffer_size=16384,
                          encoder=rs_codec.Encoder(10, 4, device="cpu"))
    golden = {}
    for s in range(14):
        with open(stripe.shard_file_name(base, s), "rb") as f:
            golden[s] = f.read()
    return base, golden


def test_projection_rebuild_on_card_with_threaded_holder_projections(card, tmp_path):
    """Three remote groups whose holder half projects on the card, four
    fetch threads per group at once, plus a local group: the rebuilt shard
    equals the original, and the launches are one projection per fetched
    chunk, one per local window and one combine per batch."""
    import threading

    base, golden = _card_shard_set(tmp_path)
    missing = [5]
    os.unlink(stripe.shard_file_name(base, 5))
    shard_size = len(golden[0])
    gpu = rs_codec.new_encoder()
    survivors = stripe.find_local_shards(base)[:10]
    plan = gpu.repair_projection_plan(survivors, missing)
    cols = lambda sids: np.stack([plan[s] for s in sids], axis=1)  # noqa: E731
    fetches, lock = [], threading.Lock()

    def holder(sids):
        def fetch(offset, size):
            actual = max(0, min(size, shard_size - offset))
            stack = np.empty((len(sids), actual), np.uint8)
            for i, s in enumerate(sids):
                with open(stripe.shard_file_name(base, s), "rb") as f:
                    stripe.read_padded_into(f, offset, stack[i])
            with lock:
                fetches.append(threading.get_ident())
            return gpu.project(cols(sids), stack).tobytes()
        return fetch

    parts = (survivors[:3], survivors[3:6], survivors[6:9])
    groups = [stripe.TraceSlabSource(f"h{i}", sids, 1, holder(sids), chunk_bytes=65536, fanout=4)
              for i, sids in enumerate(parts)]
    groups.append(stripe.LocalProjectionSource([stripe.shard_file_name(base, survivors[9])],
                                               cols(survivors[9:]), gpu))
    span = 3 * 65536
    n0 = rs_cuda.launches
    try:
        assert stripe.rebuild_ec_files_from_projections(
            base, groups, shard_size, missing, encoder=gpu, buffer_size=65536,
            max_batch_bytes=10 * span) == missing
    finally:
        for g in groups:
            g.close()
    batches = -(-shard_size // span)
    assert shard_size % span
    assert rs_cuda.launches - n0 == len(fetches) + 2 * batches
    assert len(set(fetches)) > 1
    assert sum(g.bytes_fetched for g in groups) == 3 * shard_size
    with open(stripe.shard_file_name(base, 5), "rb") as f:
        assert f.read() == golden[5]


def test_remote_rebuild_on_card_fails_over(card, tmp_path):
    base, golden = _card_shard_set(tmp_path)
    for s in (0, 5, 10, 13):
        os.unlink(stripe.shard_file_name(base, s))
    import threading

    calls, lock = {"dead": 0}, threading.Lock()

    def fetch_for(s):
        def fetch(addr, offset, size):
            if addr == "dead":
                with lock:
                    calls["dead"] += 1
                    gone = calls["dead"] > 3
                if gone:
                    raise IOError("holder gone")
            with open(stripe.shard_file_name(base, s), "rb") as f:
                return os.pread(f.fileno(), size, offset)
        return fetch

    sources = {s: stripe.RemoteSlabSource(s, ["dead", "live"], fetch_for(s), stripe_bytes=65536)
               for s in range(14) if s not in (0, 5, 10, 13)}
    n0 = rs_cuda.launches
    try:
        assert stripe.rebuild_ec_files_from_sources(
            base, sources, len(golden[0]), encoder=rs_codec.new_encoder(), buffer_size=65536,
            max_batch_bytes=10 * 2 * 65536) == [0, 5, 10, 13]
    finally:
        for src in sources.values():
            src.close()
    assert rs_cuda.launches - n0 == -(-len(golden[0]) // (2 * 65536))
    assert any(src.failovers == ["dead"] for src in sources.values())
    for s in (0, 5, 10, 13):
        with open(stripe.shard_file_name(base, s), "rb") as f:
            assert f.read() == golden[s]


def test_batch_rebuild_on_card_fused_equals_unfused(card, tmp_path):
    """Three volumes of three geometries: fused (one pipeline, one launch
    per block per batch) and unfused (one pipeline per signature) give the
    original shards."""
    specs = ((31, 700_001, (10, 4, "vandermonde"), [0, 5, 10, 13]),
             (32, 500_003, (12, 3, "cauchy"), [0, 13, 14]),
             (33, 300_007, (10, 4, "vandermonde"), [2, 11]))
    vols = []
    for vid, size, (k, m, kind), missing in specs:
        base = os.path.join(str(tmp_path), str(vid))
        with open(base + ".dat", "wb") as f:
            f.write(np.random.default_rng(vid).integers(0, 256, size, np.uint8).tobytes())
        stripe.write_ec_files(base, 65536, 16384, buffer_size=16384,
                              encoder=rs_codec.Encoder(k, m, kind, device="cpu"))
        golden = {}
        for s in missing:
            with open(stripe.shard_file_name(base, s), "rb") as f:
                golden[s] = f.read()
        vols.append((base, rs_codec.Encoder(k, m, kind, device=card), missing, golden))
    for fuse in (True, False):
        jobs = []
        for base, enc, missing, _ in vols:
            for s in missing:
                os.unlink(stripe.shard_file_name(base, s))
            present = [s for s in range(enc.total_shards) if s not in missing]
            jobs.append({"base": base, "encoder": enc, "missing": missing,
                         "shard_size": os.path.getsize(stripe.shard_file_name(base, present[0])),
                         "sources": {s: stripe.LocalSlabSource(stripe.shard_file_name(base, s))
                                     for s in present}})
        n0 = rs_cuda.launches
        try:
            res = stripe.rebuild_ec_files_batch(jobs, buffer_size=65536,
                                                max_batch_bytes=12 * 65536, fuse=fuse)
        finally:
            for job in jobs:
                for src in job["sources"].values():
                    src.close()
        assert not res["errors"] and res["signature_groups"] == 3
        assert res["dispatch_groups"] == (1 if fuse else 3)
        assert rs_cuda.launches > n0
        for base, _, missing, golden in vols:
            assert res["rebuilt"][base] == missing
            for s in missing:
                with open(stripe.shard_file_name(base, s), "rb") as f:
                    assert f.read() == golden[s], (fuse, base, s)


# -- inline ingest, conversion and scrub on the card ---------------------------------


@pytest.mark.parametrize("variant", rs_codec.FUSED_VARIANTS)
@pytest.mark.parametrize("n", [1, 17, 4113, 1 << 20])
def test_parity_delta_on_card_equals_plain_and_golden(card, variant, n):
    """The delta's (4, 1) launch at odd and wide widths, every variant."""
    enc = rs_codec.Encoder(10, 4, device=card, variant=variant)
    rng = np.random.default_rng(n)
    old, new = rng.integers(0, 256, (2, n), dtype=np.uint8)
    for shard in (0, 9):
        before = rs_cuda.launches_by_shape.get((4, 1), 0)
        got = enc.parity_delta(shard, old, new)
        assert rs_cuda.launches_by_shape.get((4, 1), 0) == before + 1
        col = np.ascontiguousarray(enc.parity_matrix[:, shard: shard + 1])
        delta = torch.from_numpy(old ^ new)[None].to(card)
        plain = rs_cuda.plain_apply(col, delta, variant=variant).cpu().numpy()
        assert got.shape == (4, n)
        assert np.array_equal(got, plain)
        assert np.array_equal(got, gf8.gf_delta_parity(enc.parity_matrix[:, shard], old ^ new))


def _ingest_with_overwrites(base: str, enc, data: bytes, large: int, small: int) -> dict:
    """Appends with a poll each, three overwrites into encoded rows (one
    across a block boundary), then the seal; -> the seal's accounting."""
    from seaweedfs_tpu_torch.ec import ingest

    b = ingest.InlineStripeBuilder(base, enc, large, small, buffer_size=4096)
    final = bytearray(data)
    with open(base + ".dat", "wb") as f:
        for off in range(0, len(data), 50_000):
            f.write(data[off: off + 50_000])
            f.flush()
            b.poll()
    rng = np.random.default_rng(len(data))
    for off, length in ((large * 3 - 7, 4113), (11, 1), (large * 10 + 5, 700)):
        new = rng.integers(0, 256, length, np.uint8).tobytes()

        def mutate(off=off, new=new):
            with open(base + ".dat", "r+b") as f:
                f.seek(off)
                f.write(new)

        assert b.overwrite(off, bytes(final[off: off + length]), new, mutate=mutate) > 0
        final[off: off + length] = new
    return b.seal()


def test_ingest_with_overwrites_on_card_equals_cpu(card, tmp_path):
    large, small = 16384, 4096
    data = np.random.default_rng(8).integers(0, 256, large * 10 * 3 + 77_777, np.uint8).tobytes()
    shas = {}
    for dev in ("cpu", card):
        base = os.path.join(str(tmp_path), str(dev), "7")
        os.makedirs(os.path.dirname(base))
        enc = rs_codec.Encoder(10, 4, device=dev)
        rs_cuda.reset_launches()
        info = _ingest_with_overwrites(base, enc, data, large, small)
        assert info["rows_inline"] == 3 and info["delta_updates"] == 3
        shas[str(dev)] = [open(stripe.shard_file_name(base, s), "rb").read() for s in range(14)]
        shas[str(dev)].append(open(base + ".eci", "rb").read())
        if dev == card:
            by_shape = dict(rs_cuda.launches_by_shape)
            assert by_shape.get((4, 10), 0) > 0 and by_shape.get((4, 1), 0) == 4  # 4 segments
    assert shas["cpu"] == shas[str(card)]


def test_conversion_chain_on_card_from_degraded_source_equals_cpu(card, tmp_path):
    """10+4 (shards 0 and 7 lost) -> 12+3 -> 20+4, on the card and on the
    CPU: the same staged and cut-over bytes; the degraded runs launch at
    (1, 10)."""
    from seaweedfs_tpu_torch.ec import convert

    data = np.random.default_rng(9).integers(0, 256, 2 * 4096 * 10 + 5 * 512 * 10 + 99,
                                             np.uint8).tobytes()
    out = {}
    for dev in ("cpu", card):
        base = os.path.join(str(tmp_path), str(dev), "1")
        os.makedirs(os.path.dirname(base))
        with open(base + ".dat", "wb") as f:
            f.write(data)
        stripe.write_ec_files(base, 4096, 512, buffer_size=512,
                              encoder=rs_codec.Encoder(10, 4, device="cpu"))
        os.unlink(base + ".dat")
        for s in (0, 7):
            os.unlink(stripe.shard_file_name(base, s))
        enc = rs_codec.Encoder(10, 4, device=dev)
        runs, reconstruct = [], enc.reconstruct
        enc.reconstruct = lambda shards, **kw: runs.append(kw) or reconstruct(shards, **kw)
        rs_cuda.reset_launches()
        res = convert.convert_ec_files(base, "cauchy_12_3", encoder=enc, buffer_size=512)
        assert res["reconstructed_bytes"] > 0 and runs
        convert.cutover(base)
        res2 = convert.convert_ec_files(base, "merge_20_4", encoder=enc, buffer_size=512)
        assert res2["reconstructed_bytes"] == 0
        convert.cutover(base)
        if dev == card:
            by_shape = dict(rs_cuda.launches_by_shape)
            assert by_shape.get((1, 10), 0) == len(runs)  # one per degraded run
            assert by_shape.get((3, 12), 0) > 0 and by_shape.get((4, 20), 0) > 0
        out[str(dev)] = [open(stripe.shard_file_name(base, s), "rb").read() for s in range(24)]
    assert out["cpu"] == out[str(card)]


def test_scrub_quarantine_repair_on_card_ec_volume(card, tmp_path):
    from seaweedfs_tpu_torch.ec import ec_volume, scrub

    base = os.path.join(str(tmp_path), "9")
    with open(base + ".dat", "wb") as f:
        f.write(np.random.default_rng(3).integers(0, 256, 600_000, np.uint8).tobytes())
    open(base + ".idx", "wb").close()
    enc = rs_codec.Encoder(10, 4, device=card)
    stripe.write_ec_files(base, 16384, 4096, encoder=enc)
    stripe.write_sorted_file_from_idx(base)
    golden = [open(stripe.shard_file_name(base, s), "rb").read() for s in range(14)]
    with ec_volume.EcVolume(base, encoder=enc, warm_on_mount=False) as ev:
        # damage under the mounted volume
        with open(stripe.shard_file_name(base, 5), "r+b") as f:
            f.seek(1000)
            f.write(bytes([golden[5][1000] ^ 1]))
        os.truncate(stripe.shard_file_name(base, 9), len(golden[9]) - 1)
        os.unlink(stripe.shard_file_name(base, 12))
        found = []

        def on_finding(vid, shard, verdict):
            found.append((shard, verdict))
            ev.quarantine_shard(shard, verdict)

        scrub.Scrubber(volumes=lambda: {9: ev}, on_finding=on_finding,
                       cursor_path=str(tmp_path / "c.json"), rate_mb=0.0).run_cycle()
        assert sorted(found) == [(5, "corrupt"), (9, "truncated"), (12, "missing")]
        n0 = rs_cuda.launches
        assert ev._read_shard_interval(5, 900, 300).tobytes() == golden[5][900:1200]
        assert rs_cuda.launches > n0
        for s in (5, 9):
            os.unlink(stripe.shard_file_name(base, s))
        before = rs_cuda.launches_by_shape.get((3, 10), 0)
        assert stripe.rebuild_ec_files(base, encoder=enc) == [5, 9, 12]
        assert rs_cuda.launches_by_shape.get((3, 10), 0) > before
        for s in (5, 9, 12):
            assert ev.mount_local_shard(s)
        verdicts, has_crcs = scrub.verify_ec_volume(ev)
        assert has_crcs and set(verdicts.values()) == {"ok"}
    assert [open(stripe.shard_file_name(base, s), "rb").read() for s in range(14)] == golden


def test_ingest_manager_seal_on_threads_beside_degraded_reads(card, tmp_path):
    """A manager's worker polls and its seal thread seal one volume on the
    card while the main thread reads another volume degraded on the card;
    both agree with the CPU."""
    import threading

    from seaweedfs_tpu_torch.ec import ec_volume, ingest

    enc = rs_codec.Encoder(10, 4, device=card)
    large, small = 16384, 4096
    base = os.path.join(str(tmp_path), "ing", "7")
    os.makedirs(os.path.dirname(base))
    data = np.random.default_rng(5).integers(0, 256, large * 10 * 4 + 1234, np.uint8).tobytes()

    class _Vol:
        base_path, dat_path, read_only, tiered = base, base + ".dat", False, False

    class _Store:
        encoder = enc

        def get_volume(self, vid):
            return _Vol()

    sealed, threads, done = {}, set(), threading.Event()

    def trigger(vid):
        try:
            threads.add(threading.current_thread().name)
            sealed.update(mgr.seal_volume(vid, base))
        finally:
            done.set()

    mgr = ingest.IngestManager(_Store(), seal_bytes=len(data), large_block_size=large,
                               small_block_size=small, buffer_size=4096, seal_trigger=trigger)
    rbase = os.path.join(str(tmp_path), "rd", "9")
    os.makedirs(os.path.dirname(rbase))
    with open(rbase + ".dat", "wb") as f:
        f.write(data[::-1])
    open(rbase + ".idx", "wb").close()
    stripe.write_ec_files(rbase, large, small, encoder=rs_codec.Encoder(10, 4, device="cpu"))
    stripe.write_sorted_file_from_idx(rbase)
    golden3 = open(stripe.shard_file_name(rbase, 3), "rb").read()
    os.unlink(stripe.shard_file_name(rbase, 3))
    try:
        with ec_volume.EcVolume(rbase, encoder=enc, warm_on_mount=False) as ev:
            with open(base + ".dat", "wb") as f:
                for off in range(0, len(data), 40_000):
                    f.write(data[off: off + 40_000])
                    f.flush()
                    mgr.on_write(7)
                    got = ev._read_shard_interval(3, off % (len(golden3) - 500), 500).tobytes()
                    assert got == golden3[off % (len(golden3) - 500):][:500]
            assert done.wait(60)
    finally:
        mgr.close()
    assert sealed.get("mode") == "inline" and threads and "MainThread" not in threads
    wbase = os.path.join(str(tmp_path), "warm", "7")
    os.makedirs(os.path.dirname(wbase))
    with open(wbase + ".dat", "wb") as f:
        f.write(data)
    stripe.write_ec_files(wbase, large, small, buffer_size=4096,
                          encoder=rs_codec.Encoder(10, 4, device="cpu"))
    for s in range(14):
        assert open(stripe.shard_file_name(base, s), "rb").read() == open(
            stripe.shard_file_name(wbase, s), "rb").read()


# -- the storage engine on the card -------------------------------------------------


@pytest.mark.parametrize("n", [32, 1000])
def test_single_interval_reconstruct_launches_at_the_4k_bucket(card, monkeypatch, n):
    """`Encoder.reconstruct` (a degraded read's one lost interval) launches
    at the 4 KiB bucket, the shape `warm_reconstruct` prepares at mount, and
    trims back to N bytes equal to the plain version's."""
    gpu, cpu = rs_codec.Encoder(10, 4, device=card), rs_codec.Encoder(10, 4, device="cpu")
    full = cpu.encode(list(np.random.default_rng(n).integers(0, 256, (10, n), np.uint8)))
    shapes = []
    real = rs_cuda.apply_matrix

    def spy(m, shards, tile=None, variant="int8"):
        shapes.append(tuple(shards.shape))
        return real(m, shards, tile, variant)

    monkeypatch.setattr(rs_cuda, "apply_matrix", spy)
    lost = [None if i == 5 else s for i, s in enumerate(full)]
    got = gpu.reconstruct(list(lost), wanted=[5])
    assert shapes == [(10, 4096)]
    assert got[5].shape == (n,) and np.array_equal(got[5], full[5])


def test_card_store_serves_a_degraded_ec_volume_equal_to_the_cpu_store(card, tmp_path):
    """A `Store` with the factory's encoder (the card) loads an EC volume
    with shards 0, 5, 10 and 13 lost and serves every needle as a CPU
    `Store` does, each degraded read one (1, 10) launch."""
    from seaweedfs_tpu_torch.storage import needle, store

    d = str(tmp_path / "store")
    cpu = rs_codec.Encoder(10, 4, device="cpu")
    s1 = store.Store([d], encoder=cpu)
    v = s1.create_volume(6, collection="benchmark")
    rng = np.random.default_rng(6)
    for i in range(1, 301):
        s1.write_needle(6, needle.Needle(cookie=i, id=i, data=rng.bytes(1024)))
    for i in range(5, 301, 10):
        s1.delete_needle(6, i)
    s1.close()
    stripe.write_ec_files(v.base_path, 1 << 16, 4096, buffer_size=4096, encoder=cpu)
    stripe.write_sorted_file_from_idx(v.base_path)
    for ext in (".dat", ".idx"):
        os.unlink(v.base_path + ext)
    for s in (0, 5, 10, 13):
        os.unlink(stripe.shard_file_name(v.base_path, s))
    plain, gpu = store.Store([d], encoder=cpu), store.Store([d])
    try:
        plain.load()
        gpu.load()
        ev = gpu.get_ec_volume(6)
        assert ev.encoder.device.type == "cuda"
        ev.warm_thread.join()
        assert [i.to_dict() for i in gpu.ec_volume_infos()] == [
            i.to_dict() for i in plain.ec_volume_infos()]
        shape0 = dict(rs_cuda.launches_by_shape)
        for i in range(1, 301):
            if i % 10 == 5:
                with pytest.raises(KeyError):
                    gpu.read_needle(6, i)
                continue
            got, want = gpu.read_needle(6, i, cookie=i), plain.read_needle(6, i, cookie=i)
            assert (got.data, got.append_at_ns) == (want.data, want.append_at_ns)
        launched = {k: v - shape0.get(k, 0) for k, v in rs_cuda.launches_by_shape.items()
                    if v != shape0.get(k, 0)}
        assert set(launched) == {(1, 10)} and launched[(1, 10)] > 0
    finally:
        plain.close()
        gpu.close()


# -- the master and volume servers on the card ----------------------------------------


def _card_cluster_run(root, encoder, monkeypatch) -> dict:
    """A port master and three volume servers on `encoder()`: 40 needles
    with fixed fids (the needle clock pinned), VolumeEcShardsGenerate on the
    owner, the spread (0-4 / 5-9 / 10-13), LOST lost, every needle read
    through the cluster, and LOST rebuilt remotely on B -> what came out."""
    import hashlib
    import itertools
    import time
    import types

    from seaweedfs_tpu_torch import rpc
    from seaweedfs_tpu_torch.cluster.client import MasterClient
    from seaweedfs_tpu_torch.cluster.master import MasterServer
    from seaweedfs_tpu_torch.cluster.volume_server import VolumeServer
    from seaweedfs_tpu_torch.pb import VOLUME_SERVICE
    from seaweedfs_tpu_torch.storage import needle
    from seaweedfs_tpu_torch.storage.file_id import FileId

    it = itertools.count(1_700_000_000_000_000_000, 1_000)
    shim = types.SimpleNamespace(**{k: getattr(time, k) for k in dir(time) if not k.startswith("_")})
    shim.time_ns = lambda: next(it)
    monkeypatch.setattr(needle, "time", shim)

    def sha(path):
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    def call(vs, method, req):
        with rpc.RpcClient(vs.grpc_address) as c:
            return c.call(VOLUME_SERVICE, method, {"volume_id": vid, **req}, timeout=120)

    def wait(cond):
        deadline = time.monotonic() + 30
        while not cond():
            assert time.monotonic() < deadline
            time.sleep(0.05)

    master = MasterServer(port=0, reap_interval=3600)
    master.start()
    servers = []
    try:
        for i in range(3):
            d = root / f"srv{i}"
            d.mkdir(parents=True)
            vs = VolumeServer([str(d)], master.address, heartbeat_interval=0.3,
                              rack=f"rack{i % 2}", encoder=encoder())
            vs.start()
            servers.append(vs)
        client = MasterClient(master.address)
        vid = int(client.assign().fid.split(",")[0])
        rng = np.random.default_rng(13)
        blobs = {}
        for key in range(1, 41):
            fid = str(FileId(vid, key, 0x2000 + key))
            blobs[fid] = rng.bytes(int(rng.integers(500, 6000)))
            client.upload(fid, blobs[fid])
        owner = next(s for s in servers if s.store.get_volume(vid) is not None)
        b, c = [s for s in servers if s is not owner]
        call(owner, "VolumeMarkReadonly", {})
        call(owner, "VolumeEcShardsGenerate", {"large_block_size": 4096, "small_block_size": 512})
        base = owner._base_path_for(vid)
        out = {"generated": {s: sha(stripe.shard_file_name(base, s)) for s in range(14)}}
        call(b, "VolumeEcShardsCopy", {"shard_ids": [5, 6, 7, 8, 9],
                                       "source_data_node": owner.grpc_address})
        call(c, "VolumeEcShardsCopy", {"shard_ids": [10, 11, 12, 13],
                                       "source_data_node": owner.grpc_address})
        call(owner, "VolumeEcShardsDelete", {"shard_ids": list(range(5, 14))})
        call(owner, "VolumeDelete", {})
        for vs in servers:
            call(vs, "VolumeEcShardsMount", {})
        for vs, lost in ((owner, [0]), (b, [5]), (c, [10, 13])):
            call(vs, "VolumeEcShardsDelete", {"shard_ids": lost})
        wait(lambda: len(master.topology.lookup_ec_shards(vid)) == 10)
        out["reads"] = {fid: client.read(fid) for fid in blobs}
        assert out["reads"] == blobs
        out["rebuild"] = call(b, "VolumeEcShardsRebuild", {"remote": True, "trace_mode": "off"})
        out["rebuilt"] = {s: sha(stripe.shard_file_name(b._base_path_for(vid), s))
                          for s in (0, 5, 10, 13)}
        client.close()
        assert out.pop("rebuild")["rebuilt_shard_ids"] == [0, 5, 10, 13]
        return out
    finally:
        for vs in servers:
            vs.stop()
        master.stop()


def test_card_cluster_generates_reads_degraded_and_rebuilds_as_the_cpu_cluster(
        card, tmp_path, monkeypatch):
    """The servers on the factory's encoder (the card) and on a CPU encoder
    run the same scenario over gRPC and HTTP on loopback: the generated
    shards, every read body and the remotely rebuilt shards are equal, and
    the card's run launched its kernel."""
    rs_cuda.reset_launches()
    on_card = _card_cluster_run(tmp_path / "card", rs_codec.new_encoder, monkeypatch)
    launched = dict(rs_cuda.launches_by_shape)
    plain = _card_cluster_run(tmp_path / "cpu",
                              lambda: rs_codec.Encoder(10, 4, device="cpu"), monkeypatch)
    assert on_card == plain
    assert on_card["rebuilt"] == {s: on_card["generated"][s] for s in (0, 5, 10, 13)}
    assert launched.get((4, 10), 0) >= 2 and launched.get((1, 10), 0) > 0, launched


# -- the operator shell on the card ----------------------------------------------------


def _card_shell_run(root, encoder, device, monkeypatch) -> dict:
    """A port master and four volume servers (racks rack0/rack1) on
    `encoder()`, 60 needles with fixed fids (the needle clock pinned), then
    the port shell on `device`: lock, ec.encode, one server's shards lost,
    ec.rebuild, ec.verify, unlock -> the shards by server index, the
    shell's output with addresses masked, and the reads."""
    import hashlib
    import io
    import itertools
    import re
    import socket
    import time
    import types

    from seaweedfs_tpu_torch.cluster.client import MasterClient
    from seaweedfs_tpu_torch.cluster.master import MasterServer
    from seaweedfs_tpu_torch.cluster.volume_server import VolumeServer
    from seaweedfs_tpu_torch.ec.shard_bits import ShardBits
    from seaweedfs_tpu_torch.shell import CommandEnv, run_script
    from seaweedfs_tpu_torch.storage import needle
    from seaweedfs_tpu_torch.storage.file_id import FileId

    it = itertools.count(1_700_000_000_000_000_000, 1_000)
    shim = types.SimpleNamespace(**{k: getattr(time, k) for k in dir(time) if not k.startswith("_")})
    shim.time_ns = lambda: next(it)
    monkeypatch.setattr(needle, "time", shim)

    def wait(cond):
        deadline = time.monotonic() + 30
        while not cond():
            assert time.monotonic() < deadline
            time.sleep(0.05)

    socks = [socket.socket() for _ in range(4)]
    for sk in socks:
        sk.bind(("127.0.0.1", 0))
    # the shell and the planners break ties on url: ports in url order
    ports = sorted((sk.getsockname()[1] for sk in socks), key=str)
    for sk in socks:
        sk.close()
    master = MasterServer(port=0, reap_interval=3600)
    master.start()
    servers, env = [], None
    try:
        for i, port in enumerate(ports):
            d = root / f"srv{i}"
            d.mkdir(parents=True)
            vs = VolumeServer([str(d)], master.address, port=port, heartbeat_interval=0.3,
                              rack=f"rack{i % 2}", encoder=encoder())
            vs.start()
            servers.append(vs)
            wait(lambda: vs.url in master.topology.nodes)
        index = {vs.url: i for i, vs in enumerate(servers)}
        client = MasterClient(master.address)
        vid = int(client.assign().fid.split(",")[0])
        rng = np.random.default_rng(17)
        blobs = {}
        for key in range(1, 61):
            fid = str(FileId(vid, key, 0x3000 + key))
            blobs[fid] = rng.bytes(int(rng.integers(500, 9000)))
            client.upload(fid, blobs[fid])
        env = CommandEnv(master.address, device=device)

        def placed():
            out = {}
            for n in env.topology_nodes():
                for e in n.get("ec_shards", []):
                    if int(e["volume_id"]) == vid:
                        out[index[n["url"]]] = ShardBits(e["shard_bits"]).shard_ids()
            return dict(sorted(out.items()))

        def shas():
            return {i: {s: hashlib.sha256(open(stripe.shard_file_name(
                servers[i]._base_path_for(vid), s), "rb").read()).hexdigest() for s in sids}
                for i, sids in placed().items()}

        text = io.StringIO()
        run_script(env, f"lock; ec.encode -volumeId {vid} -largeBlockSize 4096 "
                        f"-smallBlockSize 512", text)
        encoded = shas()
        victim, lost = next(iter(placed().items()))
        env.vs_call(servers[victim].grpc_address, "VolumeEcShardsDelete",
                    {"volume_id": vid, "shard_ids": lost})
        wait(lambda: sum(len(s) for s in placed().values()) == 14 - len(lost))
        run_script(env, "ec.rebuild; ec.verify; unlock", text)
        wait(lambda: sum(len(s) for s in placed().values()) == 14)
        reads = {fid: client.read(fid) for fid in blobs}
        client.close()
        assert reads == blobs
        assert "all shards verified clean" in text.getvalue()
        out = text.getvalue()
        for i, vs in enumerate(servers):
            out = out.replace(vs.url, f"<s{i}>")
        return {"encoded": encoded, "rebuilt": shas(), "lost": lost,
                "out": re.sub(r"127\.0\.0\.1:\d+", "<addr>", out)}
    finally:
        if env is not None:
            env.close()
        for vs in servers:
            vs.stop()
        master.stop()


def test_card_shell_encodes_rebuilds_and_verifies_as_the_cpu_shell(card, tmp_path, monkeypatch):
    """The port shell's ec.encode, ec.rebuild and ec.verify on servers on the
    factory's encoder (the card) and on a CPU encoder: the same shards on
    the same servers, the same output, and the card's run launched (4, 10)
    for the encode and the rebuild's own decode."""
    rs_cuda.reset_launches()
    on_card = _card_shell_run(tmp_path / "card", rs_codec.new_encoder, None, monkeypatch)
    launched = dict(rs_cuda.launches_by_shape)
    plain = _card_shell_run(tmp_path / "cpu", lambda: rs_codec.Encoder(10, 4, device="cpu"),
                            "cpu", monkeypatch)
    assert on_card == plain
    assert launched.get((4, 10), 0) >= 1, launched
    assert launched.get((len(on_card["lost"]), 10), 0) >= 1, launched


def hold_smoke_report(report: dict, took: float, timed: bool) -> None:
    """Every content assertion of the reference's weedload smoke case
    (`tests/test_slo_harness.py`) on a port smoke report. `timed` adds its
    two timings, the 30 s budget and `trace_overhead.ok`: they hold on a
    host with nothing else running, not under parallel test workers."""
    from seaweedfs_tpu_torch.ec import slo

    for key in slo.REPORT_SCHEMA_KEYS:
        assert key in report, f"report missing {key}"
    assert report["lost"] == [] and report["ok"]
    assert report["workload"]["open_loop"] is True
    by_class = report["workload"]["objects_by_class"]
    assert by_class["healthy"] > 0 and by_class["degraded"] > 0
    assert report["counters"]["weedtpu_degraded_read_seconds_count"] > 0
    merged_degraded = report["overall"]["degraded"]
    assert merged_degraded["count"] > 0 and merged_degraded["p99"] > 0
    attrib = report["trace_attribution"]
    for key in slo.TRACE_ATTRIB_SCHEMA_KEYS:
        assert key in attrib, f"trace attribution missing {key}"
    assert attrib["trace_count"] > 0
    for klass in ("healthy", "degraded"):
        cls = attrib["classes"][klass]
        assert cls["count"] > 0
        assert abs(cls["stage_coverage"] - 1.0) < 0.01, (klass, cls)
    assert len(attrib["slowest"]) >= 1
    assert all(t["root"].get("spans") is not None or t["kind"] for t in attrib["slowest"])
    overhead = report["trace_overhead"]
    for key in ("method", "tolerance", "abs_floor_us", "attempts", "ok"):
        assert key in overhead
    assert overhead["attempts"]
    cache = report["cache"]
    assert cache["hits"] >= 1 and cache["hit_rate"] is not None
    assert cache["budget_mb"] > 0
    assert report["overall"]["cached"]["count"] > 0
    if timed:
        assert took < 30.0, f"smoke run must stay under the 30 s budget ({took:.1f}s)"
        assert overhead["ok"], f"tracing overhead gate failed: {overhead}"


def hold_s3_smoke_report(report: dict, took: float, timed: bool) -> None:
    """Every assertion of the reference's S3-front smoke case
    (`tests/test_slo_harness.py::test_weedload_smoke_s3_front`) on a port
    report; `timed` adds its 40 s budget, which holds on a host with
    nothing else running, not under parallel test workers."""
    assert report["lost"] == [] and report["ok"]
    assert report["workload"]["front"] == "s3"
    by_class = report["workload"]["objects_by_class"]
    assert by_class["healthy"] > 0 and by_class["degraded"] > 0
    assert report["counters"]["weedtpu_degraded_read_seconds_count"] > 0
    assert report["overall"]["degraded"]["count"] > 0
    if timed:
        assert took < 40.0, f"s3 smoke must stay inside the CI budget ({took:.1f}s)"


def run_smoke(tmp_path, device: str, front: str = "master") -> tuple[dict, float]:
    """`weedload.main(["--smoke", "--front", front, ...])` on `device` in a
    fresh interpreter (no thread or cache of an earlier test shares its
    host time), timed around the call as the reference's case times it."""
    import json
    import subprocess
    import sys

    out = tmp_path / "SLO_smoke.json"
    argv = ["--smoke", "--front", front, "--device", device, "--out", str(out),
            "--trace-out", str(tmp_path / "TRACE_ATTRIB_smoke.json")]
    code = (
        "import json, sys, time\n"
        "from seaweedfs_tpu_torch.scripts import weedload\n"
        "t0 = time.monotonic()\n"
        f"rc = weedload.main({argv!r})\n"
        "print(json.dumps({'rc': rc, 'took': time.monotonic() - t0}))\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=root, env=dict(os.environ, PYTHONPATH=root))
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["rc"] == 0, "weedload smoke lost bytes or crashed"
    return json.loads(out.read_text()), result["took"]


def test_card_weedload_smoke_holds_the_reference_smoke(card, tmp_path):
    """The harness's smoke with its three in-process volume servers on the
    factory's card encoder: the reference smoke's assertions, its 30 s
    budget and its tracing-overhead gate included; the servers' /metrics
    select the cuda backend."""
    report, took = run_smoke(tmp_path, "cuda")
    hold_smoke_report(report, took, timed=True)
    assert report["server_backends"]["n0"] == [["cuda"]]


def test_card_weedload_s3_smoke_holds_the_reference_s3_smoke(card, tmp_path):
    """`--smoke --front s3` with the in-process volume servers on the
    factory's card encoder: signed requests through the port's filer and
    S3 gateway, the reference S3 smoke's assertions with its 40 s budget,
    and the servers' /metrics select the cuda backend."""
    report, took = run_smoke(tmp_path, "cuda", front="s3")
    hold_s3_smoke_report(report, took, timed=True)
    assert report["server_backends"]["n0"] == [["cuda"]]


def _contexts() -> int:
    """How many processes hold a CUDA context, as `nvidia-smi` lists them
    (in a container their pids may all read as one of another namespace)."""
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return len(out.stdout.split())


def test_card_node_reports_the_card_backend_and_leaves_no_context(card, tmp_path):
    """One `chaos_soak.Node` on the card: a `python -m seaweedfs_tpu_torch
    volume --device cuda` process whose /metrics selects the cuda backend
    and whose CUDA context `nvidia-smi` lists; SIGKILLed, it leaves no
    compute process behind."""
    import time
    import urllib.request

    from seaweedfs_tpu_torch.cluster.master import MasterServer
    from seaweedfs_tpu_torch.scripts.chaos_soak import Node, prepare_device

    prepare_device("cuda")
    base = str(tmp_path / "9")  # an EC volume to mount: its warm-ups launch on the card
    with open(base + ".dat", "wb") as f:
        f.write(np.random.default_rng(3).integers(0, 256, 400_000, np.uint8).tobytes())
    open(base + ".idx", "wb").close()
    stripe.write_ec_files(base, large_block_size=16384, small_block_size=4096,
                          encoder=rs_codec.Encoder(10, 4, device="cpu"))
    stripe.write_sorted_file_from_idx(base)
    os.unlink(base + ".dat")
    os.unlink(base + ".idx")
    torch.zeros(1, device=card)  # this process's own context, listed before
    before = _contexts()
    master = MasterServer(port=0, reap_interval=3600)
    master.start()
    node = Node(0, str(tmp_path), master.address, device="cuda")
    try:
        node.start()
        metrics, deadline = "", time.monotonic() + 120
        while 'weedtpu_ec_backend_selected{backend="cuda"' not in metrics:
            assert node.alive and time.monotonic() < deadline, open(tmp_path / "server.log").read()
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{node.http}/metrics",
                                            timeout=5) as r:
                    metrics = r.read().decode()
            except OSError:
                time.sleep(0.5)
        line = next(ln for ln in metrics.splitlines()
                    if ln.startswith('weedtpu_ec_backend_selected{backend="cuda"'))
        assert line.endswith(" 1.0")
        while _contexts() < before + 1 and time.monotonic() < deadline:
            time.sleep(0.5)
        assert _contexts() == before + 1
    finally:
        node.kill(hard=True)
        master.stop()
    deadline = time.monotonic() + 30
    while _contexts() > before and time.monotonic() < deadline:
        time.sleep(0.5)
    assert _contexts() == before


# -- the mesh backend: one process driving several devices -------------------------


def _mesh_on(devices, shape, variant="int8", rebuild=None):
    return rs_codec.Encoder(10, 4, backend="mesh", device="cuda", mesh_shape=shape,
                            mesh_rebuild=rebuild, mesh_devices=devices, variant=variant)


def _all_cards():
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more cards: the mesh over every card of the host")
    return [torch.device("cuda", i) for i in range(n)]


@pytest.mark.parametrize("variant", rs_cuda.KERNELS)
@pytest.mark.parametrize("rebuild", ["ring", "alltoall"])
def test_mesh_on_one_card_named_four_times_equals_single_card(card, variant, rebuild):
    """A 2x2 mesh over cuda:0 named 4 times: encode at an odd width, the
    flat and batched rebuilds and a block decode equal the single-card
    encoder's bytes, and each dispatch launches once per position."""
    devs = [torch.device("cuda", 0)] * 4
    enc = _mesh_on(devs, (2, 2), variant, rebuild)
    single = rs_codec.Encoder(10, 4, device="cuda", variant=variant)
    rng = np.random.default_rng(21)
    data = rng.integers(0, 256, (10, 100003), np.uint8)
    rs_cuda.reset_launches()
    got = np.asarray(enc.encode_parity_lazy(data))
    assert rs_cuda.launches_by_device == {"cuda:0": 4}
    assert np.array_equal(got, np.asarray(single.encode_parity_lazy(data)))
    shards = np.concatenate([data, got])
    lost = [0, 5, 11, 13]
    surv = [s for s in range(14) if s not in lost][:10]
    rs_cuda.reset_launches()
    rebuilt = np.asarray(enc.reconstruct_lazy(shards[surv], surv, lost))
    assert rs_cuda.launches == (8 if rebuild == "ring" else 4)
    assert np.array_equal(rebuilt, shards[lost])
    batch = rng.integers(0, 256, (3, 10, 4097), np.uint8)
    assert np.array_equal(enc.encode_batch(batch), single.encode_batch(batch))
    full = single.encode_batch(batch)
    assert np.array_equal(enc.reconstruct_batch(full[:, surv], surv, lost), full[:, lost])
    staging = np.zeros((10, 9000), np.uint8)
    staging[:, 3:8003] = shards[surv][:, :8000]
    block = {"survivors": surv, "wanted": lost, "col_start": 3, "width": 8000}
    assert np.array_equal(np.asarray(enc.reconstruct_block(staging, [block]))[:, 3:8003],
                          shards[lost][:, :8000])


@pytest.mark.parametrize("rebuild", ["ring", "alltoall"])
def test_mesh_file_pipelines_on_card_equal_single_card(card, tmp_path, rebuild):
    """write_ec_files and rebuild_ec_files with the 2x2 mesh over cuda:0
    named 4 times: every shard file equals the single-card encoder's."""
    rng = np.random.default_rng(22)
    large, small = 1 << 20, 64 << 10
    data = rng.integers(0, 256, 3 * large * 10 + 5 * small * 10 + 777, np.uint8).tobytes()
    bases = {k: str(tmp_path / k / "7") for k in ("single", "mesh")}
    for b in bases.values():
        os.makedirs(os.path.dirname(b))
        with open(b + ".dat", "wb") as f:
            f.write(data)
    stripe.write_ec_files(bases["single"], large, small, encoder=rs_codec.Encoder(10, 4))
    devs = [torch.device("cuda", 0)] * 4
    stripe.write_ec_files(bases["mesh"], large, small, encoder=_mesh_on(devs, (2, 2)))

    def read(b, s):
        with open(stripe.shard_file_name(b, s), "rb") as f:
            return f.read()

    for s in range(14):
        assert read(bases["mesh"], s) == read(bases["single"], s), s
    for s in (0, 5, 11, 13):
        os.unlink(stripe.shard_file_name(bases["mesh"], s))
    assert stripe.rebuild_ec_files(bases["mesh"], encoder=_mesh_on(devs, (2, 2), rebuild=rebuild),
                                   buffer_size=256 << 10, max_batch_bytes=8 << 20) == [0, 5, 11, 13]
    for s in (0, 5, 11, 13):
        assert read(bases["mesh"], s) == read(bases["single"], s), s


def test_mesh_over_every_card_equals_single_card(card):
    """The mesh over every card of the host (the default device list), each
    card launching its own tiles; bytes equal the single-card encoder's."""
    devs = _all_cards()
    enc = rs_codec.Encoder(10, 4, backend="mesh", device="cuda")
    md = enc._mesh_dispatch()
    assert md.n_devices == len(devs) and {str(d) for d in md.mesh.devices.flat} == {
        str(d) for d in devs}
    single = rs_codec.Encoder(10, 4, device="cuda")
    data = np.random.default_rng(23).integers(0, 256, (10, 1 << 20), np.uint8)
    rs_cuda.reset_launches()
    got = np.asarray(enc.encode_parity_lazy(data))
    assert rs_cuda.launches_by_device == {str(d): 1 for d in devs}
    assert np.array_equal(got, np.asarray(single.encode_parity_lazy(data)))
    shards = np.concatenate([data, got])
    lost = [1, 6, 12, 13]
    surv = [s for s in range(14) if s not in lost][:10]
    for rebuild in ("ring", "alltoall"):
        enc_v = rs_codec.Encoder(10, 4, backend="mesh", device="cuda", mesh_rebuild=rebuild)
        assert np.array_equal(np.asarray(enc_v.reconstruct_lazy(shards[surv], surv, lost)),
                              shards[lost])
    with pytest.raises(ValueError, match="needs"):
        rs_codec.Encoder(10, 4, backend="mesh", device="cuda",
                         mesh_shape=(len(devs) + 1, 1))._mesh_dispatch()


def test_mesh_dryrun_on_card(card):
    """The dry run's assertions (zero mismatches, parity equal to the host's,
    ring equal to all_to_all) over cuda:0 named 4 and 8 times, and over
    every card when the host has more than one."""
    from seaweedfs_tpu_torch.parallel import dryrun

    one = torch.device("cuda", 0)
    assert dryrun.dryrun([one] * 4, large_mib=16)["large"]["shard_mib"] >= 15
    assert dryrun.dryrun([one] * 8, large_mib=16)["dcn"]["mismatches"] == 0
    fn, (example,) = dryrun.entry()
    assert torch.equal(fn(example)[:, 10:], rs_cuda.plain_apply(gf8.parity_matrix(10, 4), example))
    if torch.cuda.device_count() > 1:
        cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        assert dryrun.dryrun(cards, large_mib=16)["small"]["mismatches"] == 0


def test_mesh_decision_recorded_on_the_card_factory(card):
    """Without committed GPU_MULTICHIP evidence the factory keeps the
    single-card encoder; on a multi-card host it records why."""
    enc = rs_codec.new_encoder()
    assert enc.backend == "cuda"
    if torch.cuda.device_count() > 1:
        assert "no committed mesh evidence" in enc.selection["mesh"]["reason"]
    else:
        assert "mesh" not in enc.selection
    forced = rs_codec.new_encoder(backend="mesh")
    assert forced.backend == "mesh" and forced.selection["mesh_devices"] == torch.cuda.device_count()


# -- tiering and the raft quorum over card volume servers (since PR 17) -----------------


def _pinned_needle_clock(monkeypatch):
    import itertools
    import time
    import types

    from seaweedfs_tpu_torch.storage import needle

    it = itertools.count(1_700_000_000_000_000_000, 1_000)
    shim = types.SimpleNamespace(**{k: getattr(time, k) for k in dir(time) if not k.startswith("_")})
    shim.time_ns = lambda: next(it)
    monkeypatch.setattr(needle, "time", shim)


def _wait(cond, timeout=30.0):
    import time

    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline
        time.sleep(0.05)


def _card_tier_run(root, encoder, monkeypatch) -> dict:
    """One master and one volume server on `encoder()`: 40 needles with
    fixed fids, the volume tier-moved to a local vendor and read back over
    HTTP through the remote .dat, fetched back (its sha256 the original's),
    then VolumeEcShardsGenerate -> what came out."""
    import hashlib

    from seaweedfs_tpu_torch import rpc
    from seaweedfs_tpu_torch.cluster.client import MasterClient
    from seaweedfs_tpu_torch.cluster.master import MasterServer
    from seaweedfs_tpu_torch.cluster.volume_server import VolumeServer
    from seaweedfs_tpu_torch.pb import VOLUME_SERVICE
    from seaweedfs_tpu_torch.storage.file_id import FileId

    _pinned_needle_clock(monkeypatch)

    def sha(path):
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    def call(method, req):
        with rpc.RpcClient(vs.grpc_address) as c:
            return c.call(VOLUME_SERVICE, method, {"volume_id": vid, **req}, timeout=120)

    master = MasterServer(port=0, reap_interval=3600, http_port=None)
    master.start()
    (root / "srv").mkdir(parents=True)
    vs = VolumeServer([str(root / "srv")], master.address, heartbeat_interval=0.3,
                      encoder=encoder())
    vs.start()
    client = MasterClient(master.address)
    try:
        vid = int(client.assign().fid.split(",")[0])
        rng = np.random.default_rng(17)
        blobs = {}
        for key in range(1, 41):
            fid = str(FileId(vid, key, 0x3000 + key))
            blobs[fid] = rng.bytes(int(rng.integers(500, 6000)))
            client.upload(fid, blobs[fid])
        base = vs._base_path_for(vid)
        call("VolumeMarkReadonly", {})
        dat = sha(base + ".dat")
        moved = call("VolumeTierMove", {"destination": {"vendor": "local",
                                                        "root": str(root / "cold")}})
        assert vs.store.get_volume(vid).tiered and not os.path.exists(base + ".dat")
        tiered = {fid: client.read(fid) for fid in blobs}
        assert tiered == blobs
        call("VolumeTierFetch", {})
        assert sha(base + ".dat") == dat
        call("VolumeEcShardsGenerate", {"large_block_size": 4096, "small_block_size": 512})
        return {"moved": moved, "dat": dat,
                "generated": {s: sha(stripe.shard_file_name(base, s)) for s in range(14)}}
    finally:
        client.close()
        vs.stop()
        master.stop()


def test_card_tier_move_read_fetch_and_generate_as_the_cpu_server(card, tmp_path, monkeypatch):
    """A volume server on the card tiers a volume, serves its needles from
    the remote .dat, fetches it back and EC-encodes it: the same sizes,
    keys, .dat and shards as a CPU server's run, with (4, 10) launches."""
    rs_cuda.reset_launches()
    on_card = _card_tier_run(tmp_path / "card", rs_codec.new_encoder, monkeypatch)
    launched = dict(rs_cuda.launches_by_shape)
    plain = _card_tier_run(tmp_path / "cpu", lambda: rs_codec.Encoder(10, 4, device="cpu"),
                           monkeypatch)
    assert on_card == plain
    assert launched.get((4, 10), 0) >= 1, launched


def test_card_quorum_serves_a_degraded_read_after_the_leader_stops(card, tmp_path):
    """Three masters with `peers` (raft) over a volume server on the card
    heartbeating to all of them: after EC-encoding a volume and losing two
    data shards, the leader stops; a new leader of a greater term answers
    the client's lookups, every needle reads back byte-equal, and the reads
    reconstruct on the card ((1, 10) launches)."""
    import socket

    from seaweedfs_tpu_torch import rpc
    from seaweedfs_tpu_torch.cluster.client import MasterClient
    from seaweedfs_tpu_torch.cluster.master import MasterServer
    from seaweedfs_tpu_torch.cluster.volume_server import VolumeServer
    from seaweedfs_tpu_torch.pb import VOLUME_SERVICE
    from seaweedfs_tpu_torch.storage.file_id import FileId

    socks = [socket.socket() for _ in range(3)]
    for sk in socks:
        sk.bind(("127.0.0.1", 0))
    addresses = [f"127.0.0.1:{sk.getsockname()[1]}" for sk in socks]
    for sk in socks:
        sk.close()
    for i in range(3):
        (tmp_path / f"raft{i}").mkdir()
    masters = [MasterServer(port=int(a.rsplit(":", 1)[1]), peers=addresses,
                            raft_dir=str(tmp_path / f"raft{i}"), reap_interval=3600,
                            http_port=None, election_timeout=(0.25, 0.5))
               for i, a in enumerate(addresses)]
    for m in masters:
        m.start()

    def leader(live):
        lead = [m for m in live if m.raft.is_leader]
        if len(lead) == 1 and all(m.raft.leader == lead[0].address for m in live if m is not lead[0]):
            return lead[0]
        return None

    (tmp_path / "srv").mkdir()
    vs = VolumeServer([str(tmp_path / "srv")], ",".join(addresses), heartbeat_interval=0.3,
                      encoder=rs_codec.new_encoder())
    vs.start()
    client = MasterClient(",".join(addresses))
    stopped = []
    try:
        _wait(lambda: leader(masters) is not None, 10)
        vid = int(client.assign().fid.split(",")[0])
        rng = np.random.default_rng(19)
        blobs = {}
        for key in range(1, 41):
            fid = str(FileId(vid, key, 0x4000 + key))
            blobs[fid] = rng.bytes(int(rng.integers(500, 6000)))
            client.upload(fid, blobs[fid])

        def call(method, req):
            with rpc.RpcClient(vs.grpc_address) as c:
                return c.call(VOLUME_SERVICE, method, {"volume_id": vid, **req}, timeout=120)

        call("VolumeMarkReadonly", {})
        call("VolumeEcShardsGenerate", {"large_block_size": 4096, "small_block_size": 512})
        call("VolumeDelete", {})
        call("VolumeEcShardsMount", {})
        call("VolumeEcShardsDelete", {"shard_ids": [0, 5]})
        old = leader(masters)
        old_term = old.raft.term
        old.stop()
        stopped.append(old)
        live = [m for m in masters if m is not old]
        _wait(lambda: leader(live) is not None, 10)
        new = leader(live)
        assert new.raft.term > old_term
        _wait(lambda: len(new.topology.lookup_ec_shards(vid)) == 12)
        ev = vs.store.get_ec_volume(vid)
        if ev.warm_thread is not None:
            ev.warm_thread.join()
        rs_cuda.reset_launches()
        assert {fid: client.read(fid) for fid in blobs} == blobs
        assert rs_cuda.launches_by_shape.get((1, 10), 0) > 0, dict(rs_cuda.launches_by_shape)
    finally:
        client.close()
        vs.stop()
        for m in masters:
            if m not in stopped:
                m.stop()


# -- the filer over card volume servers ---------------------------------------------


def _filer_put_get(url: str, path: str, data: bytes = None):
    import urllib.request

    req = urllib.request.Request(f"http://{url}{path}", data=data,
                                 method="PUT" if data is not None else "GET")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.read()


def test_card_filer_reads_every_file_back_through_degraded_ec_reads(card, tmp_path):
    """A filer (chunk cache off, 256 KiB chunks) over a card volume server:
    seeded files PUT through it, their volume EC-encoded by the port shell
    (16 KiB small blocks, so every shard holds data), data shards 0 and 5
    lost; every file reads back byte-equal through the filer, and the reads
    reconstruct on the card ((R, 10) launches)."""
    import io
    import json

    from seaweedfs_tpu_torch import rpc
    from seaweedfs_tpu_torch.cluster.master import MasterServer
    from seaweedfs_tpu_torch.cluster.volume_server import VolumeServer
    from seaweedfs_tpu_torch.ec import read_planner
    from seaweedfs_tpu_torch.filer import FilerServer
    from seaweedfs_tpu_torch.pb import VOLUME_SERVICE
    from seaweedfs_tpu_torch.shell import CommandEnv, run_script

    master = MasterServer(port=0, reap_interval=3600)
    master.start()
    (tmp_path / "srv").mkdir()
    vs = VolumeServer([str(tmp_path / "srv")], master.address, heartbeat_interval=0.3,
                      encoder=rs_codec.new_encoder())
    vs.start()
    fs = FilerServer(master.address, chunk_size=256 << 10, chunk_cache_bytes=0)
    fs.start()
    try:
        rng = np.random.default_rng(29)
        files = {f"/card/d{i % 4}/f{i:02d}.bin": rng.bytes(int(rng.integers(1000, 900_000)))
                 for i in range(40)}
        for path, data in files.items():
            status, body = _filer_put_get(fs.url, path, data)
            assert status == 201 and json.loads(body)["size"] == len(data)
        vids = {int(c.fid.split(",")[0]) for p in files for c in fs.filer.find_entry(p).chunks}
        _wait(lambda: all(master.topology.lookup(v) for v in vids))
        with CommandEnv(master.address) as env:
            out = io.StringIO()
            run_script(env, "lock; " + "; ".join(
                f"ec.encode -volumeId {v} -force -largeBlockSize 65536 -smallBlockSize 16384"
                for v in sorted(vids)) + "; unlock", out)
        for v in vids:
            ev = vs.store.get_ec_volume(v)
            assert ev is not None, out.getvalue()
            if ev.warm_thread is not None:
                ev.warm_thread.join()
            with rpc.RpcClient(vs.grpc_address) as c:
                c.call(VOLUME_SERVICE, "VolumeEcShardsDelete",
                       {"volume_id": v, "shard_ids": [0, 5]})
        _wait(lambda: all(len([s for s, ns in master.topology.lookup_ec_shards(v).items() if ns])
                          == 12 for v in vids))
        read_planner.CACHE.clear()
        rs_cuda.reset_launches()
        for path, data in files.items():
            assert _filer_put_get(fs.url, path) == (200, data), path
        by_shape = dict(rs_cuda.launches_by_shape)
        assert by_shape and all(c == 10 for _, c in by_shape), by_shape
    finally:
        fs.stop()
        vs.stop()
        master.stop()


def test_card_s3_gateway_reads_degraded_objects_back(card, tmp_path):
    """The S3 gateway over a filer (chunk cache off, 256 KiB chunks) and a
    card volume server: seeded objects PUT by signed requests into a bucket,
    the bucket's collection EC-encoded by the port shell (16 KiB small
    blocks), data shards 0 and 5 lost; every object reads back byte-equal by
    signed GET through the gateway, and the reads reconstruct on the card
    ((1, 10) launches)."""
    import io
    import urllib.request

    from seaweedfs_tpu_torch import rpc
    from seaweedfs_tpu_torch.cluster.master import MasterServer
    from seaweedfs_tpu_torch.cluster.volume_server import VolumeServer
    from seaweedfs_tpu_torch.ec import read_planner
    from seaweedfs_tpu_torch.filer import FilerServer
    from seaweedfs_tpu_torch.pb import VOLUME_SERVICE
    from seaweedfs_tpu_torch.s3api import Iam, Identity, S3ApiServer, sign_request
    from seaweedfs_tpu_torch.shell import CommandEnv, run_script

    def s3_call(method, path, body=b""):
        url = f"http://{s3.url}{path}"
        req = urllib.request.Request(url, data=body or None, method=method,
                                     headers=sign_request("ak", "sk", method, url, body))
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()

    master = MasterServer(port=0, reap_interval=3600)
    master.start()
    (tmp_path / "srv").mkdir()
    vs = VolumeServer([str(tmp_path / "srv")], master.address, heartbeat_interval=0.3,
                      encoder=rs_codec.new_encoder())
    vs.start()
    fs = FilerServer(master.address, chunk_size=256 << 10, chunk_cache_bytes=0)
    fs.start()
    s3 = S3ApiServer(fs.url, fs.grpc_address, iam=Iam([Identity("admin", "ak", "sk")]))
    s3.start()
    try:
        assert s3_call("PUT", "/cardbkt")[0] == 200
        rng = np.random.default_rng(37)
        objects = {f"/cardbkt/p{i % 4}/o{i:02d}.bin": rng.bytes(int(rng.integers(1000, 900_000)))
                   for i in range(40)}
        for path, data in objects.items():
            assert s3_call("PUT", path, data)[0] == 200
        vids = {int(c.fid.split(",")[0]) for p in objects
                for c in fs.filer.find_entry("/buckets" + p).chunks}
        _wait(lambda: all(master.topology.lookup(v, "cardbkt") for v in vids))
        with CommandEnv(master.address) as env:
            out = io.StringIO()
            run_script(env, "lock; ec.encode -collection cardbkt -force -largeBlockSize 65536 "
                            "-smallBlockSize 16384; unlock", out)
        for v in vids:
            ev = vs.store.get_ec_volume(v)
            assert ev is not None, out.getvalue()
            if ev.warm_thread is not None:
                ev.warm_thread.join()
            with rpc.RpcClient(vs.grpc_address) as c:
                c.call(VOLUME_SERVICE, "VolumeEcShardsDelete",
                       {"volume_id": v, "collection": "cardbkt", "shard_ids": [0, 5]})
        _wait(lambda: all(len([s for s, ns in master.topology.lookup_ec_shards(v).items() if ns])
                          == 12 for v in vids))
        read_planner.CACHE.clear()
        rs_cuda.reset_launches()
        for path, data in objects.items():
            assert s3_call("GET", path) == (200, data), path
        by_shape = dict(rs_cuda.launches_by_shape)
        assert by_shape.get((1, 10), 0) > 0 and all(c == 10 for _, c in by_shape), by_shape
    finally:
        s3.stop()
        fs.stop()
        vs.stop()
        master.stop()


def test_the_filer_command_opens_no_context_on_the_card(card, tmp_path):
    """`python -m seaweedfs_tpu_torch filer` (which takes no --device) as a
    process of its own in front of a card volume server: files written and
    read through it; `nvidia-smi` lists no context
    for it while it serves (contexts are counted: in a container their pids
    may all read as one of another namespace)."""
    import re
    import signal
    import socket
    import subprocess
    import sys
    import time

    from seaweedfs_tpu_torch.cluster.master import MasterServer
    from seaweedfs_tpu_torch.cluster.volume_server import VolumeServer

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    torch.zeros(1, device=card)  # this process's own context, listed before
    master = MasterServer(port=0, reap_interval=3600)
    master.start()
    (tmp_path / "srv").mkdir()
    vs = VolumeServer([str(tmp_path / "srv")], master.address, heartbeat_interval=0.3,
                      encoder=rs_codec.new_encoder())
    vs.start()
    before = _contexts()
    sk = socket.socket()
    sk.bind(("127.0.0.1", 0))
    port = sk.getsockname()[1]
    sk.close()
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "filer", "-port", str(port), "-master",
         master.address, "-maxMB", "1"],
        cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=root),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = proc.stdout.readline()
        assert re.search(r"filer on http \S+ grpc \S+", line), line
        rng = np.random.default_rng(31)
        files = {f"/ctx/f{i}.bin": rng.bytes(int(rng.integers(1000, 3 << 20))) for i in range(8)}
        deadline = time.monotonic() + 60
        for path, data in files.items():
            while True:
                try:
                    assert _filer_put_get(f"127.0.0.1:{port}", path, data)[0] == 201
                    break
                except OSError:
                    assert time.monotonic() < deadline
                    time.sleep(0.2)
        for path, data in files.items():
            assert _filer_put_get(f"127.0.0.1:{port}", path) == (200, data)
        assert proc.poll() is None
        assert _contexts() == before
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
        proc.stdout.close()
        vs.stop()
        master.stop()


def _ec_encode_and_lose(master, vs, vids, collection: str = "") -> None:
    """The port shell EC-encodes `vids` (64 KiB large and 16 KiB small
    blocks, so every shard holds data), then data shards 0 and 5 are lost."""
    import io

    from seaweedfs_tpu_torch import rpc
    from seaweedfs_tpu_torch.pb import VOLUME_SERVICE
    from seaweedfs_tpu_torch.shell import CommandEnv, run_script

    _wait(lambda: all(master.topology.lookup(v, collection) for v in vids))
    with CommandEnv(master.address) as env:
        out = io.StringIO()
        run_script(env, "lock; " + "; ".join(
            f"ec.encode -volumeId {v} -collection {collection} -force -largeBlockSize 65536 "
            f"-smallBlockSize 16384" if collection else
            f"ec.encode -volumeId {v} -force -largeBlockSize 65536 -smallBlockSize 16384"
            for v in sorted(vids)) + "; unlock", out)
    for v in vids:
        assert vs.store.get_ec_volume(v) is not None, out.getvalue()
        with rpc.RpcClient(vs.grpc_address) as c:
            c.call(VOLUME_SERVICE, "VolumeEcShardsDelete",
                   {"volume_id": v, "collection": collection, "shard_ids": [0, 5]})
    _wait(lambda: all(len([s for s, ns in master.topology.lookup_ec_shards(v).items() if ns])
                      == 12 for v in vids))
    for v in vids:  # the mounts' warm-up launches, before a test counts its own
        ev = vs.store.get_ec_volume(v)
        if ev.warm_thread is not None:
            ev.warm_thread.join()


def _predicted_1x10(vs, fids, collection: str = "") -> int:
    """One (1, 10) launch per lost shard (0, 5) a needle's intervals lie on,
    for each read of `fids`, from the .ecx, the .eci and `ec.locate`."""
    from seaweedfs_tpu_torch.ec import locate
    from seaweedfs_tpu_torch.storage import idx, types

    total = 0
    for fid in fids:
        vid, rest = fid.split(",")
        nid = int(rest[:-8], 16)
        base = vs._base_path_for(int(vid), collection)
        info = stripe.read_ec_info(base)
        with open(base + ".ecx", "rb") as f:
            index = idx.index_entries_array(f.read())
        pos = int(np.searchsorted(index["key"], np.uint64(nid)))
        assert int(index["key"][pos]) == nid, fid
        ivs = locate.locate_data(info["large_block_size"], info["small_block_size"],
                                 info["dat_size"],
                                 types.offset_to_actual(int(index["offset"][pos])),
                                 types.actual_size(int(index["size"][pos])), 10)
        total += len({iv.to_shard_id_and_offset(info["large_block_size"],
                                                info["small_block_size"])[0]
                      for iv in ivs} & {0, 5})
    return total


@pytest.fixture
def degraded_filer(card, tmp_path, monkeypatch):
    """A master, one card volume server and a filer (chunk cache off, 256
    KiB chunks) holding 40 seeded files under /card, their volumes
    EC-encoded with data shards 0 and 5 lost; server caches cleared and
    off, hedging off. Yields (master, vs, fs, {path: bytes}, {path: fids})."""
    from seaweedfs_tpu_torch.cluster.master import MasterServer
    from seaweedfs_tpu_torch.cluster.volume_server import VolumeServer
    from seaweedfs_tpu_torch.ec import read_planner
    from seaweedfs_tpu_torch.filer import FilerServer

    master = MasterServer(port=0, reap_interval=3600)
    master.start()
    (tmp_path / "srv").mkdir()
    vs = VolumeServer([str(tmp_path / "srv")], master.address, heartbeat_interval=0.3,
                      max_volume_count=32, encoder=rs_codec.new_encoder())
    vs.start()
    fs = FilerServer(master.address, chunk_size=256 << 10, chunk_cache_bytes=0)
    fs.start()
    try:
        rng = np.random.default_rng(41)
        files = {f"/card/d{i % 4}/f{i:02d}.bin": rng.bytes(int(rng.integers(1000, 900_000)))
                 for i in range(40)}
        for path, data in files.items():
            assert _filer_put_get(fs.url, path, data)[0] == 201
        fids = {p: [c.fid for c in fs.filer.find_entry(p).chunks] for p in files}
        _ec_encode_and_lose(master, vs, {int(f.split(",")[0]) for fs_ in fids.values()
                                         for f in fs_})
        monkeypatch.setenv("WEEDTPU_READ_CACHE_MB", "0")
        monkeypatch.setenv("WEEDTPU_HEDGE_READS", "off")
        read_planner.CACHE.clear()
        yield master, vs, fs, files, fids
    finally:
        fs.stop()
        vs.stop()
        master.stop()


def test_card_sync_backup_to_a_local_sink_is_byte_equal_with_predicted_launches(
        degraded_filer, tmp_path):
    """`filer.backup`'s path (a Replicator into a LocalSink) over the
    degraded files: the sink tree is byte-equal, and the (1, 10) launches
    equal the .ecx prediction for one read of every file."""
    from seaweedfs_tpu_torch.replication import LocalSink, Replicator

    master, vs, fs, files, fids = degraded_filer
    rs_cuda.reset_launches()
    rep = Replicator(fs.grpc_address, LocalSink(str(tmp_path / "backup")), prefix="/card")
    try:
        assert rep.run_once(max_idle_s=0.5) == len(files) + 4  # the files and 4 directories
    finally:
        rep.close()
    for path, data in files.items():
        assert (tmp_path / "backup" / path[len("/card/"):]).read_bytes() == data, path
    pred = _predicted_1x10(vs, [f for fs_ in fids.values() for f in fs_])
    assert pred > 0 and dict(rs_cuda.launches_by_shape) == {(1, 10): pred}


def test_card_mount_reads_degraded_files_byte_equal(degraded_filer):
    """A mount (WFS, its chunk cache off) over the degraded files: each
    read whole and at a seeded range is byte-equal, the launches the .ecx
    prediction's."""
    from seaweedfs_tpu_torch.mount import WFS

    master, vs, fs, files, fids = degraded_filer
    rng = np.random.default_rng(43)
    rs_cuda.reset_launches()
    with WFS(fs.grpc_address, chunk_cache_bytes=0) as w:
        for path, data in files.items():
            fh = w.open(path)
            assert fh.size == len(data) and fh.read(0, fh.size) == data, path
            lo = int(rng.integers(0, len(data)))
            assert fh.read(lo, 70_000) == data[lo: lo + 70_000], (path, lo)
            fh.release()
    chunk = 256 << 10
    ranged = []
    rng = np.random.default_rng(43)
    for path, data in files.items():
        lo = int(rng.integers(0, len(data)))
        hi = min(lo + 70_000, len(data))
        ranged += fids[path][lo // chunk: (hi - 1) // chunk + 1]
    pred = _predicted_1x10(vs, [f for fs_ in fids.values() for f in fs_] + ranged)
    assert pred > 0 and dict(rs_cuda.launches_by_shape) == {(1, 10): pred}


def test_card_mq_consumer_reads_ec_encoded_segments(card, tmp_path, monkeypatch):
    """A broker on a filer whose /topics/ collection lies on a card volume
    server: seeded records published, the broker stopped (its segments
    flushed), the collection EC-encoded with data shards 0 and 5 lost, a
    broker started again; a consumer group reads every record back in
    order from the degraded segments, with the .ecx's (1, 10) launches."""
    from seaweedfs_tpu_torch.cluster.master import MasterServer
    from seaweedfs_tpu_torch.cluster.volume_server import VolumeServer
    from seaweedfs_tpu_torch.ec import read_planner
    from seaweedfs_tpu_torch.filer import FilerServer
    from seaweedfs_tpu_torch.filer.client import FilerClient
    from seaweedfs_tpu_torch.mq import Broker, BrokerClient

    master = MasterServer(port=0, reap_interval=3600)
    master.start()
    (tmp_path / "srv").mkdir()
    vs = VolumeServer([str(tmp_path / "srv")], master.address, heartbeat_interval=0.3,
                      max_volume_count=32, encoder=rs_codec.new_encoder())
    vs.start()
    fs = FilerServer(master.address, chunk_size=256 << 10, chunk_cache_bytes=0)
    fs.start()
    brokers = []
    try:
        with FilerClient(fs.grpc_address) as fc:
            fc.set_filer_conf("/topics/", collection="cardmq")
        b = Broker(fs.url, fs.grpc_address)
        b.start()
        brokers.append(b)
        rng = np.random.default_rng(47)
        records = [(rng.bytes(8), rng.bytes(int(rng.integers(100, 3000)))) for _ in range(400)]
        placed = {}
        with BrokerClient(b.address) as c:
            c.configure_topic("cardtopic", partition_count=2)
            for key, value in records:
                placed.setdefault(c.publish("cardtopic", key, value)["partition"], []).append(
                    (key, value))
        b.stop()
        brokers.remove(b)
        segs = {e.path: [ch.fid for ch in e.chunks] for p in range(2)
                for e in fs.filer.list_entries(f"/topics/default/cardtopic/{p:04d}")}
        vids = {int(f.split(",")[0]) for fl in segs.values() for f in fl}
        _ec_encode_and_lose(master, vs, vids, "cardmq")
        monkeypatch.setenv("WEEDTPU_READ_CACHE_MB", "0")
        monkeypatch.setenv("WEEDTPU_HEDGE_READS", "off")
        read_planner.CACHE.clear()
        b = Broker(fs.url, fs.grpc_address)
        b.start()
        brokers.append(b)
        rs_cuda.reset_launches()
        got = {}
        with BrokerClient(b.address) as c:
            for part, rec in c.consume("cardtopic", "g", "c0", max_rounds=1, commit_every=32):
                got.setdefault(part, []).append((rec.key, rec.value))
        assert got == placed
        pred = _predicted_1x10(vs, [f for fl in segs.values() for f in fl], "cardmq")
        assert pred > 0 and dict(rs_cuda.launches_by_shape) == {(1, 10): pred}
    finally:
        for b in brokers:
            b.stop()
        fs.stop()
        vs.stop()
        master.stop()


@pytest.mark.parametrize("command", ["mq.broker", "filer.sync"])
def test_the_mq_broker_and_filer_sync_commands_open_no_context_on_the_card(card, tmp_path,
                                                                          command):
    """`python -m seaweedfs_tpu_torch mq.broker` and `filer.sync` (neither
    takes --device) as processes of their own beside a card volume server
    and a filer: records published through the broker and read back, files
    synced into a second filer; `nvidia-smi` lists no context for them
    while they serve (contexts are counted)."""
    import signal
    import socket
    import subprocess
    import sys
    import time

    from seaweedfs_tpu_torch.cluster.master import MasterServer
    from seaweedfs_tpu_torch.cluster.volume_server import VolumeServer
    from seaweedfs_tpu_torch.filer import FilerServer
    from seaweedfs_tpu_torch.mq import BrokerClient

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    torch.zeros(1, device=card)  # this process's own context, listed before
    master = MasterServer(port=0, reap_interval=3600)
    master.start()
    (tmp_path / "srv").mkdir()
    vs = VolumeServer([str(tmp_path / "srv")], master.address, heartbeat_interval=0.3,
                      encoder=rs_codec.new_encoder())
    vs.start()
    fs = FilerServer(master.address, chunk_cache_bytes=0)
    fs.start()
    fs2 = FilerServer(master.address, chunk_cache_bytes=0)
    fs2.start()
    before = _contexts()
    sk = socket.socket()
    sk.bind(("127.0.0.1", 0))
    port = sk.getsockname()[1]
    sk.close()
    argv = (["mq.broker", "-port", str(port), "-filer", fs.url, "-filerGrpc", fs.grpc_address]
            if command == "mq.broker" else
            ["filer.sync", "-from", fs.grpc_address, "-to", fs2.url, "-prefix", "/ctx",
             "-targetPath", "/mirror"])
    proc = subprocess.Popen([sys.executable, "-m", "seaweedfs_tpu_torch", *argv],
                            cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=root),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("mq broker on" if command == "mq.broker" else "filer.sync"), line
        rng = np.random.default_rng(53)
        if command == "mq.broker":
            with BrokerClient(f"127.0.0.1:{port}") as c:
                c.configure_topic("ctx", partition_count=1)
                sent = [rng.bytes(512) for _ in range(32)]
                for v in sent:
                    c.publish("ctx", b"", v, partition=0)
                assert [r.value for r in c.subscribe("ctx", max_idle_s=0.5)] == sent
        else:
            files = {f"/ctx/f{i}.bin": rng.bytes(int(rng.integers(1000, 300_000)))
                     for i in range(8)}
            for path, data in files.items():
                assert _filer_put_get(fs.url, path, data)[0] == 201
            deadline = time.monotonic() + 60
            for path, data in files.items():
                while not fs2.filer.exists("/mirror" + path[len("/ctx"):]):
                    assert time.monotonic() < deadline, path
                    time.sleep(0.1)
                assert _filer_put_get(fs2.url, "/mirror" + path[len("/ctx"):]) == (200, data)
        assert proc.poll() is None
        assert _contexts() == before
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
        proc.stdout.close()
        fs2.stop()
        fs.stop()
        vs.stop()
        master.stop()
