"""The dma kernel's ring (`csrc/gf_dma.cu`) on the CPU, where the kernel
itself cannot run: its schedule (`rs_cuda.dma_schedule`: which block walks
which work items, and for each stage the slot and the barrier parities the
producer and the consumers wait on), replayed against a model of
Hopper's mbarriers under random interleavings; its shared-memory plan
(`rs_cuda.dma_plan`); and its arithmetic, replayed stage by stage through
the schedule with its B operand (`rs_cuda.lift_fragments`), byte-exact
(tolerance 0: GF arithmetic is exact) against the JAX package's dma
Pallas variant in interpret mode and the port's plain version. The card
checks of the same kernel are in `tests/test_torch_cuda.py`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import gf8 as ref_gf8
from seaweedfs_tpu.ops import rs_jax, rs_pallas
from seaweedfs_tpu_torch.ops import gf8, rs_codec, rs_cuda

#: consumer warps of a dma block, each arriving once a stage on "empty"
CONSUMERS = 4
#: producer lanes, each arriving once a stage on "full"
PRODUCER_LANES = 32


# -- the schedule covers every column once ---------------------------------


@pytest.mark.parametrize("batch, n, tile, grid", [
    (1, 1, 4096, 1),                # one column
    (1, 6_553_600, 4096, 264),      # the encode shape, 2 blocks on each of 132 SMs
    (3, 10_007, 4096, 2),           # ragged N, batch > 1, fewer blocks than items
    (2, 8321, 4096, 50),            # more blocks than items: the rest walk nothing
    (5, 100, 128, 3),               # tiles of one 128-column stage
    (2, 70_001, 16_384, 7),         # 8 stages an item, ragged
    (1, 3 * 8192 + 77, 8192, 4),
])
def test_schedule_covers_every_column_once(batch, n, tile, grid):
    chunk = rs_cuda._dma_chunk(tile)
    walks = rs_cuda.dma_schedule(batch, n, tile, chunk, grid, 3)
    assert len(walks) == grid
    seen = np.zeros((batch, n), dtype=np.int64)
    items = rs_cuda.dma_items(batch, n, tile)
    for k, walk in enumerate(walks):
        starts = []
        for st in walk:
            assert 0 <= st.start < st.stop <= n and st.stop - st.start <= chunk
            assert st.start % chunk == 0 and (st.start // tile) == (st.stop - 1) // tile
            seen[st.batch, st.start:st.stop] += 1
            if st.start % tile == 0:
                starts.append(st.batch * -(-n // tile) + st.start // tile)
        assert starts == list(range(k, items, grid))  # items k, k + grid, ... in order
    assert (seen == 1).all()


@pytest.mark.parametrize("batch, n, tile, per_sm, sms, want", [
    (1, 6_553_600, 4096, 2, 132, 264),
    (1, 4096, 4096, 3, 132, 1),
    (8, 4_194_304, 4096, 2, 132, 264),
    (3, 10_007, 4096, 12, 132, 9),
])
def test_grid_is_the_blocks_that_fit_capped_at_the_items(batch, n, tile, per_sm, sms, want):
    assert rs_cuda.dma_grid(batch, n, tile, per_sm, sms) == want


# -- the ring's parities, against a model of the mbarriers ------------------


class _Barrier:
    """An mbarrier as the kernel uses it: `count` arrivals complete a
    phase; try_wait.parity(p) passes while the current (incomplete) phase's
    parity differs from p, that is, once the phase of parity p is done."""

    def __init__(self, count: int):
        self.count = self.pending = count
        self.completed = 0

    def arrive(self) -> None:
        self.pending -= 1
        assert self.pending >= 0
        if self.pending == 0:
            self.completed += 1
            self.pending = self.count

    def passed(self, parity: int) -> bool:
        return (self.completed & 1) != parity


def _run_ring(walk, stages: int, seed: int, producer_parity=None) -> None:
    """Run one block's producer and consumer warps over `walk` in a random
    interleaving. The producer waits on empty[slot] with the stage's
    empty parity (or `producer_parity(s)`), stamps the slot with the stage
    and arrives on full (each lane); each consumer waits on full[slot] with
    the stage's full parity, must find its own stage there, and arrives on
    empty. Raises AssertionError on a misread, an overwrite before every
    consumer released the slot, or a deadlock."""
    rng = np.random.default_rng(seed)
    full = [_Barrier(PRODUCER_LANES) for _ in range(stages)]
    empty = [_Barrier(CONSUMERS) for _ in range(stages)]
    tag = [None] * stages
    readers = [0] * stages
    pos = [0] * (1 + CONSUMERS)  # the producer, then the consumers

    def ready(agent: int) -> bool:
        s = pos[agent]
        if s >= len(walk):
            return False
        st = walk[s]
        if agent == 0:
            parity = st.empty_parity if producer_parity is None else producer_parity(s)
            return empty[st.slot].passed(parity)
        return full[st.slot].passed(st.full_parity)

    while any(p < len(walk) for p in pos):
        runnable = [a for a in range(1 + CONSUMERS) if ready(a)]
        assert runnable, f"deadlock at stages {pos}"
        agent = int(rng.choice(runnable))
        s = pos[agent]
        st = walk[s]
        assert st.slot == s % stages
        if agent == 0:
            assert readers[st.slot] == 0, f"stage {s} overwrites slot {st.slot} still being read"
            tag[st.slot], readers[st.slot] = s, CONSUMERS
            for _ in range(PRODUCER_LANES):
                full[st.slot].arrive()
        else:
            assert tag[st.slot] == s, f"consumer {agent} read stage {tag[st.slot]} for {s}"
            readers[st.slot] -= 1
            empty[st.slot].arrive()
        pos[agent] += 1


@pytest.mark.parametrize("stages", [2, 3, 4])
@pytest.mark.parametrize("seed", range(4))
def test_producer_and_consumer_parities_agree(stages, seed):
    for walk in rs_cuda.dma_schedule(2, 70_001, 4096, 2048, 3, stages):
        assert len(walk) > 2 * stages  # each slot turns over several times
        for s, st in enumerate(walk):  # the producer waits one phase behind the consumers
            assert st.empty_parity == st.full_parity ^ 1
            assert st.full_parity == (s // stages) & 1
        _run_ring(walk, stages, seed)


@pytest.mark.parametrize("stages", [2, 3, 4])
def test_the_ring_model_catches_a_wrong_parity(stages):
    """The model is not vacuous: a producer that never flips its parity
    overwrites a slot that is still being read, or stalls."""
    walk = rs_cuda.dma_schedule(1, 65_536, 4096, 2048, 1, stages)[0]
    with pytest.raises(AssertionError):
        _run_ring(walk, stages, 0, producer_parity=lambda s: 1)


# -- the plan: shared memory -------------------------------------------------


#: the (C, R) of tests/test_torch_variants.py::test_auto_tile_fits_the_kernel, and more
SHAPES = [(10, 4), (10, 1), (12, 3), (20, 4), (32, 32), (1, 1), (10, 5), (17, 4), (32, 4),
          (32, 5)]


@pytest.mark.parametrize("c, rows", SHAPES)
@pytest.mark.parametrize("chunk", [128, 256, 512, 1024, 2048])
def test_plan_fits_one_sm_and_places_the_fragments(c, rows, chunk):
    plan = rs_cuda.dma_plan(c, rows, chunk)
    assert 2 <= plan.stages <= 4 and plan.blocks_per_sm >= 1
    assert plan.smem <= rs_cuda.SMEM_PER_SM
    assert plan.pass_cols in (min(chunk, rs_cuda.SPAN), rs_cuda.DMA_NARROW_PASS)
    assert plan.pass_cols <= chunk and plan.pass_cols % 16 == 0
    nw = -(-c // 4)
    frags = 0 if rows <= 4 else 256 * (-(-rows // 4) * 4)  # in registers up to 4 rows
    p = plan.pass_cols
    w_words = p // 16 * 20 + 8  # 16 words and 4 of padding per 16 columns, and 8
    assert plan.smem == (128 + nw * w_words * 4 + 2 * rows * (p + 16) + frags
                         + plan.stages * c * chunk)
    if chunk == rs_cuda.DMA_CHUNK:
        assert rs_cuda.smem_bytes("dma", c, rows) == plan.smem
    # one more stage would cost a block per SM, or not fit
    more = plan.smem + c * chunk
    if plan.stages < 4:
        assert more > rs_cuda.SMEM_PER_SM or rs_cuda._dma_blocks(more) < rs_cuda._dma_blocks(
            plan.smem - (plan.stages - 2) * c * chunk)


def test_plan_at_the_main_path_shapes():
    """Encode (C, R) = (10, 4): 3 stages, 2 blocks per SM; the 1-lost
    rebuild (10, 1): 2 stages, 3 blocks; (32, 32) needs the narrow pass."""
    assert rs_cuda.dma_plan(10, 4)[:2] == (3, 2048) and rs_cuda.dma_plan(10, 4).blocks_per_sm == 2
    assert rs_cuda.dma_plan(10, 1)[:2] == (2, 2048) and rs_cuda.dma_plan(10, 1).blocks_per_sm == 3
    assert rs_cuda.dma_plan(32, 32)[:2] == (2, rs_cuda.DMA_NARROW_PASS)
    for c, rows in SHAPES:
        assert rs_cuda.auto_tile(c, rows, "dma") == 2 * rs_cuda.DMA_CHUNK


# -- the operand and the arithmetic ------------------------------------------


def _decode_4_of_10() -> np.ndarray:
    enc = rs_codec.Encoder(10, 4, device="cpu")
    return enc.reconstruction_matrix([s for s in range(14) if s not in (1, 6, 12, 13)][:10],
                                     (1, 6, 12, 13))


MATRICES = {
    "rs_10_4": lambda: gf8.parity_matrix(10, 4),
    "decode_4_of_10": _decode_4_of_10,
    "cauchy_12_3": lambda: gf8.parity_matrix(12, 3, "cauchy"),
    "random_32x32": lambda: np.random.default_rng(5).integers(0, 256, (32, 32), np.uint8),
    "random_5x17": lambda: np.random.default_rng(6).integers(0, 256, (5, 17), np.uint8),
}


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_dma_operand_is_the_lift_fragments(name):
    m = MATRICES[name]()
    key = rs_cuda._key(m)
    got = rs_cuda._device_operand(key, "dma", "cpu")
    assert rs_cuda.KERNELS["dma"][2] == "frags"
    assert np.array_equal(got.numpy(), rs_cuda.lift_fragments(rs_cuda.plane_major_matrix(m)))
    assert torch.equal(got, rs_cuda._device_operand(key, "int8", "cpu"))


def _popcount(x: np.ndarray) -> np.ndarray:
    return np.unpackbits(np.ascontiguousarray(x).view(np.uint8), axis=-1).sum(axis=-1)


def _ring_replay(m: np.ndarray, data: np.ndarray, tile: int, grid: int, stages: int) -> np.ndarray:
    """gf_dma.cu's arithmetic through its schedule: each stage's columns as
    column words (byte q of word w = row 4w + q, zero past C), each output
    bit (r, i) the parity of popc(words & B column), with B column (r, i)
    word 4h + t = fragment [r, 4i + t, h]; 8 bits per output byte."""
    frags = rs_cuda.lift_fragments(rs_cuda.plane_major_matrix(m))  # (R, 32, 2)
    r_n = m.shape[0]
    bcols = frags.reshape(r_n, 8, 4, 2).transpose(0, 1, 3, 2).reshape(r_n, 8, 8)  # [r, i, 4h + t]
    batch, c_n, n = data.shape
    out = np.full((batch, r_n, n), -1, dtype=np.int64)
    chunk = rs_cuda._dma_chunk(tile)
    for walk in rs_cuda.dma_schedule(batch, n, tile, chunk, grid, stages):
        for st in walk:
            rows = np.zeros((32, st.stop - st.start), dtype=np.uint8)
            rows[:c_n] = data[st.batch, :, st.start:st.stop]
            words = np.ascontiguousarray(rows.reshape(8, 4, -1).transpose(2, 0, 1)).view("<u4")[..., 0]
            sums = _popcount((words[:, None, None, :] & bcols[None]).reshape(-1, 1)).reshape(
                -1, r_n, 8, 8).sum(axis=-1).astype(np.int64)  # [col, r, i]
            assert sums.max() <= 8 * c_n
            packed = ((sums & 1) << np.arange(8)).sum(axis=-1)  # [col, r]
            assert (out[st.batch, :, st.start:st.stop] == -1).all()
            out[st.batch, :, st.start:st.stop] = packed.T
    assert (out >= 0).all()
    return out.astype(np.uint8)


@pytest.mark.parametrize("name, shape, tile, grid", [
    ("rs_10_4", (1, 10, 8321), None, 3),
    ("rs_10_4", (2, 10, 5000), 4096, 264),
    ("decode_4_of_10", (1, 10, 100), None, 1),
    ("cauchy_12_3", (2, 12, 3 * 2048 + 77), 2048, 2),
    ("random_32x32", (1, 32, 1000), 1024, 2),
    ("random_5x17", (1, 17, 700), 128, 3),
])
def test_ring_replay_matches_pallas_dma_and_plain(name, shape, tile, grid):
    m = MATRICES[name]()
    data = np.random.default_rng(len(name) + shape[-1]).integers(0, 256, shape, np.uint8)
    t = rs_cuda.resolve_tile("dma", tile, m.shape[1], m.shape[0])
    got = _ring_replay(m, data, t, grid, rs_cuda.dma_plan(m.shape[1], m.shape[0]).stages)
    assert np.array_equal(got[0], ref_gf8.gf_mat_vec(m, data[0]))
    plain = rs_cuda.apply_matrix(m, torch.from_numpy(data), tile=tile, variant="dma").numpy()
    assert np.array_equal(got, plain)
    ref = np.asarray(rs_pallas.gf_apply_fused(rs_jax.lifted_matrix(m), jnp.asarray(data),
                                              tile=t, mxu="dma"))
    assert np.array_equal(got, ref)
