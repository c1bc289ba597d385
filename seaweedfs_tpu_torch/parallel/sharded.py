"""Multi-card EC paths: volume-batch (dp) x stripe (sp) sharding over a
`mesh.Mesh`, the counterpart of the reference's `shard_map` programs
(`seaweedfs_tpu/parallel/sharded.py`).

A placed array is a `ShardedTensor`: one tensor per mesh position, cut by
a partition spec (one entry per array axis: None, a mesh axis name, or a
tuple of names; mesh axes the spec does not name hold replicas). The GF
apply is column-independent, so the batch and byte axes shard with no
communication: each position's step is one `rs_cuda.apply_matrix` launch
on its device's current stream (the kernel on a card, the plain version on
the CPU). The collectives are explicit copies: the shard-major to
byte-major flip of `make_distributed_rebuild_fn` is a set of tile copies
into buffers on the destination devices (the reference's `all_to_all`
over 'sp'), and the integrity count is each position's mismatch count
moved to one device and summed (its `psum`, staged over 'dcn').

Every copy allocates its destination (`torch.empty(...).copy_`): a mesh
may name one device several times, and `Tensor.to` on the tensor's own
device would return the same tensor, so blocks would alias. Host bytes
reach the devices asynchronously when they lie in pinned memory; reading
a `ShardedTensor` back (`np.asarray`) is the one synchronisation point.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from seaweedfs_tpu_torch.ops import gf8, rs_cuda
from seaweedfs_tpu_torch.parallel.mesh import Mesh

#: the batch-over-dp, bytes-over-sp layout of encode, apply and the cycle
BATCH_SPEC = ("dp", None, "sp")
#: survivors shard-major: whole shard rows over sp (the on-disk layout)
SHARD_MAJOR_SPEC = ("dp", "sp", None)


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _spec_index(mesh: Mesh, spec: Sequence, shape: Sequence[int], pos: tuple) -> tuple:
    """The slices of a global array of `shape` that mesh position `pos`
    holds under `spec`. An axis split over several mesh axes is split in
    row-major order of those axes. Raises when a split does not divide."""
    index = []
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        k, count = 0, 1
        for a in axes:
            i = mesh.axis_names.index(a)
            k = k * mesh.devices.shape[i] + pos[i]
            count *= mesh.devices.shape[i]
        if shape[d] % count:
            raise ValueError(f"axis {d} of length {shape[d]} must divide evenly over {axes}={count}")
        step = shape[d] // count
        index.append(slice(k * step, (k + 1) * step))
    return tuple(index) + (slice(None),) * (len(shape) - len(spec))


def _replica_zero(mesh: Mesh, spec: Sequence, pos: tuple) -> bool:
    """True for the one position of each replica group: every mesh axis the
    spec does not name is at 0."""
    named = {a for entry in spec for a in _axes(entry)}
    return all(pos[i] == 0 for i, a in enumerate(mesh.axis_names) if a not in named)


def copy_host(dst: torch.Tensor, src) -> None:
    """Copy host bytes (an ndarray or a CPU tensor) into `dst`. A strided
    view (a column slice of a pinned staging slot) goes to a card row by
    row, each row one contiguous run, so every copy stays asynchronous; as
    one copy it would go through a pageable temporary, which waits for the
    stream."""
    if not isinstance(src, torch.Tensor):
        src = torch.from_numpy(src if src.flags.writeable else src.copy())
    if (dst.device.type != "cpu" and src.ndim >= 2 and src.stride(-1) == 1
            and not src.is_contiguous()):
        for idx in np.ndindex(*src.shape[:-1]):
            dst[idx].copy_(src[idx], non_blocking=True)
        return
    dst.copy_(src, non_blocking=dst.device.type != "cpu")


def transfer(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A copy of `t` on `device`, always a fresh buffer (never an alias,
    even on `t`'s own device). Between two cards it is a peer copy, ordered
    after the work on both devices' current streams."""
    return torch.empty(t.shape, dtype=t.dtype, device=device).copy_(t, non_blocking=True)


class ShardedTensor:
    """A global uint8 array of `shape` cut over `mesh` by `spec`: `blocks`
    maps each mesh position to the tensor on its device. `np.asarray` on it
    gathers the blocks to the host: the only synchronisation point. Holds
    the host arrays its blocks were copied from until then, so a pinned
    buffer outlives its asynchronous copy."""

    def __init__(self, mesh: Mesh, spec: Sequence, blocks: dict, shape: Sequence[int],
                 sources: Sequence = ()):
        self.mesh = mesh
        self.spec = tuple(spec)
        self.blocks = blocks
        self.shape = tuple(int(s) for s in shape)
        self._sources = list(sources)

    def index(self, pos: tuple) -> tuple:
        return _spec_index(self.mesh, self.spec, self.shape, pos)

    def __array__(self, dtype=None, copy=None):  # noqa: ARG002 — numpy 2.x kw
        out = np.empty(self.shape, dtype=np.uint8)
        for pos in self.mesh.positions():
            if _replica_zero(self.mesh, self.spec, pos):
                out[self.index(pos)] = self.blocks[pos].cpu().numpy()
        self._sources = []
        if dtype is not None and np.dtype(dtype) != out.dtype:
            return out.astype(dtype)
        return out


def place(mesh: Mesh, host, spec: Sequence) -> ShardedTensor:
    """Copy a host uint8 array onto the mesh, cut by `spec`."""
    host = np.asarray(host, dtype=np.uint8)
    blocks = {}
    for pos in mesh.positions():
        view = host[_spec_index(mesh, spec, host.shape, pos)]
        dst = torch.empty(view.shape, dtype=torch.uint8, device=mesh.devices[pos])
        copy_host(dst, view)
        blocks[pos] = dst
    return ShardedTensor(mesh, spec, blocks, host.shape, sources=[host])


def _as_placed(mesh: Mesh, x, spec: Sequence) -> ShardedTensor:
    """`x` as placed under `spec`: a ShardedTensor of that layout passes
    through, a host array is placed."""
    if isinstance(x, ShardedTensor):
        if x.mesh is not mesh or x.spec != tuple(spec):
            raise ValueError(f"input laid out {x.spec} on {x.mesh}, want {tuple(spec)} on {mesh}")
        return x
    return place(mesh, x, spec)


def matrix_bits(m: np.ndarray) -> torch.Tensor:
    """The int8 (8R, 8C) binary lift of a GF(2^8) matrix, as the reference's
    sharded paths hold it. The port's kernels take the GF matrix itself and
    build their operands per device (`rs_cuda`), so nothing here needs it."""
    return torch.from_numpy(gf8.gf_matrix_to_bits(np.asarray(m, dtype=np.uint8)).astype(np.int8))


def pad_survivor_matrix(recon_m: np.ndarray, sp: int) -> np.ndarray:
    """Zero-pad a (L, S) decode matrix's survivor axis to a multiple of the
    'sp' axis size (zero columns contribute nothing). Shared by the
    all_to_all and ring rebuilds."""
    recon_m = np.asarray(recon_m, dtype=np.uint8)
    n_lost, n_surv = recon_m.shape
    s_pad = -(-n_surv // sp) * sp
    padded = np.zeros((n_lost, s_pad), dtype=np.uint8)
    padded[:, :n_surv] = recon_m
    return padded


def place_survivors(mesh: Mesh, survivors, n_surv: int, s_pad: int) -> ShardedTensor:
    """Validate and place survivors SHARD-major for a distributed rebuild:
    B over 'dp', the survivor rows zero-padded to `s_pad` over 'sp'. The
    pad rows are zeroed on the devices, so only real rows cross the bus.
    One copy of the contract for the all_to_all and ring rebuilds."""
    survivors = np.asarray(survivors, dtype=np.uint8)
    b, s, n = survivors.shape
    if s != n_surv:
        raise ValueError(f"want {n_surv} survivor shards, got {s}")
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    if b % dp:
        raise ValueError(f"batch {b} must divide evenly over dp={dp}")
    if n % sp:
        raise ValueError(f"shard length {n} must divide evenly over sp={sp}")
    shape = (b, s_pad, n)
    blocks = {}
    for pos in mesh.positions():
        bi, ri, _ = _spec_index(mesh, SHARD_MAJOR_SPEC, shape, pos)
        dst = torch.empty((bi.stop - bi.start, ri.stop - ri.start, n), dtype=torch.uint8,
                          device=mesh.devices[pos])
        real = max(0, min(ri.stop, s) - ri.start)
        if real:
            copy_host(dst[:, :real], survivors[bi, ri.start : ri.start + real])
        if real < dst.shape[1]:
            dst[:, real:].zero_()
        blocks[pos] = dst
    return ShardedTensor(mesh, SHARD_MAJOR_SPEC, blocks, shape, sources=[survivors])


def _apply_blocks(mesh: Mesh, m: np.ndarray, x: ShardedTensor, variant: str,
                  tile: Optional[int]) -> dict:
    return {pos: rs_cuda.apply_matrix(m, x.blocks[pos], tile, variant) for pos in mesh.positions()}


def make_matrix_apply_fn(mesh: Mesh, matrix: np.ndarray, donate: bool = False,
                         variant: str = "int8", tile: Optional[int] = None):
    """Column-sharded GF(2^8) matrix apply over the FULL device set: (C, W)
    uint8 with W split over every mesh axis -> (R, W), no communication
    (each position's column tile is an independent product). The mesh
    backend's generic dispatch; W must divide evenly over the device count
    (the dispatcher zero-pads, which is exact). `donate` is accepted for the
    reference's signature: the placed copy is freed with its last use."""
    m = np.ascontiguousarray(np.asarray(matrix, dtype=np.uint8))
    spec = (None, tuple(mesh.axis_names))

    def apply(cols) -> ShardedTensor:
        x = _as_placed(mesh, cols, spec)
        out = _apply_blocks(mesh, m, x, variant, tile)
        return ShardedTensor(mesh, spec, out, (m.shape[0], x.shape[1]), x._sources)

    return apply


def make_encode_fn(mesh: Mesh, parity_m: np.ndarray, variant: str = "int8",
                   tile: Optional[int] = None):
    """Sharded encode: (B, D, N) uint8 -> (B, D+P, N) uint8, with B on 'dp'
    and N on 'sp' (either axis may be size 1)."""
    m = np.ascontiguousarray(np.asarray(parity_m, dtype=np.uint8))

    def encode(data) -> ShardedTensor:
        x = _as_placed(mesh, data, BATCH_SPEC)
        out = {}
        for pos in mesh.positions():
            blk = x.blocks[pos]
            out[pos] = torch.cat([blk, rs_cuda.apply_matrix(m, blk, tile, variant)], dim=1)
        b, d, n = x.shape
        return ShardedTensor(mesh, BATCH_SPEC, out, (b, d + m.shape[0], n), x._sources)

    return encode


def make_apply_fn(mesh: Mesh, matrix: np.ndarray, variant: str = "int8",
                  tile: Optional[int] = None):
    """Sharded matrix application (reconstruction with a cached decode
    matrix): (B, C, N) -> (B, R, N)."""
    m = np.ascontiguousarray(np.asarray(matrix, dtype=np.uint8))

    def apply(survivors) -> ShardedTensor:
        x = _as_placed(mesh, survivors, BATCH_SPEC)
        out = _apply_blocks(mesh, m, x, variant, tile)
        b, _, n = x.shape
        return ShardedTensor(mesh, BATCH_SPEC, out, (b, m.shape[0], n), x._sources)

    return apply


def psum(mesh: Mesh, counts: dict) -> torch.Tensor:
    """The sum of per-position scalar counts, on the mesh's first device.
    With a 'dcn' axis the sum is staged: each dcn slice sums its own
    positions' counts on its first device, then one scalar per slice moves
    to the first device (the only thing that crosses 'dcn')."""
    if "dcn" not in mesh.axis_names:
        head = mesh.first()
        return torch.stack([transfer(c, head) for c in counts.values()]).sum()
    d = mesh.axis_names.index("dcn")
    slices: dict = {}
    for pos, c in counts.items():
        slices.setdefault(pos[d], []).append((pos, c))
    partial = []
    for _, members in sorted(slices.items()):
        head = mesh.devices[members[0][0]]
        partial.append(torch.stack([transfer(c, head) for _, c in members]).sum())
    return torch.stack([transfer(p, mesh.first()) for p in partial]).sum()


def make_ec_cycle_fn(mesh: Mesh, parity_m: np.ndarray, recon_m: np.ndarray, lost_ids,
                     survivor_ids, variant: str = "int8", tile: Optional[int] = None):
    """The full step the dry run drives: encode -> lose shards ->
    reconstruct -> global integrity count. On a mesh WITH a 'dcn' axis the
    batch also splits over it and the count is staged (`psum`).

    Returns fn(data (B, D, N)) -> (shards (B, T, N), global mismatches, a
    0-d tensor on the mesh's first device)."""
    m_enc = np.ascontiguousarray(np.asarray(parity_m, dtype=np.uint8))
    m_rec = np.ascontiguousarray(np.asarray(recon_m, dtype=np.uint8))
    lost = list(lost_ids)
    surv = list(survivor_ids)
    spec = (("dcn", "dp") if "dcn" in mesh.axis_names else "dp", None, "sp")

    def step(data):
        x = _as_placed(mesh, data, spec)
        shards, bad = {}, {}
        for pos in mesh.positions():
            blk = x.blocks[pos]
            full = torch.cat([blk, rs_cuda.apply_matrix(m_enc, blk, tile, variant)], dim=1)
            rebuilt = rs_cuda.apply_matrix(m_rec, full[:, surv, :], tile, variant)
            bad[pos] = (rebuilt != full[:, lost, :]).sum()
            shards[pos] = full
        b, d, n = x.shape
        out = ShardedTensor(mesh, spec, shards, (b, d + m_enc.shape[0], n), x._sources)
        return out, psum(mesh, bad)

    return step


def shard_batch(mesh: Mesh, data) -> ShardedTensor:
    """Place a (B, C, N) host array onto the mesh with B on dp, N on sp."""
    return place(mesh, data, BATCH_SPEC)


def make_multislice_ec_cycle_fn(mesh: Mesh, parity_m: np.ndarray, recon_m: np.ndarray,
                                lost_ids, survivor_ids, variant: str = "int8",
                                tile: Optional[int] = None):
    """Host-facing wrapper of make_ec_cycle_fn for a ('dcn', 'dp', 'sp')
    mesh: slices own disjoint volume sub-batches, and one scalar per slice
    crosses 'dcn'. On one host 'dcn' is the outermost group of cards."""
    if "dcn" not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no 'dcn' axis")
    step = make_ec_cycle_fn(mesh, parity_m, recon_m, lost_ids, survivor_ids, variant, tile)
    batch_div = mesh.shape["dcn"] * mesh.shape["dp"]
    sp = mesh.shape["sp"]

    def run(data):
        data = np.asarray(data, dtype=np.uint8)
        b, _c, n = data.shape
        if b % batch_div:
            raise ValueError(f"batch {b} must divide evenly over dcn*dp={batch_div}")
        if n % sp:
            raise ValueError(f"shard length {n} must divide evenly over sp={sp}")
        return step(data)

    return run


def make_distributed_rebuild_fn(mesh: Mesh, recon_m: np.ndarray, donate: bool = False,
                                variant: str = "int8", tile: Optional[int] = None):
    """Multi-card distributed rebuild. Storage hands survivors over
    SHARD-major (a card holds whole shards, the on-disk `.ecNN` layout); the
    decode wants BYTE-major (each card needs the same byte range of ALL
    survivors). The flip is the reference's one `all_to_all` over 'sp':
    each position gathers its byte tile of every 'sp' peer's rows into one
    buffer on its own device, then decodes it with one launch.

    recon_m: (L, S) decode matrix mapping S survivors to L lost shards; the
    survivor axis is zero-padded to a multiple of 'sp'. Returns
    run(survivors (B, S, N) uint8) -> (B, L, N) ShardedTensor, N over 'sp';
    `run.on_mesh` takes survivors already placed by `place_survivors`.
    `donate` is accepted for the reference's signature and has no effect."""
    n_surv = np.asarray(recon_m).shape[1]
    padded = pad_survivor_matrix(recon_m, mesh.shape["sp"])
    s_pad = padded.shape[1]
    sp = mesh.shape["sp"]
    sp_axis = mesh.axis_names.index("sp")

    def on_mesh(st: ShardedTensor) -> ShardedTensor:
        out = {}
        for pos in mesh.positions():
            j = pos[sp_axis]
            b_local, s_local, n = st.blocks[pos].shape
            tile_n = n // sp
            regrouped = torch.empty((b_local, s_pad, tile_n), dtype=torch.uint8,
                                    device=mesh.devices[pos])
            for k in range(sp):
                peer = pos[:sp_axis] + (k,) + pos[sp_axis + 1:]
                regrouped[:, k * s_local : (k + 1) * s_local].copy_(
                    st.blocks[peer][:, :, j * tile_n : (j + 1) * tile_n], non_blocking=True
                )
            out[pos] = rs_cuda.apply_matrix(padded, regrouped, tile, variant)
        b, _, n = st.shape
        return ShardedTensor(mesh, BATCH_SPEC, out, (b, padded.shape[0], n), st._sources)

    def run(survivors) -> ShardedTensor:
        return on_mesh(place_survivors(mesh, survivors, n_surv, s_pad))

    run.on_mesh = on_mesh
    return run
