"""Ring-pipelined multi-card rebuild, the counterpart of the reference's
`seaweedfs_tpu/parallel/ring.py` (a `lax.ppermute` rotation).

`sharded.make_distributed_rebuild_fn` flips shard-major survivors to
byte-major at once, which materialises every card's full survivor working
set. The ring does the same reconstruction with one resident block per
card: each card keeps its survivor-shard block and hands it one hop along
'sp' per step, accumulating that block's contribution to its own byte
tile before passing it on.

    step k on card c:
      block holds the survivor shards originally resident on card c-k
      acc ^= decode_cols(owner[block]) x block[:, :, my_byte_tile]
      block -> card c+1 (a peer copy into a fresh buffer)

After sp steps every card has seen every survivor once; GF(2^8) addition
is XOR, so the partial outputs combine exactly. The last step's hop is
not made: nothing reads it. Each step's products are launched on every
card before the hop is issued, so one card's copy and another's product
run at once; within one card they are ordered on its current stream.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from seaweedfs_tpu_torch.ops import rs_cuda
from seaweedfs_tpu_torch.parallel.mesh import Mesh
from seaweedfs_tpu_torch.parallel.sharded import (
    BATCH_SPEC,
    ShardedTensor,
    pad_survivor_matrix,
    place_survivors,
    transfer,
)


def make_ring_rebuild_fn(mesh: Mesh, recon_m: np.ndarray, donate: bool = False,
                         variant: str = "int8", tile: Optional[int] = None):
    """Ring rebuild over the 'sp' mesh axis.

    recon_m: (L, S) decode matrix (survivors -> lost shards); its survivor
    axis is zero-padded to a multiple of the ring size. Returns
    run(survivors (B, S, N) uint8) -> (B, L, N) ShardedTensor with N over
    'sp', the same contract as `make_distributed_rebuild_fn`, so the two
    are drop-in alternatives; `run.on_mesh` takes placed survivors.
    `donate` is accepted for the reference's signature and has no effect."""
    n_surv = np.asarray(recon_m).shape[1]
    sp = mesh.shape["sp"]
    padded = pad_survivor_matrix(recon_m, sp)
    s_pad = padded.shape[1]
    s_local = s_pad // sp
    owner_cols = [np.ascontiguousarray(padded[:, o * s_local : (o + 1) * s_local])
                  for o in range(sp)]
    sp_axis = mesh.axis_names.index("sp")

    def hop(pos: tuple) -> tuple:
        return pos[:sp_axis] + ((pos[sp_axis] + 1) % sp,) + pos[sp_axis + 1:]

    def on_mesh(st: ShardedTensor) -> ShardedTensor:
        blocks = dict(st.blocks)
        acc: dict = {}
        for k in range(sp):
            for pos in mesh.positions():
                my = pos[sp_axis]
                blk = blocks[pos]
                tile_n = blk.shape[2] // sp
                part = rs_cuda.apply_matrix(
                    owner_cols[(my - k) % sp], blk[:, :, my * tile_n : (my + 1) * tile_n],
                    tile, variant,
                )
                acc[pos] = part if k == 0 else acc[pos].bitwise_xor_(part)
            if k + 1 < sp:
                blocks = {hop(pos): transfer(blocks[pos], mesh.devices[hop(pos)])
                          for pos in mesh.positions()}
        b, _, n = st.shape
        return ShardedTensor(mesh, BATCH_SPEC, acc, (b, padded.shape[0], n), st._sources)

    def run(survivors) -> ShardedTensor:
        return on_mesh(place_survivors(mesh, survivors, n_surv, s_pad))

    run.on_mesh = on_mesh
    return run
