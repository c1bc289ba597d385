"""Multi-card EC paths: dp x sp sharded encode and rebuild, the
all_to_all and ring rebuilds, and the Encoder's mesh dispatch, over every
CUDA card of one host from one process (the counterpart of the
reference's `shard_map` programs over a `jax.sharding.Mesh`).

One controller drives the mesh: each device's step is the ported GF apply
(`rs_cuda.apply_matrix`) launched on that device's current stream, and the
collectives are explicit device-to-device copies (NVLink between the cards
of one host) and a sum of per-device counts. A mesh may name one device
several times, the counterpart of the reference's virtual CPU devices:
the CPU tests name the CPU 8 times, `chip_smoke.py` one card 4 times."""
