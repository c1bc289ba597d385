"""Device meshes: a named grid of torch devices, the counterpart of
`jax.sharding.Mesh`. The reference scales EC work by laying volume
batches and stripe tiles over a mesh of TPU chips; here the mesh's
entries are CUDA cards of one host (or the CPU, named as many times as
the mesh has entries, for the CPU tests)."""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np
import torch


class Mesh:
    """An ndarray of `torch.device`s with one name per axis. `shape` maps
    each axis name to its size, as the reference mesh's does."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device grid for axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def positions(self) -> Iterator[tuple]:
        """Every grid position, in row-major order."""
        return np.ndindex(*self.devices.shape)

    def first(self) -> torch.device:
        return self.devices.flat[0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def local_devices() -> list[torch.device]:
    """The host's CUDA cards, `cuda:0` .. `cuda:n-1`. Raises with no card:
    a mesh never falls back to the CPU unless the caller names it."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device: a mesh runs on the host's cards; pass devices= "
            "(e.g. [torch.device('cpu')] * 8) for the plain version"
        )
    return [torch.device("cuda", i) for i in range(n)]


def device_mesh(
    axis_names: Sequence[str] = ("dp",),
    shape: Optional[Sequence[int]] = None,
    devices=None,
) -> Mesh:
    """A mesh over `devices` (default: every card of the host).

    axis_names: logical axes, e.g. ("dp",) for volume-batch parallelism or
    ("dp", "sp") for volume x stripe 2D sharding.
    shape: devices per axis; defaults to all devices on the first axis.
    A list may name one device more than once."""
    devices = [torch.device(d) for d in (devices if devices is not None else local_devices())]
    if shape is None:
        shape = [len(devices)] + [1] * (len(axis_names) - 1)
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh shape {tuple(shape)} needs {n} devices, have {len(devices)}")
    grid = np.empty(n, dtype=object)
    for i in range(n):
        grid[i] = devices[i]
    return Mesh(grid.reshape(tuple(int(s) for s in shape)), axis_names)
