"""The control and the planted faults that the comparison must catch.

`Control` is the plain reference put in the program's place, breaking the
one guarantee the configurations state (every byte exact) as a read-back
that does not wait for its copy would: each call answers with the bytes of
the call before it.

`planted(kind)` breaks the program underneath the window, at the kernel
entry the Encoder dispatches to (`rs_cuda.apply_matrix`), for the faults
a codec on one card can have:
  * "unchanged": the step returns its state unchanged, its output as
    allocated and never written (zeros);
  * "half": half of the batch left out, the second half of the columns
    never computed;
  * "altered": one byte of the answer altered where it is produced.
The exchange between cards does not exist on one card.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import numpy as np
import torch

from ecbench import reference

KINDS = ("unchanged", "half", "altered")


class _Answer:
    def __init__(self, t: torch.Tensor):
        self._t = t
        self.shape = tuple(t.shape)

    def __array__(self, dtype=None, copy=None):  # noqa: ARG002 — numpy 2.x keyword
        return self._t.cpu().numpy()


class Control:
    """The reference in the Encoder's place, answering each call with the
    previous call's bytes (zeros for the first)."""

    def __init__(self, data_shards: int, parity_shards: int, device):
        self.k, self.m = data_shards, parity_shards
        self.device = torch.device(device)
        self.parity = reference.parity_matrix(data_shards, parity_shards)
        self._rebuild: dict = {}
        self._prev = None

    def _apply(self, m: np.ndarray, host) -> _Answer:
        out = reference.apply(m, torch.from_numpy(np.asarray(host)).to(self.device))
        prev, self._prev = self._prev, out
        return _Answer(torch.zeros_like(out) if prev is None else prev)

    def encode_parity_lazy(self, data) -> _Answer:
        return self._apply(self.parity, data)

    def reconstruct_lazy(self, stack, survivors: Sequence[int], wanted: Sequence[int]) -> _Answer:
        key = (tuple(survivors), tuple(wanted))
        if key not in self._rebuild:
            self._rebuild[key] = reference.rebuild_matrix(self.k, self.m, *key)
        return self._apply(self._rebuild[key], stack)


def _break(kind: str, out: torch.Tensor) -> torch.Tensor:
    if kind == "unchanged":
        return torch.zeros_like(out)
    if kind == "half":
        out[..., out.shape[-1] // 2:] = 0
        return out
    if kind == "altered":
        flat = out.view(-1)
        flat[flat.numel() // 2] ^= 0x5A
        return out
    raise ValueError(f"unknown fault {kind!r} (want one of {KINDS})")


@contextlib.contextmanager
def planted(kind: str):
    """The program's kernel entry broken by `kind` while the block runs."""
    from seaweedfs_tpu_torch.ops import rs_cuda

    if kind not in KINDS:
        raise ValueError(f"unknown fault {kind!r} (want one of {KINDS})")
    real = rs_cuda.apply_matrix

    def broken(m, shards, tile=None, variant="int8"):
        return _break(kind, real(m, shards, tile, variant))

    rs_cuda.apply_matrix = broken
    try:
        yield
    finally:
        rs_cuda.apply_matrix = real
