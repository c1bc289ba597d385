"""The one general generator: a cell's configuration and traffic files ->
the call the window repeats, the seeded inputs, and the answers the
reference expects.

A configuration (`configs/<name>.json`) fixes the code (data and parity
shards), how a deployment lays bytes into a call (`layout`) and its buffer
sizes. A traffic mix (`traffic/<name>.json`) fixes the operation (`encode`,
or `rebuild` of the shards in `lost`) and the calls in flight (`depth`).
The harness's own settings are constants here: the distinct pinned input
batches the stream cycles (`SLOTS`), the calls set-up makes before the
window (`WARM_CALLS`) and how many answers the check samples (`SAMPLE`).
Nothing here imports the measured program.

Layouts:
  * "stripe" (SeaweedFS `write_ec_files` / `rebuild_ec_files`): one flat
    (k, width) call, width the whole buffers that fit `max_batch_bytes`,
    buffers of `encode_buffer_size` or `rebuild_buffer_size` bytes a shard.
  * "object" (MinIO's erasure set, `erasure.Encode`): one (k, ceil(block_size
    / k)) call per block, as MinIO makes one encode call per block; the
    last shard is zero past the block's end, as the split pads it.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from ecbench import reference

HERE = os.path.dirname(os.path.abspath(__file__))
SLOTS = 5  # distinct input batches: more than depth + 1, so no two calls in flight share one
WARM_CALLS = 64  # calls set-up makes before the window
SAMPLE = 12  # answers drawn from the seed for the check, besides the last


@dataclasses.dataclass(frozen=True)
class Plan:
    op: str  # "encode" or "rebuild"
    data_shards: int
    parity_shards: int
    matrix_kind: str
    shape: tuple  # one call's input: (k, N)
    pad: int  # zero bytes at the end of the last data shard
    lost: tuple  # rebuild: the shard ids lost, which the call rebuilds
    survivors: tuple  # rebuild: the shard ids the call reads
    depth: int

    @property
    def width(self) -> int:
        return self.shape[-1]

    @property
    def out_rows(self) -> int:
        return self.parity_shards if self.op == "encode" else len(self.lost)

    @property
    def out_shape(self) -> tuple:
        return (self.out_rows, self.width)

    @property
    def in_bytes(self) -> int:
        """Bytes a call reads: the data shards (encode) or the survivors."""
        return self.data_shards * self.width

    @property
    def out_bytes(self) -> int:
        return self.out_rows * self.width


def _read_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark_file(root: str) -> dict:
    return _read_json(os.path.join(root, "BENCHMARK.json"))


def cell_entry(bench: dict, cell: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"no workload {cell!r} in BENCHMARK.json")


def config_file(name: str) -> dict:
    return _read_json(os.path.join(HERE, "configs", f"{name}.json"))


def traffic_file(name: str) -> dict:
    return _read_json(os.path.join(HERE, "traffic", f"{name}.json"))


def plan(config: dict, traffic: dict, max_width: Optional[int] = None) -> Plan:
    """The call a cell of `config` and `traffic` repeats. `max_width` cuts
    it for a test on the CPU; the benchmark never passes it."""
    k, m = int(config["data_shards"]), int(config["parity_shards"])
    op = traffic["op"]
    if op not in ("encode", "rebuild"):
        raise ValueError(f"unknown op {op!r}")
    layout = config["layout"]
    pad = 0
    if layout == "stripe":
        buf = int(config["encode_buffer_size" if op == "encode" else "rebuild_buffer_size"])
        units = max(1, int(config["max_batch_bytes"]) // (k * buf))
        width = units * buf
        shape: tuple = (k, width if max_width is None else min(width, max_width))
    elif layout == "object":
        block = int(config["block_size"])
        shard = -(-block // k)
        pad = k * shard - block
        if max_width is not None and shard > max_width:
            shard = max_width
            pad = min(pad, shard)
        shape = (k, shard)
    else:
        raise ValueError(f"unknown layout {layout!r}")
    lost = tuple(int(s) for s in traffic.get("lost", ()))
    survivors: tuple = ()
    if op == "rebuild":
        if not lost:
            raise ValueError("a rebuild traffic names the shards it loses")
        survivors = tuple(reference.survivors_of(k, m, lost))
    return Plan(
        op=op, data_shards=k, parity_shards=m,
        matrix_kind=config.get("matrix_kind", "vandermonde"), shape=shape, pad=pad,
        lost=lost, survivors=survivors, depth=int(traffic["depth"]),
    )


def slot_seed(seed: int, slot: int) -> int:
    """A 63-bit generator seed for one input batch, from the run's seed."""
    state = np.random.SeedSequence([int(seed) % (1 << 64), int(slot)]).generate_state(2)
    return int((int(state[0]) << 32 | int(state[1])) & ((1 << 63) - 1))


def _data(p: Plan, seed: int, slot: int, device: torch.device) -> torch.Tensor:
    """One batch of data shards, (k, N), made on `device`."""
    g = torch.Generator(device=device)
    g.manual_seed(slot_seed(seed, slot))
    data = torch.empty(p.shape, dtype=torch.uint8, device=device).random_(generator=g)
    if p.pad:
        data[p.data_shards - 1, p.width - p.pad:] = 0
    return data


def _codeword(p: Plan, seed: int, slot: int, device: torch.device) -> torch.Tensor:
    """All k + m shards of one batch: the data and the reference's parity."""
    data = _data(p, seed, slot, device)
    parity = reference.apply(reference.parity_matrix(p.data_shards, p.parity_shards), data)
    return torch.cat([data, parity], dim=0)


def call_input(p: Plan, seed: int, slot: int, device: torch.device) -> torch.Tensor:
    """What one call hands the program: the data (encode) or the
    survivors' rows (rebuild), on `device`."""
    if p.op == "encode":
        return _data(p, seed, slot, device)
    return _codeword(p, seed, slot, device)[list(p.survivors)].contiguous()


def make_inputs(p: Plan, seed: int, device: torch.device) -> list[np.ndarray]:
    """The `SLOTS` input batches as host arrays: made on `device`, then
    copied once into pinned host memory when `device` is a card."""
    pin = device.type == "cuda"
    out = []
    for slot in range(SLOTS):
        host = torch.empty(p.shape, dtype=torch.uint8, pin_memory=pin)
        host.copy_(call_input(p, seed, slot, device))
        out.append(host.numpy())
    return out


def expected(p: Plan, seed: int, slot: int, device: torch.device
             ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(the reference's answer for one slot, the shards lost) on `device`.
    Encode: the parity of the regenerated data, and None. Rebuild: the
    reference's rebuild of the regenerated survivors, and the lost rows of
    the regenerated codeword, which the answer must equal as well."""
    if p.op == "encode":
        m = reference.parity_matrix(p.data_shards, p.parity_shards)
        return reference.apply(m, _data(p, seed, slot, device)), None
    word = _codeword(p, seed, slot, device)
    m = reference.rebuild_matrix(p.data_shards, p.parity_shards, p.survivors, p.lost)
    answer = reference.apply(m, word[list(p.survivors)].contiguous())
    return answer, word[list(p.lost)]
