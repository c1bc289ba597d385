"""xorsched — compiled XOR-schedule realization of the GF(2^8) matrix apply.

Any matrix the `Encoder` dispatches (encode parity, fused decode, projection
column-slice, delta-parity column block) is lowered through gf8's bit-plane
decomposition (`gf_matrix_to_bits`) into a binary 8R x 8C matrix over GF(2):
with shard bytes viewed as 8 packed bit-planes, every output bit-plane is the
XOR of a fixed subset of input bit-planes.  The compiler emits that XOR
program once per (matrix bytes, tile geometry) and caches it in a bounded
LRU, exactly like the decode-matrix memo in rs_codec:

* grouping pass — the most frequent source-pair across all outputs is
  hoisted into a reused temporary (greedy common-subexpression elimination,
  after "Accelerating XOR-based Erasure Coding using Program Optimization
  Techniques").  Pairs are only hoisted while they appear >= _GROUP_THRESHOLD
  times: a temp used twice costs one extra store per use saved, so the
  break-even is three uses, and threshold 3 measures ~8% less schedule
  memory traffic than threshold 2 on the 10+4 Cauchy matrix.
* cache tiling — execution walks the width axis in tiles sized so the whole
  slot frame (inputs + temps + outputs, tile/8 bytes per plane) stays
  cache-resident; ops are replayed per tile, not per buffer.

Two executors share the program:

* `apply` — pure-numpy bulk-XOR interpreter.  Always available; the
  byte-exact oracle the native path and the tests verify against.
* `apply_native` — `weedtpu_torch_xor_schedule_apply` in `csrc/gf_host.cc`
  (flat op list, SIMD XOR over contiguous tiles; GFNI/AVX-512 bit-plane
  transposes where the host has them, AVX2 otherwise, scalar everywhere
  else), built at first use by `utils/native.py`.  None when the library
  cannot be built, and `apply_matrix`/`apply_blocks` then run the
  interpreter; `native_level()` says which one a host gets.

`apply_blocks` runs MANY programs — a block-diagonal fused decode, one
block per signature group — as ONE native call
(`weedtpu_torch_xor_schedule_apply_blocks`): every (block, width-tile)
pair is an independent task, so the native side spreads the flat task list
across a thread pool (`WEEDTPU_XORSCHED_THREADS`; width tiles never share
output bytes).  Each block keeps its own LRU'd per-matrix program — the
composite is never compiled as one giant matrix.
"""

from __future__ import annotations

import ctypes
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from seaweedfs_tpu_torch.ops import gf8
from seaweedfs_tpu_torch.utils import config, native

# Hoist a source-pair into a temp only while it recurs at least this often
# (see module docstring for the traffic break-even).
_GROUP_THRESHOLD = 3


@dataclass(frozen=True)
class XorProgram:
    """A compiled XOR schedule for one GF(2^8) matrix.

    Slot space: [0, 8*cols) are the input bit-planes (plane 8c+i = bit i of
    input shard c), temps follow, and [out_base, out_base + 8*rows) are the
    output bit-planes.  `ops` is the flat op list the executors replay, each
    op encoded as [dest_slot, n_src, src_slot...]; n_src == 0 zero-fills
    (an all-zero matrix row) and n_src == 1 copies (an identity row).
    """

    rows: int
    cols: int
    n_slots: int
    out_base: int
    ops: np.ndarray  # int32, flat [dest, nsrc, srcs...] records
    tile_sym: int  # symbols (bytes per shard) processed per tile
    raw_xors: int  # XOR count of the ungrouped program
    xor_count: int  # XOR count after the grouping pass
    n_temps: int

    @property
    def scratch_bytes(self) -> int:
        return self.n_slots * (self.tile_sym // 8)


# ---------------------------------------------------------------------------
# Compiler
# ---------------------------------------------------------------------------


def _pair(a: int, b: int) -> tuple[int, int]:
    return (a, b) if a < b else (b, a)


def _group(sets: list[set[int]], n_slots: int) -> tuple[list[tuple[int, int, int]], int]:
    """Greedy pair-CSE over the per-output term sets (mutated in place).

    Returns (temps, n_slots'): temps as (slot, src_a, src_b) in creation
    order.  Pair counts are maintained incrementally with a lazy max-heap,
    ties broken toward the lexicographically smallest pair so the same
    matrix always compiles to the identical program.
    """
    import heapq

    cnt: dict[tuple[int, int], int] = {}
    rows_of: dict[tuple[int, int], set[int]] = {}
    heap: list[tuple[int, int, int]] = []

    def bump(p: tuple[int, int], row: int) -> None:
        cnt[p] = cnt.get(p, 0) + 1
        rows_of.setdefault(p, set()).add(row)
        heapq.heappush(heap, (-cnt[p], p[0], p[1]))

    def drop(p: tuple[int, int], row: int) -> None:
        cnt[p] -= 1
        rows_of[p].discard(row)

    for ri, s in enumerate(sets):
        ss = sorted(s)
        for i in range(len(ss)):
            for j in range(i + 1, len(ss)):
                bump((ss[i], ss[j]), ri)

    temps: list[tuple[int, int, int]] = []
    while heap:
        negc, a, b = heapq.heappop(heap)
        p = (a, b)
        if cnt.get(p, 0) != -negc:
            continue  # stale heap entry
        if -negc < _GROUP_THRESHOLD:
            break
        t = n_slots
        n_slots += 1
        temps.append((t, a, b))
        for ri in sorted(rows_of[p]):
            s = sets[ri]
            if a not in s or b not in s:
                continue
            s.discard(a)
            s.discard(b)
            for x in s:
                drop(_pair(a, x), ri)
                drop(_pair(b, x), ri)
                bump(_pair(x, t), ri)
            drop(p, ri)
            s.add(t)
    return temps, n_slots


def _default_tile_sym() -> int:
    return config.env("WEEDTPU_XORSCHED_TILE_KB") * 1024


def _default_threads() -> int:
    # 0 = hardware concurrency (resolved by the native executor)
    return max(0, config.env("WEEDTPU_XORSCHED_THREADS"))


def compile_schedule(matrix: np.ndarray, tile_sym: Optional[int] = None) -> XorProgram:
    """Compile (uncached) — `get_schedule` is the memoized entry point."""
    m = np.ascontiguousarray(matrix, dtype=np.uint8)
    if m.ndim != 2 or 0 in m.shape:
        raise ValueError(f"want a non-empty 2-D GF matrix, got shape {m.shape}")
    if tile_sym is None:
        tile_sym = _default_tile_sym()
    tile_sym = max(512, (tile_sym // 512) * 512)  # SIMD transpose granularity
    bits = gf8.gf_matrix_to_bits(m)
    r8, c8 = bits.shape
    sets = [set(np.nonzero(bits[r])[0].tolist()) for r in range(r8)]
    raw_xors = sum(max(0, len(s) - 1) for s in sets)
    temps, n_slots = _group(sets, c8)
    out_base = n_slots
    ops: list[int] = []
    for t, a, b in temps:
        ops += [t, 2, a, b]
    for r in range(r8):
        ss = sorted(sets[r])
        ops += [out_base + r, len(ss)] + ss
    xor_count = len(temps) + sum(max(0, len(s) - 1) for s in sets)
    return XorProgram(
        rows=m.shape[0],
        cols=m.shape[1],
        n_slots=out_base + r8,
        out_base=out_base,
        ops=np.asarray(ops, dtype=np.int32),
        tile_sym=tile_sym,
        raw_xors=raw_xors,
        xor_count=xor_count,
        n_temps=len(temps),
    )


# ---------------------------------------------------------------------------
# Schedule LRU (mirrors rs_codec's decode-matrix memo, but with a cap that
# re-reads WEEDTPU_XORSCHED_CACHE on clear so tests can shrink it)
# ---------------------------------------------------------------------------

_cache_lock = threading.Lock()
_cache: "OrderedDict[tuple, XorProgram]" = OrderedDict()
_cache_cap: Optional[int] = None
_hits = 0
_misses = 0
_evictions = 0


def _cap() -> int:
    global _cache_cap
    if _cache_cap is None:
        _cache_cap = max(1, config.env("WEEDTPU_XORSCHED_CACHE"))
    return _cache_cap


def get_schedule(matrix: np.ndarray, tile_sym: Optional[int] = None) -> XorProgram:
    """The compiled program for (matrix bytes, tile geometry), LRU-cached."""
    global _hits, _misses, _evictions
    m = np.ascontiguousarray(matrix, dtype=np.uint8)
    if tile_sym is None:
        tile_sym = _default_tile_sym()
    key = (m.shape, m.tobytes(), tile_sym)
    with _cache_lock:
        prog = _cache.get(key)
        if prog is not None:
            _hits += 1
            _cache.move_to_end(key)
            return prog
        _misses += 1
    prog = compile_schedule(m, tile_sym)
    with _cache_lock:
        _cache[key] = prog
        _cache.move_to_end(key)
        while len(_cache) > _cap():
            _cache.popitem(last=False)
            _evictions += 1
    return prog


def schedule_cache_info() -> dict:
    with _cache_lock:
        return {
            "hits": _hits,
            "misses": _misses,
            "evictions": _evictions,
            "size": len(_cache),
            "cap": _cap(),
        }


def clear_schedule_cache() -> None:
    """Empty the LRU and re-read the cap knob (test hook, like
    rs_codec.clear_decode_matrix_cache)."""
    global _cache_cap, _hits, _misses, _evictions
    with _cache_lock:
        _cache.clear()
        _cache_cap = None
        _hits = _misses = _evictions = 0


# ---------------------------------------------------------------------------
# Numpy interpreter — the byte-exact oracle
# ---------------------------------------------------------------------------


def _to_planes(seg: np.ndarray) -> np.ndarray:
    """(C, w) bytes -> (8C, ceil(w/8)) packed bit-planes (little-endian:
    plane byte j bit k = bit i of symbol 8j+k)."""
    c, w = seg.shape
    pw8 = -(-w // 8) * 8
    if pw8 != w:
        seg = np.pad(seg, ((0, 0), (0, pw8 - w)))
    bits = np.unpackbits(seg, axis=1, bitorder="little").reshape(c, pw8, 8)
    planes = np.packbits(bits.transpose(0, 2, 1).reshape(c * 8, pw8), axis=1, bitorder="little")
    return planes


def _from_planes(planes: np.ndarray, w: int) -> np.ndarray:
    """(8R, pw) packed bit-planes -> (R, w) bytes (inverse of _to_planes)."""
    r8, pw = planes.shape
    bits = np.unpackbits(planes, axis=1, bitorder="little").reshape(r8 // 8, 8, pw * 8)
    out = np.packbits(bits.transpose(0, 2, 1), axis=2, bitorder="little")[:, :, 0]
    return np.ascontiguousarray(out[:, :w])


def apply(prog: XorProgram, inputs: Sequence[np.ndarray]) -> list[np.ndarray]:
    """Run the schedule with numpy bulk XOR — tile loop, packed planes."""
    ins, n = _coerce_inputs(prog, inputs)
    outs = [np.empty(n, dtype=np.uint8) for _ in range(prog.rows)]
    ops = prog.ops
    for off in range(0, n, prog.tile_sym):
        w = min(prog.tile_sym, n - off)
        pw = -(-w // 8)
        seg = np.stack([i[off:off + w] for i in ins])
        slots = np.zeros((prog.n_slots, pw), dtype=np.uint8)
        slots[: prog.cols * 8] = _to_planes(seg)
        k = 0
        while k < len(ops):
            dest, nsrc = int(ops[k]), int(ops[k + 1])
            k += 2
            if nsrc:
                srcs = ops[k:k + nsrc]
                k += nsrc
                np.bitwise_xor.reduce(slots[srcs], axis=0, out=slots[dest])
        res = _from_planes(slots[prog.out_base:], w)
        for r in range(prog.rows):
            outs[r][off:off + w] = res[r]
    return outs


def _coerce_inputs(prog: XorProgram, inputs: Sequence[np.ndarray]) -> tuple[list[np.ndarray], int]:
    ins = [np.ascontiguousarray(np.frombuffer(i, dtype=np.uint8)) if not isinstance(i, np.ndarray)
           else np.ascontiguousarray(i, dtype=np.uint8) for i in inputs]
    if len(ins) != prog.cols:
        raise ValueError(f"program wants {prog.cols} inputs, got {len(ins)}")
    n = ins[0].shape[0]
    for i in ins:
        if i.shape[0] != n:
            raise ValueError("input shards differ in length")
    return ins, n


# ---------------------------------------------------------------------------
# Native executor (csrc/gf_host.cc through utils/native)
# ---------------------------------------------------------------------------


def native_available() -> bool:
    """True when the native executor's library is built and loaded."""
    return native.load_gf() is not None


def native_level() -> str:
    """SIMD level the native executor would run at: gfni | avx2 | scalar |
    unavailable (the library cannot be built: the interpreter runs)."""
    lib = native.load_gf()
    if lib is None:
        return "unavailable"
    return {2: "gfni", 1: "avx2"}.get(int(lib.weedtpu_torch_xorsched_level()), "scalar")


def _addresses(arrays: Sequence[np.ndarray]) -> ctypes.Array:
    return (ctypes.c_void_p * len(arrays))(*[a.ctypes.data for a in arrays])


def _native_apply_blocks(
    lib,
    progs: Sequence[XorProgram],
    ins_per_block: Sequence[Sequence[np.ndarray]],
    outs_per_block: Sequence[Sequence[np.ndarray]],
    lens: Sequence[int],
    tile_sym: int,
    threads: int,
) -> bool:
    """Marshal the parallel block arrays for
    `weedtpu_torch_xor_schedule_apply_blocks`. Returns False when the call
    is rejected."""
    nb = len(progs)
    sched = np.concatenate([np.ascontiguousarray(p.ops, dtype=np.int32) for p in progs])
    sched_off = np.zeros(nb, dtype=np.uint64)
    sched_words = np.asarray([p.ops.shape[0] for p in progs], dtype=np.uint64)
    np.cumsum(sched_words[:-1], out=sched_off[1:])
    n_slots = np.asarray([p.n_slots for p in progs], dtype=np.uint32)
    in_planes = np.asarray([p.cols * 8 for p in progs], dtype=np.uint32)
    out_base = np.asarray([p.out_base for p in progs], dtype=np.uint32)
    out_planes = np.asarray([p.rows * 8 for p in progs], dtype=np.uint32)
    ins_off = np.zeros(nb, dtype=np.uint64)
    in_counts = np.asarray([len(b) for b in ins_per_block], dtype=np.uint64)
    np.cumsum(in_counts[:-1], out=ins_off[1:])
    outs_off = np.zeros(nb, dtype=np.uint64)
    out_counts = np.asarray([len(b) for b in outs_per_block], dtype=np.uint64)
    np.cumsum(out_counts[:-1], out=outs_off[1:])
    lens_arr = np.asarray(lens, dtype=np.uint64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    rc = lib.weedtpu_torch_xor_schedule_apply_blocks(
        sched.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        sched_off.ctypes.data_as(u64p),
        sched_words.ctypes.data_as(u64p),
        n_slots.ctypes.data_as(u32p),
        in_planes.ctypes.data_as(u32p),
        out_base.ctypes.data_as(u32p),
        out_planes.ctypes.data_as(u32p),
        _addresses([a for b in ins_per_block for a in b]),
        ins_off.ctypes.data_as(u64p),
        _addresses([a for b in outs_per_block for a in b]),
        outs_off.ctypes.data_as(u64p),
        lens_arr.ctypes.data_as(u64p),
        nb,
        tile_sym,
        threads,
    )
    return bool(rc)


def apply_native(
    prog: XorProgram,
    inputs: Sequence[np.ndarray],
    threads: Optional[int] = None,
) -> Optional[list[np.ndarray]]:
    """Run the schedule through the native executor; None when its library
    is unavailable (or rejects the call). threads != 1 routes through the
    width-parallel blocks entry (n_blocks = 1); the default comes from
    WEEDTPU_XORSCHED_THREADS."""
    lib = native.load_gf()
    if lib is None:
        return None
    ins, n = _coerce_inputs(prog, inputs)
    # np.empty, not zeros: the backward transpose writes every output byte,
    # and the zeroing pass costs ~15% of the whole apply at these speeds
    outs = [np.empty(n, dtype=np.uint8) for _ in range(prog.rows)]
    if threads is None:
        threads = _default_threads()
    if threads != 1:
        if _native_apply_blocks(lib, [prog], [ins], [outs], [n], prog.tile_sym, threads):
            return outs
        return None
    ops = np.ascontiguousarray(prog.ops, dtype=np.int32)
    rc = lib.weedtpu_torch_xor_schedule_apply(
        ops.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ops.shape[0],
        prog.n_slots,
        prog.cols * 8,
        prog.out_base,
        prog.rows * 8,
        _addresses(ins),
        _addresses(outs),
        n,
        prog.tile_sym,
    )
    if not rc:
        return None
    return outs


def apply_blocks(
    progs: Sequence[XorProgram],
    inputs_per_block: Sequence[Sequence[np.ndarray]],
    threads: Optional[int] = None,
    outputs_per_block: Optional[Sequence[Sequence[np.ndarray]]] = None,
) -> list[list[np.ndarray]]:
    """Run a block-diagonal set of schedules as one stitched pass.

    Block g applies progs[g] to inputs_per_block[g]; blocks are mutually
    independent (disjoint columns of the fused decode), so the native
    executor walks one flat (block, width-tile) task list across
    `threads` workers (default WEEDTPU_XORSCHED_THREADS; tiles never
    share output bytes).  Falls back to the per-block interpreter when
    the native library is unavailable.  Byte-identical either way.
    Blocks may have different lengths but must share tile_sym.

    `outputs_per_block` lets the caller supply the destination arrays —
    e.g. contiguous row slices of one fused output matrix — which the
    native executor writes in place (zero-copy stitch); each must be a
    C-contiguous uint8 array of the block's input length.
    """
    if len(progs) != len(inputs_per_block):
        raise ValueError(f"{len(progs)} programs but {len(inputs_per_block)} input blocks")
    if not progs:
        return []
    tile_sym = progs[0].tile_sym
    for p in progs:
        if p.tile_sym != tile_sym:
            raise ValueError("all blocks must share tile_sym")
    if threads is None:
        threads = _default_threads()
    coerced: list[list[np.ndarray]] = []
    lens: list[int] = []
    for prog, inputs in zip(progs, inputs_per_block):
        ins, n = _coerce_inputs(prog, inputs)
        coerced.append(ins)
        lens.append(n)
    if outputs_per_block is None:
        outs = [[np.empty(n, dtype=np.uint8) for _ in range(p.rows)]
                for p, n in zip(progs, lens)]
    else:
        if len(outputs_per_block) != len(progs):
            raise ValueError(f"{len(progs)} programs but {len(outputs_per_block)} output blocks")
        outs = []
        for prog, block, n in zip(progs, outputs_per_block, lens):
            if len(block) != prog.rows:
                raise ValueError(f"program wants {prog.rows} outputs, got {len(block)}")
            for a in block:
                if not (isinstance(a, np.ndarray) and a.dtype == np.uint8
                        and a.flags.c_contiguous and a.shape == (n,)):
                    raise ValueError(
                        "outputs must be C-contiguous uint8 arrays matching the block length"
                    )
            outs.append(list(block))
    lib = native.load_gf()
    if lib is not None:
        if _native_apply_blocks(lib, progs, coerced, outs, lens, tile_sym, threads):
            return outs
    for p, ins, block in zip(progs, coerced, outs):
        for dst, src in zip(block, apply(p, ins)):
            np.copyto(dst, src)
    return outs


def apply_matrix(matrix: np.ndarray, inputs: Sequence[np.ndarray]) -> list[np.ndarray]:
    """Compile-and-run convenience: native executor when present, numpy
    interpreter otherwise.  Byte-identical either way."""
    prog = get_schedule(matrix)
    out = apply_native(prog, inputs)
    if out is not None:
        return out
    return apply(prog, inputs)


def export_cache_stats() -> None:
    """Mirror the LRU counters into `weedtpu_xorsched_schedule_cache` (each
    xorsched dispatch calls this)."""
    from seaweedfs_tpu_torch import stats

    for event, v in schedule_cache_info().items():
        stats.XorschedCache.labels(event).set(v)
