"""Time the tensor-core products the GF(2^8) kernels issue, alone, on the card.

    python -m seaweedfs_tpu_torch.scripts.mma_rates [--iters N] [--out FILE]

For each `mma.sync` form the kernels use (the 1-bit AND-popc m16n8k256 of
int8 and dma, the s8 m16n8k32 of u8 and mplane and of every kernel's pack,
the s8 m16n8k16 of mplane at C <= 16), every warp of a full grid (8 warps
a block, 8 blocks an SM) issues N rounds of 8 independent products, each
chain with A and B registers of its own, as in a kernel, timed
between CUDA events; then one warp on each SM issues the same 8 chains,
and then one chain of dependent products, both timed by the SM's own
clock (`clock64`). Prints one JSON line per form: products per second,
operations per second (2*M*N*K), cycles per product on one SM
sub-partition (4 per SM) at the card's maximum SM clock
(`nvidia-smi --query-gpu=clocks.max.sm`), the cycles per product of one
warp alone with 8 chains, and the latency of one product in SM cycles,
beside the card line. The source is
built by `nvcc` into `seaweedfs_tpu_torch/_build/` at first use.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

// 8 products a round into CHAINS accumulators: 8 independent chains, or 1
template <int FORM, int CHAINS>
__global__ void __launch_bounds__(256) probe(int iters, long long* sink) {
  int d[8][4] = {};
  uint32_t a[8][4], b[8][2];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t x = (threadIdx.x + 32 * k) * 2654435761u + blockIdx.x;
    a[k][0] = x, a[k][1] = x * 3u, a[k][2] = x * 5u, a[k][3] = x * 7u;
    b[k][0] = x * 11u, b[k][1] = x * 13u;
  }
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = j % CHAINS;
      if (FORM == 0) {
        asm volatile("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
                     "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+r"(d[k][0]), "+r"(d[k][1]), "+r"(d[k][2]), "+r"(d[k][3])
                     : "r"(a[j][0]), "r"(a[j][1]), "r"(a[j][2]), "r"(a[j][3]), "r"(b[j][0]), "r"(b[j][1]));
      } else if (FORM == 1) {
        asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
                     "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+r"(d[k][0]), "+r"(d[k][1]), "+r"(d[k][2]), "+r"(d[k][3])
                     : "r"(a[j][0]), "r"(a[j][1]), "r"(a[j][2]), "r"(a[j][3]), "r"(b[j][0]), "r"(b[j][1]));
      } else {
        asm volatile("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
                     "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
                     : "+r"(d[k][0]), "+r"(d[k][1]), "+r"(d[k][2]), "+r"(d[k][3])
                     : "r"(a[j][0]), "r"(a[j][1]), "r"(b[j][0]));
      }
    }
  }
  const long long t1 = clock64();
  int s = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) s ^= d[k][0] ^ d[k][1] ^ d[k][2] ^ d[k][3];
  if (threadIdx.x == 0) sink[blockIdx.x] = (t1 - t0) | (s == 0x7fffffff);  // keeps them live
}

// mode 0: `blocks` blocks of 8 warps, 8 chains; 1: one warp a block, one
// chain; 2: one warp a block, 8 chains. sink: one clock64 interval a block.
extern "C" int mma_probe(int form, int mode, int blocks, int iters, void* sink, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* out = static_cast<long long*>(sink);
  const int threads = mode ? 32 : 256;
  const bool chained = mode == 1;
  if (form == 0 && !chained) probe<0, 8><<<blocks, threads, 0, s>>>(iters, out);
  else if (form == 1 && !chained) probe<1, 8><<<blocks, threads, 0, s>>>(iters, out);
  else if (!chained) probe<2, 8><<<blocks, threads, 0, s>>>(iters, out);
  else if (form == 0) probe<0, 1><<<blocks, threads, 0, s>>>(iters, out);
  else if (form == 1) probe<1, 1><<<blocks, threads, 0, s>>>(iters, out);
  else probe<2, 1><<<blocks, threads, 0, s>>>(iters, out);
  return static_cast<int>(cudaGetLastError());
}
"""

#: form -> (name, M, N, K)
FORMS = {
    0: ("m16n8k256.b1.and.popc", 16, 8, 256),
    1: ("m16n8k32.s8", 16, 8, 32),
    2: ("m16n8k16.s8", 16, 8, 16),
}


def _library():
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    from seaweedfs_tpu_torch.ops import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, "mma_rates.cu")
    so = os.path.join(_build.BUILD_DIR, "libmma_rates.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", so, src], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    lib.mma_probe.restype = ctypes.c_int
    lib.mma_probe.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p, ctypes.c_void_p]
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=4096)
    ap.add_argument("--out", default=None, help="append the JSON lines to this file too")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("mma_rates: no CUDA device", file=sys.stderr)
        return 1
    from seaweedfs_tpu_torch.ops import measure

    card = measure.card_line()
    max_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0])
    lib = _library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = 8 * sms
    sink = torch.zeros(blocks, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    lines = []
    for form, (name, m, n, k) in FORMS.items():
        def run(iters, mode=0):
            err = lib.mma_probe(form, mode, sms if mode else blocks, iters, sink.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"mma_probe {name}: cudaError {err}")
        run(16)
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run(args.iters)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        sec = sorted(times)[len(times) // 2]
        run(args.iters, mode=2)
        torch.cuda.synchronize()
        one_warp = float(sink[:sms].double().median()) / (8 * args.iters)
        run(args.iters, mode=1)
        torch.cuda.synchronize()
        latency = float(sink[:sms].double().median()) / (8 * args.iters)
        products = blocks * 8 * args.iters * 8  # blocks x warps x rounds x products
        rate = products / sec
        lines.append({
            "form": name, "products_per_s": rate, "ops_per_s": rate * 2 * m * n * k,
            "cycles_per_product_per_subpartition": 4 * sms * max_mhz * 1e6 / rate,
            "one_warp_cycles_per_product": one_warp, "latency_cycles": latency, "max_sm_mhz": max_mhz, "seconds": sec, "card": card,
        })
    out = open(args.out, "a") if args.out else None
    for rec in lines:
        print(json.dumps(rec), flush=True)
        if out:
            out.write(json.dumps(rec) + "\n")
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
