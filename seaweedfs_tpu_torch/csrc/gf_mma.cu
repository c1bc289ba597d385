// GF(2^8) matrix application over byte shards on the tensor cores in int8
// (mma.sync m16n8k32 and m16n8k16 over 0/1 bytes, int32 sums), for Hopper (sm_90a): two
// kernels, the ports of the two Pallas variants that take the product in
// int8 over a stack of 0/1 input bits.
//
//   gf_u8_apply      replaces seaweedfs_tpu/ops/rs_pallas.py:_kernel_u8
//                    (:187): one int8 product over the whole plane-major
//                    0/1 stack, which the TPU kernel makes shift-free by
//                    mask and compare;
//   gf_mplane_apply  replaces rs_pallas.py:_kernel_mplane (:210): eight
//                    per-plane int8 products, each with K = C, summed into
//                    one int32 accumulator.
//
// Both compute out[b, r, n] = XOR_c m[r][c] * data[b, c, n] over GF(2^8) as
// (lift . bits(data)) mod 2, where lift is the (8R, 8C) binary lift of the
// (R, C) matrix, and differ only in the order of K, the input bits.
//
// What bounds them on this card: HBM, (C + R) bytes per column: 0.0274 ms
// for the (4,10) x (10, 6 553 600) encode batch at 3.35 TB/s (the TPU
// kernels' own product, 2 * 8R * 8C operations per column, takes 0.0170
// ms at 1979 TOP/s). The products this design issues, with K padded, are
// far below that rate for u8: 12 m16n8k32 per 16 columns at C = 10, R = 4
// (0.022 ms at 1979 TOP/s); mplane takes one K step per plane and R, 32
// products, each an m16n8k16 for C <= 16 (0.029 ms at that rate, about
// the byte bound); each adds one pack product. What the design does about
// the rest, the integer work that turns bytes into operands and sums back
// into bytes:
//   * the product is taken transposed, outT = bitsT . liftT: M = 16 byte
//     columns, N = output bits (n8 tile r = output row r, column i = its
//     bit i; nothing padded), K = the variant's stack;
//   * so the data is the A operand, built once per K step and 16 columns
//     and reused by every output row. Lane (g, t)'s a0/a1 are K bytes
//     4t..4t+3 of columns g and g + 8, a2/a3 bytes 16 + 4t..; each is
//     plane j of a column word as 0/1 bytes, (W >> j) & 0x01010101: a
//     shift and an AND. The TPU kernel's mask and compare,
//     __vcmpne4(W & (0x01010101 << j), 0) & 0x01010101, gives the same
//     bytes, but this card emulates __vcmpne4 in several instructions.
//       u8:     K step s of 32 holds stack words q = 8s + t (a0/a1) and
//               q + 4 (a2/a3), plane j of word w with (j, w) = divmod(q,
//               NW): the plane-major stack, each plane padded to 4 * NW
//               rows, so NW steps (3 for C = 10). Each lane reads its
//               step's words of columns g and g + 8 with one 8-byte load,
//               since u8 stages W with the two side by side;
//       mplane: K step j is plane j: a0/a1 from word t (rows 4t..4t+3),
//               a2/a3 from word 4 + t, zero past NW; the words are read
//               once per 16 columns, and 8 steps follow by shifts. For
//               C <= 16, a2/a3 and b1 (rows 16-31) are zero, and each step
//               is an m16n8k16 on a0/a1 and b0: the same sums, half the
//               tensor-core work;
//   * the lift is the B operand, constant for the launch: 0/1 bytes in
//     fragment order (`rs_cuda.s8_fragments`). It is held in registers for
//     R <= 4, one kernel per (NW, R) so that no product is predicated (u8
//     2 * NW * R registers; mplane 16 * R, or 8 * R for C <= 16), else
//     staged in shared memory and read per product in groups of 4 output
//     rows;
//   * every sum is at most 8C <= 256 (int32) and its bit 0 is the output
//     bit. The pack is one int8 m16n8k32 per group of 4 output rows
//     (`gf::pack_group`, shared with the int8 and bf16 kernels): the sums'
//     C layout is its A fragment as it stands, no shuffle;
//   * input moves with 16-byte loads and is transposed into column words
//     through shared memory; output goes through a shared tile and leaves
//     with 16-byte stores (`gf::stage_words`, `gf::store_tile`). A block's
//     phases run in turn, so blocks overlap each other's: where ptxas
//     would take more than 128 registers at C <= 16 and hold an SM to 3
//     blocks, or spill, the launch bounds ask for 4 (`min_blocks`).
// Per block of 128 threads and trip of 2048 columns, each warp on its own
// 512 columns (so warps meet at __syncwarp only):
//   1. each thread loads its 16 columns of every input row and stores
//      their column words to shared W[w][col] (byte q of word w = row
//      4w + q);
//   2. the warp walks its columns, 16 per M tile up to the edge: the A
//      fragments of all K steps, R products per step into int32
//      accumulators, the pack, and lanes t < 2 write the bytes of output
//      rows 2t, 2t + 1 to the shared tile;
//   3. each thread stores its 16 columns of the output tile.
// The ragged edge is masked in the kernel, so any N >= 1 works with no pad,
// and a block walks `tile` columns, any multiple of 16, in trips of 2048.

#include <cstdint>
#include <cuda_runtime.h>

#include "gf_common.cuh"

namespace {

using gf::kCols;
using gf::kGroup;
using gf::kOutStride;
using gf::kSpan;
using gf::kThreads;
using gf::kWStride;

enum Variant { kMplane = 0, kU8 = 1 };

constexpr uint32_t kOnes = 0x01010101u;

// K steps of 32: u8 the padded stack (NW), mplane one per plane (8)
template <int V, int NW>
__host__ __device__ constexpr int k_steps() {
  return V == kU8 ? NW : 8;
}

struct Job {
  const uint8_t* data;
  long long in_batch, in_row;
  uint8_t* out;
  long long out_batch, out_row;
  const uint2* frags;  // [R][S][32] B fragments
  int c, r_rows;
  long long n, tile;
  bool vec_in, vec_out;
};

// d += a . b, m16n8k16 with u8 operands: the k32 product's a0/a1 and b0
__device__ __forceinline__ void mma_u8_k16(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// The product of one K step: m16n8k16 when its K bytes 16-31 are zero
// (mplane with C <= 16), else m16n8k32.
template <int V, int NW>
__device__ __forceinline__ void step_product(int (&d)[4], const uint32_t (&a)[4], uint2 b) {
  if constexpr (V == kMplane && NW <= 4) {
    mma_u8_k16(d, a[0], a[1], b.x);
  } else {
    gf::mma_u8(d, a, b.x, b.y);
  }
}

// The A fragments of every K step for lane (g, t) of one M tile. u8: wg is
// W at the tile's column pair g (word w of columns g and g + 8 at wg + w *
// kWStride, the pair layout of `gf::stage_words`). mplane: wg is W at the
// tile's column g (word w of column g at wg[w * kWStride], of column g + 8
// eight words on).
template <int V, int NW, int S>
__device__ __forceinline__ void a_fragments(const uint32_t* wg, int t, uint32_t (&a)[S][4]) {
  if constexpr (V == kU8) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = 8 * s + 4 * h + t;  // stack word: plane q / NW of word q % NW
        const uint2 x = *reinterpret_cast<const uint2*>(wg + (q % NW) * kWStride);
        a[s][2 * h] = (x.x >> (q / NW)) & kOnes;
        a[s][2 * h + 1] = (x.y >> (q / NW)) & kOnes;
      }
    }
  } else {
    const uint32_t x0 = t < NW ? wg[t * kWStride] : 0u;
    const uint32_t x1 = t < NW ? wg[t * kWStride + 8] : 0u;
    uint32_t x2 = 0u, x3 = 0u;
    if constexpr (NW > 4) {
      x2 = 4 + t < NW ? wg[(4 + t) * kWStride] : 0u;
      x3 = 4 + t < NW ? wg[(4 + t) * kWStride + 8] : 0u;
    }
#pragma unroll
    for (int j = 0; j < S; ++j) {
      a[j][0] = (x0 >> j) & kOnes;
      a[j][1] = (x1 >> j) & kOnes;
      a[j][2] = (x2 >> j) & kOnes;
      a[j][3] = (x3 >> j) & kOnes;
    }
  }
}

// Blocks per SM the register allocation must leave room for: 4 (at most
// 128 registers a thread) where ptxas would otherwise take more and hold
// the SM to 3 blocks (u8 at NW = 3 and 4, R >= 2, where at NW = 3, R = 2
// its own choice spills; mplane at NW = 3, R = 4 and NW = 4, R >= 3:
// timed faster, `PERF.md` §6), else 0, ptxas's own choice (a cap there
// raises the count it takes).
template <int V, int NW, int NT>
__host__ __device__ constexpr int min_blocks() {
  const int from = V == kU8 ? 2 : (NW == 3 ? 4 : 3);
  return (NW == 3 || NW == 4) && NT >= from ? 4 : 0;
}

// shared memory of one block: W, the output tile and, past 4 output rows,
// the B fragments in whole groups of 4 rows
template <int V, int NW>
constexpr int smem_bytes(int r) {
  return NW * kWStride * 4 + r * kOutStride +
         (r <= 4 ? 0 : gf::padded_rows(r) * k_steps<V, NW>() * 32 * 8);
}

// NW = ceil(C / 4): words per column. NT = 1..4: R = NT, the B fragments
// held in registers; NT = 0: any R, the fragments in shared memory,
// zero-padded to whole groups of 4 rows. A block covers the columns
// [blockIdx.x * tile, + tile), kSpan per trip of its loop.
template <int V, int NW, int NT>
__global__ void __launch_bounds__(kThreads, (min_blocks<V, NW, NT>())) gf_mma_kernel(const Job job) {
  constexpr int S = k_steps<V, NW>();
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* s_w = reinterpret_cast<uint32_t*>(smem);  // [NW][kWStride]
  uint8_t* s_out = smem + NW * kWStride * 4;           // [r_rows][kOutStride]
  uint2* s_b = reinterpret_cast<uint2*>(s_out + job.r_rows * kOutStride);  // [rt][S][32]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r_rows = job.r_rows;

  uint2 b[NT > 0 ? NT : 1][S];
  if constexpr (NT > 0) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        b[nt][s] = job.frags[(nt * S + s) * 32 + lane];
      }
    }
  } else {
    const int rt = gf::padded_rows(r_rows);
    for (int k = threadIdx.x; k < rt * S * 32; k += kThreads) {
      s_b[k] = k < r_rows * S * 32 ? job.frags[k] : make_uint2(0u, 0u);
    }
    __syncthreads();
  }
  uint32_t pack0, pack1;
  gf::pack_operand(g, t, pack0, pack1);

  const long long start = static_cast<long long>(blockIdx.x) * job.tile;
  const long long lim = min(job.n, start + job.tile);
  const uint8_t* src = job.data + blockIdx.y * job.in_batch;
  uint8_t* dst = job.out + blockIdx.y * job.out_batch;
  const int off = threadIdx.x * kCols;

  for (long long base = start; base < lim; base += kSpan) {
    // 1. bytes -> column words in shared memory
    const long long col0 = base + off;
    gf::stage_words<NW, 0x5410u, V == kU8>(src, job.in_row, job.c, col0, lim, job.vec_in, s_w, off);
    __syncwarp();

    // 2. the warp's M tiles of 16 columns, up to the edge
    const int m_tiles = gf::warp_m_tiles(base, lim, warp);
#pragma unroll 1
    for (int mt = 0; mt < m_tiles; ++mt) {
      const int nb = warp * gf::kWarpCols + mt * 16;
      uint32_t a[S][4];
      a_fragments<V, NW, S>(s_w + nb + (V == kU8 ? 2 * g : g), t, a);
      if constexpr (NT > 0) {
        int d[kGroup][4] = {};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int s = 0; s < S; ++s) step_product<V, NW>(d[nt], a[s], b[nt][s]);
        }
        gf::pack_group(d, pack0, pack1, s_out + nb + g, r_rows, t);
      } else {
        for (int rg = 0; rg < r_rows; rg += kGroup) {
          int d[kGroup][4] = {};
#pragma unroll
          for (int s = 0; s < S; ++s) {
#pragma unroll
            for (int nt = 0; nt < kGroup; ++nt) {
              step_product<V, NW>(d[nt], a[s], s_b[((rg + nt) * S + s) * 32 + lane]);
            }
          }
          gf::pack_group(d, pack0, pack1, s_out + rg * kOutStride + nb + g, r_rows - rg, t);
        }
      }
    }
    __syncwarp();

    // 3. output tile -> HBM, 16 bytes per row per thread
    gf::store_tile(dst, job.out_row, s_out, r_rows, col0, lim, job.vec_out, off);
    __syncwarp();  // the next trip's products rewrite the output tile
  }
}

template <int V, int NW, int NT>
int launch(const Job& job, int batch, cudaStream_t stream) {
  const int smem = smem_bytes<V, NW>(job.r_rows);
  static int opted[64];
  static std::mutex lock;
  const cudaError_t e = gf::opt_in_smem(gf_mma_kernel<V, NW, NT>, smem, opted, lock);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(gf::column_blocks(job.n, job.tile), static_cast<unsigned>(batch));
  gf_mma_kernel<V, NW, NT><<<grid, kThreads, smem, stream>>>(job);
  return static_cast<int>(cudaGetLastError());
}

// B fragments in registers for R <= 4, else in shared memory.
template <int V, int NW>
int dispatch(const Job& job, int batch, cudaStream_t stream) {
  switch (job.r_rows) {
    case 1: return launch<V, NW, 1>(job, batch, stream);
    case 2: return launch<V, NW, 2>(job, batch, stream);
    case 3: return launch<V, NW, 3>(job, batch, stream);
    case 4: return launch<V, NW, 4>(job, batch, stream);
    default: return launch<V, NW, 0>(job, batch, stream);
  }
}

template <int V>
int apply(const void* data, long long in_batch, long long in_row, void* out,
          long long out_batch, long long out_row, const void* frags, int batch,
          int c, int r_rows, long long n, long long tile, void* stream) {
  if (tile == 0) tile = kSpan;
  if (!gf::shape_ok(batch, c, r_rows, n) || tile < 0 || tile % 16 ||
      (reinterpret_cast<uintptr_t>(frags) & 7u)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Job job{static_cast<const uint8_t*>(data), in_batch, in_row,
                static_cast<uint8_t*>(out), out_batch, out_row,
                static_cast<const uint2*>(frags), c, r_rows, n, tile,
                gf::vectorizable(data, in_batch, in_row, batch),
                gf::vectorizable(out, out_batch, out_row, batch)};
  auto s = static_cast<cudaStream_t>(stream);
  switch ((c + 3) / 4) {
    case 1: return dispatch<V, 1>(job, batch, s);
    case 2: return dispatch<V, 2>(job, batch, s);
    case 3: return dispatch<V, 3>(job, batch, s);
    case 4: return dispatch<V, 4>(job, batch, s);
    case 5: return dispatch<V, 5>(job, batch, s);
    case 6: return dispatch<V, 6>(job, batch, s);
    case 7: return dispatch<V, 7>(job, batch, s);
    default: return dispatch<V, 8>(job, batch, s);
  }
}

}  // namespace

// out[b, r, :] for b < batch, r < r_rows, from data[b, c, :]; strides are in
// bytes, the last axis contiguous. frags: the lift as 0/1 int8 B fragments,
// device uint32[r_rows][S][32][2] with S = ceil(c / 4) for u8 and 8 for
// mplane (`rs_cuda.s8_fragments`), 8-byte aligned. tile: columns per block,
// a positive multiple of 16, or 0 for 2048 (one trip per block). Returns 0
// or the cudaError_t of the launch.
#define GF_MMA_ENTRY(NAME, V)                                                  \
  extern "C" int NAME(const void* data, long long in_batch, long long in_row, \
                      void* out, long long out_batch, long long out_row,      \
                      const void* frags, int batch, int c, int r_rows,        \
                      long long n, long long tile, void* stream) {            \
    return apply<V>(data, in_batch, in_row, out, out_batch, out_row, frags,   \
                    batch, c, r_rows, n, tile, stream);                       \
  }

GF_MMA_ENTRY(gf_mplane_apply, kMplane)
GF_MMA_ENTRY(gf_u8_apply, kU8)
