// GF(2^8) matrix application over byte shards on the tensor cores
// (mma.sync: a binary AND-popc product, then an int8 pack product), for
// Hopper (sm_90a).
//
// Replaces seaweedfs_tpu/ops/rs_pallas.py:_kernel (the "int8" Pallas
// kernel). Both compute out[b, r, n] = XOR_c m[r][c] * data[b, c, n] over
// GF(2^8) as (lift . bits(data)) mod 2, where lift is the (8R, 8C) binary
// lift of the (R, C) matrix and bits() unpacks each byte into 8 planes.
//
// What bounds it on this card: HBM (C + R bytes per column: 0.027 ms for a
// 64 MiB encode batch at 3.35 TB/s) and the integer work that turns bytes
// into operands and sums back into bytes, not the tensor cores. What the
// design does about it: the product is taken transposed, outT = bitsT .
// liftT, on mma.m16n8k256 with 1-bit operands and AND + popc:
//   * M = 16 byte columns, N = output bits (8 per n8 tile: tile r, column
//     i = bit i of output row r; nothing padded), K = the 8C input bits in
//     column-word order (word w = the bytes of rows 4w..4w+3, bit 8q + p =
//     plane p of row 4w + q), up to 256: one product per n-tile for any
//     C <= 32;
//   * so the A fragment IS the column words: lane t's a0/a1 are word t of
//     columns g and g + 8, a2/a3 word 4 + t. There is no unpack at all.
//     (An int8 m16n8k32 product over 0/1 bytes instead, K = 32 per step,
//     a shift and an AND per A register, 3 steps and 12 products per 16
//     columns for C = 10, R = 4, timed 0.074 ms at that shape on an H100
//     SXM at 700 W: no faster than the popc form; this one, 0.049.)
//   * the lift is the B operand, constant for the launch: the popc masks
//     of each output bit over the column words, which the wrapper hands
//     over in fragment order (`rs_cuda.lift_fragments`). They are held in
//     registers for R <= 4 (one kernel per R, so no product is predicated;
//     8 registers), else read from shared memory, one 8-byte load per
//     n-tile, in groups of 4 output rows;
//   * each sum is popc(column bits & mask), and its parity (bit 0) is the
//     output bit. The pack is one int8 m16n8k32: the sums' low bytes, with
//     & 1, laid out as its A fragment with no shuffle (its K order follows
//     the accumulators' C layout), times B = 2^i, sums the 8 bits of each
//     output byte for 4 output rows at once;
//   * input moves with 16-byte loads and is transposed into column words
//     through shared memory; output goes through a shared tile and leaves
//     with 16-byte stores.
// Sums are exact: every accumulator is at most 8C <= 256 (int32).
// Per block of 128 threads and trip of 2048 columns, each warp on its own
// 512 columns (so warps meet at __syncwarp only):
//   1. each thread issues the 16-byte loads of its 16 columns of every
//      input row (masked edge), then stores their column words to shared
//      W[w][col];
//   2. the warp walks its columns, 16 per M tile: A from W, R products
//      into int32 accumulators, the pack product, and lanes t < 2 write
//      the bytes of output rows 2t, 2t + 1 to the shared tile;
//   3. each thread stores its 16 columns of the output tile with 16-byte
//      stores.
// The ragged edge is masked in the kernel, so any N >= 1 works with no pad.
// An explicit tile makes each block walk `tile` columns in trips of 2048,
// the counterpart of the reference's `pallas_tile`.

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
using gf::padded_rows;

// One M tile against one group of up to 4 output rows: the NT products
// into int32 accumulators (tiles past NT stay zero), then the pack.
template <int NT>
__device__ __forceinline__ void group_product(const uint32_t (&a)[4], const uint2 (&b)[NT],
                                              uint32_t pack0, uint32_t pack1,
                                              uint8_t* cell, int rows, int t) {
  int d[kGroup][4];
#pragma unroll
  for (int nt = 0; nt < kGroup; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) d[nt][e] = 0;
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) gf::mma_and_popc(d[nt], a, b[nt].x, b[nt].y);
  gf::pack_group(d, pack0, pack1, cell, rows, t);
}

// shared memory of one block: W, the output tile, and the lift fragments
// when they are not held in registers (NT == 0)
__host__ __device__ constexpr int smem_bytes(int nw, int nt, int r) {
  return nw * kWStride * 4 + r * kOutStride + (nt > 0 ? 0 : padded_rows(r) * 32 * 8);
}

// NW = ceil(C / 4): words per column. NT = 1..4: R = NT, the lift
// fragments held in registers; NT = 0: any R, the fragments in shared
// memory, zero-padded to whole groups of 4 rows. A block covers the
// columns [blockIdx.x * tile, + tile), kSpan per trip of its loop.
template <int NW, int NT>
__global__ void __launch_bounds__(kThreads)
gf_bitplane_kernel(const uint8_t* __restrict__ data, long long in_batch,
                   long long in_row, uint8_t* __restrict__ out,
                   long long out_batch, long long out_row,
                   const uint2* __restrict__ frags, int c, int r_rows,
                   long long n, long long tile, bool vec_in, bool vec_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* s_w = reinterpret_cast<uint32_t*>(smem);  // [NW][kWStride]
  uint8_t* s_out = smem + NW * kWStride * 4;           // [r_rows][kOutStride]
  uint2* s_b = reinterpret_cast<uint2*>(s_out + r_rows * kOutStride);  // [rt][32]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int rt = padded_rows(r_rows);

  uint2 b[NT > 0 ? NT : 1];
  if constexpr (NT > 0) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) b[nt] = frags[nt * 32 + lane];
  } else {
    for (int k = threadIdx.x; k < rt * 32; k += kThreads) {
      s_b[k] = k < r_rows * 32 ? frags[k] : make_uint2(0u, 0u);
    }
    __syncthreads();
  }
  uint32_t pack0, pack1;
  gf::pack_operand(g, t, pack0, pack1);

  const long long start = static_cast<long long>(blockIdx.x) * tile;
  const long long lim = min(n, start + tile);
  const uint8_t* src = data + blockIdx.y * in_batch;
  uint8_t* dst = out + blockIdx.y * out_batch;
  const int off = threadIdx.x * kCols;

  for (long long base = start; base < lim; base += kSpan) {
    // 1. bytes -> column words in shared memory
    const long long col0 = base + off;
    gf::stage_words<NW>(src, in_row, c, col0, lim, vec_in, s_w, off);
    __syncwarp();

    // 2. the warp's M tiles of 16 columns, up to the edge
    const int m_tiles = gf::warp_m_tiles(base, lim, warp);
    for (int mt = 0; mt < m_tiles; ++mt) {
      const int nb = warp * gf::kWarpCols + mt * 16;
      uint32_t a[4];  // words t and 4 + t of columns g and g + 8
      a[0] = t < NW ? s_w[t * kWStride + nb + g] : 0u;
      a[1] = t < NW ? s_w[t * kWStride + nb + g + 8] : 0u;
      a[2] = 4 + t < NW ? s_w[(4 + t) * kWStride + nb + g] : 0u;
      a[3] = 4 + t < NW ? s_w[(4 + t) * kWStride + nb + g + 8] : 0u;
      if constexpr (NT > 0) {
        group_product<NT>(a, b, pack0, pack1, s_out + nb + g, r_rows, t);
      } else {
        for (int rg = 0; rg < r_rows; rg += kGroup) {
          uint2 bg[kGroup];
#pragma unroll
          for (int nt = 0; nt < kGroup; ++nt) bg[nt] = s_b[(rg + nt) * 32 + lane];
          group_product<kGroup>(a, bg, pack0, pack1, s_out + rg * kOutStride + nb + g,
                                r_rows - rg, t);
        }
      }
    }
    __syncwarp();

    // 3. output tile -> HBM, 16 bytes per row per thread
    gf::store_tile(dst, out_row, s_out, r_rows, col0, lim, vec_out, off);
    __syncwarp();  // the next trip's products rewrite the output tile
  }
}

template <int NW, int NT>
int launch(const uint8_t* data, long long in_batch, long long in_row,
           uint8_t* out, long long out_batch, long long out_row,
           const uint2* frags, int batch, int c, int r, long long n,
           long long tile, bool vec_in, bool vec_out, cudaStream_t stream) {
  const int smem = smem_bytes(NW, NT, r);
  static int opted[64];
  static std::mutex lock;
  const cudaError_t e = gf::opt_in_smem(gf_bitplane_kernel<NW, NT>, smem, opted, lock);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(gf::column_blocks(n, tile), static_cast<unsigned>(batch));
  gf_bitplane_kernel<NW, NT><<<grid, kThreads, smem, stream>>>(
      data, in_batch, in_row, out, out_batch, out_row, frags, c, r, n, tile,
      vec_in, vec_out);
  return static_cast<int>(cudaGetLastError());
}

// Lift fragments in registers for R <= 4, else in shared memory.
template <int NW>
int dispatch(const uint8_t* data, long long in_batch, long long in_row,
             uint8_t* out, long long out_batch, long long out_row,
             const uint2* frags, int batch, int c, int r, long long n,
             long long tile, bool vec_in, bool vec_out, cudaStream_t stream) {
  switch (r) {
    case 1: return launch<NW, 1>(data, in_batch, in_row, out, out_batch, out_row, frags, batch, c, r, n, tile, vec_in, vec_out, stream);
    case 2: return launch<NW, 2>(data, in_batch, in_row, out, out_batch, out_row, frags, batch, c, r, n, tile, vec_in, vec_out, stream);
    case 3: return launch<NW, 3>(data, in_batch, in_row, out, out_batch, out_row, frags, batch, c, r, n, tile, vec_in, vec_out, stream);
    case 4: return launch<NW, 4>(data, in_batch, in_row, out, out_batch, out_row, frags, batch, c, r, n, tile, vec_in, vec_out, stream);
    default: return launch<NW, 0>(data, in_batch, in_row, out, out_batch, out_row, frags, batch, c, r, n, tile, vec_in, vec_out, stream);
  }
}

}  // namespace

// out[b, r, :] for b < batch, r < r_rows, from data[b, c, :]; strides are in
// bytes, the last axis contiguous. frags: the lift in B fragment order,
// device uint32[r_rows][32][2] (`rs_cuda.lift_fragments`), 8-byte aligned.
// tile: columns per block, a positive multiple of 16, or 0 for 2048 (one
// trip per block). Returns 0 or the cudaError_t of the launch.
extern "C" int gf_bitplane_apply(const void* data, long long in_batch,
                                 long long in_row, void* out,
                                 long long out_batch, long long out_row,
                                 const void* frags, int batch, int c,
                                 int r_rows, long long n, long long tile,
                                 void* stream) {
  if (tile == 0) tile = kSpan;
  if (!gf::shape_ok(batch, c, r_rows, n) || tile < 0 || tile % 16 ||
      (reinterpret_cast<uintptr_t>(frags) & 7u)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec_in = gf::vectorizable(data, in_batch, in_row, batch);
  const bool vec_out = gf::vectorizable(out, out_batch, out_row, batch);
  const auto* d = static_cast<const uint8_t*>(data);
  auto* o = static_cast<uint8_t*>(out);
  const auto* f = static_cast<const uint2*>(frags);
  auto s = static_cast<cudaStream_t>(stream);
  switch ((c + 3) / 4) {
    case 1: return dispatch<1>(d, in_batch, in_row, o, out_batch, out_row, f, batch, c, r_rows, n, tile, vec_in, vec_out, s);
    case 2: return dispatch<2>(d, in_batch, in_row, o, out_batch, out_row, f, batch, c, r_rows, n, tile, vec_in, vec_out, s);
    case 3: return dispatch<3>(d, in_batch, in_row, o, out_batch, out_row, f, batch, c, r_rows, n, tile, vec_in, vec_out, s);
    case 4: return dispatch<4>(d, in_batch, in_row, o, out_batch, out_row, f, batch, c, r_rows, n, tile, vec_in, vec_out, s);
    case 5: return dispatch<5>(d, in_batch, in_row, o, out_batch, out_row, f, batch, c, r_rows, n, tile, vec_in, vec_out, s);
    case 6: return dispatch<6>(d, in_batch, in_row, o, out_batch, out_row, f, batch, c, r_rows, n, tile, vec_in, vec_out, s);
    case 7: return dispatch<7>(d, in_batch, in_row, o, out_batch, out_row, f, batch, c, r_rows, n, tile, vec_in, vec_out, s);
    default: return dispatch<8>(d, in_batch, in_row, o, out_batch, out_row, f, batch, c, r_rows, n, tile, vec_in, vec_out, s);
  }
}
