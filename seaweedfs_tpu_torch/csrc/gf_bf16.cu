// GF(2^8) matrix application over byte shards on the tensor cores in bf16
// (wgmma, and mma.sync past 4 output rows: bf16 operands, float32 sums),
// for Hopper (sm_90a).
//
// Replaces seaweedfs_tpu/ops/rs_pallas.py:_kernel_bf16 (:146), which
// computes out[b, r, n] = XOR_c m[r][c] * data[b, c, n] over GF(2^8) as
// (lift . bits(data)) mod 2 with the product in bf16 and float32
// accumulation. This kernel takes the same product in the same types.
//
// What bounds it on this card: operations. The TPU kernel's product is
// 2 * 8R * 8C bf16 operations per byte column; at the encode shape ((4,10)
// x (10, 6 553 600)) that is 0.0339 ms at the H100 SXM's 989 TFLOP/s dense
// bf16, above the 0.0274 ms its (C + R) bytes per column take at 3.35
// TB/s. (A 1-lost rebuild, R = 1, is bound by bytes: 0.0138 ms.) What the
// design does about it: it spends the tensor cores on the product's own
// operations, padded by nothing, and keeps the integer work around them
// to a shift and an AND per operand register:
//   * the product is taken transposed, outT = bitsT . liftT: M = byte
//     columns (16 per warp, 64 per wgmma), N = output bits (8 per output
//     row: R = 4 is N = 32, R = 1 is N = 8), K = the input bits, 16 per K
//     step = two input rows, so K = 16 * ceil(C/2): 80 for C = 10, the
//     TPU kernel's own 8C;
//   * the A operand is built from the column words in registers, one
//     funnel shift and one AND per register: a bf16 register holds two K
//     values, bits b and b + 16 of a word, and rotl(W, 14 - b) &
//     0x40004000 puts them at bits 14 and 30, bf16 2.0 or 0.0 in each
//     half. The words hold rows 4w, 4w + 2, 4w + 1, 4w + 3 in bytes 0-3
//     (`kRowPairs`), so K step s = 2w + h, bit pairs b = 8h + 4 * reg +
//     t, is rows 4w + 2h and 4w + 2h + 1: each lane's four shift counts
//     are fixed for the launch, and the last step, all zero when C % 4 is
//     1 or 2, is skipped;
//   * the B operand is the lift in bf16 (1.0 or 0.0), constant for the
//     launch and prepared once by the wrapper in mma.m16n8k16 fragment
//     order (`rs_cuda.bf16_fragments`). For R <= 4 (one kernel per R) each
//     block stages it in shared memory as the no-swizzle K-major image a
//     wgmma descriptor reads, and one wgmma.m64nNk16 per K step, N = 8R,
//     covers every output row of 64 columns: A from registers (each warp
//     its own 16 columns), float32 sums in registers. Past 4 rows, each
//     warp takes mma.sync.m16n8k16 products in groups of 4 output rows,
//     reading B through the read-only cache;
//   * every sum is 2 x a popcount <= 2 * 8C <= 512, exact in float32;
//     fma(sum, 0.5, 2^23) puts that count in the low bits of the float's
//     word, so its bit 0 is the output bit. The float32 C layout of both
//     products (per 8 columns of N, per warp) is the m16n8k256 int32 layout
//     of the int8 kernel, so the same int8 pack product (`gf::pack_group`)
//     turns the parities into bytes with no shuffle;
//   * input moves with 16-byte loads and is transposed into column words
//     through shared memory; output goes through a shared tile and leaves
//     with 16-byte stores (`gf::stage_words`, `gf::store_tile`).
// Per block of 128 threads (one warpgroup) and trip of 2048 columns, each
// warp works on its own 512 columns; warps meet only in the wgmma, which
// every warp issues for the same number of M tiles (past the ragged edge
// on zero words). Any N >= 1 works with no pad. A block walks `tile`
// columns (a multiple of 2048) in trips of 2048.

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

constexpr uint32_t kTwo = 0x40004000u;  // bf16 2.0 in both halves
// column-word byte order: rows 4w, 4w + 2, 4w + 1, 4w + 3 in bytes 0-3, so
// that the bit pairs (b, b + 16) of K step 2w + h are rows 4w + 2h, + 1
constexpr uint32_t kRowPairs = 0x5140u;
// The B image of the wgmma path in shared memory: K step s at s * R * 256
// bytes; in it the core matrix (8 N rows x 8 K values, 128 bytes, row n at
// 16n) of output row r and K half c (k 0-7, 8-15) at r * kSbo + c * kLbo.
constexpr uint32_t kLbo = 128;  // between core matrices adjacent in K
constexpr uint32_t kSbo = 256;  // between core matrices adjacent in N

struct Job {
  const uint8_t* data;
  long long in_batch, in_row;
  uint8_t* out;
  long long out_batch, out_row;
  const uint2* frags;  // [R][2 * NW][32] B fragments
  int c, r_rows;
  long long n, tile;
  bool vec_in, vec_out;
};

// d += a . b, m16n8k16 with bf16 operands and float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// wgmma.mma_async m64nNk16, N = 8 * NT: d += a . B, bf16 operands, float32
// sums; A (this warp's 16 rows of the 64) from registers in the m16n8k16
// layout, B from shared memory behind `desc`. d[nt] is the m16n8 C layout
// of n-tile nt.
template <int NT>
__device__ __forceinline__ void wgmma_bf16(float (&d)[NT][4], const uint32_t (&a)[4],
                                           uint64_t desc) {
  if constexpr (NT == 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
        : "memory");
  } else if constexpr (NT == 2) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7}, {%8,%9,%10,%11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
        : "memory");
  } else if constexpr (NT == 3) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, %16, p, 1, 1, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
        : "memory");
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
        "{%16,%17,%18,%19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
        : "memory");
  }
}

// Keep the compiler from moving reads or writes of the accumulators across
// the asynchronous product (the fence, commit and wait name no registers).
template <int NT>
__device__ __forceinline__ void pin(float (&d)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[nt][e])::"memory");
  }
}

// The shared-memory matrix descriptor of a no-swizzle K-major operand at p.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(kLbo >> 4) << 16) | (static_cast<uint64_t>(kSbo >> 4) << 32);
}

// The A fragment of one K step from the step's word of columns g (x0) and
// g + 8 (x1): rotations by the lane's two shift counts, then bf16 2.0/0.0.
__device__ __forceinline__ void a_fragment(uint32_t x0, uint32_t x1, int sh0, int sh1,
                                           uint32_t (&a)[4]) {
  a[0] = __funnelshift_l(x0, x0, sh0) & kTwo;
  a[1] = __funnelshift_l(x1, x1, sh0) & kTwo;
  a[2] = __funnelshift_l(x0, x0, sh1) & kTwo;
  a[3] = __funnelshift_l(x1, x1, sh1) & kTwo;
}

// The float sums of up to 4 n-tiles as integers whose bit 0 is the output
// bit (tiles past NT are 0), then the pack into bytes.
template <int NT>
__device__ __forceinline__ void pack_sums(const float (&d)[NT][4], uint32_t pack0,
                                          uint32_t pack1, uint8_t* cell, int rows, int t) {
  int k[kGroup][4];
#pragma unroll
  for (int nt = 0; nt < kGroup; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      k[nt][e] = nt < NT ? __float_as_int(fmaf(d[nt < NT ? nt : 0][e], 0.5f, 8388608.0f)) : 0;
    }
  }
  gf::pack_group(k, pack0, pack1, cell, rows, t);
}

// NW = ceil(C / 4): words per column, S = 2 * NW K steps at most. NT = 1..4: R =
// NT on wgmma, B staged once per block in shared memory; NT = 0: any R on
// mma.sync, B read per product in groups of 4 output rows. A block covers
// the columns [blockIdx.x * tile, + tile), kSpan per trip of its loop.
template <int NW, int NT>
__global__ void __launch_bounds__(kThreads) gf_bf16_kernel(const Job job) {
  constexpr int S = 2 * NW;
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* s_w = reinterpret_cast<uint32_t*>(smem);  // [NW][kWStride]
  uint8_t* s_out = smem + NW * kWStride * 4;           // [r_rows][kOutStride]
  uint8_t* s_b = s_out + job.r_rows * kOutStride;      // wgmma: [S][R * 256]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r_rows = job.r_rows;
  // K steps: one per two input rows, so the last of the 2 * NW is all zero
  // (and skipped) when C % 4 is 1 or 2
  const bool full = (job.c + 1) / 2 == S;
  int sh[2][2];  // rotation of K half-step h, registers a0/a1 (0) or a2/a3 (1)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int reg = 0; reg < 2; ++reg) sh[h][reg] = (14 - 8 * h - 4 * reg - t) & 31;
  }
  constexpr int kStep = NT * 256;  // bytes of the B image per K step
  uint64_t desc = 0;
  if constexpr (NT > 0) {
    // fragment [r][s][lane] (b0, b1) -> core matrices (r, K half 0 and 1)
    for (int i = threadIdx.x; i < NT * S * 32; i += kThreads) {
      const int r = i / (S * 32);
      const int s = (i / 32) % S;
      const int l = i % 32;
      const uint2 v = job.frags[i];
      uint8_t* p = s_b + s * kStep + r * kSbo + (l >> 2) * 16 + (l & 3) * 4;
      *reinterpret_cast<uint32_t*>(p) = v.x;
      *reinterpret_cast<uint32_t*>(p + kLbo) = v.y;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    __syncthreads();
    desc = smem_desc(s_b);
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
    gf::stage_words<NW, kRowPairs>(src, job.in_row, job.c, col0, lim, job.vec_in, s_w, off);
    __syncwarp();

    // 2. the warp's M tiles of 16 columns, up to the edge; on wgmma every
    // warp runs warp 0's count (past the edge on zero words), so that the
    // warpgroup issues each product together
    const int m_tiles = gf::warp_m_tiles(base, lim, NT > 0 ? 0 : warp);
    for (int mt = 0; mt < m_tiles; ++mt) {
      const int nb = warp * gf::kWarpCols + mt * 16;
      const uint32_t* wg = s_w + nb + g;
      uint32_t a[S][4];
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const uint32_t x0 = wg[w * kWStride];
        const uint32_t x1 = wg[w * kWStride + 8];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (2 * w + h < S - 1 || full) a_fragment(x0, x1, sh[h][0], sh[h][1], a[2 * w + h]);
        }
      }
      if constexpr (NT > 0) {
        float d[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) d[nt][e] = 0.0f;
        }
        pin(d);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int s = 0; s < S - 1; ++s) wgmma_bf16<NT>(d, a[s], desc + ((s * kStep) >> 4));
        if (full) wgmma_bf16<NT>(d, a[S - 1], desc + (((S - 1) * kStep) >> 4));
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        pin(d);
        pack_sums<NT>(d, pack0, pack1, s_out + nb + g, r_rows, t);
      } else {
        for (int rg = 0; rg < r_rows; rg += kGroup) {
          float d[kGroup][4];
#pragma unroll
          for (int nt = 0; nt < kGroup; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) d[nt][e] = 0.0f;
          }
#pragma unroll
          for (int s = 0; s < S; ++s) {
            if (s == S - 1 && !full) break;
#pragma unroll
            for (int nt = 0; nt < kGroup; ++nt) {
              const uint2 bv = rg + nt < r_rows ? __ldg(job.frags + ((rg + nt) * S + s) * 32 + lane)
                                                : make_uint2(0u, 0u);
              mma_bf16(d[nt], a[s], bv.x, bv.y);
            }
          }
          pack_sums<kGroup>(d, pack0, pack1, s_out + rg * kOutStride + nb + g, r_rows - rg, t);
        }
      }
    }
    __syncwarp();

    // 3. output tile -> HBM, 16 bytes per row per thread
    gf::store_tile(dst, job.out_row, s_out, r_rows, col0, lim, job.vec_out, off);
    __syncwarp();  // the next trip's products rewrite the output tile
  }
}

// shared memory of one block: W, the output tile and, on wgmma (R <= 4),
// the B image
constexpr int smem_bytes(int nw, int r) {
  return nw * kWStride * 4 + r * kOutStride + (r <= 4 ? 2 * nw * r * 256 : 0);
}

template <int NW, int NT>
int launch(const Job& job, int batch, cudaStream_t stream) {
  const int smem = smem_bytes(NW, job.r_rows);
  static int opted[64];
  static std::mutex lock;
  const cudaError_t e = gf::opt_in_smem(gf_bf16_kernel<NW, NT>, smem, opted, lock);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(gf::column_blocks(job.n, job.tile), static_cast<unsigned>(batch));
  gf_bf16_kernel<NW, NT><<<grid, kThreads, smem, stream>>>(job);
  return static_cast<int>(cudaGetLastError());
}

// wgmma for R <= 4 (one kernel per R, N = 8R), mma.sync above that.
template <int NW>
int dispatch(const Job& job, int batch, cudaStream_t stream) {
  switch (job.r_rows) {
    case 1: return launch<NW, 1>(job, batch, stream);
    case 2: return launch<NW, 2>(job, batch, stream);
    case 3: return launch<NW, 3>(job, batch, stream);
    case 4: return launch<NW, 4>(job, batch, stream);
    default: return launch<NW, 0>(job, batch, stream);
  }
}

}  // namespace

// out[b, r, :] for b < batch, r < r_rows, from data[b, c, :]; strides are in
// bytes, the last axis contiguous. frags: the lift as bf16 B fragments,
// device uint32[r_rows][2 * ceil(c / 4)][32][2] (`rs_cuda.bf16_fragments`),
// 8-byte aligned. tile: columns per block, a positive multiple of 2048.
// Returns 0 or the cudaError_t of the launch.
extern "C" int gf_bf16_apply(const void* data, long long in_batch, long long in_row,
                             void* out, long long out_batch, long long out_row,
                             const void* frags, int batch, int c, int r_rows,
                             long long n, long long tile, void* stream) {
  if (!gf::shape_ok(batch, c, r_rows, n) || tile < kSpan || tile % kSpan ||
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
    case 1: return dispatch<1>(job, batch, s);
    case 2: return dispatch<2>(job, batch, s);
    case 3: return dispatch<3>(job, batch, s);
    case 4: return dispatch<4>(job, batch, s);
    case 5: return dispatch<5>(job, batch, s);
    case 6: return dispatch<6>(job, batch, s);
    case 7: return dispatch<7>(job, batch, s);
    default: return dispatch<8>(job, batch, s);
  }
}
