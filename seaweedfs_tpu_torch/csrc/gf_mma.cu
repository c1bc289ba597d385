// GF(2^8) matrix application on the tensor cores (mma.sync), for Hopper
// (sm_90a): two kernels, the ports of two Pallas variants.
//
//   gf_mplane_apply  replaces rs_pallas.py:_kernel_mplane (:210): eight
//                    per-plane int8 products (K = C, padded to 32) summed
//                    into one int32 accumulator; the (8C, T) bit stack is
//                    never built.
//   gf_u8_apply      replaces rs_pallas.py:_kernel_u8 (:187): one int8
//                    product over the whole plane-major stack, whose bytes
//                    are made by mask-and-compare (__vcmpne4), no shifts
//                    of the data.
//
// Both compute out[b, r, n] = XOR_c m[r][c] * data[b, c, n] over GF(2^8) as
// (lift @ bits) mod 2: M = output bits, K = input bits, N = byte columns.
//
// What bounds them on this card: not HBM (C + R bytes per column) and not
// the tensor cores (with the padding, ~107 GOP of int8 MMA for mplane and
// ~40 for u8 per 64 MiB encode batch: 54 and 20 us at peak) but the
// integer work around the MMAs: the shared-memory transpose of the bytes
// into column words, the per-MMA operand unpack and the shuffle pack of
// the output bits. What the design does about it: the B operand is built
// from a column word in place (a shift and an AND for mplane; an AND, a
// __vcmpne4, which this card emulates in a few instructions, and an AND
// for u8), the A operand (the lift) sits in shared memory in MMA row
// order and is read once per four n8 tiles, and input and output move
// with 16-byte accesses only.
//
// Layout, per block of 128 threads and per trip of 2048 columns:
//   1. each thread loads 16 columns of every input row (16-byte loads,
//      masked edge) and writes their column words (byte q of word w of a
//      column = the byte of row 4w + q) to shared W[w][col];
//   2. each warp takes 512 columns, four n8 tiles at a time. For each
//      16-row M tile and each K step it reads the A fragment from shared
//      memory and issues one mma per n8 tile; B comes from W words:
//        mplane, plane j:  (W[t] >> j) & 0x01010101 and (W[4+t] >> j) & ...
//        u8, K word q:     __vcmpne4(W[w] & (0x01010101 << j), 0) & 0x01010101
//                          with (j, w) = divmod(q, NW), the stack order
//                          q = j*NW + w: plane-major, each plane padded to
//                          4*NW rows (zero columns in A; exact);
//   3. M rows are ordered so that an M tile holds the 8 bits of two output
//      rows (row 8h + i = bit i of output row 2*mt + h). After `& 1` each
//      lane holds bit g of two adjacent bytes; three xor-shuffles over the
//      lanes of one column pair OR the 8 bits together, and one lane
//      writes the two bytes to a shared output tile;
//   4. the block stores the output tile with 16-byte stores.
// A (the lift, zero-padded to 16-row M tiles and 32-column K steps) is
// prepared by the wrapper (`rs_cuda.mma_operand`) and staged into shared
// memory once per block.

#include <cstdint>

#include <cuda_runtime.h>

#include "gf_common.cuh"

namespace {

using gf::kCols;
using gf::kSpan;
using gf::kThreads;

constexpr int kWStride = kSpan + 8;  // words per W row: +8 spreads the banks
constexpr int kGroup = 4;            // n8 tiles sharing one A fragment read
constexpr int kWarpCols = kSpan / (kThreads / 32);

enum Variant { kMplane = 0, kU8 = 1 };

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Plane j of a column word as 0/1 bytes, by mask and compare.
__device__ __forceinline__ uint32_t plane_bytes(uint32_t word, int j) {
  return __vcmpne4(word & (0x01010101u << j), 0u) & 0x01010101u;
}

// K columns of the A image: 8 planes x 32 (mplane) or the padded stack.
template <int V, int NW>
__host__ __device__ constexpr int k_pad() {
  return V == kMplane ? 256 : 32 * NW;
}

template <int V, int NW>
__host__ __device__ constexpr int k_steps() {
  return V == kMplane ? 8 : NW;
}

template <int V, int NW>
__global__ void __launch_bounds__(kThreads)
gf_mma_kernel(const uint8_t* __restrict__ data, long long in_batch,
              long long in_row, uint8_t* __restrict__ out, long long out_batch,
              long long out_row, const uint8_t* __restrict__ a_img, int c,
              int r_rows, long long n, long long tile, bool vec_in,
              bool vec_out) {
  constexpr int kA = k_pad<V, NW>() + 16;  // A row stride in bytes
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* s_w = reinterpret_cast<uint32_t*>(smem);  // [NW][kWStride]
  uint8_t* s_a = smem + NW * kWStride * 4;             // [16 * mt_n][kA]
  const int mt_n = (r_rows + 1) >> 1;
  const int a_bytes = 16 * mt_n * kA;
  uint8_t* s_out = s_a + a_bytes;  // [r_rows][kSpan]
  for (int k = threadIdx.x; k < a_bytes / 16; k += kThreads) {
    reinterpret_cast<uint4*>(s_a)[k] = reinterpret_cast<const uint4*>(a_img)[k];
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long start = static_cast<long long>(blockIdx.x) * tile;
  const long long lim = min(n, start + tile);
  const uint8_t* src = data + blockIdx.y * in_batch;
  uint8_t* dst = out + blockIdx.y * out_batch;

  for (long long base = start; base < lim; base += kSpan) {
    // 1. bytes -> column words in shared memory
    const int off = threadIdx.x * kCols;
    const long long col0 = base + off;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      uint4 v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ci = 4 * w + q;
        v[q] = (ci < c && col0 < lim)
                   ? gf::load16(src + ci * in_row, col0, lim, vec_in)
                   : make_uint4(0u, 0u, 0u, 0u);
      }
      uint32_t words[kCols];
      gf::column_words(v, words);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        *reinterpret_cast<uint4*>(s_w + w * kWStride + off + 4 * s) =
            make_uint4(words[4 * s], words[4 * s + 1], words[4 * s + 2],
                       words[4 * s + 3]);
      }
    }
    __syncthreads();

    // 2. tensor-core products, four n8 tiles at a time
    for (int grp = 0; grp < kWarpCols / (8 * kGroup); ++grp) {
      const int nb = warp * kWarpCols + grp * 8 * kGroup;
      if (base + nb >= lim) break;  // warp-uniform: the rest is past the edge
      uint32_t wv[kGroup][2];  // mplane: the two words a lane's B reads
      if constexpr (V == kMplane) {
#pragma unroll
        for (int nt = 0; nt < kGroup; ++nt) {
          const int col = nb + nt * 8 + g;
          wv[nt][0] = t < NW ? s_w[t * kWStride + col] : 0u;
          wv[nt][1] = 4 + t < NW ? s_w[(4 + t) * kWStride + col] : 0u;
        }
      }
      for (int mt = 0; mt < mt_n; ++mt) {
        int acc[kGroup][4];
#pragma unroll
        for (int nt = 0; nt < kGroup; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = 0;
        }
        const uint8_t* arow = s_a + (mt * 16 + g) * kA;
#pragma unroll
        for (int s = 0; s < k_steps<V, NW>(); ++s) {
          uint32_t a[4];
          const uint8_t* ar = arow + 32 * s + 4 * t;
          a[0] = *reinterpret_cast<const uint32_t*>(ar);
          a[1] = *reinterpret_cast<const uint32_t*>(ar + 8 * kA);
          a[2] = *reinterpret_cast<const uint32_t*>(ar + 16);
          a[3] = *reinterpret_cast<const uint32_t*>(ar + 8 * kA + 16);
#pragma unroll
          for (int nt = 0; nt < kGroup; ++nt) {
            const int col = nb + nt * 8 + g;
            if constexpr (V == kMplane) {
              mma_s8(acc[nt], a, (wv[nt][0] >> s) & 0x01010101u,
                     (wv[nt][1] >> s) & 0x01010101u);
            } else {
              const int q0 = 8 * s + t;
              const int q1 = q0 + 4;
              const uint32_t b0 = plane_bytes(s_w[(q0 % NW) * kWStride + col], q0 / NW);
              const uint32_t b1 = plane_bytes(s_w[(q1 % NW) * kWStride + col], q1 / NW);
              mma_s8(acc[nt], a, b0, b1);
            }
          }
        }
        // 3. epilogue: & 1, then OR bit g of the 8 lanes of a column pair
#pragma unroll
        for (int nt = 0; nt < kGroup; ++nt) {
          uint32_t e[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) e[k] = static_cast<uint32_t>(acc[nt][k]) & 1u;
          uint32_t v0 = (e[0] | (e[1] << 8)) << g;  // output row 2*mt
          uint32_t v1 = (e[2] | (e[3] << 8)) << g;  // output row 2*mt + 1
#pragma unroll
          for (int x = 4; x < 32; x <<= 1) {
            v0 |= __shfl_xor_sync(0xffffffffu, v0, x);
            v1 |= __shfl_xor_sync(0xffffffffu, v1, x);
          }
          const int col = nb + nt * 8 + 2 * t;
          if (g == 0) {
            *reinterpret_cast<uint16_t*>(s_out + (2 * mt) * kSpan + col) =
                static_cast<uint16_t>(v0);
          } else if (g == 1 && 2 * mt + 1 < r_rows) {
            *reinterpret_cast<uint16_t*>(s_out + (2 * mt + 1) * kSpan + col) =
                static_cast<uint16_t>(v1);
          }
        }
      }
    }
    __syncthreads();

    // 4. output tile -> HBM, 16 bytes per row per thread
    if (col0 < lim) {
      for (int r = 0; r < r_rows; ++r) {
        const uint4 v = *reinterpret_cast<const uint4*>(s_out + r * kSpan + off);
        const uint32_t o[4] = {v.x, v.y, v.z, v.w};
        gf::store16(dst + r * out_row, col0, lim, vec_out, o);
      }
    }
    // the next trip's W stores need no barrier (W was last read before the
    // one above); its barrier orders these reads before the next writes
  }
}

template <int V, int NW>
size_t smem_bytes(int r_rows) {
  return static_cast<size_t>(NW) * kWStride * 4 +
         static_cast<size_t>(16) * ((r_rows + 1) / 2) * (k_pad<V, NW>() + 16) +
         static_cast<size_t>(r_rows) * kSpan;
}

template <int V, int NW>
int launch(const uint8_t* data, long long in_batch, long long in_row,
           uint8_t* out, long long out_batch, long long out_row,
           const uint8_t* a_img, int batch, int c, int r, long long n,
           long long tile, bool vec_in, bool vec_out, cudaStream_t stream) {
  const size_t smem = smem_bytes<V, NW>(r);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gf_mma_kernel<V, NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(gf::column_blocks(n, tile), static_cast<unsigned>(batch));
  gf_mma_kernel<V, NW><<<grid, kThreads, smem, stream>>>(
      data, in_batch, in_row, out, out_batch, out_row, a_img, c, r, n, tile,
      vec_in, vec_out);
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int apply(const void* data, long long in_batch, long long in_row, void* out,
          long long out_batch, long long out_row, const void* a_img, int batch,
          int c, int r_rows, long long n, long long tile, void* stream) {
  if (!gf::shape_ok(batch, c, r_rows, n) || tile < kSpan || tile % kSpan ||
      !gf::aligned16(a_img)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec_in = gf::vectorizable(data, in_batch, in_row, batch);
  const bool vec_out = gf::vectorizable(out, out_batch, out_row, batch);
  const auto* d = static_cast<const uint8_t*>(data);
  auto* o = static_cast<uint8_t*>(out);
  const auto* a = static_cast<const uint8_t*>(a_img);
  auto s = static_cast<cudaStream_t>(stream);
  switch ((c + 3) / 4) {
    case 1: return launch<V, 1>(d, in_batch, in_row, o, out_batch, out_row, a, batch, c, r_rows, n, tile, vec_in, vec_out, s);
    case 2: return launch<V, 2>(d, in_batch, in_row, o, out_batch, out_row, a, batch, c, r_rows, n, tile, vec_in, vec_out, s);
    case 3: return launch<V, 3>(d, in_batch, in_row, o, out_batch, out_row, a, batch, c, r_rows, n, tile, vec_in, vec_out, s);
    case 4: return launch<V, 4>(d, in_batch, in_row, o, out_batch, out_row, a, batch, c, r_rows, n, tile, vec_in, vec_out, s);
    case 5: return launch<V, 5>(d, in_batch, in_row, o, out_batch, out_row, a, batch, c, r_rows, n, tile, vec_in, vec_out, s);
    case 6: return launch<V, 6>(d, in_batch, in_row, o, out_batch, out_row, a, batch, c, r_rows, n, tile, vec_in, vec_out, s);
    case 7: return launch<V, 7>(d, in_batch, in_row, o, out_batch, out_row, a, batch, c, r_rows, n, tile, vec_in, vec_out, s);
    default: return launch<V, 8>(d, in_batch, in_row, o, out_batch, out_row, a, batch, c, r_rows, n, tile, vec_in, vec_out, s);
  }
}

}  // namespace

// out[b, r, :] for b < batch, r < r_rows, from data[b, c, :]; strides in
// bytes, last axis contiguous. a_img: the wrapper's A image for this
// variant (16-byte aligned, 16 * ceil(R/2) rows of K + 16 bytes). tile:
// columns per block, a positive multiple of 2048. Returns 0 or a
// cudaError_t.
#define GF_MMA_ENTRY(NAME, V)                                                  \
  extern "C" int NAME(const void* data, long long in_batch, long long in_row, \
                      void* out, long long out_batch, long long out_row,      \
                      const void* a_img, int batch, int c, int r_rows,        \
                      long long n, long long tile, void* stream) {            \
    return apply<V>(data, in_batch, in_row, out, out_batch, out_row, a_img,   \
                    batch, c, r_rows, n, tile, stream);                       \
  }

GF_MMA_ENTRY(gf_mplane_apply, kMplane)
GF_MMA_ENTRY(gf_u8_apply, kU8)
