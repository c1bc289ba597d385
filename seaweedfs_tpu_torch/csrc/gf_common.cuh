// Helpers shared by the GF(2^8) kernels: masked 16-byte column loads and
// stores, and the byte-order column words every kernel builds its bit
// operands from.
//
// Column words: for byte columns col0 .. col0+15 and input rows
// 4w .. 4w+3, word t of `column_words` packs the four bytes of column
// col0 + t little-endian (byte q = row 4w + q), so bit 8q + j is bit j of
// row 4w + q. Rows at or past C load as zero.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <mutex>

namespace gf {

constexpr int kCols = 16;      // byte columns per thread
constexpr int kThreads = 128;  // threads per block
constexpr int kSpan = kCols * kThreads;  // columns one block covers per trip
constexpr int kMaxRows = 32;   // R and C limits
constexpr int kMaxCols = 32;
constexpr int kMaxBatch = 65535;

__device__ __forceinline__ uint32_t lane(const uint4& v, int s) {
  return s == 0 ? v.x : s == 1 ? v.y : s == 2 ? v.z : v.w;
}

// 16 bytes of `row` from col0, zero past `lim`; one vector load when the
// caller vouched for alignment and the 16 bytes lie inside the limit.
__device__ __forceinline__ uint4 load16(const uint8_t* row, long long col0,
                                        long long lim, bool vec) {
  if (vec && col0 + kCols <= lim) {
    return __ldcs(reinterpret_cast<const uint4*>(row + col0));
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    if (col0 + k < lim) w[k >> 2] |= uint32_t(row[col0 + k]) << ((k & 3) * 8);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store16(uint8_t* row, long long col0,
                                        long long lim, bool vec,
                                        const uint32_t o[4]) {
  if (vec && col0 + kCols <= lim) {
    __stcs(reinterpret_cast<uint4*>(row + col0),
           make_uint4(o[0], o[1], o[2], o[3]));
    return;
  }
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    if (col0 + k < lim) row[col0 + k] = uint8_t(o[k >> 2] >> ((k & 3) * 8));
  }
}

// v[q] holds 16 bytes of row 4w + q; words[t] becomes column t's word.
// `order` is the last byte permute: 0x5410 keeps byte q = row 4w + q;
// 0x5140 puts rows 4w, 4w + 2, 4w + 1, 4w + 3 in bytes 0-3.
__device__ __forceinline__ void column_words(const uint4 v[4], uint32_t words[kCols],
                                             uint32_t order = 0x5410u) {
#pragma unroll
  for (int t = 0; t < kCols; ++t) {
    const uint32_t sel = (t & 3) | (((t & 3) + 4) << 4);
    const uint32_t lo = __byte_perm(lane(v[0], t >> 2), lane(v[1], t >> 2), sel);
    const uint32_t hi = __byte_perm(lane(v[2], t >> 2), lane(v[3], t >> 2), sel);
    words[t] = __byte_perm(lo, hi, order);
  }
}

// -- the transposed tensor-core kernels (gf_bitplane.cu, gf_bf16.cu, gf_dma.cu) --
//
// All take outT = bitsT . liftT with 16 byte columns on M and one n8 tile
// per output row (column i = its bit i), stage each trip's column words in
// shared W[w][col], and pack each sum's parity into bytes with one int8
// product per group of 4 output rows.

constexpr int kWStride = kSpan + 8;     // words per W row: +8 spreads the banks
constexpr int kOutStride = kSpan + 16;  // bytes per output-tile row
constexpr int kWarpCols = kSpan / (kThreads / 32);  // each warp's columns of a trip
constexpr int kGroup = 4;               // output rows (n8 tiles) per pack product

// d += a . b, m16n8k32 with u8 operands
__device__ __forceinline__ void mma_u8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the parities (bit 0) of x0..x3 as the 4 bytes of one A register of the
// pack product
__device__ __forceinline__ uint32_t parity_bytes(int x0, int x1, int x2, int x3) {
  const uint32_t lo = __byte_perm(static_cast<uint32_t>(x0), static_cast<uint32_t>(x1), 0x40);
  const uint32_t hi = __byte_perm(static_cast<uint32_t>(x2), static_cast<uint32_t>(x3), 0x40);
  return __byte_perm(lo, hi, 0x5410) & 0x01010101u;
}

// The pack product's B for lane (g, t): row k = 4t' + e (pack0) or 16 +
// 4t' + e (pack1) is bit 2t' + (e & 1) of n-tile (e >> 1) or 2 + (e >> 1);
// column g is output row g of the group; entries 2^bit.
__device__ __forceinline__ void pack_operand(int g, int t, uint32_t& pack0, uint32_t& pack1) {
  pack0 = 0u;
  pack1 = 0u;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t v = (1u << (2 * t + (e & 1))) << (8 * e);
    if (g == (e >> 1)) pack0 |= v;
    if (g == 2 + (e >> 1)) pack1 |= v;
  }
}

// Pack the sums of one M tile against one group of 4 output rows (d[nt]
// in the m16n8 C layout: lane t holds bits 2t, 2t + 1 of n-tile nt for
// columns g and g + 8; the output bit is bit 0 of each sum) into bytes,
// and write rows 2t, 2t + 1 of the group (lanes t < 2) to `cell`, the
// output tile at the group's first row and column g, rows `stride` bytes
// apart. The A fragment of the pack product is that C layout as it
// stands: no shuffle.
__device__ __forceinline__ void pack_group(const int (&d)[kGroup][4], uint32_t pack0,
                                           uint32_t pack1, uint8_t* cell, int rows, int t,
                                           int stride = kOutStride) {
  const uint32_t e[4] = {
      parity_bytes(d[0][0], d[0][1], d[1][0], d[1][1]),  // column g, tiles 0-1
      parity_bytes(d[0][2], d[0][3], d[1][2], d[1][3]),  // column g + 8
      parity_bytes(d[2][0], d[2][1], d[3][0], d[3][1]),  // column g, tiles 2-3
      parity_bytes(d[2][2], d[2][3], d[3][2], d[3][3]),
  };
  int o[4] = {0, 0, 0, 0};
  mma_u8(o, e, pack0, pack1);
  // o: rows 2t, 2t + 1 of column g (o[0], o[1]) and of column g + 8
  if (t < 2 && 2 * t < rows) {
    cell[2 * t * stride] = static_cast<uint8_t>(o[0]);
    cell[2 * t * stride + 8] = static_cast<uint8_t>(o[2]);
  }
  if (t < 2 && 2 * t + 1 < rows) {
    cell[(2 * t + 1) * stride] = static_cast<uint8_t>(o[1]);
    cell[(2 * t + 1) * stride + 8] = static_cast<uint8_t>(o[3]);
  }
}

// d += popc(a & b) per output, m16n8k256 with 1-bit operands
__device__ __forceinline__ void mma_and_popc(int (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Phase 1 of a trip: thread `off / kCols` loads its 16 columns from col0 of
// every input row (16-byte loads, all in flight first; zero past C and
// past lim) and stores their column words (byte order `kOrder`, as
// `column_words`) to W[w][off .. off + 15]: column off + k at off + k, or
// with kPairs at off + 2 * (k % 8) + k / 8, so that the words of columns
// g and g + 8 of a 16-column M tile are one 8-byte load.
template <int NW, uint32_t kOrder = 0x5410u, bool kPairs = false>
__device__ __forceinline__ void stage_words(const uint8_t* src, long long in_row, int c,
                                            long long col0, long long lim, bool vec_in,
                                            uint32_t* s_w, int off) {
  uint4 v[NW][4];
  if (vec_in && col0 + kCols <= lim) {
#pragma unroll
    for (int w = 0; w < NW; ++w) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ci = 4 * w + q;
        v[w][q] = ci < c ? __ldcs(reinterpret_cast<const uint4*>(src + ci * in_row + col0))
                         : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  } else {
#pragma unroll
    for (int w = 0; w < NW; ++w) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ci = 4 * w + q;
        v[w][q] = (ci < c && col0 < lim) ? load16(src + ci * in_row, col0, lim, false)
                                         : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    uint32_t words[kCols];
    column_words(v[w], words, kOrder);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      *reinterpret_cast<uint4*>(s_w + w * kWStride + off + 4 * s) =
          kPairs ? make_uint4(words[2 * s], words[2 * s + 8], words[2 * s + 1], words[2 * s + 9])
                 : make_uint4(words[4 * s], words[4 * s + 1], words[4 * s + 2], words[4 * s + 3]);
    }
  }
}

// M tiles of 16 columns the warp has in the trip at `base`, up to the edge.
__device__ __forceinline__ int warp_m_tiles(long long base, long long lim, int warp) {
  const long long left = lim - base - warp * kWarpCols;
  return left <= 0 ? 0
                   : static_cast<int>(min((left + 15) / 16, static_cast<long long>(kWarpCols / 16)));
}

// Phase 3 of a trip: the thread's 16 columns of the output tile to HBM,
// one 16-byte store per row.
__device__ __forceinline__ void store_tile(uint8_t* dst, long long out_row, const uint8_t* s_out,
                                           int r_rows, long long col0, long long lim,
                                           bool vec_out, int off) {
  if (col0 >= lim) return;
  for (int r = 0; r < r_rows; ++r) {
    const uint4 o = *reinterpret_cast<const uint4*>(s_out + r * kOutStride + off);
    const uint32_t ow[4] = {o.x, o.y, o.z, o.w};
    store16(dst + r * out_row, col0, lim, vec_out, ow);
  }
}

__host__ __device__ constexpr int padded_rows(int r) {
  return (r + kGroup - 1) / kGroup * kGroup;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// 16-byte access is safe when the base and every row and batch stride are
// multiples of 16 (tiles and chunks are multiples of 16 columns too).
inline bool vectorizable(const void* base, long long batch_stride,
                         long long row_stride, int batch) {
  return aligned16(base) && row_stride % 16 == 0 &&
         (batch == 1 || batch_stride % 16 == 0);
}

inline bool shape_ok(int batch, int c, int r_rows, long long n) {
  return c >= 1 && c <= kMaxCols && r_rows >= 1 && r_rows <= kMaxRows &&
         n >= 1 && batch >= 1 && batch <= kMaxBatch;
}

// Opt `kernel` in to `smem` bytes of dynamic shared memory on the current
// device. Reader threads may launch one kernel with different shared memory
// at once (NT = 0 kernels size it by R), so the opt-in only ever rises,
// under a lock: no thread lowers it below what another is about to launch
// with. `opted` is the kernel's own high-water mark per device.
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, int smem, int (&opted)[64], std::mutex& lock) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(lock);
  if (smem <= opted[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) opted[dev] = smem;
  return e;
}

// Blocks along the columns: one per `tile` columns.
inline unsigned column_blocks(long long n, long long tile) {
  return static_cast<unsigned>((n + tile - 1) / tile);
}

}  // namespace gf
