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
__device__ __forceinline__ void column_words(const uint4 v[4], uint32_t words[kCols]) {
#pragma unroll
  for (int t = 0; t < kCols; ++t) {
    const uint32_t sel = (t & 3) | (((t & 3) + 4) << 4);
    const uint32_t lo = __byte_perm(lane(v[0], t >> 2), lane(v[1], t >> 2), sel);
    const uint32_t hi = __byte_perm(lane(v[2], t >> 2), lane(v[3], t >> 2), sel);
    words[t] = __byte_perm(lo, hi, 0x5410);
  }
}

// Output bit (r, i) of column t = parity(popc(XOR_w mask[(r*8+i)*NW + w] &
// bits[t][w])); 8 bits pack into each output byte, 16 bytes per row per
// store. s_masks: the lift as per-output-bit masks over the column words.
template <int NW>
__device__ __forceinline__ void parity_rows(const uint32_t (&bits)[kCols][NW],
                                            const uint32_t* s_masks, int r_rows,
                                            uint8_t* dst, long long out_row,
                                            long long col0, long long lim,
                                            bool vec_out) {
  for (int r = 0; r < r_rows; ++r) {
    uint32_t o[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      uint32_t m[NW];
#pragma unroll
      for (int w = 0; w < NW; ++w) m[w] = s_masks[(r * 8 + i) * NW + w];
#pragma unroll
      for (int t = 0; t < kCols; ++t) {
        uint32_t x = 0u;
#pragma unroll
        for (int w = 0; w < NW; ++w) x ^= m[w] & bits[t][w];
        o[t >> 2] |= (uint32_t(__popc(x)) & 1u) << ((t & 3) * 8 + i);
      }
    }
    store16(dst + r * out_row, col0, lim, vec_out, o);
  }
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

// Blocks along the columns: one per `tile` columns.
inline unsigned column_blocks(long long n, long long tile) {
  return static_cast<unsigned>((n + tile - 1) / tile);
}

}  // namespace gf
