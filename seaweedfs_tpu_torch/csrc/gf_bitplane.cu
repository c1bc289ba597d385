// GF(2^8) matrix application over byte shards, bit-plane formulation, for
// Hopper (sm_90a).
//
// Replaces seaweedfs_tpu/ops/rs_pallas.py:_kernel (the "int8" Pallas
// kernel). Both compute out[b, r, n] = XOR_c m[r][c] * data[b, c, n] over
// GF(2^8) as (lift @ bits(data)) mod 2, where lift is the (8R, 8C) binary
// lift of the (R, C) matrix and bits() unpacks each byte into 8 planes.
//
// What bounds it on this card: the integer pipe. Per byte column it issues
// ~288 integer operations for C = 10, R = 4 (for each of the 32 output
// bits: AND, XOR, popc, AND, shift, OR over ceil(C/4) words), ~0.1 ms for
// a 64 MiB encode batch, while its C + R bytes per column need ~0.03 ms at
// the H100's 3.35 TB/s. What the design does about it: each input byte is
// read once with 16-byte loads and each output byte is written once with
// 16-byte stores; the bit vectors, the lift and the accumulators never
// touch device memory, so the memory side stays far below its bound.
//
// Design (the TPU kernel's formulation, kept on the CUDA cores):
//   * each thread owns 16 byte columns: one 16-byte load per input row;
//   * per column it builds the 8C-bit vector in ceil(C/4) uint32 words,
//     byte ci of word ci/4 being the column's byte of row ci (bit position
//     8*ci + j = bit j of row ci) with __byte_perm;
//   * the lift arrives as bit masks over that bit order, one row of
//     ceil(C/4) words per output bit (row (r*8 + i) = bit i of output row
//     r), staged in shared memory once per block;
//   * output bit (r, i) = parity(popc(XOR_w mask[w] & bits[w]));
//   * 8 bits pack into each output byte, 16 bytes per row per store.
// The ragged edge is masked in the kernel, so any N >= 1 works with no pad.
// An explicit tile makes each block walk `tile` columns in a loop, the
// counterpart of the reference's `pallas_tile`.

#include <cstdint>
#include <cuda_runtime.h>

#include "gf_common.cuh"

namespace {

using gf::kCols;
using gf::kSpan;
using gf::kThreads;

// NW = ceil(C / 4): uint32 words of one column's 8C-bit vector. A block
// covers the columns [blockIdx.x * tile, + tile), kSpan per trip of its
// loop; tile == kSpan is one trip, the launch of one block per 2048 columns.
template <int NW>
__global__ void __launch_bounds__(kThreads)
gf_bitplane_kernel(const uint8_t* __restrict__ data, long long in_batch,
                   long long in_row, uint8_t* __restrict__ out,
                   long long out_batch, long long out_row,
                   const uint32_t* __restrict__ masks, int c, int r_rows,
                   long long n, long long tile, bool vec_in, bool vec_out) {
  extern __shared__ uint32_t s_masks[];  // [r_rows * 8][NW]
  for (int k = threadIdx.x; k < r_rows * 8 * NW; k += blockDim.x) {
    s_masks[k] = masks[k];
  }
  __syncthreads();

  const long long start = static_cast<long long>(blockIdx.x) * tile;
  const long long lim = min(n, start + tile);
  const uint8_t* src = data + blockIdx.y * in_batch;
  uint8_t* dst = out + blockIdx.y * out_batch;

  for (long long col0 = start + threadIdx.x * kCols; col0 < lim; col0 += kSpan) {
    // Column bit vectors: bits[t][w] holds rows 4w..4w+3 of column col0 + t.
    uint32_t bits[kCols][NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      uint4 v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ci = 4 * w + q;
        v[q] = ci < c ? gf::load16(src + ci * in_row, col0, lim, vec_in)
                      : make_uint4(0u, 0u, 0u, 0u);
      }
      uint32_t words[kCols];
      gf::column_words(v, words);
#pragma unroll
      for (int t = 0; t < kCols; ++t) bits[t][w] = words[t];
    }

    gf::parity_rows<NW>(bits, s_masks, r_rows, dst, out_row, col0, lim, vec_out);
  }
}

template <int NW>
void launch(const uint8_t* data, long long in_batch, long long in_row,
            uint8_t* out, long long out_batch, long long out_row,
            const uint32_t* masks, int batch, int c, int r, long long n,
            long long tile, bool vec_in, bool vec_out, cudaStream_t stream) {
  const dim3 grid(gf::column_blocks(n, tile), static_cast<unsigned>(batch));
  const size_t smem = sizeof(uint32_t) * r * 8 * NW;
  gf_bitplane_kernel<NW><<<grid, kThreads, smem, stream>>>(
      data, in_batch, in_row, out, out_batch, out_row, masks, c, r, n, tile,
      vec_in, vec_out);
}

}  // namespace

// out[b, r, :] for b < batch, r < r_rows, from data[b, c, :]; strides are in
// bytes, the last axis contiguous. masks: device uint32[r_rows * 8][ceil(C/4)].
// tile: columns per block, a positive multiple of 16, or 0 for 2048 (one
// trip per block). Returns 0 or the cudaError_t of the launch.
extern "C" int gf_bitplane_apply(const void* data, long long in_batch,
                                 long long in_row, void* out,
                                 long long out_batch, long long out_row,
                                 const void* masks, int batch, int c,
                                 int r_rows, long long n, long long tile,
                                 void* stream) {
  if (tile == 0) tile = kSpan;
  if (!gf::shape_ok(batch, c, r_rows, n) || tile < 0 || tile % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec_in = gf::vectorizable(data, in_batch, in_row, batch);
  const bool vec_out = gf::vectorizable(out, out_batch, out_row, batch);
  const auto* d = static_cast<const uint8_t*>(data);
  auto* o = static_cast<uint8_t*>(out);
  const auto* m = static_cast<const uint32_t*>(masks);
  auto s = static_cast<cudaStream_t>(stream);
  switch ((c + 3) / 4) {
    case 1: launch<1>(d, in_batch, in_row, o, out_batch, out_row, m, batch, c, r_rows, n, tile, vec_in, vec_out, s); break;
    case 2: launch<2>(d, in_batch, in_row, o, out_batch, out_row, m, batch, c, r_rows, n, tile, vec_in, vec_out, s); break;
    case 3: launch<3>(d, in_batch, in_row, o, out_batch, out_row, m, batch, c, r_rows, n, tile, vec_in, vec_out, s); break;
    case 4: launch<4>(d, in_batch, in_row, o, out_batch, out_row, m, batch, c, r_rows, n, tile, vec_in, vec_out, s); break;
    case 5: launch<5>(d, in_batch, in_row, o, out_batch, out_row, m, batch, c, r_rows, n, tile, vec_in, vec_out, s); break;
    case 6: launch<6>(d, in_batch, in_row, o, out_batch, out_row, m, batch, c, r_rows, n, tile, vec_in, vec_out, s); break;
    case 7: launch<7>(d, in_batch, in_row, o, out_batch, out_row, m, batch, c, r_rows, n, tile, vec_in, vec_out, s); break;
    default: launch<8>(d, in_batch, in_row, o, out_batch, out_row, m, batch, c, r_rows, n, tile, vec_in, vec_out, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
