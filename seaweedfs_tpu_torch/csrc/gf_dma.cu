// GF(2^8) matrix application fed by a 2-slot cp.async ring, for Hopper
// (sm_90a).
//
// Replaces seaweedfs_tpu/ops/rs_pallas.py:_make_dma_kernel (the "dma"
// Pallas kernel, :234). That kernel keeps the data in HBM and streams
// (C, chunk) sub-tiles of its tile through a 2-slot VMEM ring with async
// copies, starting the copy of chunk k+1 before it computes chunk k.
//
// Same function as gf_bitplane.cu: out[b, r, n] = XOR_c m[r][c] *
// data[b, c, n] over GF(2^8), computed as the parity of popc(mask & column
// bits) per output bit, the lift held as per-output-bit masks over the
// byte-order column words (`rs_cuda.kernel_masks`).
//
// What bounds it on this card: like gf_bitplane, the integer pipe (about
// 288 integer operations per byte column for C = 10, R = 4) rather than the
// (C + R) bytes per column it moves. What the design does: the copy engine
// moves each (C, chunk) stage into shared memory with cp.async.cg (16 bytes
// a request, no registers held while in flight), so the loads of chunk k+1
// overlap the popc arithmetic of chunk k, and every input byte is read from
// HBM once.
//
// Design choice: one block per tile (not persistent blocks). The block
// walks its `tile` columns in `chunk` = rs_cuda._dma_chunk(tile) stages;
// thread t computes columns 16t .. 16t+15 of each stage and stores its
// output bytes straight from registers, 16 bytes per row. Pieces that are
// not 16-byte aligned or that cross the ragged edge are loaded by the
// scalar masked path into the same slot, so any stride and any N work.

#include <cstdint>
#include <cuda_runtime.h>

#include "gf_common.cuh"

namespace {

using gf::kCols;
using gf::kThreads;

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(saddr), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start the copy of stage `k` (columns cbase .. cbase+chunk) into `slot`.
__device__ __forceinline__ void issue_stage(uint8_t* slot, const uint8_t* src,
                                            long long in_row, int c, int chunk,
                                            long long cbase, long long lim,
                                            bool vec_in) {
  const int pieces = chunk / kCols;
  for (int p = threadIdx.x; p < c * pieces; p += kThreads) {
    const int ci = p / pieces;
    const int q = p - ci * pieces;
    const long long col = cbase + q * kCols;
    uint8_t* d = slot + ci * chunk + q * kCols;
    if (vec_in && col + kCols <= lim) {
      cp_async16(d, src + ci * in_row + col);
    } else {
      *reinterpret_cast<uint4*>(d) = gf::load16(src + ci * in_row, col, lim, false);
    }
  }
  cp_async_commit();
}

template <int NW>
__global__ void __launch_bounds__(kThreads)
gf_dma_kernel(const uint8_t* __restrict__ data, long long in_batch,
              long long in_row, uint8_t* __restrict__ out, long long out_batch,
              long long out_row, const uint32_t* __restrict__ masks, int c,
              int r_rows, long long n, long long tile, int chunk, bool vec_in,
              bool vec_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* s_masks = reinterpret_cast<uint32_t*>(smem);  // [r_rows * 8][NW]
  uint8_t* ring = smem + r_rows * 8 * NW * 4;             // [2][c][chunk]
  for (int k = threadIdx.x; k < r_rows * 8 * NW; k += kThreads) {
    s_masks[k] = masks[k];
  }

  const long long start = static_cast<long long>(blockIdx.x) * tile;
  const long long lim = min(n, start + tile);
  const int nchunks = static_cast<int>((lim - start + chunk - 1) / chunk);
  const uint8_t* src = data + blockIdx.y * in_batch;
  uint8_t* dst = out + blockIdx.y * out_batch;
  const int stage_bytes = c * chunk;

  issue_stage(ring, src, in_row, c, chunk, start, lim, vec_in);
  for (int k = 0; k < nchunks; ++k) {
    const int slot = k & 1;
    if (k + 1 < nchunks) {
      issue_stage(ring + (slot ^ 1) * stage_bytes, src, in_row, c, chunk,
                  start + static_cast<long long>(k + 1) * chunk, lim, vec_in);
      cp_async_wait<1>();  // stage k has landed; k+1 stays in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int off = threadIdx.x * kCols;
    const long long col0 = start + static_cast<long long>(k) * chunk + off;
    if (off < chunk && col0 < lim) {
      const uint8_t* st = ring + slot * stage_bytes;
      uint32_t bits[kCols][NW];
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        uint4 v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int ci = 4 * w + q;
          v[q] = ci < c ? *reinterpret_cast<const uint4*>(st + ci * chunk + off)
                        : make_uint4(0u, 0u, 0u, 0u);
        }
        uint32_t words[kCols];
        gf::column_words(v, words);
#pragma unroll
        for (int t = 0; t < kCols; ++t) bits[t][w] = words[t];
      }
      gf::parity_rows<NW>(bits, s_masks, r_rows, dst, out_row, col0, lim, vec_out);
    }
    __syncthreads();  // slot k is free for stage k+2
  }
}

template <int NW>
int launch(const uint8_t* data, long long in_batch, long long in_row,
           uint8_t* out, long long out_batch, long long out_row,
           const uint32_t* masks, int batch, int c, int r, long long n,
           long long tile, int chunk, bool vec_in, bool vec_out,
           cudaStream_t stream) {
  const size_t smem = sizeof(uint32_t) * r * 8 * NW + 2 * static_cast<size_t>(c) * chunk;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gf_dma_kernel<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(gf::column_blocks(n, tile), static_cast<unsigned>(batch));
  gf_dma_kernel<NW><<<grid, kThreads, smem, stream>>>(
      data, in_batch, in_row, out, out_batch, out_row, masks, c, r, n, tile,
      chunk, vec_in, vec_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// As gf_bitplane_apply, with the data streamed through the ring: tile is
// the columns per block (a positive multiple of chunk), chunk the columns
// per stage (a multiple of 16, at most 2048). Returns 0 or a cudaError_t.
extern "C" int gf_dma_apply(const void* data, long long in_batch,
                            long long in_row, void* out, long long out_batch,
                            long long out_row, const void* masks, int batch,
                            int c, int r_rows, long long n, long long tile,
                            int chunk, void* stream) {
  if (!gf::shape_ok(batch, c, r_rows, n) || chunk < kCols ||
      chunk > gf::kSpan || chunk % kCols || tile < chunk || tile % chunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec_in = gf::vectorizable(data, in_batch, in_row, batch);
  const bool vec_out = gf::vectorizable(out, out_batch, out_row, batch);
  const auto* d = static_cast<const uint8_t*>(data);
  auto* o = static_cast<uint8_t*>(out);
  const auto* m = static_cast<const uint32_t*>(masks);
  auto s = static_cast<cudaStream_t>(stream);
  switch ((c + 3) / 4) {
    case 1: return launch<1>(d, in_batch, in_row, o, out_batch, out_row, m, batch, c, r_rows, n, tile, chunk, vec_in, vec_out, s);
    case 2: return launch<2>(d, in_batch, in_row, o, out_batch, out_row, m, batch, c, r_rows, n, tile, chunk, vec_in, vec_out, s);
    case 3: return launch<3>(d, in_batch, in_row, o, out_batch, out_row, m, batch, c, r_rows, n, tile, chunk, vec_in, vec_out, s);
    case 4: return launch<4>(d, in_batch, in_row, o, out_batch, out_row, m, batch, c, r_rows, n, tile, chunk, vec_in, vec_out, s);
    case 5: return launch<5>(d, in_batch, in_row, o, out_batch, out_row, m, batch, c, r_rows, n, tile, chunk, vec_in, vec_out, s);
    case 6: return launch<6>(d, in_batch, in_row, o, out_batch, out_row, m, batch, c, r_rows, n, tile, chunk, vec_in, vec_out, s);
    case 7: return launch<7>(d, in_batch, in_row, o, out_batch, out_row, m, batch, c, r_rows, n, tile, chunk, vec_in, vec_out, s);
    default: return launch<8>(d, in_batch, in_row, o, out_batch, out_row, m, batch, c, r_rows, n, tile, chunk, vec_in, vec_out, s);
  }
}
