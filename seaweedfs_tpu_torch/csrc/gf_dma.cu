// GF(2^8) matrix application on the tensor cores, fed by a TMA ring in
// shared memory, warp-specialised and persistent, for Hopper (sm_90a).
//
// Replaces seaweedfs_tpu/ops/rs_pallas.py:_make_dma_kernel (the "dma"
// Pallas kernel, :234). That kernel keeps the data in HBM and streams
// (C, chunk) sub-tiles of its tile through a 2-slot VMEM ring with async
// copies signalled on semaphores, starting the copy of chunk k+1 before it
// computes chunk k, and takes one int8 product per chunk.
//
// Same function as gf_bitplane.cu: out[b, r, n] = XOR_c m[r][c] *
// data[b, c, n] over GF(2^8), as the transposed product outT = bitsT .
// liftT on mma.m16n8k256 with 1-bit operands and AND + popc
// (`gf::mma_and_popc`: the column words as A, the lift as B in fragment
// order, `rs_cuda.lift_fragments`), then int8's pack product
// (`gf::pack_group`).
//
// What bounds it on this card: HBM sets the floor ((C + R) bytes per
// column: 0.027 ms for a 64 MiB encode batch at 3.35 TB/s). What holds it
// above that is the consumer warps' work per 16 columns (4 AND-popc
// products, the pack's parity bytes, an int8 product and byte stores for
// R = 4, about 47 instructions), not the loads: the ring keeps the copies
// out of the consumers' way. What the design does, the Pallas ring's
// counterparts on Hopper:
//   * a TMA ring: each stage of `chunk` columns moves from HBM to shared
//     memory as one 1-D bulk copy (cp.async.bulk) per input row, which
//     completes on the slot's "full" mbarrier; consumers release the slot
//     on its "empty" mbarrier as soon as its bytes are column words. 2 to
//     4 slots, as shared memory allows (`plan`);
//   * warp specialisation: one producer warp (one elected lane issues the
//     copies) runs ahead of four consumer warps, which turn the staged
//     bytes into column words (W, padded against bank conflicts), release
//     the slot, then take the products two M tiles at a time, loading the
//     next pair's A before storing this pair's bytes;
//   * persistent blocks: as many blocks as fit the SMs walk the work items
//     (batch element, tile) in a fixed stride, the producer running ahead
//     across item boundaries; the lift is staged once per block;
//   * output through two shared tiles: after a consumer-only named
//     barrier, one thread (a warp in turn) writes a pass back with one
//     bulk copy per output row (after fence.proxy.async); a tile is
//     rewritten only after its copies' cp.async.bulk.wait_group.read.
// Stages whose rows are not 16-byte aligned, or that cross the ragged
// edge, are filled by the producer warp's masked loads (`gf::load16`) into
// the same slot, and output that is not aligned, or crosses the edge,
// leaves by masked 16-byte stores, so any stride, offset and N >= 1 work.
//
// The ring's schedule is `rs_cuda.dma_schedule`: block k walks the work
// items k, k + grid, ...; stage s of its walk uses slot s % stages; the
// producer waits on empty[slot] for parity ((s / stages) & 1) ^ 1, the
// consumers on full[slot] for parity (s / stages) & 1. The stage count,
// the columns per consumer pass and the shared memory are
// `rs_cuda.dma_plan`, which this file's `plan` mirrors.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>
#include <mutex>

#include "gf_common.cuh"

namespace {

using gf::kCols;
using gf::kGroup;
using gf::padded_rows;

constexpr int kConsumerWarps = 4;
constexpr int kBlock = 32 * (kConsumerWarps + 1);  // the consumers, then the producer warp
constexpr int kMinStages = 2;
constexpr int kMaxStages = 4;
constexpr int kNarrowPass = 512;  // columns per consumer pass when 2048 does not fit
constexpr int kBarBytes = 128;    // the ring's 2 * kMaxStages mbarriers
constexpr int kSmemPerBlock = 232448;  // the most one block may use
constexpr int kSmemPerSm = 233472;     // an SM's, of which each block reserves 1 KiB
constexpr int kBlocksPerSmByThreads = 2048 / kBlock;
constexpr int kMinBlocks = 3;  // registers for 3 blocks an SM (<= 136 a thread): no spills
constexpr long long kWatchdogCycles = 1ll << 34;  // ~9 s: a ring that stalls this long traps

// -- the plan: stages, columns per consumer pass, shared memory ------------

struct Plan {
  int stages, pass, smem;
};

// W's words per row for a pass: 20 per 16 columns (see w_col), and 8 more,
// so that the A loads of lanes t = 0..3 (W rows t, 8 banks apart) and
// g = 0..7 hit 32 different banks
__host__ __device__ constexpr int w_stride(int pass) { return pass / 16 * 20 + 8; }

// barriers, W (column words), two output tiles, the lift fragments past 4 rows
inline int fixed_bytes(int nw, int r, int pass) {
  return kBarBytes + nw * w_stride(pass) * 4 + 2 * r * (pass + 16) +
         (r > 4 ? padded_rows(r) * 32 * 8 : 0);
}

inline int blocks_by_smem(int smem) {
  return std::min(kSmemPerSm / (smem + 1024), kBlocksPerSmByThreads);
}

// Consumers take a stage in passes of min(chunk, 2048) columns, or 512
// when two stages would not fit beside 2048-column tiles (C, R near 32);
// then the most stages, up to 4, that keep as many blocks per SM as 2 do.
inline Plan plan(int c, int r, int chunk) {
  const int nw = (c + 3) / 4;
  const int stage = c * chunk;
  int pass = std::min(chunk, gf::kSpan);
  if (fixed_bytes(nw, r, pass) + kMinStages * stage > kSmemPerBlock && pass > kNarrowPass) {
    pass = kNarrowPass;
  }
  const int base = fixed_bytes(nw, r, pass);
  const int per_sm = blocks_by_smem(base + kMinStages * stage);
  int stages = kMinStages;
  for (int s = kMinStages + 1; s <= kMaxStages; ++s) {
    if (base + s * stage <= kSmemPerBlock && blocks_by_smem(base + s * stage) == per_sm) stages = s;
  }
  return {stages, pass, base + stages * stage};
}

// -- mbarriers, bulk copies ------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// arrive, and expect `bytes` more of transactions before the phase completes
__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool bar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of `parity` has completed. A wait that outlasts the
// watchdog traps: a launch error, not a hung card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  if (bar_try_wait(a, parity)) return;
  const long long t0 = clock64();
  while (!bar_try_wait(a, parity)) {
    if (clock64() - t0 > kWatchdogCycles) __trap();
  }
}

// HBM -> shared memory, completing on `bar` (16-byte aligned, size % 16 == 0)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// shared memory -> HBM, in this thread's current bulk async-group
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// all but the newest N groups have finished reading shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// -- the work items --------------------------------------------------------

struct Item {
  long long start, lim;  // columns [start, lim) of batch element b
  int b;
};

__device__ __forceinline__ Item item_at(long long i, long long per_batch, long long tile,
                                        long long n) {
  const long long b = i / per_batch;
  const long long start = (i - b * per_batch) * tile;
  return {start, min(n, start + tile), static_cast<int>(b)};
}

// -- the two roles ---------------------------------------------------------

struct Ring {
  uint64_t* full;   // [stages], count 32: every producer lane arrives once a stage
  uint64_t* empty;  // [stages], count kConsumerWarps: lane 0 of each consumer warp
  uint8_t* slots;   // [stages][c][chunk]
  int stages, chunk, stage_bytes;
};

// The producer warp: for each stage, wait for its slot to be empty, then
// either lane 0 arms the full barrier with the stage's bytes and issues
// one bulk copy per input row, or (not aligned, or crossing the edge) the
// 32 lanes fill the slot by masked loads; every lane then arrives on full.
__device__ __forceinline__ void produce(const Ring& ring, const uint8_t* data,
                                        long long in_batch, long long in_row, int c, long long n,
                                        long long tile, long long per_batch, long long items,
                                        bool vec_in, int lane) {
  int slot = 0;
  uint32_t phase = 0;
  for (long long i = blockIdx.x; i < items; i += gridDim.x) {
    const Item it = item_at(i, per_batch, tile, n);
    const uint8_t* src = data + it.b * in_batch;
    for (long long cbase = it.start; cbase < it.lim; cbase += ring.chunk) {
      bar_wait(ring.empty + slot, phase ^ 1u);
      uint8_t* st = ring.slots + slot * ring.stage_bytes;
      uint64_t* full = ring.full + slot;
      if (vec_in && cbase + ring.chunk <= it.lim) {
        if (lane == 0) {
          bar_arrive_tx(full, static_cast<uint32_t>(ring.stage_bytes));
          for (int ci = 0; ci < c; ++ci) {
            bulk_load(st + ci * ring.chunk, src + ci * in_row + cbase, ring.chunk, full);
          }
        } else {
          bar_arrive(full);
        }
      } else {
        const int pieces = ring.chunk / kCols;
        for (int p = lane; p < c * pieces; p += 32) {
          const int ci = p / pieces;
          const long long col = cbase + (p - ci * pieces) * kCols;
          *reinterpret_cast<uint4*>(st + ci * ring.chunk + (p - ci * pieces) * kCols) =
              col < it.lim ? gf::load16(src + ci * in_row, col, it.lim, vec_in)
                           : make_uint4(0u, 0u, 0u, 0u);
        }
        bar_arrive(full);  // each lane's release covers its own stores
      }
      if (++slot == ring.stages) {
        slot = 0;
        phase ^= 1u;
      }
    }
  }
}

// Where column col of a pass sits in a W row: 16 words per 16 columns
// and 4 spare, so that the 16-byte stores of 8 lanes (one phase) 80 bytes
// apart hit 8 different bank groups.
__device__ __forceinline__ int w_col(int col) { return col + (col >> 4) * 4; }

// Column words of the lane's 16 columns of a stage (`st` at its first
// column; rows `chunk` bytes apart) into 16 consecutive words of each W
// row w (`w_dst`, rows `ws` words apart); rows at or past C are zero.
template <int NW>
__device__ __forceinline__ void stage_words(const uint8_t* st, int chunk, int c,
                                            uint32_t* w_dst, int ws) {
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    uint4 v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int ci = 4 * w + q;
      v[q] = ci < c ? *reinterpret_cast<const uint4*>(st + ci * chunk)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
    uint32_t words[kCols];
    gf::column_words(v, words);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      *reinterpret_cast<uint4*>(w_dst + w * ws + 4 * s) =
          make_uint4(words[4 * s], words[4 * s + 1], words[4 * s + 2], words[4 * s + 3]);
    }
  }
}

// The A fragment of the M tile at column nb of W (lane (g, t): words t and
// 4 + t of columns nb + g and nb + g + 8), or zero when `live` is false.
template <int NW>
__device__ __forceinline__ void a_fragment(uint32_t (&a)[4], const uint32_t* s_w, int ws, int nb,
                                           bool live, int g, int t) {
  const int c0 = w_col(nb) + g;  // nb is a multiple of 16
  a[0] = live && t < NW ? s_w[t * ws + c0] : 0u;
  a[1] = live && t < NW ? s_w[t * ws + c0 + 8] : 0u;
  a[2] = live && 4 + t < NW ? s_w[(4 + t) * ws + c0] : 0u;
  a[3] = live && 4 + t < NW ? s_w[(4 + t) * ws + c0 + 8] : 0u;
}

// The AND-popc products of one pair of M tiles (A fragments a[0], a[1])
// against NT output rows (fragments b) into d; rows past NT stay zero.
template <int NT>
__device__ __forceinline__ void pair_products(int (&d)[2][kGroup][4], const uint32_t (&a)[2][4],
                                              const uint2 (&b)[NT]) {
#pragma unroll
  for (int nt = 0; nt < kGroup; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) d[0][nt][e] = d[1][nt][e] = 0;
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    gf::mma_and_popc(d[0][nt], a[0], b[nt].x, b[nt].y);
    gf::mma_and_popc(d[1][nt], a[1], b[nt].x, b[nt].y);
  }
}

// A consumer warp. Per stage: wait on full, then per pass of `pass`
// columns (one pass unless the plan narrowed it): the warp's share of the
// pass (pass / 4 columns, 16 per lane) into column words in W; after the
// stage's last pass, release the slot on empty; then the warp's M tiles
// of 16 columns two at a time (A from W, the products of both, the next
// pair's A, the packs into the output tile); then the pass's tile out to
// HBM.
template <int NW, int NT>
__device__ __forceinline__ void consume(const Ring& ring, uint8_t* out, long long out_batch,
                                        long long out_row, const uint2* frags, const uint2* s_b,
                                        uint32_t* s_w, uint8_t* s_out, int c, int r_rows,
                                        long long n, long long tile, long long per_batch,
                                        long long items, int pass, bool vec_out, int warp,
                                        int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
  uint2 b[NT > 0 ? NT : 1];
  if constexpr (NT > 0) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) b[nt] = frags[nt * 32 + lane];
  }
  uint32_t pack0, pack1;
  gf::pack_operand(g, t, pack0, pack1);

  // the warp's columns of a pass, whole M tiles
  const int share = (pass + 16 * kConsumerWarps - 1) / (16 * kConsumerWarps) * 16;
  const int ws = w_stride(pass);            // words per W row
  const int os = pass + 16;                 // bytes per output-tile row
  const int wbase = warp * share;           // the warp's first column in a pass
  const int off = wbase + kCols * lane;     // the lane's
  const bool lane_cols = kCols * lane < share;
  int slot = 0;
  uint32_t phase = 0;
  int buf = 0;
  int issuer = 0;  // the warp whose lane 0 stores this pass
  for (long long i = blockIdx.x; i < items; i += gridDim.x) {
    const Item it = item_at(i, per_batch, tile, n);
    uint8_t* dst = out + it.b * out_batch;
    for (long long cbase = it.start; cbase < it.lim; cbase += ring.chunk) {
      bar_wait(ring.full + slot, phase);
      const uint8_t* st = ring.slots + slot * ring.stage_bytes;
      const long long clim = min(it.lim, cbase + ring.chunk);
      for (int p0 = 0; p0 < ring.chunk; p0 += pass) {
        const long long pbase = cbase + p0;
        const long long plim = min(clim, pbase + pass);
        // 1. staged bytes -> column words
        if (lane_cols && pbase + off < plim) {
          stage_words<NW>(st + p0 + off, ring.chunk, c, s_w + w_col(off), ws);
        }
        __syncwarp();
        if (p0 + pass >= ring.chunk && lane == 0) bar_arrive(ring.empty + slot);

        // 2. products into this pass's output tile (its last stores have read it:
        // step 3 of the pass before)
        uint8_t* o = s_out + buf * r_rows * os;
        const long long left = plim - pbase - wbase;
        const int m_tiles = left <= 0 ? 0 : static_cast<int>(min((left + 15) / 16,
                                                                 static_cast<long long>(share / 16)));
        uint32_t a[2][4];
        a_fragment<NW>(a[0], s_w, ws, wbase, m_tiles > 0, g, t);
        a_fragment<NW>(a[1], s_w, ws, wbase + 16, m_tiles > 1, g, t);
        for (int mt = 0; mt < m_tiles; mt += 2) {
          const int nb = wbase + mt * 16;
          uint32_t next[2][4];  // loaded before this pair's stores, so they overlap its products
          if constexpr (NT > 0) {
            int d[2][kGroup][4];
            pair_products<NT>(d, a, b);
            a_fragment<NW>(next[0], s_w, ws, nb + 32, mt + 2 < m_tiles, g, t);
            a_fragment<NW>(next[1], s_w, ws, nb + 48, mt + 3 < m_tiles, g, t);
            gf::pack_group(d[0], pack0, pack1, o + nb + g, r_rows, t, os);
            if (mt + 1 < m_tiles) gf::pack_group(d[1], pack0, pack1, o + nb + 16 + g, r_rows, t, os);
          } else {  // B from shared memory, 4 output rows at a time
            a_fragment<NW>(next[0], s_w, ws, nb + 32, mt + 2 < m_tiles, g, t);
            a_fragment<NW>(next[1], s_w, ws, nb + 48, mt + 3 < m_tiles, g, t);
            for (int rg = 0; rg < r_rows; rg += kGroup) {
              uint2 bg[kGroup];
#pragma unroll
              for (int nt = 0; nt < kGroup; ++nt) bg[nt] = s_b[(rg + nt) * 32 + lane];
              int d[2][kGroup][4];
              pair_products<kGroup>(d, a, bg);
              gf::pack_group(d[0], pack0, pack1, o + rg * os + nb + g, r_rows - rg, t, os);
              if (mt + 1 < m_tiles) {
                gf::pack_group(d[1], pack0, pack1, o + rg * os + nb + 16 + g, r_rows - rg, t, os);
              }
            }
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            a[0][e] = next[0][e];
            a[1][e] = next[1][e];
          }
        }

        // 3. the tile -> HBM. Every consumer thread fences its tile stores for
        // the async proxy, and lane 0 of each warp waits until its own bulk
        // stores of earlier passes have read the other tile, which the next
        // pass rewrites; then the consumers meet, and one thread (a warp in
        // turn) stores the whole pass, one bulk copy per output row, or
        // (not aligned, or crossing the edge) every lane stores its 16
        // columns of each row.
        const bool bulk = vec_out && plim == pbase + pass;
        if (bulk) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        if (lane == 0) bulk_wait_read<0>();
        asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumerWarps) : "memory");
        if (bulk) {
          if (lane == 0 && warp == issuer) {
            for (int r = 0; r < r_rows; ++r) {
              bulk_store(dst + r * out_row + pbase, o + r * os, static_cast<uint32_t>(pass));
            }
            bulk_commit();
          }
        } else if (lane_cols && pbase + off < plim) {
          for (int r = 0; r < r_rows; ++r) {
            const uint4 v = *reinterpret_cast<const uint4*>(o + r * os + off);
            const uint32_t ow[4] = {v.x, v.y, v.z, v.w};
            gf::store16(dst + r * out_row, pbase + off, plim, vec_out, ow);
          }
        }
        if (++issuer == kConsumerWarps) issuer = 0;
        buf ^= 1;
        __syncwarp();  // the next pass rewrites W
      }
      if (++slot == ring.stages) {
        slot = 0;
        phase ^= 1u;
      }
    }
  }
  if (lane == 0) bulk_wait_all();
}

// NW = ceil(C / 4): words per column. NT = 1..4: R = NT, the lift
// fragments in registers; NT = 0: any R, the fragments in shared memory,
// zero-padded to whole groups of 4 rows.
template <int NW, int NT>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
gf_dma_kernel(const uint8_t* __restrict__ data, long long in_batch, long long in_row,
              uint8_t* __restrict__ out, long long out_batch, long long out_row,
              const uint2* __restrict__ frags, int batch, int c, int r_rows, long long n,
              long long tile, int chunk, int stages, int pass, bool vec_in, bool vec_out) {
  extern __shared__ __align__(128) uint8_t smem[];
  Ring ring;
  ring.full = reinterpret_cast<uint64_t*>(smem);
  ring.empty = ring.full + stages;
  ring.slots = smem + kBarBytes;
  ring.stages = stages;
  ring.chunk = chunk;
  ring.stage_bytes = c * chunk;
  uint32_t* s_w = reinterpret_cast<uint32_t*>(ring.slots + stages * ring.stage_bytes);
  uint8_t* s_out = reinterpret_cast<uint8_t*>(s_w + NW * w_stride(pass));  // [2][r_rows][pass + 16]
  uint2* s_b = reinterpret_cast<uint2*>(s_out + 2 * r_rows * (pass + 16));  // [rt][32]

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      bar_init(ring.full + s, 32);
      bar_init(ring.empty + s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (NT == 0) {
    const int rt = padded_rows(r_rows);
    for (int k = threadIdx.x; k < rt * 32; k += kBlock) {
      s_b[k] = k < r_rows * 32 ? frags[k] : make_uint2(0u, 0u);
    }
  }
  __syncthreads();

  const long long per_batch = (n + tile - 1) / tile;
  const long long items = per_batch * batch;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp == kConsumerWarps) {
    produce(ring, data, in_batch, in_row, c, n, tile, per_batch, items, vec_in, lane);
  } else {
    consume<NW, NT>(ring, out, out_batch, out_row, frags, s_b, s_w, s_out, c, r_rows, n, tile,
                    per_batch, items, pass, vec_out, warp, lane);
  }
}

using KernelFn = void (*)(const uint8_t*, long long, long long, uint8_t*, long long, long long,
                          const uint2*, int, int, int, long long, long long, int, int, int, bool,
                          bool);

#define GF_DMA_ROW(NW)                                                          \
  {                                                                             \
    gf_dma_kernel<NW, 0>, gf_dma_kernel<NW, 1>, gf_dma_kernel<NW, 2>,           \
        gf_dma_kernel<NW, 3>, gf_dma_kernel<NW, 4>                              \
  }
// [NW - 1][NT]: the fragments in registers for R <= 4 (NT = R), else in
// shared memory (NT = 0)
const KernelFn kKernels[gf::kMaxCols / 4][5] = {
    GF_DMA_ROW(1), GF_DMA_ROW(2), GF_DMA_ROW(3), GF_DMA_ROW(4),
    GF_DMA_ROW(5), GF_DMA_ROW(6), GF_DMA_ROW(7), GF_DMA_ROW(8),
};
#undef GF_DMA_ROW

int nw_index(int c) { return (c + 3) / 4 - 1; }
int nt_index(int r) { return r <= 4 ? r : 0; }

// SMs of the current device, read once per device
int sm_count(int dev) {
  static std::atomic<int> counts[64];
  if (dev < 0 || dev >= 64) return 0;
  int k = counts[dev].load(std::memory_order_relaxed);
  if (k == 0) {
    if (cudaDeviceGetAttribute(&k, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
    counts[dev].store(k, std::memory_order_relaxed);
  }
  return k;
}

// Opt the kernel for (C, R) in to `smem` bytes on device `dev`, and return
// the blocks of it that fit one SM (shared memory, registers and threads
// together), or a cudaError_t < 0. Both cost host time, so each kernel
// remembers them for the last (device, smem) it ran with; the opt-in only
// ever rises (`gf::opt_in_smem`), so a remembered (device, smem) stays
// opted in while other threads launch the kernel with other chunks.
int blocks_per_sm(int c, int r, int smem, int dev) {
  static std::atomic<unsigned long long> seen[gf::kMaxCols / 4][5];
  static int opted[gf::kMaxCols / 4][5][64];
  static std::mutex lock;
  std::atomic<unsigned long long>& slot = seen[nw_index(c)][nt_index(r)];
  const unsigned long long key = (static_cast<unsigned long long>(dev) << 40) |
                                 (static_cast<unsigned long long>(smem) << 8);
  const unsigned long long got = slot.load(std::memory_order_acquire);
  if (got != 0 && (got & ~0xffull) == key) return static_cast<int>(got & 0xff);
  const KernelFn k = kKernels[nw_index(c)][nt_index(r)];
  const cudaError_t oe = gf::opt_in_smem(k, smem, opted[nw_index(c)][nt_index(r)], lock);
  if (oe != cudaSuccess) return -static_cast<int>(oe);
  int per_sm = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kBlock, smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  slot.store(key | static_cast<unsigned long long>(per_sm & 0xff), std::memory_order_release);
  return per_sm;
}

bool args_ok(int batch, int c, int r_rows, long long n, long long tile, int chunk) {
  return gf::shape_ok(batch, c, r_rows, n) && chunk >= kCols && chunk <= gf::kSpan &&
         chunk % kCols == 0 && tile >= chunk && tile % chunk == 0;
}

}  // namespace

// As gf_bitplane_apply, with the data streamed through the ring: frags is
// the lift in B fragment order, device uint32[r_rows][32][2]
// (`rs_cuda.lift_fragments`), 8-byte aligned; tile the columns of one work
// item (a positive multiple of chunk), chunk the columns per stage (a
// multiple of 16, at most 2048). Returns 0 or a cudaError_t.
extern "C" int gf_dma_apply(const void* data, long long in_batch, long long in_row, void* out,
                            long long out_batch, long long out_row, const void* frags, int batch,
                            int c, int r_rows, long long n, long long tile, int chunk,
                            void* stream) {
  if (!args_ok(batch, c, r_rows, n, tile, chunk) ||
      (reinterpret_cast<uintptr_t>(frags) & 7u)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = plan(c, r_rows, chunk);
  int dev = 0;
  const cudaError_t de = cudaGetDevice(&dev);
  if (de != cudaSuccess) return static_cast<int>(de);
  const int per_sm = blocks_per_sm(c, r_rows, p.smem, dev);
  if (per_sm < 0) return -per_sm;
  const int sms = sm_count(dev);
  if (per_sm == 0 || sms == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long items = (n + tile - 1) / tile * batch;
  const long long grid = std::min(items, static_cast<long long>(per_sm) * sms);
  const KernelFn k = kKernels[nw_index(c)][nt_index(r_rows)];
  k<<<static_cast<unsigned>(grid), kBlock, p.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), in_batch, in_row, static_cast<uint8_t*>(out), out_batch,
      out_row, static_cast<const uint2*>(frags), batch, c, r_rows, n, tile, chunk, p.stages,
      p.pass, gf::vectorizable(data, in_batch, in_row, batch),
      gf::vectorizable(out, out_batch, out_row, batch));
  return static_cast<int>(cudaGetLastError());
}

// The ring's plan for an (R x C) matrix and `chunk`-column stages, as
// gf_dma_apply launches it: plan[0..4] = stages, columns per consumer
// pass, shared memory bytes, blocks per SM (the occupancy calculator's,
// on the current device), SMs. Returns 0 or a cudaError_t.
extern "C" int gf_dma_plan(int c, int r_rows, int chunk, int* plan_out) {
  if (!args_ok(1, c, r_rows, 1, chunk, chunk)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan(c, r_rows, chunk);
  int dev = 0;
  const cudaError_t de = cudaGetDevice(&dev);
  if (de != cudaSuccess) return static_cast<int>(de);
  const int per_sm = blocks_per_sm(c, r_rows, p.smem, dev);
  if (per_sm < 0) return -per_sm;
  plan_out[0] = p.stages;
  plan_out[1] = p.pass;
  plan_out[2] = p.smem;
  plan_out[3] = per_sm;
  plan_out[4] = sm_count(dev);
  return 0;
}
