// GF(2^8) host codecs: the split-table multiply-accumulate (PSHUFB nibble
// tables, AVX2 where the host has it) behind the "native" backend, and the
// compiled XOR-schedule executor behind the "xorsched" backend
// (ops/xorsched.py). Host code with a plain C interface, built by
// utils/native.py with the host C++ compiler at first use.
//
// No global -mavx2/-mgfni: every SIMD body carries a per-function target
// attribute and is chosen at run time (__builtin_cpu_supports), so one
// binary runs on any x86-64 host.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__x86_64__)
#include <immintrin.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// GF(2^8) multiply-accumulate, poly 0x11D
// ---------------------------------------------------------------------------

static uint8_t gf_mul_table[256][256];

static const int gf_initialized = [] {
  for (int a = 0; a < 256; a++) {
    for (int b = 0; b < 256; b++) {
      uint16_t x = (uint16_t)a, r = 0, y = (uint16_t)b;
      while (y) {
        if (y & 1) r ^= x;
        x <<= 1;
        if (x & 0x100) x ^= 0x11D;
        y >>= 1;
      }
      gf_mul_table[a][b] = (uint8_t)r;
    }
  }
  return 1;
}();

#if defined(__x86_64__)
// AVX2 body compiled with a per-function target attribute and selected at
// runtime via __builtin_cpu_supports, so one binary runs on any x86-64 host
// (no -mavx2 global flag, no SIGILL on pre-AVX2 machines).
__attribute__((target("avx2"))) static void gf_mul_xor_slice_avx2(
    const uint8_t* row, const uint8_t* src, uint8_t* dst, uint64_t len) {
  // PSHUFB nibble tables: y = lo_tbl[x & 0xF] ^ hi_tbl[x >> 4]
  uint8_t lo[16], hi[16];
  for (int i = 0; i < 16; i++) {
    lo[i] = row[i];
    hi[i] = row[i << 4];
  }
  const __m256i vlo = _mm256_broadcastsi128_si256(_mm_loadu_si128((const __m128i*)lo));
  const __m256i vhi = _mm256_broadcastsi128_si256(_mm_loadu_si128((const __m128i*)hi));
  const __m256i mask = _mm256_set1_epi8(0x0F);
  uint64_t i = 0;
  for (; i + 32 <= len; i += 32) {
    __m256i x = _mm256_loadu_si256((const __m256i*)(src + i));
    __m256i xl = _mm256_and_si256(x, mask);
    __m256i xh = _mm256_and_si256(_mm256_srli_epi64(x, 4), mask);
    __m256i y = _mm256_xor_si256(_mm256_shuffle_epi8(vlo, xl),
                                 _mm256_shuffle_epi8(vhi, xh));
    __m256i d = _mm256_loadu_si256((const __m256i*)(dst + i));
    _mm256_storeu_si256((__m256i*)(dst + i), _mm256_xor_si256(d, y));
  }
  for (; i < len; i++) dst[i] ^= row[src[i]];
}
#endif

// dst[i] ^= gmul(c, src[i]) for i in [0, len)
void weedtpu_torch_gf_mul_xor_slice(uint8_t c, const uint8_t* src, uint8_t* dst,
                              uint64_t len) {
  if (c == 0) return;
  const uint8_t* row = gf_mul_table[c];
#if defined(__x86_64__)
  if (__builtin_cpu_supports("avx2")) {
    gf_mul_xor_slice_avx2(row, src, dst, len);
    return;
  }
#endif
  for (uint64_t i = 0; i < len; i++) dst[i] ^= row[src[i]];
}

// One contiguous byte range of the apply: for each output row, zero the
// range then XOR-accumulate every input slice through its coefficient.
// Iterating (row, col) inside a bounded range keeps src/dst resident in
// cache across the inner passes — the same blocking the reference codec
// gets from its per-goroutine split (WithAutoGoroutines).
static void gf_matrix_apply_range(const uint8_t* matrix, uint32_t rows,
                                  uint32_t cols, const uint8_t* const* inputs,
                                  uint8_t* const* outputs, uint64_t off,
                                  uint64_t n) {
  for (uint32_t r = 0; r < rows; r++) {
    memset(outputs[r] + off, 0, n);
    for (uint32_t c0 = 0; c0 < cols; c0++) {
      uint8_t coef = matrix[r * cols + c0];
      if (coef)
        weedtpu_torch_gf_mul_xor_slice(coef, inputs[c0] + off, outputs[r] + off, n);
    }
  }
}

// outputs[r] = XOR_c gmul(matrix[r*cols+c], inputs[c]), each slice `len` bytes
void weedtpu_torch_gf_matrix_apply(const uint8_t* matrix, uint32_t rows, uint32_t cols,
                             const uint8_t* const* inputs, uint8_t* const* outputs,
                             uint64_t len) {
  gf_matrix_apply_range(matrix, rows, cols, inputs, outputs, 0, len);
}

// Multithreaded variant: the byte range splits across `threads` workers
// (0 = hardware concurrency), each running the blocked single-thread body
// on a disjoint 64B-aligned chunk. Mirrors klauspost/reedsolomon's
// WithAutoGoroutines data split; output rows are disjoint per range, so
// no synchronization beyond join is needed.
void weedtpu_torch_gf_matrix_apply_mt(const uint8_t* matrix, uint32_t rows,
                                uint32_t cols, const uint8_t* const* inputs,
                                uint8_t* const* outputs, uint64_t len,
                                uint32_t threads) {
  if (threads == 0) {
    unsigned hw = std::thread::hardware_concurrency();
    threads = hw ? hw : 1;
  }
  // below ~256 KiB per worker, spawn overhead beats the parallel win
  uint64_t max_useful = len / (256 * 1024);
  if (max_useful < threads) threads = (uint32_t)std::max<uint64_t>(1, max_useful);
  if (threads <= 1) {
    gf_matrix_apply_range(matrix, rows, cols, inputs, outputs, 0, len);
    return;
  }
  uint64_t chunk = (len / threads + 63) & ~63ull;  // 64B-aligned split
  std::vector<std::thread> pool;
  pool.reserve(threads);
  uint64_t off = 0;
  for (uint32_t t = 0; t < threads && off < len; t++) {
    uint64_t n = std::min(chunk, len - off);
    pool.emplace_back(gf_matrix_apply_range, matrix, rows, cols, inputs,
                      outputs, off, n);
    off += n;
  }
  if (off < len)  // remainder from alignment rounding
    gf_matrix_apply_range(matrix, rows, cols, inputs, outputs, off, len - off);
  for (auto& th : pool) th.join();
}

// Batched apply: `batch` independent stacks sharing one matrix.
// inputs holds batch*cols slice pointers, outputs batch*rows; workers split
// over batch elements — one pool for the whole flush instead of one per
// element, and no host-side repacking (each slice pointer is used as-is).
void weedtpu_torch_gf_matrix_apply_batch(const uint8_t* matrix, uint32_t rows,
                                   uint32_t cols,
                                   const uint8_t* const* inputs,
                                   uint8_t* const* outputs, uint64_t len,
                                   uint32_t batch, uint32_t threads) {
  if (threads == 0) {
    unsigned hw = std::thread::hardware_concurrency();
    threads = hw ? hw : 1;
  }
  if (threads > batch) {
    // fewer elements than workers: the per-element byte-range split keeps
    // the whole machine busy (a batch of 2 large stacks on 16 cores would
    // otherwise run on 2 threads)
    for (uint32_t b = 0; b < batch; b++)
      weedtpu_torch_gf_matrix_apply_mt(matrix, rows, cols, inputs + (uint64_t)b * cols,
                                 outputs + (uint64_t)b * rows, len, threads);
    return;
  }
  uint64_t max_useful = (uint64_t)batch * cols * len / (256 * 1024);
  if (max_useful < threads) threads = (uint32_t)std::max<uint64_t>(1, max_useful);
  auto run_span = [&](uint32_t b0, uint32_t b1) {
    for (uint32_t b = b0; b < b1; b++)
      gf_matrix_apply_range(matrix, rows, cols, inputs + (uint64_t)b * cols,
                            outputs + (uint64_t)b * rows, 0, len);
  };
  if (threads <= 1) {
    run_span(0, batch);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(threads);
  uint32_t per = (batch + threads - 1) / threads;
  for (uint32_t t = 0; t < threads; t++) {
    uint32_t b0 = t * per, b1 = std::min(batch, b0 + per);
    if (b0 >= b1) break;
    pool.emplace_back(run_span, b0, b1);
  }
  for (auto& th : pool) th.join();
}

int weedtpu_torch_has_avx2() {
#if defined(__x86_64__)
  return __builtin_cpu_supports("avx2") ? 1 : 0;
#else
  return 0;
#endif
}

// ---------------------------------------------------------------------------
// xorsched — compiled XOR-schedule executor (ops/xorsched.py)
//
// The schedule arrives as a flat int32 op list ([dest, nsrc, srcs...]
// records) over a slot space of packed bit-planes: slots [0, in_planes) are
// the transposed input shards (plane 8c+i = bit i of shard c), temps follow,
// and [out_base, out_base + out_planes) are the output bit-planes.  The
// executor tiles the width axis (tile_sym symbols per shard per tile), and
// per tile: byte->bit-plane transposes the inputs into a scratch frame,
// replays the XOR program with wide vector XORs, and transposes the output
// planes back to bytes.  Three SIMD levels, dispatched at runtime like the
// PSHUFB kernel above: GFNI+AVX-512 (one vgf2p8affineqb per 8x8 bit
// transpose), AVX2 (movemask / shuffle+cmpeq), scalar (Hacker's Delight).
// ---------------------------------------------------------------------------

// 8x8 bit-matrix transpose of a little-endian qword: result byte i bit j =
// input byte j bit i — i.e. 8 symbols in, their 8 packed plane bytes out
// (an involution, so it is also the plane->symbol direction).
static inline uint64_t xs_t8(uint64_t x) {
  uint64_t t;
  t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAull; x ^= t ^ (t << 7);
  t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCull; x ^= t ^ (t << 14);
  t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ull; x ^= t ^ (t << 28);
  return x;
}

static void xs_xor_op_scalar(uint8_t* dst, const uint8_t* const* srcs, int nsrc,
                             uint64_t nb) {
  uint64_t i = 0;
  for (; i + 8 <= nb; i += 8) {
    uint64_t v;
    memcpy(&v, srcs[0] + i, 8);
    for (int s = 1; s < nsrc; s++) {
      uint64_t w;
      memcpy(&w, srcs[s] + i, 8);
      v ^= w;
    }
    memcpy(dst + i, &v, 8);
  }
  for (; i < nb; i++) {
    uint8_t v = srcs[0][i];
    for (int s = 1; s < nsrc; s++) v ^= srcs[s][i];
    dst[i] = v;
  }
}

#if defined(__x86_64__)

// ---- AVX2 level ----

// 32 symbols -> one uint32 per plane: movemask peels the MSB plane, then
// paddb shifts the next bit into MSB position.
__attribute__((target("avx2"))) static void xs_fwd32_avx2(
    const uint8_t* src, uint8_t* const pl[8], uint64_t word_off) {
  __m256i v = _mm256_loadu_si256((const __m256i*)src);
  for (int bit = 7; bit >= 0; bit--) {
    uint32_t w = (uint32_t)_mm256_movemask_epi8(v);
    memcpy(pl[bit] + word_off * 4, &w, 4);
    v = _mm256_add_epi8(v, v);
  }
}

// one uint32 per plane -> 32 symbols: broadcast each plane word, spread its
// bytes across lanes with shuffle, test each lane's bit with cmpeq.
__attribute__((target("avx2"))) static void xs_bwd32_avx2(
    uint8_t* const pl[8], uint64_t word_off, uint8_t* dst) {
  const __m256i sel = _mm256_setr_epi8(
      0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1,
      2, 2, 2, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 3);
  const __m256i bits = _mm256_setr_epi8(
      1, 2, 4, 8, 16, 32, 64, (char)128, 1, 2, 4, 8, 16, 32, 64, (char)128,
      1, 2, 4, 8, 16, 32, 64, (char)128, 1, 2, 4, 8, 16, 32, 64, (char)128);
  __m256i acc = _mm256_setzero_si256();
  for (int bit = 0; bit < 8; bit++) {
    uint32_t w;
    memcpy(&w, pl[bit] + word_off * 4, 4);
    __m256i x = _mm256_broadcastd_epi32(_mm_cvtsi32_si128((int)w));
    __m256i sh = _mm256_shuffle_epi8(x, sel);
    __m256i isset = _mm256_cmpeq_epi8(_mm256_and_si256(sh, bits), bits);
    acc = _mm256_or_si256(acc,
                          _mm256_and_si256(isset, _mm256_set1_epi8((char)(1 << bit))));
  }
  _mm256_storeu_si256((__m256i*)dst, acc);
}

__attribute__((target("avx2"))) static void xs_xor_op_avx2(
    uint8_t* dst, const uint8_t* const* srcs, int nsrc, uint64_t nb) {
  uint64_t i = 0;
  for (; i + 64 <= nb; i += 64) {
    __m256i a0 = _mm256_loadu_si256((const __m256i*)(srcs[0] + i));
    __m256i a1 = _mm256_loadu_si256((const __m256i*)(srcs[0] + i + 32));
    for (int s = 1; s < nsrc; s++) {
      a0 = _mm256_xor_si256(a0, _mm256_loadu_si256((const __m256i*)(srcs[s] + i)));
      a1 = _mm256_xor_si256(a1, _mm256_loadu_si256((const __m256i*)(srcs[s] + i + 32)));
    }
    _mm256_storeu_si256((__m256i*)(dst + i), a0);
    _mm256_storeu_si256((__m256i*)(dst + i + 32), a1);
  }
  for (; i < nb; i++) {
    uint8_t v = srcs[0][i];
    for (int s = 1; s < nsrc; s++) v ^= srcs[s][i];
    dst[i] = v;
  }
}

// ---- GFNI + AVX-512 level ----

#define XS_REV8_BYTES                                                      \
  56, 57, 58, 59, 60, 61, 62, 63, 48, 49, 50, 51, 52, 53, 54, 55, 40, 41, \
      42, 43, 44, 45, 46, 47, 32, 33, 34, 35, 36, 37, 38, 39, 24, 25, 26, \
      27, 28, 29, 30, 31, 16, 17, 18, 19, 20, 21, 22, 23, 8, 9, 10, 11,   \
      12, 13, 14, 15, 0, 1, 2, 3, 4, 5, 6, 7
#define XS_GATHER_BYTES                                                    \
  63, 55, 47, 39, 31, 23, 15, 7, 62, 54, 46, 38, 30, 22, 14, 6, 61, 53,   \
      45, 37, 29, 21, 13, 5, 60, 52, 44, 36, 28, 20, 12, 4, 59, 51, 43,   \
      35, 27, 19, 11, 3, 58, 50, 42, 34, 26, 18, 10, 2, 57, 49, 41, 33,   \
      25, 17, 9, 1, 56, 48, 40, 32, 24, 16, 8, 0

// 512 symbols -> 64 contiguous bytes in each of 8 planes.  Per qword,
// vgf2p8affineqb(IDENT, rev8(x)) is an 8x8 bit transpose (the data rides in
// the matrix operand; IDENT byte i = 1<<i); vpermb then groups each plane's
// 8 bytes, and a 3-stage unpack/shuffle network transposes the 8x8 qword
// block across registers into whole-plane 64-byte stores.
__attribute__((target("gfni,avx512f,avx512bw,avx512vbmi"))) static void
xs_fwd512_gfni(const uint8_t* src, uint8_t* const pl[8], uint64_t boff) {
  const __m512i ident = _mm512_set1_epi64((long long)0x8040201008040201ull);
  const __m512i rev8 = _mm512_set_epi8(XS_REV8_BYTES);
  const __m512i gather = _mm512_set_epi8(XS_GATHER_BYTES);
  __m512i w[8];
  for (int g = 0; g < 8; g++) {
    _mm_prefetch((const char*)(src + 64 * g + 1024), _MM_HINT_T0);
    __m512i v = _mm512_loadu_si512(src + 64 * g);
    v = _mm512_gf2p8affine_epi64_epi8(ident, _mm512_shuffle_epi8(v, rev8), 0);
    w[g] = _mm512_permutexvar_epi8(gather, v);
  }
  __m512i a0 = _mm512_unpacklo_epi64(w[0], w[1]);
  __m512i a1 = _mm512_unpackhi_epi64(w[0], w[1]);
  __m512i a2 = _mm512_unpacklo_epi64(w[2], w[3]);
  __m512i a3 = _mm512_unpackhi_epi64(w[2], w[3]);
  __m512i a4 = _mm512_unpacklo_epi64(w[4], w[5]);
  __m512i a5 = _mm512_unpackhi_epi64(w[4], w[5]);
  __m512i a6 = _mm512_unpacklo_epi64(w[6], w[7]);
  __m512i a7 = _mm512_unpackhi_epi64(w[6], w[7]);
  __m512i b0 = _mm512_shuffle_i64x2(a0, a2, 0x88);
  __m512i b1 = _mm512_shuffle_i64x2(a0, a2, 0xDD);
  __m512i b2 = _mm512_shuffle_i64x2(a1, a3, 0x88);
  __m512i b3 = _mm512_shuffle_i64x2(a1, a3, 0xDD);
  __m512i b4 = _mm512_shuffle_i64x2(a4, a6, 0x88);
  __m512i b5 = _mm512_shuffle_i64x2(a4, a6, 0xDD);
  __m512i b6 = _mm512_shuffle_i64x2(a5, a7, 0x88);
  __m512i b7 = _mm512_shuffle_i64x2(a5, a7, 0xDD);
  _mm512_storeu_si512(pl[0] + boff, _mm512_shuffle_i64x2(b0, b4, 0x88));
  _mm512_storeu_si512(pl[4] + boff, _mm512_shuffle_i64x2(b0, b4, 0xDD));
  _mm512_storeu_si512(pl[1] + boff, _mm512_shuffle_i64x2(b2, b6, 0x88));
  _mm512_storeu_si512(pl[5] + boff, _mm512_shuffle_i64x2(b2, b6, 0xDD));
  _mm512_storeu_si512(pl[2] + boff, _mm512_shuffle_i64x2(b1, b5, 0x88));
  _mm512_storeu_si512(pl[6] + boff, _mm512_shuffle_i64x2(b1, b5, 0xDD));
  _mm512_storeu_si512(pl[3] + boff, _mm512_shuffle_i64x2(b3, b7, 0x88));
  _mm512_storeu_si512(pl[7] + boff, _mm512_shuffle_i64x2(b3, b7, 0xDD));
}

// exact inverse of xs_fwd512_gfni (every stage is an involution)
__attribute__((target("gfni,avx512f,avx512bw,avx512vbmi"))) static void
xs_bwd512_gfni(uint8_t* const pl[8], uint64_t boff, uint8_t* dst) {
  const __m512i ident = _mm512_set1_epi64((long long)0x8040201008040201ull);
  const __m512i rev8 = _mm512_set_epi8(XS_REV8_BYTES);
  const __m512i gather = _mm512_set_epi8(XS_GATHER_BYTES);
  __m512i p[8];
  for (int i = 0; i < 8; i++) p[i] = _mm512_loadu_si512(pl[i] + boff);
  __m512i a0 = _mm512_unpacklo_epi64(p[0], p[1]);
  __m512i a1 = _mm512_unpackhi_epi64(p[0], p[1]);
  __m512i a2 = _mm512_unpacklo_epi64(p[2], p[3]);
  __m512i a3 = _mm512_unpackhi_epi64(p[2], p[3]);
  __m512i a4 = _mm512_unpacklo_epi64(p[4], p[5]);
  __m512i a5 = _mm512_unpackhi_epi64(p[4], p[5]);
  __m512i a6 = _mm512_unpacklo_epi64(p[6], p[7]);
  __m512i a7 = _mm512_unpackhi_epi64(p[6], p[7]);
  __m512i b0 = _mm512_shuffle_i64x2(a0, a2, 0x88);
  __m512i b1 = _mm512_shuffle_i64x2(a0, a2, 0xDD);
  __m512i b2 = _mm512_shuffle_i64x2(a1, a3, 0x88);
  __m512i b3 = _mm512_shuffle_i64x2(a1, a3, 0xDD);
  __m512i b4 = _mm512_shuffle_i64x2(a4, a6, 0x88);
  __m512i b5 = _mm512_shuffle_i64x2(a4, a6, 0xDD);
  __m512i b6 = _mm512_shuffle_i64x2(a5, a7, 0x88);
  __m512i b7 = _mm512_shuffle_i64x2(a5, a7, 0xDD);
  __m512i w[8];
  w[0] = _mm512_shuffle_i64x2(b0, b4, 0x88);
  w[4] = _mm512_shuffle_i64x2(b0, b4, 0xDD);
  w[1] = _mm512_shuffle_i64x2(b2, b6, 0x88);
  w[5] = _mm512_shuffle_i64x2(b2, b6, 0xDD);
  w[2] = _mm512_shuffle_i64x2(b1, b5, 0x88);
  w[6] = _mm512_shuffle_i64x2(b1, b5, 0xDD);
  w[3] = _mm512_shuffle_i64x2(b3, b7, 0x88);
  w[7] = _mm512_shuffle_i64x2(b3, b7, 0xDD);
  for (int g = 0; g < 8; g++) {
    __m512i v = _mm512_permutexvar_epi8(gather, w[g]);
    v = _mm512_gf2p8affine_epi64_epi8(ident, _mm512_shuffle_epi8(v, rev8), 0);
    _mm512_storeu_si512(dst + 64 * g, v);
  }
}

__attribute__((target("avx512f"))) static void xs_xor_op_avx512(
    uint8_t* dst, const uint8_t* const* srcs, int nsrc, uint64_t nb) {
  uint64_t i = 0;
  for (; i + 128 <= nb; i += 128) {
    __m512i a0 = _mm512_loadu_si512(srcs[0] + i);
    __m512i a1 = _mm512_loadu_si512(srcs[0] + i + 64);
    for (int s = 1; s < nsrc; s++) {
      a0 = _mm512_xor_si512(a0, _mm512_loadu_si512(srcs[s] + i));
      a1 = _mm512_xor_si512(a1, _mm512_loadu_si512(srcs[s] + i + 64));
    }
    _mm512_storeu_si512(dst + i, a0);
    _mm512_storeu_si512(dst + i + 64, a1);
  }
  for (; i + 64 <= nb; i += 64) {
    __m512i a0 = _mm512_loadu_si512(srcs[0] + i);
    for (int s = 1; s < nsrc; s++)
      a0 = _mm512_xor_si512(a0, _mm512_loadu_si512(srcs[s] + i));
    _mm512_storeu_si512(dst + i, a0);
  }
  for (; i < nb; i++) {
    uint8_t v = srcs[0][i];
    for (int s = 1; s < nsrc; s++) v ^= srcs[s][i];
    dst[i] = v;
  }
}

#endif  // __x86_64__

// 0 = scalar, 1 = AVX2, 2 = GFNI+AVX-512 (what the executor will use here)
int weedtpu_torch_xorsched_level() {
#if defined(__x86_64__)
  if (__builtin_cpu_supports("gfni") && __builtin_cpu_supports("avx512f") &&
      __builtin_cpu_supports("avx512bw") && __builtin_cpu_supports("avx512vbmi"))
    return 2;
  if (__builtin_cpu_supports("avx2")) return 1;
#endif
  return 0;
}

// One compiled schedule bound to its shard set — the unit the tile runner
// executes.  A single-matrix apply is one block; a block-diagonal fused
// decode is many, each owning a disjoint output range.
struct XsBlock {
  const int32_t* sched;
  uint64_t sched_words;
  uint32_t in_shards;
  uint32_t out_base;
  uint32_t out_shards;
  const uint8_t* const* ins;
  uint8_t* const* outs;
  uint64_t len;
};

// Validate one op stream so a malformed schedule cannot scribble outside
// the slot frame.  Returns the stream's max nsrc, or -1 on a bad stream.
static int32_t xs_validate(const int32_t* sched, uint64_t sched_words,
                           uint32_t n_slots) {
  int32_t max_nsrc = 1;
  for (uint64_t k = 0; k < sched_words;) {
    if (k + 2 > sched_words) return -1;
    int32_t dest = sched[k], nsrc = sched[k + 1];
    if (dest < 0 || (uint32_t)dest >= n_slots || nsrc < 0) return -1;
    if (nsrc > max_nsrc) max_nsrc = nsrc;
    k += 2;
    if (k + (uint64_t)nsrc > sched_words) return -1;
    for (int32_t s = 0; s < nsrc; s++)
      if (sched[k + s] < 0 || (uint32_t)sched[k + s] >= n_slots) return -1;
    k += nsrc;
  }
  return max_nsrc;
}

// Run width tiles [t0, t1) of one block: forward transpose -> XOR replay ->
// backward transpose, all inside the caller's scratch slot frame.  Tiles
// are independent (each covers a disjoint byte range of every shard), so
// disjoint tile ranges of the same block may run on different threads.
static void xs_run_tiles(const XsBlock& b, uint64_t tile_sym, uint64_t plane_b,
                         int level, uint8_t* scratch, const uint8_t** srcs,
                         uint64_t t0, uint64_t t1) {
  for (uint64_t ti = t0; ti < t1; ti++) {
    const uint64_t off = ti * tile_sym;
    const uint64_t w = std::min(tile_sym, b.len - off);
    const uint64_t pw = (w + 7) / 8;
    // forward transpose: shard bytes -> packed bit-planes
    for (uint32_t c = 0; c < b.in_shards; c++) {
      const uint8_t* src = b.ins[c] + off;
      uint8_t* pl[8];
      for (int i = 0; i < 8; i++) pl[i] = scratch + ((uint64_t)c * 8 + i) * plane_b;
      uint64_t s = 0;
#if defined(__x86_64__)
      if (level == 2) {
        const uint64_t w512 = w / 512 * 512;
        for (; s < w512; s += 512) xs_fwd512_gfni(src + s, pl, s / 8);
      } else if (level == 1) {
        const uint64_t w32 = w / 32 * 32;
        for (; s < w32; s += 32) xs_fwd32_avx2(src + s, pl, s / 32);
      }
#endif
      for (; s < w; s += 8) {
        uint64_t x = 0;
        const uint64_t n = std::min<uint64_t>(8, w - s);
        memcpy(&x, src + s, n);
        const uint64_t y = xs_t8(x);
        for (int i = 0; i < 8; i++) pl[i][s / 8] = (uint8_t)(y >> (8 * i));
      }
    }
    // replay the XOR program over this tile's planes
    for (uint64_t k = 0; k < b.sched_words;) {
      const int32_t dest = b.sched[k], nsrc = b.sched[k + 1];
      k += 2;
      uint8_t* d = scratch + (uint64_t)dest * plane_b;
      if (nsrc == 0) {
        memset(d, 0, pw);
        continue;
      }
      for (int32_t j = 0; j < nsrc; j++)
        srcs[(size_t)j] = scratch + (uint64_t)b.sched[k + j] * plane_b;
      k += nsrc;
#if defined(__x86_64__)
      if (level == 2) xs_xor_op_avx512(d, srcs, nsrc, pw);
      else if (level == 1) xs_xor_op_avx2(d, srcs, nsrc, pw);
      else xs_xor_op_scalar(d, srcs, nsrc, pw);
#else
      xs_xor_op_scalar(d, srcs, nsrc, pw);
#endif
    }
    // backward transpose: output planes -> shard bytes
    for (uint32_t r = 0; r < b.out_shards; r++) {
      uint8_t* dst = b.outs[r] + off;
      uint8_t* pl[8];
      for (int i = 0; i < 8; i++)
        pl[i] = scratch + ((uint64_t)b.out_base + (uint64_t)r * 8 + i) * plane_b;
      uint64_t s = 0;
#if defined(__x86_64__)
      if (level == 2) {
        const uint64_t w512 = w / 512 * 512;
        for (; s < w512; s += 512) xs_bwd512_gfni(pl, s / 8, dst + s);
      } else if (level == 1) {
        const uint64_t w32 = w / 32 * 32;
        for (; s < w32; s += 32) xs_bwd32_avx2(pl, s / 32, dst + s);
      }
#endif
      for (; s < w; s += 8) {
        uint64_t y = 0;
        for (int i = 0; i < 8; i++) y |= (uint64_t)pl[i][s / 8] << (8 * i);
        const uint64_t x = xs_t8(y);
        const uint64_t n = std::min<uint64_t>(8, w - s);
        memcpy(dst + s, &x, n);
      }
    }
  }
}

// Replay a compiled XOR schedule.  sched: flat [dest, nsrc, srcs...] int32
// records (sched_words total); slots [0, in_planes) are input planes,
// [out_base, out_base+out_planes) output planes; ins/outs hold in_planes/8
// and out_planes/8 shard pointers of `len` bytes; tile_sym is the per-shard
// tile width (multiple of 512).  Returns 1 on success, 0 on invalid args.
int weedtpu_torch_xor_schedule_apply(const int32_t* sched, uint64_t sched_words,
                               uint32_t n_slots, uint32_t in_planes,
                               uint32_t out_base, uint32_t out_planes,
                               const uint8_t* const* ins, uint8_t* const* outs,
                               uint64_t len, uint64_t tile_sym) {
  if (!sched || !ins || !outs || n_slots == 0 || (in_planes % 8) ||
      (out_planes % 8) || tile_sym < 512 || (tile_sym % 512) ||
      out_base + out_planes > n_slots || in_planes > n_slots)
    return 0;
  const int32_t max_nsrc = xs_validate(sched, sched_words, n_slots);
  if (max_nsrc < 0) return 0;
  const uint64_t plane_b = tile_sym / 8;
  uint8_t* scratch = (uint8_t*)aligned_alloc(64, (size_t)n_slots * plane_b);
  if (!scratch) return 0;
  std::vector<const uint8_t*> srcs((size_t)max_nsrc);
  const XsBlock b = {sched, sched_words, in_planes / 8, out_base,
                     out_planes / 8, ins, outs, len};
  xs_run_tiles(b, tile_sym, plane_b, weedtpu_torch_xorsched_level(), scratch,
               srcs.data(), 0, (len + tile_sym - 1) / tile_sym);
  free(scratch);
  return 1;
}

// Block-diagonal, width-parallel schedule replay: `n_blocks` compiled
// schedules, each bound to its own shard pointers and byte length, run as
// ONE flat (block, tile) task list across a thread pool.  Parallel arrays
// describe the blocks; sched_off/ins_off/outs_off index into the
// concatenated op-word / input-pointer / output-pointer arrays.  All
// blocks share `tile_sym` (one slot-frame geometry, one scratch size).
// threads = 0 means hardware concurrency; the pool is clamped to the
// task count and to a ~256 KiB-per-worker usefulness floor, like
// weedtpu_torch_gf_matrix_apply_mt.  Tiles never share output bytes, so no
// synchronization beyond the final join is needed.  Returns 1 on
// success, 0 on invalid args.
int weedtpu_torch_xor_schedule_apply_blocks(
    const int32_t* sched, const uint64_t* sched_off, const uint64_t* sched_words,
    const uint32_t* n_slots, const uint32_t* in_planes, const uint32_t* out_base,
    const uint32_t* out_planes, const uint8_t* const* ins,
    const uint64_t* ins_off, uint8_t* const* outs, const uint64_t* outs_off,
    const uint64_t* lens, uint32_t n_blocks, uint64_t tile_sym,
    uint32_t threads) {
  if (!sched || !sched_off || !sched_words || !n_slots || !in_planes ||
      !out_base || !out_planes || !ins || !ins_off || !outs || !outs_off ||
      !lens || n_blocks == 0 || tile_sym < 512 || (tile_sym % 512))
    return 0;
  std::vector<XsBlock> blocks((size_t)n_blocks);
  uint32_t max_slots = 0;
  int32_t max_nsrc = 1;
  uint64_t total_bytes = 0;
  // (block, first tile) prefix so tasks flatten to one atomic counter
  std::vector<uint64_t> tile_base((size_t)n_blocks + 1, 0);
  for (uint32_t g = 0; g < n_blocks; g++) {
    if (n_slots[g] == 0 || (in_planes[g] % 8) || (out_planes[g] % 8) ||
        out_base[g] + out_planes[g] > n_slots[g] || in_planes[g] > n_slots[g])
      return 0;
    const int32_t mn = xs_validate(sched + sched_off[g], sched_words[g],
                                   n_slots[g]);
    if (mn < 0) return 0;
    if (mn > max_nsrc) max_nsrc = mn;
    if (n_slots[g] > max_slots) max_slots = n_slots[g];
    blocks[g] = {sched + sched_off[g], sched_words[g], in_planes[g] / 8,
                 out_base[g], out_planes[g] / 8, ins + ins_off[g],
                 outs + outs_off[g], lens[g]};
    tile_base[g + 1] = tile_base[g] + (lens[g] + tile_sym - 1) / tile_sym;
    total_bytes += (uint64_t)(in_planes[g] / 8) * lens[g];
  }
  const uint64_t n_tasks = tile_base[n_blocks];
  if (n_tasks == 0) return 1;  // every block empty: vacuous success
  if (threads == 0) {
    unsigned hw = std::thread::hardware_concurrency();
    threads = hw ? hw : 1;
  }
  // below ~256 KiB per worker, spawn overhead beats the parallel win
  uint64_t max_useful = total_bytes / (256 * 1024);
  if (max_useful < threads) threads = (uint32_t)std::max<uint64_t>(1, max_useful);
  if (threads > n_tasks) threads = (uint32_t)n_tasks;
  const uint64_t plane_b = tile_sym / 8;
  const int level = weedtpu_torch_xorsched_level();
  std::atomic<uint64_t> next{0};
  std::atomic<int> oom{0};
  auto worker = [&]() {
    uint8_t* scratch = (uint8_t*)aligned_alloc(64, (size_t)max_slots * plane_b);
    if (!scratch) {
      oom.store(1);
      return;
    }
    std::vector<const uint8_t*> srcs((size_t)max_nsrc);
    uint32_t g = 0;
    for (;;) {
      const uint64_t t = next.fetch_add(1);
      if (t >= n_tasks) break;
      while (t >= tile_base[g + 1]) g++;  // task ids ascend per worker
      while (t < tile_base[g]) g--;       // (other workers may skip g ahead)
      xs_run_tiles(blocks[g], tile_sym, plane_b, level, scratch, srcs.data(),
                   t - tile_base[g], t - tile_base[g] + 1);
    }
    free(scratch);
  };
  if (threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (uint32_t t = 0; t < threads; t++) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return oom.load() ? 0 : 1;
}

}  // extern "C"
