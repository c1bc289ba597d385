// Standalone sanitizer driver for the threaded entry points of gf_host.cc:
// the XOR-schedule executor's tile pool
// (weedtpu_torch_xor_schedule_apply_blocks) and the split-table
// multiply-accumulate's two pools (weedtpu_torch_gf_matrix_apply_mt and
// weedtpu_torch_gf_matrix_apply_batch, which the "native" backend calls
// from ctypes threads with the interpreter lock released).
//
// Loading a sanitizer-instrumented library into an uninstrumented Python
// would need the sanitizer runtime preloaded into the interpreter, so the
// coverage runs as this binary, linked with gf_host.cc under
// -fsanitize=thread or -fsanitize=address (ops/host_sanitizer.py builds
// both). Arguments are the thread counts to exercise (default 1 2 4 8).
// Exit 0 = clean; the sanitizer runtime exits nonzero on any report, and
// the driver itself exits nonzero when a parallel result drifts from its
// oracle.
//
// XOR schedule: the geometry of the reference's native/xs_tsan_driver.cc.
// Two blocks with different non-tile-aligned lengths exercise the
// block-diagonal task walk; lengths are sized so total bytes clear the
// executor's ~256 KiB-per-worker clamp at 8 threads (smaller inputs would
// silently collapse every run to one worker and race-check nothing).
// 4 input shards -> planes [0,32), one temp shard -> planes [32,40), 2
// output shards at out_base=40. Per bit i: temp = in0 ^ in2,
// out0 = in0^in1^in2^in3, out1 = temp ^ in1. Uniform shard-level ops make
// the bit-plane program equal a plain byte-wise XOR, which is the oracle.
//
// GF apply: a seeded (4 x 10) matrix; the oracle is the single-thread
// weedtpu_torch_gf_matrix_apply. The _mt length (2 MiB + 4099) and the
// _batch geometry (8 stacks of 64 KiB + 37) clear each function's
// ~256 KiB-per-worker clamp at 8 threads, so every worker really runs,
// and the batch never exceeds its stack count (which would hand it to _mt).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" int weedtpu_torch_xor_schedule_apply_blocks(
    const int32_t* sched, const uint64_t* sched_off, const uint64_t* sched_words,
    const uint32_t* n_slots, const uint32_t* in_planes, const uint32_t* out_base,
    const uint32_t* out_planes, const uint8_t* const* ins,
    const uint64_t* ins_off, uint8_t* const* outs, const uint64_t* outs_off,
    const uint64_t* lens, uint32_t n_blocks, uint64_t tile_sym,
    uint32_t threads);
extern "C" void weedtpu_torch_gf_matrix_apply(
    const uint8_t* matrix, uint32_t rows, uint32_t cols,
    const uint8_t* const* inputs, uint8_t* const* outputs, uint64_t len);
extern "C" void weedtpu_torch_gf_matrix_apply_mt(
    const uint8_t* matrix, uint32_t rows, uint32_t cols,
    const uint8_t* const* inputs, uint8_t* const* outputs, uint64_t len,
    uint32_t threads);
extern "C" void weedtpu_torch_gf_matrix_apply_batch(
    const uint8_t* matrix, uint32_t rows, uint32_t cols,
    const uint8_t* const* inputs, uint8_t* const* outputs, uint64_t len,
    uint32_t batch, uint32_t threads);

static const int K = 4;  // input shards per XOR block
static const int R = 2;  // output shards per XOR block
static const uint32_t GF_ROWS = 4, GF_COLS = 10;
static const uint64_t MT_LEN = (2u << 20) + 4099;
static const uint32_t BATCH = 8;
static const uint64_t BATCH_LEN = (64u << 10) + 37;

typedef std::vector<std::vector<uint8_t>> Slices;

static uint32_t lcg(uint32_t* s) {  // deterministic, no libc rand
  *s = *s * 1664525u + 1013904223u;
  return *s >> 24;
}

static Slices seeded(size_t n, uint64_t len, uint32_t seed) {
  Slices out(n, std::vector<uint8_t>(len));
  uint32_t s = seed;
  for (auto& v : out)
    for (uint64_t i = 0; i < len; i++) v[i] = (uint8_t)lcg(&s);
  return out;
}

struct Block {
  Slices ins, outs, want;
  uint64_t len;
};

static Block make_block(uint64_t len, uint32_t seed) {
  Block b;
  b.len = len;
  b.ins = seeded(K, len, seed);
  b.outs.assign(R, std::vector<uint8_t>(len));
  b.want.assign(R, std::vector<uint8_t>(len));
  for (uint64_t i = 0; i < len; i++) {
    b.want[0][i] = b.ins[0][i] ^ b.ins[1][i] ^ b.ins[2][i] ^ b.ins[3][i];
    b.want[1][i] = b.ins[0][i] ^ b.ins[1][i] ^ b.ins[2][i];
  }
  return b;
}

static int xor_schedule(const std::vector<uint32_t>& counts) {
  std::vector<int32_t> sched;
  for (int i = 0; i < 8; i++) {  // temp = in0 ^ in2
    sched.push_back(32 + i);
    sched.push_back(2);
    sched.push_back(i);
    sched.push_back(16 + i);
  }
  for (int i = 0; i < 8; i++) {  // out0 = in0 ^ in1 ^ in2 ^ in3
    sched.push_back(40 + i);
    sched.push_back(4);
    for (int c = 0; c < K; c++) sched.push_back(c * 8 + i);
  }
  for (int i = 0; i < 8; i++) {  // out1 = temp ^ in1
    sched.push_back(48 + i);
    sched.push_back(2);
    sched.push_back(32 + i);
    sched.push_back(8 + i);
  }

  Block blocks[2] = {
      make_block(400 * 512 + 137, 1u),  // odd tail tile
      make_block(700 * 512 + 1, 2u),
  };

  uint64_t sched_words[2] = {sched.size(), sched.size()};
  uint64_t sched_off[2] = {0, 0};  // both blocks share one program
  uint32_t n_slots[2] = {56, 56}, in_planes[2] = {32, 32};
  uint32_t out_base[2] = {40, 40}, out_planes[2] = {16, 16};
  uint64_t lens[2] = {blocks[0].len, blocks[1].len};
  const uint8_t* ins[2 * K];
  uint8_t* outs[2 * R];
  uint64_t ins_off[2] = {0, K}, outs_off[2] = {0, R};
  for (int g = 0; g < 2; g++) {
    for (int c = 0; c < K; c++) ins[g * K + c] = blocks[g].ins[c].data();
    for (int r = 0; r < R; r++) outs[g * R + r] = blocks[g].outs[r].data();
  }

  for (uint32_t t : counts) {
    for (int iter = 0; iter < 3; iter++) {
      for (int g = 0; g < 2; g++)
        for (int r = 0; r < R; r++)
          memset(blocks[g].outs[r].data(), 0xAA, blocks[g].len);
      int rc = weedtpu_torch_xor_schedule_apply_blocks(
          sched.data(), sched_off, sched_words, n_slots, in_planes, out_base,
          out_planes, ins, ins_off, outs, outs_off, lens, 2, 512, t);
      if (!rc) {
        fprintf(stderr, "apply_blocks rejected args (threads=%u)\n", t);
        return 4;
      }
      for (int g = 0; g < 2; g++)
        for (int r = 0; r < R; r++)
          if (memcmp(blocks[g].outs[r].data(), blocks[g].want[r].data(),
                     blocks[g].len) != 0) {
            fprintf(stderr,
                    "block %d out %d drifts from XOR oracle (threads=%u)\n",
                    g, r, t);
            return 2;
          }
    }
    printf("threads=%u ok\n", t);
  }
  return 0;
}

// `stacks` stacks of GF_COLS input slices of `len` bytes: the pointer
// arrays the batch entry point takes, and the single-thread oracle's
// outputs for each stack.
struct GfCase {
  Slices ins, outs, want;
  std::vector<const uint8_t*> in_ptrs;
  std::vector<uint8_t*> out_ptrs;
  uint64_t len;
};

static GfCase make_gf(const uint8_t* matrix, uint32_t stacks, uint64_t len,
                      uint32_t seed) {
  GfCase c;
  c.len = len;
  c.ins = seeded((size_t)stacks * GF_COLS, len, seed);
  c.outs.assign((size_t)stacks * GF_ROWS, std::vector<uint8_t>(len));
  c.want.assign((size_t)stacks * GF_ROWS, std::vector<uint8_t>(len));
  for (auto& v : c.ins) c.in_ptrs.push_back(v.data());
  for (auto& v : c.outs) c.out_ptrs.push_back(v.data());
  std::vector<uint8_t*> want_ptrs;
  for (auto& v : c.want) want_ptrs.push_back(v.data());
  for (uint32_t b = 0; b < stacks; b++)
    weedtpu_torch_gf_matrix_apply(matrix, GF_ROWS, GF_COLS,
                                  c.in_ptrs.data() + b * GF_COLS,
                                  want_ptrs.data() + b * GF_ROWS, len);
  return c;
}

static bool gf_drifts(GfCase& c) {
  for (size_t r = 0; r < c.outs.size(); r++)
    if (memcmp(c.outs[r].data(), c.want[r].data(), c.len) != 0) return true;
  return false;
}

static int gf_apply(const std::vector<uint32_t>& counts) {
  uint32_t s = 7u;
  uint8_t matrix[GF_ROWS * GF_COLS];
  for (auto& m : matrix) m = (uint8_t)lcg(&s);
  GfCase mt = make_gf(matrix, 1, MT_LEN, 3u);
  GfCase batch = make_gf(matrix, BATCH, BATCH_LEN, 4u);
  for (uint32_t t : counts) {
    for (int iter = 0; iter < 3; iter++) {
      for (auto& v : mt.outs) memset(v.data(), 0xAA, v.size());
      weedtpu_torch_gf_matrix_apply_mt(matrix, GF_ROWS, GF_COLS,
                                       mt.in_ptrs.data(), mt.out_ptrs.data(),
                                       mt.len, t);
      if (gf_drifts(mt)) {
        fprintf(stderr, "gf_matrix_apply_mt drifts from one thread (threads=%u)\n", t);
        return 3;
      }
    }
    printf("gf_matrix_apply_mt threads=%u ok\n", t);
  }
  for (uint32_t t : counts) {
    for (int iter = 0; iter < 3; iter++) {
      for (auto& v : batch.outs) memset(v.data(), 0xAA, v.size());
      weedtpu_torch_gf_matrix_apply_batch(matrix, GF_ROWS, GF_COLS,
                                          batch.in_ptrs.data(),
                                          batch.out_ptrs.data(), batch.len,
                                          BATCH, t);
      if (gf_drifts(batch)) {
        fprintf(stderr, "gf_matrix_apply_batch drifts from one thread (threads=%u)\n", t);
        return 3;
      }
    }
    printf("gf_matrix_apply_batch threads=%u ok\n", t);
  }
  return 0;
}

int main(int argc, char** argv) {
  std::vector<uint32_t> counts;
  for (int a = 1; a < argc; a++) counts.push_back((uint32_t)atoi(argv[a]));
  if (counts.empty()) counts = {1, 2, 4, 8};
  int rc = xor_schedule(counts);
  if (rc == 0) rc = gf_apply(counts);
  if (rc != 0) return rc;
  puts("xs sanitizer driver: all clean");
  return 0;
}
