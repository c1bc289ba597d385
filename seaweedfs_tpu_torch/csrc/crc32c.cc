// CRC32C (Castagnoli, reflected polynomial 0x82F63B78), slice-by-8: the
// needle checksum of upstream SeaweedFS. Host code with a plain C
// interface, built by utils/native.py with the host C++ compiler.
#include <cstdint>
#include <cstring>

extern "C" {

static uint32_t crc32c_table[8][256];

// Filled by a static constructor while the library is loaded (one
// thread), so concurrent first calls from ctypes threads see the whole
// table.
static const int crc32c_initialized = [] {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t crc = i;
    for (int j = 0; j < 8; j++) crc = (crc >> 1) ^ (0x82F63B78u & (0u - (crc & 1)));
    crc32c_table[0][i] = crc;
  }
  for (uint32_t i = 0; i < 256; i++)
    for (int s = 1; s < 8; s++)
      crc32c_table[s][i] =
          (crc32c_table[s - 1][i] >> 8) ^ crc32c_table[0][crc32c_table[s - 1][i] & 0xFF];
  return 1;
}();

uint32_t weedtpu_torch_crc32c(uint32_t crc, const uint8_t* buf, uint64_t len) {
  crc = ~crc;
  while (len >= 8) {
    uint64_t word;
    memcpy(&word, buf, 8);
    word ^= crc;  // little-endian hosts only (x86-64, arm64)
    crc = crc32c_table[7][word & 0xFF] ^ crc32c_table[6][(word >> 8) & 0xFF] ^
          crc32c_table[5][(word >> 16) & 0xFF] ^ crc32c_table[4][(word >> 24) & 0xFF] ^
          crc32c_table[3][(word >> 32) & 0xFF] ^ crc32c_table[2][(word >> 40) & 0xFF] ^
          crc32c_table[1][(word >> 48) & 0xFF] ^ crc32c_table[0][(word >> 56) & 0xFF];
    buf += 8;
    len -= 8;
  }
  while (len--) crc = (crc >> 8) ^ crc32c_table[0][(crc ^ *buf++) & 0xFF];
  return ~crc;
}

}  // extern "C"
