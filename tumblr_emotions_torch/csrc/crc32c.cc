// CRC-32C (Castagnoli, reflected polynomial 0x82F63B78): the checksum of
// TFRecord framing, of the blocks of TF's table files and of the tensors of
// a TF tensor bundle.  Built by the host C++ compiler at first use
// (utils/crc32c.py) and bound with ctypes.
//
// The SSE4.2 crc32 instruction computes exactly this polynomial; where the
// CPU lacks it, a slicing-by-8 table loop does the same work.
#include <cstddef>
#include <cstdint>
#include <cstring>

#if defined(__x86_64__)
#include <nmmintrin.h>
#endif

namespace {

struct Tables {
  uint32_t t[8][256];
  Tables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1u)));
      t[0][i] = c;
    }
    for (int k = 1; k < 8; ++k)
      for (int i = 0; i < 256; ++i) t[k][i] = (t[k - 1][i] >> 8) ^ t[0][t[k - 1][i] & 0xFF];
  }
};
const Tables tables;

// crc is the running register (already inverted).
uint32_t crc_tables(uint32_t crc, const uint8_t* p, size_t n) {
  const auto& t = tables.t;
  while (n >= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, p, 4);
    std::memcpy(&hi, p + 4, 4);
    lo ^= crc;
    crc = t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF] ^ t[4][lo >> 24] ^
          t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF] ^ t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ t[0][(crc ^ *p++) & 0xFF];
  return crc;
}

#if defined(__x86_64__)
__attribute__((target("sse4.2"))) uint32_t crc_sse42(uint32_t crc, const uint8_t* p, size_t n) {
  uint64_t c = crc;
  while (n >= 8) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    c = _mm_crc32_u64(c, v);
    p += 8;
    n -= 8;
  }
  uint32_t c32 = static_cast<uint32_t>(c);
  while (n--) c32 = _mm_crc32_u8(c32, *p++);
  return c32;
}

bool has_sse42() {
  static const bool yes = __builtin_cpu_supports("sse4.2");
  return yes;
}
#endif

}  // namespace

extern "C" {

// The CRC-32C of data[0:n] continued from `crc`, the CRC-32C of the bytes
// before it (0 for none): crc32c_extend(crc32c(a), b) == crc32c(a + b).
uint32_t crc32c_extend(uint32_t crc, const void* data, size_t n) {
  const auto* p = static_cast<const uint8_t*>(data);
  crc = ~crc;
#if defined(__x86_64__)
  if (has_sse42()) return ~crc_sse42(crc, p, n);
#endif
  return ~crc_tables(crc, p, n);
}

// 1 when crc32c_extend runs on the SSE4.2 instruction, else 0.
int crc32c_hardware(void) {
#if defined(__x86_64__)
  return has_sse42() ? 1 : 0;
#else
  return 0;
#endif
}

// The table loop alone, so the two paths can be held against each other.
uint32_t crc32c_extend_tables(uint32_t crc, const void* data, size_t n) {
  return ~crc_tables(~crc, static_cast<const uint8_t*>(data), n);
}
}
