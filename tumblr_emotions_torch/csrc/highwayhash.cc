// HighwayHash-64 (Alakuijala, Cox, Wassenberg), the portable scalar form:
// the hash riegeli keeps in every block header and chunk header of a
// records file (ArrayRecord shards are riegeli records files).  Built by
// the host C++ compiler at first use (utils/highwayhash.py) and bound with
// ctypes.
//
// State: four lanes each of v0, v1, mul0, mul1.  Each 32-byte packet is
// added in by Update; a tail of 1..31 bytes is folded into one last packet
// (UpdateRemainder); Finalize64 permutes and updates four more times.
#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

struct State {
  uint64_t v0[4], v1[4], mul0[4], mul1[4];
};

inline uint64_t rot32(uint64_t x) { return (x >> 32) | (x << 32); }

void reset(const uint64_t key[4], State* s) {
  static const uint64_t kMul0[4] = {0xdbe6d5d5fe4cce2full, 0xa4093822299f31d0ull,
                                    0x13198a2e03707344ull, 0x243f6a8885a308d3ull};
  static const uint64_t kMul1[4] = {0x3bd39e10cb0ef593ull, 0xc0acf169b5f18a8cull,
                                    0xbe5466cf34e90c6cull, 0x452821e638d01377ull};
  for (int i = 0; i < 4; ++i) {
    s->mul0[i] = kMul0[i];
    s->mul1[i] = kMul1[i];
    s->v0[i] = kMul0[i] ^ key[i];
    s->v1[i] = kMul1[i] ^ rot32(key[i]);
  }
}

void zipper_merge_and_add(uint64_t v1, uint64_t v0, uint64_t* add1, uint64_t* add0) {
  *add0 += (((v0 & 0xff000000ull) | (v1 & 0xff00000000ull)) >> 24) |
           (((v0 & 0xff0000000000ull) | (v1 & 0xff000000000000ull)) >> 16) |
           (v0 & 0xff0000ull) | ((v0 & 0xff00ull) << 32) |
           ((v1 & 0xff00000000000000ull) >> 8) | (v0 << 56);
  *add1 += (((v1 & 0xff000000ull) | (v0 & 0xff00000000ull)) >> 24) |
           (v1 & 0xff0000ull) | ((v1 & 0xff0000000000ull) >> 16) |
           ((v1 & 0xff00ull) << 24) | ((v0 & 0xff000000000000ull) >> 8) |
           ((v1 & 0xffull) << 48) | (v0 & 0xff00000000000000ull);
}

void update(const uint64_t lanes[4], State* s) {
  for (int i = 0; i < 4; ++i) {
    s->v1[i] += s->mul0[i] + lanes[i];
    s->mul0[i] ^= (s->v1[i] & 0xffffffffull) * (s->v0[i] >> 32);
    s->v0[i] += s->mul1[i];
    s->mul1[i] ^= (s->v0[i] & 0xffffffffull) * (s->v1[i] >> 32);
  }
  zipper_merge_and_add(s->v1[1], s->v1[0], &s->v0[1], &s->v0[0]);
  zipper_merge_and_add(s->v1[3], s->v1[2], &s->v0[3], &s->v0[2]);
  zipper_merge_and_add(s->v0[1], s->v0[0], &s->v1[1], &s->v1[0]);
  zipper_merge_and_add(s->v0[3], s->v0[2], &s->v1[3], &s->v1[2]);
}

inline uint64_t read64(const uint8_t* p) {
  uint64_t x = 0;
  for (int i = 7; i >= 0; --i) x = (x << 8) | p[i];  // little-endian on any host
  return x;
}

void update_packet(const uint8_t* packet, State* s) {
  const uint64_t lanes[4] = {read64(packet), read64(packet + 8), read64(packet + 16),
                             read64(packet + 24)};
  update(lanes, s);
}

// Rotates each 32-bit half of each lane left by count (1..31).
void rotate32_by(uint64_t count, uint64_t lanes[4]) {
  for (int i = 0; i < 4; ++i) {
    const uint32_t half0 = static_cast<uint32_t>(lanes[i]);
    const uint32_t half1 = static_cast<uint32_t>(lanes[i] >> 32);
    lanes[i] = static_cast<uint32_t>((half0 << count) | (half0 >> (32 - count)));
    lanes[i] |= static_cast<uint64_t>(static_cast<uint32_t>((half1 << count) |
                                                            (half1 >> (32 - count))))
                << 32;
  }
}

void update_remainder(const uint8_t* bytes, size_t size_mod32, State* s) {
  const size_t size_mod4 = size_mod32 & 3;
  const uint8_t* remainder = bytes + (size_mod32 & ~size_t{3});
  uint8_t packet[32] = {0};
  for (int i = 0; i < 4; ++i) s->v0[i] += (static_cast<uint64_t>(size_mod32) << 32) + size_mod32;
  rotate32_by(size_mod32, s->v1);
  std::memcpy(packet, bytes, static_cast<size_t>(remainder - bytes));
  if (size_mod32 & 16) {
    for (int i = 0; i < 4; ++i) packet[28 + i] = remainder[i + size_mod4 - 4];
  } else if (size_mod4) {
    packet[16 + 0] = remainder[0];
    packet[16 + 1] = remainder[size_mod4 >> 1];
    packet[16 + 2] = remainder[size_mod4 - 1];
  }
  update_packet(packet, s);
}

uint64_t finalize64(State* s) {
  for (int n = 0; n < 4; ++n) {
    const uint64_t permuted[4] = {rot32(s->v0[2]), rot32(s->v0[3]), rot32(s->v0[0]),
                                  rot32(s->v0[1])};
    update(permuted, s);
  }
  return s->v0[0] + s->v1[0] + s->mul0[0] + s->mul1[0];
}

}  // namespace

extern "C" {

uint64_t highwayhash64(const uint64_t* key, const uint8_t* data, size_t size) {
  State s;
  reset(key, &s);
  size_t i = 0;
  for (; i + 32 <= size; i += 32) update_packet(data + i, &s);
  if (size & 31) update_remainder(data + i, size & 31, &s);
  return finalize64(&s);
}

}  // extern "C"
