// JPEG decoder and PIL-bilinear resize for the port's host data path.
//
// Self-contained C++ (no libjpeg underneath) with a plain C ABI bound by
// ctypes from data/jpeg.py.  It decodes what libjpeg-turbo 2.1.5 (x86-64,
// with its SIMD code) decodes, to the same bytes, and refuses what that
// library refuses.  It follows the library's code path by path:
//
//   * the memory source (jdatasrc.c): past the end of the data every refill
//     is a fake EOI, so the stream goes on as FF D9 FF D9 ...;
//   * markers as jdmarker.c reads them: SOI, APPn (JFIF and Adobe are read,
//     the rest skipped), COM, DQT, DHT, DAC, DRI, SOF0/1/2/9/10, SOS, RSTn,
//     DNL, EOI; bytes before a marker are skipped ("extraneous data");
//   * Huffman decoding, sequential (jdhuff.c: its fast path and the slow
//     path it falls back to; a missing table 0 or 1 is the standard one) and
//     progressive (jdphuff.c), with libjpeg's warn-and-go-on: entropy data
//     that runs into a marker is padded with zero bits and the MCUs after it
//     in its restart interval are skipped; a bad code decodes as 0; a
//     missing or wrong restart marker is resynchronised as
//     jpeg_resync_to_restart does;
//   * arithmetic decoding (jdarith.c), sequential and progressive, with DAC
//     conditioning and restarts; a bad code leaves the rest of its segment
//     as it stands;
//   * one scan holding every component is decoded alone (a second SOS is an
//     error); otherwise every scan up to EOI is read, and a progressive
//     image that lacks some coefficients is block-smoothed as jdcoefct.c's
//     decompress_smooth_data does (2.1's 5x5 kernels);
//   * the three IDCTs as the library's SIMD code computes them: islow
//     (jidctint-avx2: 16-bit dequantization, 32-bit products, passes
//     saturated to 16 bits), ifast (jidctfst-sse2: 16-bit AA&N with pmulhw
//     constants) and float (jidctflt-sse2: single-precision AA&N, rounded by
//     adding a magic number); each output saturates to 0..255;
//   * DCT-domain scaling to scale_num/8 (jdmaster.c): the output is
//     ceil(size * scale_num / 8); each component's IDCT is scale_num samples
//     wide, doubled while its sampling factors let the IDCT do the
//     upsampling's work (4:2:0 chroma at 2 * scale_num); an IDCT of other
//     than 8x8 reads the raw quantizers and is jidctred.c's 1x1, the SSE2
//     2x2 and 4x4 (jidctred-sse2: 16-bit dequantization, 32-bit sums, the
//     first pass saturated to 16 bits) or jidctint.c's 3x3 to 7x7, 10x10,
//     12x12 and 14x14 (64-bit sums, a 32-bit work array);
//   * upsampling as jdsample.c: fancy h2v1, h1v2 and h2v2 (the triangle
//     filters, edge rows replicated as jdmainct.c does), replication for
//     every other integral factor and for components 2 samples wide or less;
//     chosen from the ratio of each component's scaled size to the output's,
//     and never fancy at scale_num 1;
//   * YCbCr->RGB with the fixed-point tables of jdcolor.c; RGB copied;
//     grayscale replicated to RGB.
//
// It refuses, with an error message, what libjpeg-turbo 2.1.5 refuses:
// samples of other than 8 bits, lossless and hierarchical JPEG, colour
// spaces with no conversion to RGB (CMYK, YCCK, 2 or 4+ components),
// fractional sampling factors, and every fatal error of the library (bad
// marker lengths, missing tables, bad progression parameters, a cut inside
// the headers...).  It also refuses images of more than 2^28 pixels.
// The float IDCT must be built without contracting products and sums into
// FMAs (-ffp-contract=off).
//
// resize_bilinear is Pillow's ImagingResample with the BILINEAR filter on an
// 8-bit RGB image (Resample.c): coefficients in double, normalised, then 22
// fractional bits; a horizontal pass then a vertical pass, each rounded and
// clipped to uint8.
//
// Entry points return 0 on success or write a message into err[errlen] and
// return nonzero.  Batch entry points run a per-call std::thread pool.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <new>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw Error(msg); }

// Images with more pixels are refused before any allocation: a corrupt
// header must not make the process allocate gigabytes.
constexpr long long kMaxPixels = 1LL << 28;
constexpr int kMaxDimension = 65500;  // JPEG_MAX_DIMENSION
constexpr int kMaxComponents = 10;    // MAX_COMPONENTS
constexpr int kMaxBlocksInMcu = 10;   // D_MAX_BLOCKS_IN_MCU

enum Dct { kIslow = 0, kIfast = 1, kFloat = 2 };

// jpeg_natural_order, with 16 extra entries so a corrupt run cannot index
// past the block (as libjpeg pads it).
constexpr int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ---------------------------------------------------------------------------
// The memory source (jdatasrc.c)
// ---------------------------------------------------------------------------

struct Source {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;

  // Past the end, fill_mem_input_buffer hands out FF D9 on every refill.
  int at(size_t p) const { return p < size ? data[p] : (((p - size) & 1) ? 0xD9 : 0xFF); }
  int byte() { return at(pos++); }
  void skip(long n) {
    if (n > 0) pos += static_cast<size_t>(n);
  }
  size_t bytes_in_buffer() const { return pos < size ? size - pos : 0; }
};

// ---------------------------------------------------------------------------
// Huffman tables (jpeg_make_d_derived_tbl, jstdhuff.c)
// ---------------------------------------------------------------------------

constexpr int kLookahead = 8;  // HUFF_LOOKAHEAD

struct HuffTable {  // JHUFF_TBL
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
};

struct Derived {  // d_derived_tbl
  int32_t maxcode[18];
  int32_t valoffset[18];
  int lookup[1 << kLookahead];
  const uint8_t* vals;
};

void derive(const HuffTable& t, bool is_dc, Derived& d) {
  if (!t.defined) fail("corrupt JPEG: missing Huffman table");
  int huffsize[257];
  uint32_t huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; l++) {
    int i = t.bits[l];
    if (p + i > 256) fail("corrupt JPEG: bad Huffman table");
    while (i--) huffsize[p++] = l;
  }
  huffsize[p] = 0;
  const int numsymbols = p;
  uint32_t code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) {
      huffcode[p++] = code;
      code++;
    }
    if (static_cast<int64_t>(code) >= (int64_t{1} << si)) fail("corrupt JPEG: bad Huffman table");
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (t.bits[l]) {
      d.valoffset[l] = p - static_cast<int32_t>(huffcode[p]);
      p += t.bits[l];
      d.maxcode[l] = static_cast<int32_t>(huffcode[p - 1]);
    } else {
      d.maxcode[l] = -1;
    }
  }
  d.valoffset[17] = 0;
  d.maxcode[17] = 0xFFFFF;
  for (int i = 0; i < (1 << kLookahead); i++) d.lookup[i] = (kLookahead + 1) << kLookahead;
  p = 0;
  for (int l = 1; l <= kLookahead; l++) {
    for (int i = 1; i <= t.bits[l]; i++, p++) {
      int lookbits = static_cast<int>(huffcode[p]) << (kLookahead - l);
      for (int ctr = 1 << (kLookahead - l); ctr > 0; ctr--)
        d.lookup[lookbits++] = (l << kLookahead) | t.vals[p];
    }
  }
  if (is_dc) {
    for (int i = 0; i < numsymbols; i++)
      if (t.vals[i] > 15) fail("corrupt JPEG: bad DC Huffman table");
  }
  d.vals = t.vals;
}

// The tables of Annex K (std_huff_tables), which the sequential decoder puts
// in slots 0 and 1 when the file defines none there.
constexpr uint8_t kStdBitsDc0[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
constexpr uint8_t kStdBitsDc1[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
constexpr uint8_t kStdBitsAc0[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
constexpr uint8_t kStdBitsAc1[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
constexpr uint8_t kStdValsDc[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
constexpr uint8_t kStdValsAc0[162] = {
    1,   2,   3,   0,   4,   17,  5,   18,  33,  49,  65,  6,   19,  81,  97,  7,   34,  113,
    20,  50,  129, 145, 161, 8,   35,  66,  177, 193, 21,  82,  209, 240, 36,  51,  98,  114,
    130, 9,   10,  22,  23,  24,  25,  26,  37,  38,  39,  40,  41,  42,  52,  53,  54,  55,
    56,  57,  58,  67,  68,  69,  70,  71,  72,  73,  74,  83,  84,  85,  86,  87,  88,  89,
    90,  99,  100, 101, 102, 103, 104, 105, 106, 115, 116, 117, 118, 119, 120, 121, 122, 131,
    132, 133, 134, 135, 136, 137, 138, 146, 147, 148, 149, 150, 151, 152, 153, 154, 162, 163,
    164, 165, 166, 167, 168, 169, 170, 178, 179, 180, 181, 182, 183, 184, 185, 186, 194, 195,
    196, 197, 198, 199, 200, 201, 202, 210, 211, 212, 213, 214, 215, 216, 217, 218, 225, 226,
    227, 228, 229, 230, 231, 232, 233, 234, 241, 242, 243, 244, 245, 246, 247, 248, 249, 250};
constexpr uint8_t kStdValsAc1[162] = {
    0,   1,   2,   3,   17,  4,   5,   33,  49,  6,   18,  65,  81,  7,   97,  113, 19,  34,
    50,  129, 8,   20,  66,  145, 161, 177, 193, 9,   35,  51,  82,  240, 21,  98,  114, 209,
    10,  22,  36,  52,  225, 37,  241, 23,  24,  25,  26,  38,  39,  40,  41,  42,  53,  54,
    55,  56,  57,  58,  67,  68,  69,  70,  71,  72,  73,  74,  83,  84,  85,  86,  87,  88,
    89,  90,  99,  100, 101, 102, 103, 104, 105, 106, 115, 116, 117, 118, 119, 120, 121, 122,
    130, 131, 132, 133, 134, 135, 136, 137, 138, 146, 147, 148, 149, 150, 151, 152, 153, 154,
    162, 163, 164, 165, 166, 167, 168, 169, 170, 178, 179, 180, 181, 182, 183, 184, 185, 186,
    194, 195, 196, 197, 198, 199, 200, 201, 202, 210, 211, 212, 213, 214, 215, 216, 217, 218,
    226, 227, 228, 229, 230, 231, 232, 233, 234, 242, 243, 244, 245, 246, 247, 248, 249, 250};

void set_std_table(HuffTable& t, const uint8_t* bits, const uint8_t* vals, int n) {
  if (t.defined) return;
  std::memcpy(t.bits, bits, 17);
  std::memset(t.vals, 0, sizeof(t.vals));
  std::memcpy(t.vals, vals, static_cast<size_t>(n));
  t.defined = true;
}

inline int huff_extend(int x, int s) {  // HUFF_EXTEND
  return x < (1 << (s - 1)) ? x + static_cast<int>(~0u << s) + 1 : x;
}

// ---------------------------------------------------------------------------
// The arithmetic decoder's probability table (jaricom.c)
// ---------------------------------------------------------------------------

#define V(i, qe, nlps, nmps, sw) \
  ((int32_t{qe} << 16) | (int32_t{nmps} << 8) | (int32_t{sw} << 7) | int32_t{nlps})
constexpr int32_t kAritab[114] = {
    V(0, 0x5a1d, 1, 1, 1),       V(1, 0x2586, 14, 2, 0),      V(2, 0x1114, 16, 3, 0),
    V(3, 0x080b, 18, 4, 0),      V(4, 0x03d8, 20, 5, 0),      V(5, 0x01da, 23, 6, 0),
    V(6, 0x00e5, 25, 7, 0),      V(7, 0x006f, 28, 8, 0),      V(8, 0x0036, 30, 9, 0),
    V(9, 0x001a, 33, 10, 0),     V(10, 0x000d, 35, 11, 0),    V(11, 0x0006, 9, 12, 0),
    V(12, 0x0003, 10, 13, 0),    V(13, 0x0001, 12, 13, 0),    V(14, 0x5a7f, 15, 15, 1),
    V(15, 0x3f25, 36, 16, 0),    V(16, 0x2cf2, 38, 17, 0),    V(17, 0x207c, 39, 18, 0),
    V(18, 0x17b9, 40, 19, 0),    V(19, 0x1182, 42, 20, 0),    V(20, 0x0cef, 43, 21, 0),
    V(21, 0x09a1, 45, 22, 0),    V(22, 0x072f, 46, 23, 0),    V(23, 0x055c, 48, 24, 0),
    V(24, 0x0406, 49, 25, 0),    V(25, 0x0303, 51, 26, 0),    V(26, 0x0240, 52, 27, 0),
    V(27, 0x01b1, 54, 28, 0),    V(28, 0x0144, 56, 29, 0),    V(29, 0x00f5, 57, 30, 0),
    V(30, 0x00b7, 59, 31, 0),    V(31, 0x008a, 60, 32, 0),    V(32, 0x0068, 62, 33, 0),
    V(33, 0x004e, 63, 34, 0),    V(34, 0x003b, 32, 35, 0),    V(35, 0x002c, 33, 9, 0),
    V(36, 0x5ae1, 37, 37, 1),    V(37, 0x484c, 64, 38, 0),    V(38, 0x3a0d, 65, 39, 0),
    V(39, 0x2ef1, 67, 40, 0),    V(40, 0x261f, 68, 41, 0),    V(41, 0x1f33, 69, 42, 0),
    V(42, 0x19a8, 70, 43, 0),    V(43, 0x1518, 72, 44, 0),    V(44, 0x1177, 73, 45, 0),
    V(45, 0x0e74, 74, 46, 0),    V(46, 0x0bfb, 75, 47, 0),    V(47, 0x09f8, 77, 48, 0),
    V(48, 0x0861, 78, 49, 0),    V(49, 0x0706, 79, 50, 0),    V(50, 0x05cd, 48, 51, 0),
    V(51, 0x04de, 50, 52, 0),    V(52, 0x040f, 50, 53, 0),    V(53, 0x0363, 51, 54, 0),
    V(54, 0x02d4, 52, 55, 0),    V(55, 0x025c, 53, 56, 0),    V(56, 0x01f8, 54, 57, 0),
    V(57, 0x01a4, 55, 58, 0),    V(58, 0x0160, 56, 59, 0),    V(59, 0x0125, 57, 60, 0),
    V(60, 0x00f6, 58, 61, 0),    V(61, 0x00cb, 59, 62, 0),    V(62, 0x00ab, 61, 63, 0),
    V(63, 0x008f, 61, 32, 0),    V(64, 0x5b12, 65, 65, 1),    V(65, 0x4d04, 80, 66, 0),
    V(66, 0x412c, 81, 67, 0),    V(67, 0x37d8, 82, 68, 0),    V(68, 0x2fe8, 83, 69, 0),
    V(69, 0x293c, 84, 70, 0),    V(70, 0x2379, 86, 71, 0),    V(71, 0x1edf, 87, 72, 0),
    V(72, 0x1aa9, 87, 73, 0),    V(73, 0x174e, 72, 74, 0),    V(74, 0x1424, 72, 75, 0),
    V(75, 0x119c, 74, 76, 0),    V(76, 0x0f6b, 74, 77, 0),    V(77, 0x0d51, 75, 78, 0),
    V(78, 0x0bb6, 77, 79, 0),    V(79, 0x0a40, 77, 48, 0),    V(80, 0x5832, 80, 81, 1),
    V(81, 0x4d1c, 88, 82, 0),    V(82, 0x438e, 89, 83, 0),    V(83, 0x3bdd, 90, 84, 0),
    V(84, 0x34ee, 91, 85, 0),    V(85, 0x2eae, 92, 86, 0),    V(86, 0x299a, 93, 87, 0),
    V(87, 0x2516, 86, 71, 0),    V(88, 0x5570, 88, 89, 1),    V(89, 0x4ca9, 95, 90, 0),
    V(90, 0x44d9, 96, 91, 0),    V(91, 0x3e22, 97, 92, 0),    V(92, 0x3824, 99, 93, 0),
    V(93, 0x32b4, 99, 94, 0),    V(94, 0x2e17, 93, 86, 0),    V(95, 0x56a8, 95, 96, 1),
    V(96, 0x4f46, 101, 97, 0),   V(97, 0x47e5, 102, 98, 0),   V(98, 0x41cf, 103, 99, 0),
    V(99, 0x3c3d, 104, 100, 0),  V(100, 0x375e, 99, 93, 0),   V(101, 0x5231, 105, 102, 0),
    V(102, 0x4c0f, 106, 103, 0), V(103, 0x4639, 107, 104, 0), V(104, 0x415e, 103, 99, 0),
    V(105, 0x5627, 105, 106, 1), V(106, 0x50e7, 108, 107, 0), V(107, 0x4b85, 109, 103, 0),
    V(108, 0x5597, 110, 109, 0), V(109, 0x504f, 111, 107, 0), V(110, 0x5a10, 110, 111, 1),
    V(111, 0x5522, 112, 109, 0), V(112, 0x59eb, 112, 111, 1), V(113, 0x5a1d, 113, 113, 0)};
#undef V

constexpr int kDcStatBins = 64;
constexpr int kAcStatBins = 256;
constexpr int kArithTables = 16;

// ---------------------------------------------------------------------------
// Decoder state
// ---------------------------------------------------------------------------

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;              // width_in_blocks / height_in_blocks
  int bw_alloc = 0, bh_alloc = 0;  // blocks of the interleaved MCU grid
  int dw = 0, dh = 0;              // downsampled_width / height, after scaling
  int ssize = 8;                   // DCT_scaled_size: the IDCT's output width
  bool quant_latched = false;      // quant_table != NULL
  uint16_t quant[64] = {};         // natural order
  std::vector<int16_t> coef;       // bw_alloc * bh_alloc * 64
  int dc_tbl = 0, ac_tbl = 0;
  int coef_bits[64];               // progression status, -1 = not yet seen
  int prev_coef_bits[64];          // the status before the current scan
  std::vector<uint8_t> plane;      // IDCT output, stride bw * ssize
};

struct Decoder {
  Source src;
  int unread_marker = 0;
  bool saw_soi = false, saw_sof = false;

  bool progressive = false, arith = false;
  int precision = 0, width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int mcus_x = 0, mcus_y = 0;  // interleaved MCU grid; mcus_y = total_iMCU_rows
  int scale = 8, out_w = 0, out_h = 0;  // scale_num and the output size
  Component comp[kMaxComponents];
  uint16_t qt[4][64] = {};
  bool qt_defined[4] = {};
  HuffTable dc_huff[4], ac_huff[4];
  int restart_interval = 0;
  uint8_t arith_dc_l[kArithTables], arith_dc_u[kArithTables], arith_ac_k[kArithTables];
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;

  // Scan parameters (get_sos, per_scan_setup).
  int comps_in_scan = 0, cur[4] = {}, ss = 0, se = 0, ah = 0, al = 0;
  int input_scan_number = 0, next_restart_num = 0;
  bool has_multiple_scans = false;
  int blocks_in_mcu = 0, membership[kMaxBlocksInMcu] = {};
  int last_good_imcu_row = 0;

  // Entropy decoder state.
  enum Mode { kHuff, kDcFirst, kDcRefine, kAcFirst, kAcRefine } mode = kHuff;
  uint64_t get_buffer = 0;
  int bits_left = 0;
  bool insufficient = false;
  unsigned restarts_to_go = 0;
  int last_dc_val[4] = {};
  unsigned eobrun = 0;
  Derived dc_derived[4], ac_derived[4];
  const Derived* dc_cur[kMaxBlocksInMcu] = {};
  const Derived* ac_cur[kMaxBlocksInMcu] = {};
  const Derived* ac_tbl_cur = nullptr;
  int64_t ac = 0, aa = 0;  // the arithmetic decoder's C and A registers
  int ct = 0;
  int dc_context[4] = {};
  uint8_t dc_stats[kArithTables][kDcStatBins];
  uint8_t ac_stats[kArithTables][kAcStatBins];
  uint8_t fixed_bin = 113;

  Decoder(const uint8_t* d, size_t size) : src{d, size} {
    for (int i = 0; i < kArithTables; i++) {
      arith_dc_l[i] = 0;
      arith_dc_u[i] = 1;
      arith_ac_k[i] = 5;
    }
  }

  // --- jdmarker.c ---

  int word() {
    int hi = src.byte();
    return (hi << 8) | src.byte();
  }

  void first_marker() {
    int c = src.byte(), c2 = src.byte();
    if (c != 0xFF || c2 != 0xD8) fail("not a JPEG: no SOI marker");
    unread_marker = c2;
  }

  void next_marker() {
    int c;
    for (;;) {
      c = src.byte();
      while (c != 0xFF) c = src.byte();
      do {
        c = src.byte();
      } while (c == 0xFF);
      if (c != 0) break;
    }
    unread_marker = c;
  }

  void get_soi() {
    if (saw_soi) fail("corrupt JPEG: second SOI marker");
    for (int i = 0; i < kArithTables; i++) {
      arith_dc_l[i] = 0;
      arith_dc_u[i] = 1;
      arith_ac_k[i] = 5;
    }
    restart_interval = 0;
    saw_jfif = saw_adobe = false;
    adobe_transform = 0;
    saw_soi = true;
  }

  void get_sof(bool is_prog, bool is_arith) {
    if (saw_sof) fail("corrupt JPEG: more than one SOF marker");
    progressive = is_prog;
    arith = is_arith;
    int length = word();
    precision = src.byte();
    height = word();
    width = word();
    ncomp = src.byte();
    length -= 8;
    if (height <= 0 || width <= 0 || ncomp <= 0)
      fail("corrupt JPEG: empty image (height, width or components 0)");
    if (length != ncomp * 3) fail("corrupt JPEG: bad SOF length");
    // initial_setup's checks (libjpeg makes them at the first SOS; a file
    // with no SOS fails all the same).
    if (height > kMaxDimension || width > kMaxDimension)
      fail("unsupported JPEG: image of " + std::to_string(width) + "x" +
           std::to_string(height) + " pixels is too large");
    if (precision == 12) fail("unsupported JPEG: 12-bit samples");
    if (precision != 8)
      fail("unsupported JPEG: " + std::to_string(precision) + "-bit samples");
    if (ncomp > kMaxComponents)
      fail("unsupported JPEG: " + std::to_string(ncomp) + " components");
    hmax = vmax = 1;
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.id = src.byte();
      int hv = src.byte();
      c.h = (hv >> 4) & 15;
      c.v = hv & 15;
      c.tq = src.byte();
    }
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) fail("corrupt JPEG: bad sampling factors");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    saw_sof = true;
  }

  void get_sos() {
    if (!saw_sof) fail("corrupt JPEG: SOS before SOF");
    int length = word();
    int n = src.byte();
    if (length != n * 2 + 6 || n < 1 || n > 4) fail("corrupt JPEG: bad SOS length");
    comps_in_scan = n;
    bool used[4] = {};  // cur_comp_info[ci] != NULL, as libjpeg tests it
    for (int i = 0; i < n; i++) {
      int cc = src.byte(), c = src.byte();
      int ci = 0;
      const int searched = std::min(ncomp, 4);
      for (; ci < searched; ci++)
        if (cc == comp[ci].id && !used[ci]) break;
      if (ci == searched) fail("corrupt JPEG: SOS names an unknown component");
      cur[i] = ci;
      used[i] = true;
      comp[ci].dc_tbl = (c >> 4) & 15;
      comp[ci].ac_tbl = c & 15;
      for (int pi = 0; pi < i; pi++)
        if (cur[pi] == ci) fail("corrupt JPEG: SOS names a component twice");
    }
    ss = src.byte();
    se = src.byte();
    int c = src.byte();
    ah = (c >> 4) & 15;
    al = c & 15;
    next_restart_num = 0;
    input_scan_number++;
  }

  void get_dac() {
    int length = word() - 2;
    while (length > 0) {
      int index = src.byte(), val = src.byte();
      length -= 2;
      if (index >= 2 * kArithTables) fail("corrupt JPEG: bad DAC index");
      if (index >= kArithTables) {
        arith_ac_k[index - kArithTables] = static_cast<uint8_t>(val);
      } else {
        arith_dc_l[index] = static_cast<uint8_t>(val & 0x0F);
        arith_dc_u[index] = static_cast<uint8_t>(val >> 4);
        if (arith_dc_l[index] > arith_dc_u[index]) fail("corrupt JPEG: bad DAC value");
      }
    }
    if (length != 0) fail("corrupt JPEG: bad DAC length");
  }

  void get_dht() {
    int length = word() - 2;
    while (length > 16) {
      int index = src.byte();
      uint8_t bits[17] = {};
      int count = 0;
      for (int i = 1; i <= 16; i++) {
        bits[i] = static_cast<uint8_t>(src.byte());
        count += bits[i];
      }
      length -= 1 + 16;
      if (count > 256 || count > length) fail("corrupt JPEG: bad Huffman table");
      uint8_t vals[256] = {};
      for (int i = 0; i < count; i++) vals[i] = static_cast<uint8_t>(src.byte());
      length -= count;
      HuffTable* t;
      if (index & 0x10) {
        index -= 0x10;
        if (index >= 4) fail("corrupt JPEG: bad Huffman table index");
        t = &ac_huff[index];
      } else {
        if (index >= 4) fail("corrupt JPEG: bad Huffman table index");
        t = &dc_huff[index];
      }
      std::memcpy(t->bits, bits, sizeof(bits));
      std::memcpy(t->vals, vals, sizeof(vals));
      t->defined = true;
    }
    if (length != 0) fail("corrupt JPEG: bad DHT length");
  }

  void get_dqt() {
    int length = word() - 2;
    while (length > 0) {
      int n = src.byte();
      int prec = n >> 4;
      n &= 0x0F;
      if (n >= 4) fail("corrupt JPEG: bad quantization table index");
      for (int i = 0; i < 64; i++) {
        int v = prec ? word() : src.byte();
        qt[n][kNatural[i]] = static_cast<uint16_t>(v);
      }
      qt_defined[n] = true;
      length -= 64 + 1;
      if (prec) length -= 64;
    }
    if (length != 0) fail("corrupt JPEG: bad DQT length");
  }

  void get_dri() {
    if (word() != 4) fail("corrupt JPEG: bad DRI length");
    restart_interval = word();
  }

  void get_interesting_appn(int marker) {  // APP0 / APP14
    long length = word() - 2;
    uint8_t b[14];
    int numtoread = length >= 14 ? 14 : (length > 0 ? static_cast<int>(length) : 0);
    for (int i = 0; i < numtoread; i++) b[i] = static_cast<uint8_t>(src.byte());
    length -= numtoread;
    if (marker == 0xE0) {
      if (numtoread >= 14 && b[0] == 0x4A && b[1] == 0x46 && b[2] == 0x49 && b[3] == 0x46 &&
          b[4] == 0)
        saw_jfif = true;
    } else if (numtoread >= 12 && b[0] == 0x41 && b[1] == 0x64 && b[2] == 0x6F &&
               b[3] == 0x62 && b[4] == 0x65) {
      saw_adobe = true;
      adobe_transform = b[11];
    }
    src.skip(length);
  }

  void skip_variable() { src.skip(static_cast<long>(word()) - 2); }

  // read_markers: returns at SOS (parameters read) or EOI.
  enum Reached { kSos, kEoi };
  Reached read_markers() {
    for (;;) {
      if (unread_marker == 0) {
        if (!saw_soi) first_marker();
        else next_marker();
      }
      const int m = unread_marker;
      switch (m) {
        case 0xD8: get_soi(); break;
        case 0xC0: case 0xC1: get_sof(false, false); break;
        case 0xC2: get_sof(true, false); break;
        case 0xC9: get_sof(false, true); break;
        case 0xCA: get_sof(true, true); break;
        case 0xC3: case 0xC5: case 0xC6: case 0xC7: case 0xC8: case 0xCB: case 0xCD:
        case 0xCE: case 0xCF:
          fail("unsupported JPEG: lossless or hierarchical process (SOF" +
               std::to_string(m - 0xC0) + ")");
        case 0xDA:
          get_sos();
          unread_marker = 0;
          return kSos;
        case 0xD9:
          unread_marker = 0;
          return kEoi;
        case 0xCC: get_dac(); break;
        case 0xC4: get_dht(); break;
        case 0xDB: get_dqt(); break;
        case 0xDD: get_dri(); break;
        case 0xE0: case 0xEE: get_interesting_appn(m); break;
        case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4: case 0xD5: case 0xD6:
        case 0xD7: case 0x01:
          break;  // parameterless
        case 0xDC: skip_variable(); break;  // DNL: ignored, as libjpeg does
        default:
          if ((m >= 0xE1 && m <= 0xEF) || m == 0xFE) {
            skip_variable();
            break;
          }
          fail("corrupt JPEG: unknown marker " + std::to_string(m));
      }
      unread_marker = 0;
    }
  }

  void read_restart_marker() {
    if (unread_marker == 0) next_marker();
    if (unread_marker == 0xD0 + next_restart_num) unread_marker = 0;
    else resync_to_restart(next_restart_num);
    next_restart_num = (next_restart_num + 1) & 7;
  }

  void resync_to_restart(int desired) {  // jpeg_resync_to_restart
    int marker = unread_marker;
    for (;;) {
      int action;
      if (marker < 0xC0) {
        action = 2;
      } else if (marker < 0xD0 || marker > 0xD7) {
        action = 3;
      } else {
        if (marker == 0xD0 + ((desired + 1) & 7) || marker == 0xD0 + ((desired + 2) & 7))
          action = 3;
        else if (marker == 0xD0 + ((desired - 1) & 7) || marker == 0xD0 + ((desired - 2) & 7))
          action = 2;
        else
          action = 1;
      }
      if (action == 1) {
        unread_marker = 0;
        return;
      }
      if (action == 3) return;
      next_marker();
      marker = unread_marker;
    }
  }

  // --- the headers (jpeg_read_header) and the set-up for output ---

  void read_header() {
    if (src.size == 0) fail("not a JPEG: empty data");
    if (read_markers() == kEoi) {
      if (src.pos > src.size) fail("JPEG data truncated: the data ends before any scan");
      fail("corrupt JPEG: no image data");
    }
    if (static_cast<long long>(width) * height > kMaxPixels)
      fail("unsupported JPEG: image of " + std::to_string(width) + "x" +
           std::to_string(height) + " pixels is too large");
    mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
    mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.dw = static_cast<int>((static_cast<long long>(width) * c.h + hmax - 1) / hmax);
      c.dh = static_cast<int>((static_cast<long long>(height) * c.v + vmax - 1) / vmax);
      c.bw = (c.dw + 7) / 8;
      c.bh = (c.dh + 7) / 8;
      c.bw_alloc = mcus_x * c.h;
      c.bh_alloc = mcus_y * c.v;
    }
    has_multiple_scans = comps_in_scan < ncomp || progressive;
  }

  // jpeg_calc_output_dimensions at scale_num/8: the output size, each
  // component's IDCT size (doubled while its sampling factors let the IDCT
  // scale it up in place of the upsampler) and its size in samples.  The
  // coefficient blocks (bw, bh) stay as read_header set them.
  void set_scale(int s) {
    if (s < 1 || s > 8) fail("scale_num " + std::to_string(s) + " is not 1..8");
    scale = s;
    out_w = static_cast<int>((static_cast<long long>(width) * s + 7) / 8);
    out_h = static_cast<int>((static_cast<long long>(height) * s + 7) / 8);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      int ssize = s;
      while (ssize < 8 && (hmax * s) % (c.h * ssize * 2) == 0 && (vmax * s) % (c.v * ssize * 2) == 0)
        ssize *= 2;
      c.ssize = ssize;
      c.dw = static_cast<int>((static_cast<long long>(width) * c.h * ssize + hmax * 8 - 1) /
                              (hmax * 8));
      c.dh = static_cast<int>((static_cast<long long>(height) * c.v * ssize + vmax * 8 - 1) /
                              (vmax * 8));
    }
  }

  // jinit_master_decompress's refusals, then the coefficient buffers.
  void start_decompress() {
    if (ncomp == 4) fail("unsupported JPEG: CMYK/YCCK (4 components)");
    if (ncomp != 1 && ncomp != 3)
      fail("unsupported JPEG: " + std::to_string(ncomp) + " components");
    for (int i = 0; i < ncomp; i++)
      if (hmax % comp[i].h != 0 || vmax % comp[i].v != 0)
        fail("unsupported JPEG: fractional sampling factors");
    if (!arith && !progressive) {  // jinit_huff_decoder: std_huff_tables
      set_std_table(dc_huff[0], kStdBitsDc0, kStdValsDc, 12);
      set_std_table(ac_huff[0], kStdBitsAc0, kStdValsAc0, 162);
      set_std_table(dc_huff[1], kStdBitsDc1, kStdValsDc, 12);
      set_std_table(ac_huff[1], kStdBitsAc1, kStdValsAc1, 162);
    }
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.coef.assign(static_cast<size_t>(c.bw_alloc) * c.bh_alloc * 64, 0);
      for (int k = 0; k < 64; k++) c.coef_bits[k] = c.prev_coef_bits[k] = -1;
    }
  }

  int16_t* block(Component& c, int by, int bx) {
    return c.coef.data() + (static_cast<size_t>(by) * c.bw_alloc + bx) * 64;
  }

  // start_input_pass: per_scan_setup, latch_quant_tables, the entropy
  // decoder's start_pass.
  void start_input_pass() {
    if (comps_in_scan == 1) {
      blocks_in_mcu = 1;
      membership[0] = 0;
    } else {
      blocks_in_mcu = 0;
      for (int i = 0; i < comps_in_scan; i++) {
        const Component& c = comp[cur[i]];
        int n = c.h * c.v;
        if (blocks_in_mcu + n > kMaxBlocksInMcu) fail("corrupt JPEG: too many blocks in an MCU");
        while (n-- > 0) membership[blocks_in_mcu++] = i;
      }
    }
    for (int i = 0; i < comps_in_scan; i++) {
      Component& c = comp[cur[i]];
      if (c.quant_latched) continue;
      if (c.tq >= 4 || !qt_defined[c.tq]) fail("corrupt JPEG: missing quantization table");
      std::memcpy(c.quant, qt[c.tq], sizeof(c.quant));
      c.quant_latched = true;
    }
    if (arith) start_pass_arith();
    else if (progressive) start_pass_phuff();
    else start_pass_huff();
  }

  // The progression checks and the coef_bits update of jdphuff.c/jdarith.c.
  void check_progression() {
    bool bad = false;
    if (ss == 0) {
      if (se != 0) bad = true;
    } else {
      if (ss > se || se > 63) bad = true;
      if (comps_in_scan != 1) bad = true;
    }
    if (ah != 0 && al != ah - 1) bad = true;
    if (al > 13) bad = true;
    if (bad) fail("corrupt JPEG: bad progression parameters");
    for (int i = 0; i < comps_in_scan; i++) {
      Component& c = comp[cur[i]];
      for (int k = std::min(ss, 1); k <= std::max(se, 9); k++)
        c.prev_coef_bits[k] = input_scan_number > 1 ? c.coef_bits[k] : 0;
      for (int k = ss; k <= se; k++) c.coef_bits[k] = al;
    }
    if (ss == 0) mode = ah == 0 ? kDcFirst : kDcRefine;
    else mode = ah == 0 ? kAcFirst : kAcRefine;
  }

  void start_pass_huff() {  // jdhuff.c (Ss, Se, Ah, Al are only warned about)
    mode = kHuff;
    for (int i = 0; i < comps_in_scan; i++) {
      const Component& c = comp[cur[i]];
      if (c.dc_tbl >= 4) fail("corrupt JPEG: missing Huffman table");
      if (c.ac_tbl >= 4) fail("corrupt JPEG: missing Huffman table");
      derive(dc_huff[c.dc_tbl], true, dc_derived[c.dc_tbl]);
      derive(ac_huff[c.ac_tbl], false, ac_derived[c.ac_tbl]);
      last_dc_val[i] = 0;
    }
    for (int b = 0; b < blocks_in_mcu; b++) {
      const Component& c = comp[cur[membership[b]]];
      dc_cur[b] = &dc_derived[c.dc_tbl];
      ac_cur[b] = &ac_derived[c.ac_tbl];
    }
    bits_left = 0;
    get_buffer = 0;
    insufficient = false;
    restarts_to_go = static_cast<unsigned>(restart_interval);
  }

  void start_pass_phuff() {  // jdphuff.c; derived tables share one array
    check_progression();
    for (int i = 0; i < comps_in_scan; i++) {
      const Component& c = comp[cur[i]];
      if (ss == 0) {
        if (ah == 0) {
          if (c.dc_tbl >= 4) fail("corrupt JPEG: missing Huffman table");
          derive(dc_huff[c.dc_tbl], true, dc_derived[c.dc_tbl]);
          dc_cur[i] = &dc_derived[c.dc_tbl];
        }
      } else {
        if (c.ac_tbl >= 4) fail("corrupt JPEG: missing Huffman table");
        derive(ac_huff[c.ac_tbl], false, ac_derived[c.ac_tbl]);
        ac_tbl_cur = &ac_derived[c.ac_tbl];
      }
      last_dc_val[i] = 0;
    }
    bits_left = 0;
    get_buffer = 0;
    insufficient = false;
    eobrun = 0;
    restarts_to_go = static_cast<unsigned>(restart_interval);
  }

  void start_pass_arith() {  // jdarith.c
    if (progressive) {
      check_progression();
    } else {
      mode = kHuff;  // the sequential decode_mcu
    }
    for (int i = 0; i < comps_in_scan; i++) {
      const Component& c = comp[cur[i]];
      if (!progressive || (ss == 0 && ah == 0)) {
        std::memset(dc_stats[c.dc_tbl], 0, kDcStatBins);
        last_dc_val[i] = 0;
        dc_context[i] = 0;
      }
      if (!progressive || ss) std::memset(ac_stats[c.ac_tbl], 0, kAcStatBins);
    }
    ac = 0;
    aa = 0;
    ct = -16;
    insufficient = false;
    restarts_to_go = static_cast<unsigned>(restart_interval);
  }

  // --- jdhuff.c's bit reader ---

  static constexpr int kMinGetBits = 64 - 7;  // MIN_GET_BITS

  // jpeg_fill_bit_buffer
  void fill_bit_buffer(int nbits) {
    if (unread_marker == 0) {
      bool hit = false;
      while (bits_left < kMinGetBits) {
        int c = src.byte();
        if (c == 0xFF) {
          do {
            c = src.byte();
          } while (c == 0xFF);
          if (c == 0) {
            c = 0xFF;
          } else {
            unread_marker = c;
            hit = true;
            break;
          }
        }
        get_buffer = (get_buffer << 8) | static_cast<uint64_t>(c);
        bits_left += 8;
      }
      if (!hit) return;
    }
    if (nbits > bits_left) {  // insert zero bits
      insufficient = true;
      get_buffer <<= kMinGetBits - bits_left;
      bits_left = kMinGetBits;
    }
  }

  void check_bits(int nbits) {
    if (bits_left < nbits) fill_bit_buffer(nbits);
  }
  int get_bits(int nbits) {
    bits_left -= nbits;
    return static_cast<int>(get_buffer >> bits_left) & ((1 << nbits) - 1);
  }
  int peek_bits(int nbits) const {
    return static_cast<int>(get_buffer >> (bits_left - nbits)) & ((1 << nbits) - 1);
  }

  int huff_decode_long(const Derived& d, int min_bits) {  // jpeg_huff_decode
    int l = min_bits;
    check_bits(l);
    int32_t code = get_bits(l);
    while (code > d.maxcode[l]) {
      code <<= 1;
      check_bits(1);
      code |= get_bits(1);
      l++;
    }
    if (l > 16) return 0;  // bad code: libjpeg warns and fakes a zero
    return d.vals[code + d.valoffset[l]];
  }

  int huff_decode(const Derived& d) {  // HUFF_DECODE
    if (bits_left < kLookahead) {
      fill_bit_buffer(0);
      if (bits_left < kLookahead) return huff_decode_long(d, 1);
    }
    const int look = peek_bits(kLookahead);
    const int nb = d.lookup[look] >> kLookahead;
    if (nb <= kLookahead) {
      bits_left -= nb;
      return d.lookup[look] & ((1 << kLookahead) - 1);
    }
    return huff_decode_long(d, nb);
  }

  void decode_mcu_slow(int16_t** blocks) {
    for (int b = 0; b < blocks_in_mcu; b++) {
      int16_t* blk = blocks[b];
      int s = huff_decode(*dc_cur[b]);
      if (s) {
        check_bits(s);
        s = huff_extend(get_bits(s), s);
      }
      const int ci = membership[b];
      s = static_cast<int>(static_cast<unsigned>(s) + static_cast<unsigned>(last_dc_val[ci]));
      last_dc_val[ci] = s;
      blk[0] = static_cast<int16_t>(s);
      const Derived& act = *ac_cur[b];
      for (int k = 1; k < 64; k++) {
        s = huff_decode(act);
        int r = s >> 4;
        s &= 15;
        if (s) {
          k += r;
          check_bits(s);
          s = huff_extend(get_bits(s), s);
          blk[kNatural[k]] = static_cast<int16_t>(s);
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    }
  }

  // decode_mcu_fast: reads bytes ahead without the slow path's marker
  // handling; on any FF not followed by 00 it pads with zeros, finishes the
  // MCU (writing into the blocks) and reports failure, and the slow path
  // decodes the MCU again over what it wrote.
  bool decode_mcu_fast(int16_t** blocks) {
    uint64_t gb = get_buffer;
    int bl = bits_left;
    size_t pos = src.pos;
    bool marker = false;
    int dc[4] = {last_dc_val[0], last_dc_val[1], last_dc_val[2], last_dc_val[3]};
    auto get_byte = [&]() {
      const int c0 = src.at(pos++);
      const int c1 = src.at(pos);
      gb = (gb << 8) | static_cast<uint64_t>(c0);
      bl += 8;
      if (c0 == 0xFF) {
        pos++;
        if (c1 != 0) {
          marker = true;
          pos -= 2;
          gb &= ~uint64_t{0xFF};
        }
      }
    };
    auto fill = [&]() {
      if (bl <= 16)
        for (int i = 0; i < 6; i++) get_byte();
    };
    auto bits = [&](int n) {
      bl -= n;
      return static_cast<int>(gb >> bl) & ((1 << n) - 1);
    };
    auto decode = [&](const Derived& d) {
      fill();
      int s = d.lookup[static_cast<int>(gb >> (bl - kLookahead)) & ((1 << kLookahead) - 1)];
      int nb = s >> kLookahead;
      bl -= nb;
      s &= (1 << kLookahead) - 1;
      if (nb > kLookahead) {
        s = static_cast<int>(gb >> bl) & ((1 << nb) - 1);
        while (s > d.maxcode[nb]) {
          s <<= 1;
          s |= bits(1);
          nb++;
        }
        s = nb > 16 ? 0 : d.vals[(s + d.valoffset[nb]) & 0xFF];
      }
      return s;
    };
    for (int b = 0; b < blocks_in_mcu; b++) {
      int16_t* blk = blocks[b];
      int s = decode(*dc_cur[b]);
      if (s) {
        fill();
        s = huff_extend(bits(s), s);
      }
      const int ci = membership[b];
      s = static_cast<int>(static_cast<unsigned>(s) + static_cast<unsigned>(dc[ci]));
      dc[ci] = s;
      blk[0] = static_cast<int16_t>(s);
      const Derived& act = *ac_cur[b];
      for (int k = 1; k < 64; k++) {
        s = decode(act);
        int r = s >> 4;
        s &= 15;
        if (s) {
          k += r;
          fill();
          s = huff_extend(bits(s), s);
          blk[kNatural[k]] = static_cast<int16_t>(s);
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    }
    if (marker) return false;
    src.pos = pos;
    get_buffer = gb;
    bits_left = bl;
    std::memcpy(last_dc_val, dc, sizeof(dc));
    return true;
  }

  void process_restart_huff() {  // jdhuff.c / jdphuff.c process_restart
    bits_left = 0;
    read_restart_marker();
    for (int i = 0; i < comps_in_scan; i++) last_dc_val[i] = 0;
    eobrun = 0;
    restarts_to_go = static_cast<unsigned>(restart_interval);
    if (unread_marker == 0) insufficient = false;
  }

  void decode_mcu_huff(int16_t** blocks) {  // jdhuff.c decode_mcu
    bool usefast = true;
    if (restart_interval) {
      if (restarts_to_go == 0) process_restart_huff();
      usefast = false;
    }
    if (src.bytes_in_buffer() < 512u * static_cast<unsigned>(blocks_in_mcu) || unread_marker)
      usefast = false;
    if (!insufficient) {
      if (!usefast || !decode_mcu_fast(blocks)) decode_mcu_slow(blocks);
    }
    if (restart_interval) restarts_to_go--;
  }

  // --- jdphuff.c ---

  void decode_dc_first(int16_t** blocks) {
    if (restart_interval && restarts_to_go == 0) process_restart_huff();
    if (!insufficient) {
      for (int b = 0; b < blocks_in_mcu; b++) {
        const int ci = membership[b];
        int s = huff_decode(*dc_cur[ci]);
        if (s) {
          check_bits(s);
          s = huff_extend(get_bits(s), s);
        }
        const int last = last_dc_val[ci];
        if ((last >= 0 && s > INT32_MAX - last) || (last < 0 && s < INT32_MIN - last))
          fail("corrupt JPEG data: bad DC coefficient");
        s += last;
        last_dc_val[ci] = s;
        blocks[b][0] = static_cast<int16_t>(static_cast<unsigned>(s) << al);
      }
    }
    if (restart_interval) restarts_to_go--;
  }

  void decode_dc_refine(int16_t** blocks) {
    if (restart_interval && restarts_to_go == 0) process_restart_huff();
    const int p1 = 1 << al;
    for (int b = 0; b < blocks_in_mcu; b++) {
      check_bits(1);
      if (get_bits(1)) blocks[b][0] = static_cast<int16_t>(blocks[b][0] | p1);
    }
    if (restart_interval) restarts_to_go--;
  }

  void decode_ac_first(int16_t** blocks) {
    if (restart_interval && restarts_to_go == 0) process_restart_huff();
    if (!insufficient) {
      if (eobrun > 0) {
        eobrun--;
      } else {
        int16_t* blk = blocks[0];
        for (int k = ss; k <= se; k++) {
          int s = huff_decode(*ac_tbl_cur);
          int r = s >> 4;
          s &= 15;
          if (s) {
            k += r;
            check_bits(s);
            s = huff_extend(get_bits(s), s);
            blk[kNatural[k]] = static_cast<int16_t>(static_cast<unsigned>(s) << al);
          } else if (r == 15) {
            k += 15;
          } else {
            eobrun = 1u << r;
            if (r) {
              check_bits(r);
              eobrun += static_cast<unsigned>(get_bits(r));
            }
            eobrun--;
            break;
          }
        }
      }
    }
    if (restart_interval) restarts_to_go--;
  }

  void decode_ac_refine(int16_t** blocks) {
    if (restart_interval && restarts_to_go == 0) process_restart_huff();
    if (!insufficient) {
      int16_t* blk = blocks[0];
      const int p1 = 1 << al;
      const int m1 = -1 * (1 << al);
      auto correct = [&](int16_t* coef) {
        check_bits(1);
        if (get_bits(1)) {
          if ((*coef & p1) == 0) {
            if (*coef >= 0) *coef = static_cast<int16_t>(*coef + p1);
            else *coef = static_cast<int16_t>(*coef + m1);
          }
        }
      };
      int k = ss;
      if (eobrun == 0) {
        for (; k <= se; k++) {
          int s = huff_decode(*ac_tbl_cur);
          int r = s >> 4;
          s &= 15;
          if (s) {
            check_bits(1);
            s = get_bits(1) ? p1 : m1;
          } else if (r != 15) {
            eobrun = 1u << r;
            if (r) {
              check_bits(r);
              eobrun += static_cast<unsigned>(get_bits(r));
            }
            break;
          }
          do {
            int16_t* coef = blk + kNatural[k];
            if (*coef != 0) {
              correct(coef);
            } else {
              if (--r < 0) break;
            }
            k++;
          } while (k <= se);
          if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
        }
      }
      if (eobrun > 0) {
        for (; k <= se; k++) {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) correct(coef);
        }
        eobrun--;
      }
    }
    if (restart_interval) restarts_to_go--;
  }

  // --- jdarith.c ---

  int arith_decode(uint8_t* st) {
    while (aa < 0x8000) {
      if (--ct < 0) {
        int data;
        if (unread_marker) {
          data = 0;
        } else {
          data = src.byte();
          if (data == 0xFF) {
            do {
              data = src.byte();
            } while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;
            } else {
              unread_marker = data;
              data = 0;
            }
          }
        }
        ac = (ac << 8) | data;
        if ((ct += 8) < 0)
          if (++ct == 0) aa = 0x8000;
      }
      aa <<= 1;
    }
    int sv = *st;
    int32_t qe = kAritab[sv & 0x7F];
    const int nl = qe & 0xFF;
    qe >>= 8;
    const int nm = qe & 0xFF;
    qe >>= 8;
    int64_t temp = aa - qe;
    aa = temp;
    temp <<= ct;
    if (ac >= temp) {
      ac -= temp;
      if (aa < qe) {
        aa = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        aa = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (aa < 0x8000) {
      if (aa < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  void process_restart_arith() {
    read_restart_marker();
    for (int i = 0; i < comps_in_scan; i++) {
      const Component& c = comp[cur[i]];
      if (!progressive || (ss == 0 && ah == 0)) {
        std::memset(dc_stats[c.dc_tbl], 0, kDcStatBins);
        last_dc_val[i] = 0;
        dc_context[i] = 0;
      }
      if (!progressive || ss) std::memset(ac_stats[c.ac_tbl], 0, kAcStatBins);
    }
    ac = 0;
    aa = 0;
    ct = -16;
    restarts_to_go = static_cast<unsigned>(restart_interval);
  }

  void arith_restart_tick() {
    if (restart_interval) {
      if (restarts_to_go == 0) process_restart_arith();
      restarts_to_go--;
    }
  }

  // Figures F.19-F.24: a DC difference with its conditioning (returns false
  // on a magnitude overflow, after setting ct = -1).
  bool arith_dc_diff(int ci, int tbl, int* diff) {
    uint8_t* st = dc_stats[tbl] + dc_context[ci];
    if (arith_decode(st) == 0) {
      dc_context[ci] = 0;
      *diff = 0;
      return true;
    }
    const int sign = arith_decode(st + 1);
    st += 2;
    st += sign;
    int m = arith_decode(st);
    if (m != 0) {
      st = dc_stats[tbl] + 20;
      while (arith_decode(st)) {
        if ((m <<= 1) == 0x8000) {
          ct = -1;
          return false;
        }
        st += 1;
      }
    }
    if (m < static_cast<int>((1L << arith_dc_l[tbl]) >> 1)) dc_context[ci] = 0;
    else if (m > static_cast<int>((1L << arith_dc_u[tbl]) >> 1)) dc_context[ci] = 12 + sign * 4;
    else dc_context[ci] = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (arith_decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    *diff = v;
    return true;
  }

  // Figures F.20-F.24 over k in [k0, kend] into blk (scaled by shift);
  // returns false after setting ct = -1 on a spectral or magnitude overflow.
  bool arith_ac(int16_t* blk, int tbl, int k0, int kend, int shift) {
    for (int k = k0; k <= kend; k++) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (arith_decode(st)) break;  // EOB
      while (arith_decode(st + 1) == 0) {
        st += 3;
        if (++k > kend) {
          ct = -1;
          return false;
        }
      }
      const int sign = arith_decode(&fixed_bin);
      st += 2;
      int m = arith_decode(st);
      if (m != 0) {
        if (arith_decode(st)) {
          m <<= 1;
          st = ac_stats[tbl] + (k <= arith_ac_k[tbl] ? 189 : 217);
          while (arith_decode(st)) {
            if ((m <<= 1) == 0x8000) {
              ct = -1;
              return false;
            }
            st += 1;
          }
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (arith_decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[kNatural[k]] = static_cast<int16_t>(static_cast<unsigned>(v) << shift);
    }
    return true;
  }

  void arith_decode_mcu(int16_t** blocks) {
    arith_restart_tick();
    switch (mode) {
      case kHuff: {  // sequential
        if (ct == -1) return;
        for (int b = 0; b < blocks_in_mcu; b++) {
          const int ci = membership[b];
          const Component& c = comp[cur[ci]];
          int diff;
          if (!arith_dc_diff(ci, c.dc_tbl, &diff)) return;
          if (diff) last_dc_val[ci] = (last_dc_val[ci] + diff) & 0xffff;
          blocks[b][0] = static_cast<int16_t>(last_dc_val[ci]);
          if (!arith_ac(blocks[b], c.ac_tbl, 1, 63, 0)) return;
        }
        return;
      }
      case kDcFirst: {
        if (ct == -1) return;
        for (int b = 0; b < blocks_in_mcu; b++) {
          const int ci = membership[b];
          int diff;
          if (!arith_dc_diff(ci, comp[cur[ci]].dc_tbl, &diff)) return;
          if (diff) last_dc_val[ci] = (last_dc_val[ci] + diff) & 0xffff;
          blocks[b][0] = static_cast<int16_t>(static_cast<unsigned>(last_dc_val[ci]) << al);
        }
        return;
      }
      case kDcRefine: {
        const int p1 = 1 << al;
        for (int b = 0; b < blocks_in_mcu; b++)
          if (arith_decode(&fixed_bin)) blocks[b][0] = static_cast<int16_t>(blocks[b][0] | p1);
        return;
      }
      case kAcFirst: {
        if (ct == -1) return;
        arith_ac(blocks[0], comp[cur[0]].ac_tbl, ss, se, al);
        return;
      }
      case kAcRefine: {
        if (ct == -1) return;
        int16_t* blk = blocks[0];
        const int tbl = comp[cur[0]].ac_tbl;
        const int p1 = 1 << al;
        const int m1 = -1 * (1 << al);
        int kex = se;
        for (; kex > 0; kex--)
          if (blk[kNatural[kex]]) break;
        for (int k = ss; k <= se; k++) {
          uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
          if (k > kex)
            if (arith_decode(st)) break;  // EOB
          for (;;) {
            int16_t* coef = blk + kNatural[k];
            if (*coef) {
              if (arith_decode(st + 2)) {
                if (*coef < 0) *coef = static_cast<int16_t>(*coef + m1);
                else *coef = static_cast<int16_t>(*coef + p1);
              }
              break;
            }
            if (arith_decode(st + 1)) {
              *coef = static_cast<int16_t>(arith_decode(&fixed_bin) ? m1 : p1);
              break;
            }
            st += 3;
            if (++k > se) {
              ct = -1;
              return;
            }
          }
        }
        return;
      }
    }
  }

  void decode_mcu(int16_t** blocks) {
    if (arith) {
      arith_decode_mcu(blocks);
      return;
    }
    switch (mode) {
      case kHuff: decode_mcu_huff(blocks); break;
      case kDcFirst: decode_dc_first(blocks); break;
      case kDcRefine: decode_dc_refine(blocks); break;
      case kAcFirst: decode_ac_first(blocks); break;
      case kAcRefine: decode_ac_refine(blocks); break;
    }
  }

  // consume_data over one scan.
  void decode_scan() {
    start_input_pass();
    int16_t* blocks[kMaxBlocksInMcu];
    if (comps_in_scan == 1) {
      Component& c = comp[cur[0]];
      for (int by = 0; by < c.bh; by++) {
        for (int bx = 0; bx < c.bw; bx++) {
          if (!insufficient) last_good_imcu_row = by / c.v;
          blocks[0] = block(c, by, bx);
          decode_mcu(blocks);
        }
      }
    } else {
      for (int my = 0; my < mcus_y; my++) {
        for (int mx = 0; mx < mcus_x; mx++) {
          int n = 0;
          for (int i = 0; i < comps_in_scan; i++) {
            Component& c = comp[cur[i]];
            for (int v = 0; v < c.v; v++)
              for (int h = 0; h < c.h; h++) blocks[n++] = block(c, my * c.v + v, mx * c.h + h);
          }
          if (!insufficient) last_good_imcu_row = my;
          decode_mcu(blocks);
        }
      }
    }
  }

  void decode_all() {
    read_header();
    start_decompress();
    for (;;) {
      decode_scan();
      if (read_markers() == kEoi) break;
      if (!has_multiple_scans) fail("corrupt JPEG: a second scan in a single-scan image");
    }
  }
};

// ---------------------------------------------------------------------------
// IDCTs, as libjpeg-turbo's x86-64 SIMD code computes them
// ---------------------------------------------------------------------------

inline int16_t wrap16(int32_t v) { return static_cast<int16_t>(static_cast<uint16_t>(v)); }
inline int16_t sat16(int32_t v) {
  return static_cast<int16_t>(v > 32767 ? 32767 : (v < -32768 ? -32768 : v));
}
inline uint8_t out8(int16_t v) {  // packsswb, then + CENTERJSAMPLE
  return static_cast<uint8_t>((v > 127 ? 127 : (v < -128 ? -128 : v)) + 128);
}

// Per-component multiplier tables (jddctmgr.c start_pass), all zero for a
// component that no scan named (no quantization table latched).
struct Multipliers {
  int16_t i[64];  // islow: the quantizers; ifast: scaled by aanscales (16 bits)
  float f[64];    // float: scaled by aanscalefactor
};

void make_multipliers(const Component& c, int method, Multipliers& m) {
  std::memset(&m, 0, sizeof(m));
  if (!c.quant_latched) return;
  static const int16_t kAanScales[64] = {
      16384, 22725, 21407, 19266, 16384, 12873, 8867,  4520,  22725, 31521, 29692, 26722, 22725,
      17855, 12299, 6270,  21407, 29692, 27969, 25172, 21407, 16819, 11585, 5906,  19266, 26722,
      25172, 22654, 19266, 15137, 10426, 5315,  16384, 22725, 21407, 19266, 16384, 12873, 8867,
      4520,  12873, 17855, 16819, 15137, 12873, 10114, 6967,  3552,  8867,  12299, 11585, 10426,
      8867,  6967,  4799,  2446,  4520,  6270,  5906,  5315,  4520,  3552,  2446,  1247};
  static const double kAanScaleFactor[8] = {1.0,         1.387039845, 1.306562965, 1.175875602,
                                            1.0,         0.785694958, 0.541196100, 0.275899379};
  for (int k = 0; k < 64; k++) {
    const int32_t q = c.quant[k];
    if (method == kIslow) {
      m.i[k] = wrap16(q);
    } else if (method == kIfast) {
      m.i[k] = wrap16((q * kAanScales[k] + (1 << 11)) >> 12);  // DESCALE(q * aan, 14 - 2)
    } else {
      m.f[k] = static_cast<float>(static_cast<double>(q) * kAanScaleFactor[k >> 3] *
                                  kAanScaleFactor[k & 7]);
    }
  }
}

// jidctint-avx2's dodct over one column or row: 16-bit inputs, the sums
// in0+-in4, in7+in3 and in5+in1 wrapped to 16 bits, products and sums in 32
// bits, descaled with rounding and saturated to 16 bits.
constexpr int32_t F_0_298 = 2446, F_0_390 = 3196, F_0_541 = 4433, F_0_765 = 6270,
                  F_0_899 = 7373, F_1_175 = 9633, F_1_501 = 12299, F_1_847 = 15137,
                  F_1_961 = 16069, F_2_053 = 16819, F_2_562 = 20995, F_3_072 = 25172;

inline void islow_1d(const int16_t* in, int is, int16_t* out, int os, int shift) {
  const int32_t i0 = in[0], i1 = in[is], i2 = in[2 * is], i3 = in[3 * is], i4 = in[4 * is],
                i5 = in[5 * is], i6 = in[6 * is], i7 = in[7 * is];
  const int32_t t3 = i2 * (F_0_541 + F_0_765) + i6 * F_0_541;
  const int32_t t2 = i2 * F_0_541 + i6 * (F_0_541 - F_1_847);
  const int32_t t0 = static_cast<int32_t>(wrap16(i0 + i4)) * (1 << 13);
  const int32_t t1 = static_cast<int32_t>(wrap16(i0 - i4)) * (1 << 13);
  const int32_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
  const int32_t z3 = wrap16(i7 + i3), z4 = wrap16(i5 + i1);
  const int32_t z3p = z3 * (F_1_175 - F_1_961) + z4 * F_1_175;
  const int32_t z4p = z3 * F_1_175 + z4 * (F_1_175 - F_0_390);
  const int32_t o0 = i7 * (F_0_298 - F_0_899) + i1 * (-F_0_899) + z3p;
  const int32_t o1 = i5 * (F_2_053 - F_2_562) + i3 * (-F_2_562) + z4p;
  const int32_t o2 = i5 * (-F_2_562) + i3 * (F_3_072 - F_2_562) + z3p;
  const int32_t o3 = i7 * (-F_0_899) + i1 * (F_1_501 - F_0_899) + z4p;
  const int32_t r = 1 << (shift - 1);
  out[0] = sat16((t10 + o3 + r) >> shift);
  out[7 * os] = sat16((t10 - o3 + r) >> shift);
  out[os] = sat16((t11 + o2 + r) >> shift);
  out[6 * os] = sat16((t11 - o2 + r) >> shift);
  out[2 * os] = sat16((t12 + o1 + r) >> shift);
  out[5 * os] = sat16((t12 - o1 + r) >> shift);
  out[3 * os] = sat16((t13 + o0 + r) >> shift);
  out[4 * os] = sat16((t13 - o0 + r) >> shift);
}

inline bool ac_rows_zero(const int16_t* in) {  // rows 1..7 all zero
  for (int k = 8; k < 64; k++)
    if (in[k]) return false;
  return true;
}

void idct_islow(const int16_t* in, const int16_t* mult, uint8_t* out, int stride) {
  int16_t d[64], ws[64], o[8];
  for (int k = 0; k < 64; k++) d[k] = wrap16(in[k] * mult[k]);  // vpmullw
  if (ac_rows_zero(in)) {
    for (int col = 0; col < 8; col++) {
      const int16_t v = wrap16(d[col] * 4);  // vpsllw by PASS1_BITS
      for (int row = 0; row < 8; row++) ws[row * 8 + col] = v;
    }
  } else {
    for (int col = 0; col < 8; col++) islow_1d(d + col, 8, ws + col, 8, 13 - 2);
  }
  for (int row = 0; row < 8; row++) {
    islow_1d(ws + row * 8, 1, o, 1, 13 + 2 + 3);
    uint8_t* op = out + static_cast<size_t>(row) * stride;
    for (int x = 0; x < 8; x++) op[x] = out8(o[x]);
  }
}

// jidctfst-sse2: every value 16 bits wide and wrapped; MULTIPLY is pmulhw of
// the value shifted left by 2 with the 8-bit constant shifted left by 6.
inline int16_t mulhi(int16_t a, int16_t b) {
  return static_cast<int16_t>((static_cast<int32_t>(a) * b) >> 16);
}
constexpr int16_t kF1414 = 362 << 6, kF1847 = 473 << 6, kF1082 = 277 << 6,
                  kMF1613 = -((669 - 256) << 6);

inline void ifast_1d(const int16_t* in, int is, int16_t* out, int os) {
  const int16_t i0 = in[0], i1 = in[is], i2 = in[2 * is], i3 = in[3 * is], i4 = in[4 * is],
                i5 = in[5 * is], i6 = in[6 * is], i7 = in[7 * is];
  const int16_t t10 = wrap16(i0 + i4), t11 = wrap16(i0 - i4), t13 = wrap16(i2 + i6);
  const int16_t t12 = wrap16(mulhi(wrap16(wrap16(i2 - i6) * 4), kF1414) - t13);
  const int16_t t0 = wrap16(t10 + t13), t3 = wrap16(t10 - t13), t1 = wrap16(t11 + t12),
                t2 = wrap16(t11 - t12);
  const int16_t z13 = wrap16(i5 + i3), z10 = wrap16(i5 - i3), z11 = wrap16(i1 + i7),
                z12 = wrap16(i1 - i7);
  const int16_t z10s = wrap16(z10 * 4), z12s = wrap16(z12 * 4);
  const int16_t t7 = wrap16(z11 + z13);
  const int16_t o11 = mulhi(wrap16(wrap16(z11 - z13) * 4), kF1414);
  const int16_t z5 = mulhi(wrap16(z10s + z12s), kF1847);
  const int16_t o12 = wrap16(wrap16(mulhi(z10s, kMF1613) - z10) + z5);
  const int16_t o10 = wrap16(mulhi(z12s, kF1082) - z5);
  const int16_t t6 = wrap16(o12 - t7);
  const int16_t t5 = wrap16(o11 - t6);
  const int16_t t4 = wrap16(o10 + t5);
  out[0] = wrap16(t0 + t7);
  out[7 * os] = wrap16(t0 - t7);
  out[os] = wrap16(t1 + t6);
  out[6 * os] = wrap16(t1 - t6);
  out[2 * os] = wrap16(t2 + t5);
  out[5 * os] = wrap16(t2 - t5);
  out[4 * os] = wrap16(t3 + t4);
  out[3 * os] = wrap16(t3 - t4);
}

void idct_ifast(const int16_t* in, const int16_t* mult, uint8_t* out, int stride) {
  int16_t d[64], ws[64], o[8];
  for (int k = 0; k < 64; k++) d[k] = wrap16(in[k] * mult[k]);  // pmullw
  for (int col = 0; col < 8; col++) ifast_1d(d + col, 8, ws + col, 8);
  for (int row = 0; row < 8; row++) {
    ifast_1d(ws + row * 8, 1, o, 1);
    uint8_t* op = out + static_cast<size_t>(row) * stride;
    for (int x = 0; x < 8; x++) op[x] = out8(static_cast<int16_t>(o[x] >> 5));  // psraw 5
  }
}

// jidctflt-sse2: single-precision AA&N in the SIMD code's order of
// operations; the output is rounded by adding 1.5 * 2^26 (which also divides
// by 8), its low 16 bits read as a signed value.
inline void float_1d(const float* in, int is, float* out, int os) {
  const float i0 = in[0], i1 = in[is], i2 = in[2 * is], i3 = in[3 * is], i4 = in[4 * is],
              i5 = in[5 * is], i6 = in[6 * is], i7 = in[7 * is];
  const float t10 = i0 + i4, t11 = i0 - i4, t13 = i2 + i6;
  const float t12 = (i2 - i6) * 1.414213562f - t13;
  const float t0 = t10 + t13, t3 = t10 - t13, t1 = t11 + t12, t2 = t11 - t12;
  const float z13 = i5 + i3, z10 = i5 - i3, z11 = i1 + i7, z12 = i1 - i7;
  const float t7 = z11 + z13;
  const float o11 = (z11 - z13) * 1.414213562f;
  const float z5 = (z10 + z12) * 1.847759065f;
  const float o12 = z10 * -2.613125930f + z5;
  const float o10 = z12 * 1.082392200f - z5;
  const float t6 = o12 - t7;
  const float t5 = o11 - t6;
  const float t4 = o10 + t5;
  out[0] = t0 + t7;
  out[7 * os] = t0 - t7;
  out[os] = t1 + t6;
  out[6 * os] = t1 - t6;
  out[2 * os] = t2 + t5;
  out[5 * os] = t2 - t5;
  out[4 * os] = t3 + t4;
  out[3 * os] = t3 - t4;
}

void idct_float(const int16_t* in, const float* mult, uint8_t* out, int stride) {
  float d[64], ws[64], o[8];
  for (int k = 0; k < 64; k++) d[k] = static_cast<float>(in[k]) * mult[k];
  for (int col = 0; col < 8; col++) float_1d(d + col, 8, ws + col, 8);
  for (int row = 0; row < 8; row++) {
    float_1d(ws + row * 8, 1, o, 1);
    uint8_t* op = out + static_cast<size_t>(row) * stride;
    for (int x = 0; x < 8; x++) {
      const float v = o[x] + 100663296.0f;  // PD_RNDINT_MAGIC
      uint32_t bits;
      std::memcpy(&bits, &v, sizeof(bits));
      op[x] = out8(static_cast<int16_t>(static_cast<uint16_t>(bits & 0xFFFF)));
    }
  }
}

// ---------------------------------------------------------------------------
// Scaled IDCTs (jidctred.c, jidctred-sse2, jidctint.c), each reading the
// raw quantizers (the islow table, 16 bits wide)
// ---------------------------------------------------------------------------

// IDCT_range_limit as the C IDCTs index it: the low 10 bits of the value,
// read as signed, saturated to -128..127 and centred.
inline uint8_t range_limit(int64_t v) {
  const int x = (static_cast<int>(v & 1023) ^ 512) - 512;
  return static_cast<uint8_t>((x < -128 ? -128 : (x > 127 ? 127 : x)) + 128);
}

// jpeg_idct_1x1: an eighth of the dequantized DC.
void idct_1x1(const int16_t* in, const int16_t* q, uint8_t* out) {
  out[0] = range_limit((static_cast<int64_t>(in[0] * q[0]) + 4) >> 3);
}

// 32-bit lanes of the SSE2 code: sums wrap, pmaddwd multiplies two 16-bit
// pairs and adds them.
inline int32_t w32(int64_t v) { return static_cast<int32_t>(static_cast<uint32_t>(v)); }
inline int32_t madd(int16_t a, int16_t b, int32_t ca, int32_t cb) {
  return w32(static_cast<int64_t>(a) * ca + static_cast<int64_t>(b) * cb);
}
constexpr int32_t R_0_211 = 1730, R_0_509 = 4176, R_0_601 = 4926, R_0_720 = 5906,
                  R_0_765 = 6270, R_0_850 = 6967, R_0_899 = 7373, R_1_061 = 8697,
                  R_1_272 = 10426, R_1_451 = 11893, R_1_847 = 15137, R_2_172 = 17799,
                  R_2_562 = 20995, R_3_624 = 29692;

// jsimd_idct_2x2_sse2: no zero-column shortcut; columns 0, 1, 3, 5 and 7
// in 32 bits, the odd columns packed to 16 bits for the second pass, the DC
// column shifted back up in 32 bits.
void idct_2x2(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
  int16_t d[64];
  for (int k = 0; k < 64; k++) d[k] = wrap16(in[k] * q[k]);  // pmullw
  int32_t a[2][8];  // a[row][col]: the first pass's rows 0 and 1
  for (int col : {0, 1, 3, 5, 7}) {
    const int32_t t0 = w32(int64_t{madd(d[8 + col], d[24 + col], R_3_624, -R_1_272)} +
                           madd(d[40 + col], d[56 + col], R_0_850, -R_0_720));
    const int32_t t10 = w32(int64_t{d[col]} * (1 << 15));
    a[0][col] = w32(int64_t{t10} + t0 + (1 << 12)) >> 13;
    a[1][col] = w32(int64_t{t10} - t0 + (1 << 12)) >> 13;
  }
  for (int row = 0; row < 2; row++) {
    const int32_t* r = a[row];
    const int32_t t0 = w32(int64_t{madd(sat16(r[1]), sat16(r[3]), R_3_624, -R_1_272)} +
                           madd(sat16(r[5]), sat16(r[7]), R_0_850, -R_0_720));
    const int32_t t10 = w32(int64_t{r[0]} * (1 << 15));
    uint8_t* o = out + static_cast<size_t>(row) * stride;
    o[0] = out8(sat16(w32(int64_t{t10} + t0 + (1 << 19)) >> 20));
    o[1] = out8(sat16(w32(int64_t{t10} - t0 + (1 << 19)) >> 20));
  }
}

// jsimd_idct_4x4_sse2: when rows 1-3 and 5-7 of the whole block are zero,
// the first pass is the dequantized DC shifted in 16 bits; otherwise every
// column in 32 bits, saturated to 16; the second pass in 32 bits.
void idct_4x4(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
  int16_t d[64], ws[4][8];
  for (int k = 0; k < 64; k++) d[k] = wrap16(in[k] * q[k]);  // pmullw
  bool ac_zero = true;
  for (int row : {1, 2, 3, 5, 6, 7})
    for (int col = 0; col < 8; col++)
      if (in[row * 8 + col]) ac_zero = false;
  for (int col = 0; col < 8; col++) {
    if (ac_zero) {
      const int16_t v = wrap16(d[col] * 4);  // psllw by PASS1_BITS
      for (int row = 0; row < 4; row++) ws[row][col] = v;
      continue;
    }
    const int16_t* x = d + col;
    const int32_t t0 = w32(int64_t{madd(x[8], x[24], R_1_061, -R_2_172)} +
                           madd(x[40], x[56], R_1_451, -R_0_211));
    const int32_t t2 = w32(int64_t{madd(x[8], x[24], R_2_562, R_0_899)} +
                           madd(x[40], x[56], -R_0_601, -R_0_509));
    const int32_t e = madd(x[16], x[48], R_1_847, -R_0_765);
    const int32_t t10 = w32(int64_t{x[0]} * (1 << 14) + e);
    const int32_t t12 = w32(int64_t{x[0]} * (1 << 14) - e);
    ws[0][col] = sat16(w32(int64_t{t10} + t2 + (1 << 11)) >> 12);
    ws[3][col] = sat16(w32(int64_t{t10} - t2 + (1 << 11)) >> 12);
    ws[1][col] = sat16(w32(int64_t{t12} + t0 + (1 << 11)) >> 12);
    ws[2][col] = sat16(w32(int64_t{t12} - t0 + (1 << 11)) >> 12);
  }
  for (int row = 0; row < 4; row++) {
    const int16_t* x = ws[row];
    const int32_t t0 = w32(int64_t{madd(x[1], x[3], R_1_061, -R_2_172)} +
                           madd(x[5], x[7], R_1_451, -R_0_211));
    const int32_t t2 = w32(int64_t{madd(x[1], x[3], R_2_562, R_0_899)} +
                           madd(x[5], x[7], -R_0_601, -R_0_509));
    const int32_t e = madd(x[2], x[6], R_1_847, -R_0_765);
    const int32_t t10 = w32(int64_t{x[0]} * (1 << 14) + e);
    const int32_t t12 = w32(int64_t{x[0]} * (1 << 14) - e);
    uint8_t* o = out + static_cast<size_t>(row) * stride;
    o[0] = out8(sat16(w32(int64_t{t10} + t2 + (1 << 18)) >> 19));
    o[3] = out8(sat16(w32(int64_t{t10} - t2 + (1 << 18)) >> 19));
    o[1] = out8(sat16(w32(int64_t{t12} + t0 + (1 << 18)) >> 19));
    o[2] = out8(sat16(w32(int64_t{t12} - t0 + (1 << 18)) >> 19));
  }
}

// jidctint.c's N-point kernels, one for both passes: x[0..7] are the inputs
// (x[0] already dc = x[0] << 13 plus the pass's rounding), y[0..N-1] the
// outputs before the pass's final shift.  Where the C code shifts a term
// of the first pass early and adds a term that PASS1_BITS scales (the 6-,
// 10- and 14-point middle outputs), it adds a multiple of the divisor
// before an arithmetic shift, which is the same as adding after it.
constexpr int64_t fix(double x) { return static_cast<int64_t>(x * 8192 + 0.5); }

void kernel3(int64_t dc, const int64_t* x, int64_t* y) {
  const int64_t t12 = x[2] * fix(0.707106781);
  const int64_t t10 = dc + t12, t2 = dc - t12 - t12;
  const int64_t t0 = x[1] * fix(1.224744871);
  y[0] = t10 + t0;
  y[2] = t10 - t0;
  y[1] = t2;
}

void kernel5(int64_t dc, const int64_t* x, int64_t* y) {
  const int64_t z1 = (x[2] + x[4]) * fix(0.790569415);
  const int64_t z2 = (x[2] - x[4]) * fix(0.353553391);
  const int64_t z3 = dc + z2;
  const int64_t t10 = z3 + z1, t11 = z3 - z1, t12 = dc - z2 * 4;
  const int64_t zo = (x[1] + x[3]) * fix(0.831253876);
  const int64_t t0 = zo + x[1] * fix(0.513743148);
  const int64_t t1 = zo - x[3] * fix(2.176250899);
  y[0] = t10 + t0;
  y[4] = t10 - t0;
  y[1] = t11 + t1;
  y[3] = t11 - t1;
  y[2] = t12;
}

void kernel6(int64_t dc, const int64_t* x, int64_t* y) {
  const int64_t c4 = x[4] * fix(0.707106781);
  const int64_t t1 = dc + c4, t11 = dc - c4 - c4;
  const int64_t c2 = x[2] * fix(1.224744871);
  const int64_t t10 = t1 + c2, t12 = t1 - c2;
  const int64_t z1 = x[1], z2 = x[3], z3 = x[5];
  const int64_t o = (z1 + z3) * fix(0.366025404);
  const int64_t o0 = o + (z1 + z2) * 8192, o2 = o + (z3 - z2) * 8192, o1 = (z1 - z2 - z3) * 8192;
  y[0] = t10 + o0;
  y[5] = t10 - o0;
  y[1] = t11 + o1;
  y[4] = t11 - o1;
  y[2] = t12 + o2;
  y[3] = t12 - o2;
}

void kernel7(int64_t dc, const int64_t* x, int64_t* y) {
  int64_t z1 = x[2], z2 = x[4], z3 = x[6];
  int64_t t10 = (z2 - z3) * fix(0.881747734);
  int64_t t12 = (z1 - z2) * fix(0.314692123);
  const int64_t t11 = t10 + t12 + dc - z2 * fix(1.841218003);
  int64_t t0 = z1 + z3;
  z2 -= t0;
  t0 = t0 * fix(1.274162392) + dc;
  t10 += t0 - z3 * fix(0.077722536);
  t12 += t0 - z1 * fix(2.470602249);
  const int64_t t13 = dc + z2 * fix(1.414213562);
  z1 = x[1];
  z2 = x[3];
  z3 = x[5];
  int64_t t1 = (z1 + z2) * fix(0.935414347);
  int64_t t2 = (z1 - z2) * fix(0.170262339);
  t0 = t1 - t2;
  t1 += t2;
  t2 = (z2 + z3) * -fix(1.378756276);
  t1 += t2;
  z2 = (z1 + z3) * fix(0.613604268);
  t0 += z2;
  t2 += z2 + z3 * fix(1.870828693);
  y[0] = t10 + t0;
  y[6] = t10 - t0;
  y[1] = t11 + t1;
  y[5] = t11 - t1;
  y[2] = t12 + t2;
  y[4] = t12 - t2;
  y[3] = t13;
}

void kernel10(int64_t dc, const int64_t* x, int64_t* y) {
  int64_t z1 = x[4] * fix(1.144122806), z2 = x[4] * fix(0.437016024);
  int64_t t10 = dc + z1, t11 = dc - z2;
  const int64_t t22 = dc - (z1 - z2) * 2;
  z2 = x[2];
  int64_t z3 = x[6];
  z1 = (z2 + z3) * fix(0.831253876);
  int64_t t12 = z1 + z2 * fix(0.513743148);
  int64_t t13 = z1 - z3 * fix(2.176250899);
  const int64_t t20 = t10 + t12, t24 = t10 - t12, t21 = t11 + t13, t23 = t11 - t13;
  z1 = x[1];
  z2 = x[3];
  z3 = x[5] * 8192;
  int64_t z4 = x[7];
  t11 = z2 + z4;
  t13 = z2 - z4;
  t12 = t13 * fix(0.309016994);
  z2 = t11 * fix(0.951056516);
  z4 = z3 + t12;
  t10 = z1 * fix(1.396802247) + z2 + z4;
  const int64_t t14 = z1 * fix(0.221231742) - z2 + z4;
  z2 = t11 * fix(0.587785252);
  z4 = z3 - t12 - t13 * 4096;
  t12 = (z1 - t13) * 8192 - z3;
  t11 = z1 * fix(1.260073511) - z2 - z4;
  t13 = z1 * fix(0.642039522) - z2 + z4;
  y[0] = t20 + t10;
  y[9] = t20 - t10;
  y[1] = t21 + t11;
  y[8] = t21 - t11;
  y[2] = t22 + t12;
  y[7] = t22 - t12;
  y[3] = t23 + t13;
  y[6] = t23 - t13;
  y[4] = t24 + t14;
  y[5] = t24 - t14;
}

void kernel12(int64_t dc, const int64_t* x, int64_t* y) {
  const int64_t z3 = dc;
  int64_t z4 = x[4] * fix(1.224744871);
  int64_t t10 = z3 + z4, t11 = z3 - z4;
  int64_t z1 = x[2];
  z4 = z1 * fix(1.366025404);
  z1 *= 8192;
  int64_t z2 = x[6] * 8192;
  int64_t t12 = z1 - z2;
  const int64_t t21 = z3 + t12, t24 = z3 - t12;
  t12 = z4 + z2;
  const int64_t t20 = t10 + t12, t25 = t10 - t12;
  t12 = z4 - z1 - z2;
  const int64_t t22 = t11 + t12, t23 = t11 - t12;
  z1 = x[1];
  z2 = x[3];
  int64_t zz3 = x[5];
  z4 = x[7];
  t11 = z2 * fix(1.306562965);
  int64_t t14 = z2 * -4433;  // -FIX_0_541196100
  t10 = z1 + zz3;
  int64_t t15 = (t10 + z4) * fix(0.860918669);
  t12 = t15 + t10 * fix(0.261052384);
  t10 = t12 + t11 + z1 * fix(0.280143716);
  int64_t t13 = (zz3 + z4) * -fix(1.045510580);
  t12 += t13 + t14 - zz3 * fix(1.478575242);
  t13 += t15 - t11 + z4 * fix(1.586706681);
  t15 += t14 - z1 * fix(0.676326758) - z4 * fix(1.982889723);
  z1 -= z4;
  z2 -= zz3;
  zz3 = (z1 + z2) * 4433;      // FIX_0_541196100
  t11 = zz3 + z1 * 6270;       // FIX_0_765366865
  t14 = zz3 - z2 * 15137;      // FIX_1_847759065
  y[0] = t20 + t10;
  y[11] = t20 - t10;
  y[1] = t21 + t11;
  y[10] = t21 - t11;
  y[2] = t22 + t12;
  y[9] = t22 - t12;
  y[3] = t23 + t13;
  y[8] = t23 - t13;
  y[4] = t24 + t14;
  y[7] = t24 - t14;
  y[5] = t25 + t15;
  y[6] = t25 - t15;
}

void kernel14(int64_t dc, const int64_t* x, int64_t* y) {
  int64_t z1 = dc;
  int64_t z4 = x[4];
  int64_t z2 = z4 * fix(1.274162392), z3 = z4 * fix(0.314692123);
  z4 *= fix(0.881747734);
  const int64_t t10 = z1 + z2, t11 = z1 + z3, t12 = z1 - z4;
  const int64_t t23 = z1 - (z2 + z3 - z4) * 2;
  z1 = x[2];
  z2 = x[6];
  z3 = (z1 + z2) * fix(1.105676686);
  int64_t t13 = z3 + z1 * fix(0.273079590);
  int64_t t14 = z3 - z2 * fix(1.719280954);
  int64_t t15 = z1 * fix(0.613604268) - z2 * fix(1.378756276);
  const int64_t t20 = t10 + t13, t26 = t10 - t13, t21 = t11 + t14, t25 = t11 - t14,
                t22 = t12 + t15, t24 = t12 - t15;
  z1 = x[1];
  z2 = x[3];
  z3 = x[5];
  z4 = x[7] * 8192;
  t14 = z1 + z3;
  int64_t o11 = (z1 + z2) * fix(1.334852607);
  int64_t o12 = t14 * fix(1.197448846);
  const int64_t o10 = o11 + o12 + z4 - z1 * fix(1.126980169);
  t14 *= fix(0.752406978);
  int64_t o16 = t14 - z1 * fix(1.061150426);
  z1 -= z2;
  t15 = z1 * fix(0.467085129) - z4;
  o16 += t15;
  t13 = (z2 + z3) * -fix(0.158341681) - z4;
  o11 += t13 - z2 * fix(0.424103948);
  o12 += t13 - z3 * fix(2.373959773);
  t13 = (z3 - z2) * fix(1.405321284);
  t14 += t13 + z4 - z3 * fix(1.6906431334);
  t15 += t13 + z2 * fix(0.674957567);
  t13 = (z1 - z3) * 8192 + z4;
  y[0] = t20 + o10;
  y[13] = t20 - o10;
  y[1] = t21 + o11;
  y[12] = t21 - o11;
  y[2] = t22 + o12;
  y[11] = t22 - o12;
  y[3] = t23 + t13;
  y[10] = t23 - t13;
  y[4] = t24 + t14;
  y[9] = t24 - t14;
  y[5] = t25 + t15;
  y[8] = t25 - t15;
  y[6] = t26 + o16;
  y[7] = t26 - o16;
}

// jidctint.c's NxN: the first pass over min(N, 8) columns of the
// dequantized block (products in 32 bits, exact), its outputs descaled into
// a 32-bit work array; the second over the N rows of that array.
template <int N, void (*Kernel)(int64_t, const int64_t*, int64_t*)>
void idct_int(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
  constexpr int C = N < 8 ? N : 8;
  int32_t ws[N * C];
  int64_t x[8] = {}, y[N];
  for (int col = 0; col < C; col++) {
    for (int k = 0; k < C; k++) x[k] = in[k * 8 + col] * q[k * 8 + col];
    Kernel(x[0] * 8192 + (1 << 10), x, y);
    for (int i = 0; i < N; i++) ws[i * C + col] = w32(y[i] >> 11);
  }
  for (int row = 0; row < N; row++) {
    for (int k = 0; k < C; k++) x[k] = ws[row * C + k];
    Kernel((x[0] + 16) * 8192, x, y);
    uint8_t* o = out + static_cast<size_t>(row) * stride;
    for (int i = 0; i < N; i++) o[i] = range_limit(y[i] >> 18);
  }
}

// One block of a component whose IDCT is ssize x ssize (jddctmgr.c's
// choice): 8 runs the image's method with its multipliers, every other
// size the raw quantizers.
void idct_scaled(int ssize, int method, const int16_t* in, const Multipliers& m, uint8_t* out,
                 int stride) {
  switch (ssize) {
    case 1: idct_1x1(in, m.i, out); break;
    case 2: idct_2x2(in, m.i, out, stride); break;
    case 3: idct_int<3, kernel3>(in, m.i, out, stride); break;
    case 4: idct_4x4(in, m.i, out, stride); break;
    case 5: idct_int<5, kernel5>(in, m.i, out, stride); break;
    case 6: idct_int<6, kernel6>(in, m.i, out, stride); break;
    case 7: idct_int<7, kernel7>(in, m.i, out, stride); break;
    case 8:
      if (method == kIslow) idct_islow(in, m.i, out, stride);
      else if (method == kIfast) idct_ifast(in, m.i, out, stride);
      else idct_float(in, m.f, out, stride);
      break;
    case 10: idct_int<10, kernel10>(in, m.i, out, stride); break;
    case 12: idct_int<12, kernel12>(in, m.i, out, stride); break;
    case 14: idct_int<14, kernel14>(in, m.i, out, stride); break;
    default: fail("no IDCT of size " + std::to_string(ssize));
  }
}

// ---------------------------------------------------------------------------
// Block smoothing of an incomplete progressive image (jdcoefct.c)
// ---------------------------------------------------------------------------

constexpr int kSavedCoefs = 10;
constexpr int kQPos[kSavedCoefs] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};  // Q00 Q01 Q10 ...

// smoothing_ok: latches the coefficient status of every component.
bool smoothing_ok(const Decoder& d, int latch[][kSavedCoefs], int prev[][kSavedCoefs]) {
  if (!d.progressive) return false;
  bool useful = false;
  for (int ci = 0; ci < d.ncomp; ci++) {
    const Component& c = d.comp[ci];
    if (!c.quant_latched) return false;
    for (int k = 0; k < kSavedCoefs; k++)
      if (c.quant[kQPos[k]] == 0) return false;
    if (c.coef_bits[0] < 0) return false;
    latch[ci][0] = c.coef_bits[0];
    for (int k = 1; k < kSavedCoefs; k++) {
      prev[ci][k] = d.input_scan_number > 1 ? c.prev_coef_bits[k] : -1;
      latch[ci][k] = c.coef_bits[k];
      if (c.coef_bits[k] != 0) useful = true;
    }
  }
  return useful;
}

inline int16_t predict(int64_t num, int64_t q, int al) {
  int pred;
  if (num >= 0) {
    pred = static_cast<int>(((q << 7) + num) / (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  } else {
    pred = static_cast<int>(((q << 7) - num) / (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    pred = -pred;
  }
  return static_cast<int16_t>(pred);
}

// decompress_smooth_data over one component: every block, its missing low
// AC coefficients (and, when no AC data is known, its DC) estimated from the
// DC values of the 5x5 blocks around it.
void smooth_component(Decoder& d, Component& c, int method, const Multipliers& m,
                      const int* latch, const int* prev, uint8_t* plane, int stride) {
  const int last_imcu = d.mcus_y - 1;
  const int last_col = c.bw - 1;
  const int64_t q00 = c.quant[0], q01 = c.quant[1], q10 = c.quant[8], q20 = c.quant[16],
                q11 = c.quant[9], q02 = c.quant[2];
  int16_t ws[64];
  for (int imcu = 0; imcu <= last_imcu; imcu++) {
    int block_rows = c.v;
    if (imcu == last_imcu) {
      block_rows = c.bh % c.v;
      if (block_rows == 0) block_rows = c.v;
    }
    const int* bits = imcu > d.last_good_imcu_row ? prev : latch;
    bool change_dc = true;
    for (int k = 1; k < kSavedCoefs; k++)
      if (bits[k] != -1) change_dc = false;
    int64_t q03 = 0, q12 = 0, q21 = 0, q30 = 0;
    if (change_dc) {
      q03 = c.quant[3];
      q12 = c.quant[10];
      q21 = c.quant[17];
      q30 = c.quant[24];
    }
    for (int br = 0; br < block_rows; br++) {
      const int r = imcu * c.v + br;
      const int16_t* row = d.block(c, r, 0);
      const int16_t* prow = (br > 0 || imcu > 0) ? d.block(c, r - 1, 0) : row;
      const int16_t* pprow = (br > 1 || imcu > 1) ? d.block(c, r - 2, 0) : prow;
      const int16_t* nrow = (br < block_rows - 1 || imcu < last_imcu) ? d.block(c, r + 1, 0) : row;
      const int16_t* nnrow =
          (br < block_rows - 2 || imcu + 1 < last_imcu) ? d.block(c, r + 2, 0) : nrow;
      int DC01, DC02, DC03, DC04, DC05, DC06, DC07, DC08, DC09, DC10, DC11, DC12, DC13, DC14,
          DC15, DC16, DC17, DC18, DC19, DC20, DC21, DC22, DC23, DC24, DC25;
      DC01 = DC02 = DC03 = DC04 = DC05 = pprow[0];
      DC06 = DC07 = DC08 = DC09 = DC10 = prow[0];
      DC11 = DC12 = DC13 = DC14 = DC15 = row[0];
      DC16 = DC17 = DC18 = DC19 = DC20 = nrow[0];
      DC21 = DC22 = DC23 = DC24 = DC25 = nnrow[0];
      for (int b = 0; b <= last_col; b++) {
        const size_t o = static_cast<size_t>(b) * 64;
        std::memcpy(ws, row + o, sizeof(ws));
        if (b == 0 && b < last_col) {
          DC04 = pprow[o + 64];
          DC09 = prow[o + 64];
          DC14 = row[o + 64];
          DC19 = nrow[o + 64];
          DC24 = nnrow[o + 64];
        }
        if (b + 1 < last_col) {
          DC05 = pprow[o + 128];
          DC10 = prow[o + 128];
          DC15 = row[o + 128];
          DC20 = nrow[o + 128];
          DC25 = nnrow[o + 128];
        }
        int al;
        if ((al = bits[1]) != 0 && ws[1] == 0) {  // AC01
          const int64_t num =
              q00 * (change_dc ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 -
                                  13 * DC09 + 3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 +
                                  3 * DC15 - 3 * DC16 + 13 * DC17 - 13 * DC19 + 3 * DC20 -
                                  DC21 - DC22 + DC24 + DC25)
                               : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
          ws[1] = predict(num, q01, al);
        }
        if ((al = bits[2]) != 0 && ws[8] == 0) {  // AC10
          const int64_t num =
              q00 * (change_dc ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 +
                                  13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 + DC16 - 13 * DC17 -
                                  38 * DC18 - 13 * DC19 + DC20 + DC21 + 3 * DC22 + 3 * DC23 +
                                  3 * DC24 + DC25)
                               : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
          ws[8] = predict(num, q10, al);
        }
        if ((al = bits[3]) != 0 && ws[16] == 0) {  // AC20
          const int64_t num =
              q00 * (change_dc ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 -
                                  5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 + DC23)
                               : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23));
          ws[16] = predict(num, q20, al);
        }
        if ((al = bits[4]) != 0 && ws[9] == 0) {  // AC11
          const int64_t num =
              q00 * (change_dc ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 +
                                  DC21 - DC25)
                               : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 -
                                  DC24 + DC04 - DC06 + 10 * DC07 - 10 * DC09));
          ws[9] = predict(num, q11, al);
        }
        if ((al = bits[5]) != 0 && ws[2] == 0) {  // AC02
          const int64_t num =
              q00 * (change_dc ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 +
                                  7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19)
                               : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15));
          ws[2] = predict(num, q02, al);
        }
        if (change_dc) {
          if ((al = bits[6]) != 0 && ws[3] == 0)  // AC03
            ws[3] = predict(q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19), q03, al);
          if ((al = bits[7]) != 0 && ws[10] == 0)  // AC12
            ws[10] = predict(q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19), q12, al);
          if ((al = bits[8]) != 0 && ws[17] == 0)  // AC21
            ws[17] = predict(q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19), q21, al);
          if ((al = bits[9]) != 0 && ws[24] == 0)  // AC30
            ws[24] = predict(q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19), q30, al);
          const int64_t num =
              q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 +
                     6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 +
                     152 * DC13 + 42 * DC14 - 8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 +
                     6 * DC19 - 6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 -
                     2 * DC25);
          ws[0] = predict(num, q00, 0);
        }
        idct_scaled(c.ssize, method, ws, m,
                    plane + static_cast<size_t>(r) * c.ssize * stride + b * c.ssize, stride);
        DC01 = DC02;
        DC02 = DC03;
        DC03 = DC04;
        DC04 = DC05;
        DC06 = DC07;
        DC07 = DC08;
        DC08 = DC09;
        DC09 = DC10;
        DC11 = DC12;
        DC12 = DC13;
        DC13 = DC14;
        DC14 = DC15;
        DC16 = DC17;
        DC17 = DC18;
        DC18 = DC19;
        DC19 = DC20;
        DC21 = DC22;
        DC22 = DC23;
        DC23 = DC24;
        DC24 = DC25;
      }
    }
  }
}

// The output pass of the coefficient controller: every component's blocks
// through the IDCT into its sample plane.
void output_planes(Decoder& d, int method) {
  int latch[kMaxComponents][kSavedCoefs], prev[kMaxComponents][kSavedCoefs];
  const bool smooth = smoothing_ok(d, latch, prev);
  for (int ci = 0; ci < d.ncomp; ci++) {
    Component& c = d.comp[ci];
    // jddctmgr.c: only the 8x8 IDCT takes the image's method and its
    // multipliers; the scaled ones read the raw quantizers.
    const int cmethod = c.ssize == 8 ? method : kIslow;
    Multipliers m;
    make_multipliers(c, cmethod, m);
    const int n = c.ssize, stride = c.bw * n;
    c.plane.assign(static_cast<size_t>(stride) * c.bh * n, 0);
    if (smooth) {
      smooth_component(d, c, cmethod, m, latch[ci], prev[ci], c.plane.data(), stride);
      continue;
    }
    for (int by = 0; by < c.bh; by++)
      for (int bx = 0; bx < c.bw; bx++)
        idct_scaled(n, cmethod, d.block(c, by, bx), m,
                    c.plane.data() + static_cast<size_t>(by) * n * stride + bx * n, stride);
  }
}

// ---------------------------------------------------------------------------
// Upsampling (jdsample.c) and colour conversion (jdcolor.c)
// ---------------------------------------------------------------------------

enum class Up { Full, H2V1Fancy, H1V2Fancy, H2V2Fancy, Replicate };

struct ColorTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  ColorTables() {
    constexpr int kScale = 16;
    constexpr int32_t kHalf = int32_t{1} << (kScale - 1);
    auto fix = [](double x) { return static_cast<int32_t>(x * (1L << kScale) + 0.5); };
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
  }
};
const ColorTables kColor;

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// One component's samples on the output grid, row by row.
struct Upsampler {
  const Component* c;
  Up method;
  int hr, vr;          // replication factors
  int stride;
  std::vector<uint8_t> row;  // the upsampled row (width rounded up)

  const uint8_t* in_row(int y) const {  // jdmainct's edge replication
    y = std::max(0, std::min(y, c->dh - 1));
    return c->plane.data() + static_cast<size_t>(y) * stride;
  }

  const uint8_t* get(int y, int out_w) {
    if (method == Up::Full) return in_row(y);
    uint8_t* o = row.data();
    const int dw = c->dw;
    switch (method) {
      case Up::H2V1Fancy: {
        const uint8_t* in = in_row(y);
        o[0] = in[0];
        o[1] = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
        for (int x = 1; x < dw - 1; x++) {
          int v = in[x] * 3;
          o[2 * x] = static_cast<uint8_t>((v + in[x - 1] + 1) >> 2);
          o[2 * x + 1] = static_cast<uint8_t>((v + in[x + 1] + 2) >> 2);
        }
        int v = in[dw - 1];
        o[2 * dw - 2] = static_cast<uint8_t>((v * 3 + in[dw - 2] + 1) >> 2);
        o[2 * dw - 1] = static_cast<uint8_t>(v);
        break;
      }
      case Up::H1V2Fancy: {
        const int iy = y >> 1;
        const bool below = y & 1;
        const uint8_t* in0 = in_row(iy);
        const uint8_t* in1 = in_row(below ? iy + 1 : iy - 1);
        const int bias = below ? 2 : 1;
        for (int x = 0; x < dw; x++) o[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
        break;
      }
      case Up::H2V2Fancy: {
        const int iy = y >> 1;
        const bool below = y & 1;
        const uint8_t* in0 = in_row(iy);
        const uint8_t* in1 = in_row(below ? iy + 1 : iy - 1);
        int this_sum = in0[0] * 3 + in1[0];
        int next_sum = in0[1] * 3 + in1[1];
        o[0] = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
        o[1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
        int last_sum = this_sum;
        this_sum = next_sum;
        for (int x = 2; x < dw; x++) {
          next_sum = in0[x] * 3 + in1[x];
          o[2 * x - 2] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
          o[2 * x - 1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
          last_sum = this_sum;
          this_sum = next_sum;
        }
        o[2 * dw - 2] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
        o[2 * dw - 1] = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
        break;
      }
      case Up::Replicate: {
        const uint8_t* in = in_row(y / vr);
        const int n = (out_w + hr - 1) / hr;
        for (int x = 0; x < n; x++)
          for (int k = 0; k < hr; k++) o[x * hr + k] = in[x];
        break;
      }
      default:
        break;
    }
    return o;
  }
};

void finish(Decoder& d, uint8_t* out, bool fancy, int method) {
  const int W = d.out_w, H = d.out_h;
  output_planes(d, method);
  // jinit_upsampler: no fancy upsampling at scale 1 (jdmainct.c gives no
  // context rows there); each component's factors are those of its scaled
  // size ("input group") against the output's.
  const bool do_fancy = fancy && d.scale > 1;
  std::vector<Upsampler> ups(d.ncomp);
  for (int i = 0; i < d.ncomp; i++) {
    Component& c = d.comp[i];
    const int h_in = c.h * c.ssize / d.scale, v_in = c.v * c.ssize / d.scale;
    Upsampler& u = ups[i];
    u.c = &c;
    u.stride = c.bw * c.ssize;
    u.hr = d.hmax / h_in;
    u.vr = d.vmax / v_in;
    // jinit_upsampler's choice, in its order.
    if (u.hr == 1 && u.vr == 1) u.method = Up::Full;
    else if (u.hr == 2 && u.vr == 1 && do_fancy && c.dw > 2) u.method = Up::H2V1Fancy;
    else if (u.hr == 1 && u.vr == 2 && do_fancy) u.method = Up::H1V2Fancy;
    else if (u.hr == 2 && u.vr == 2 && do_fancy && c.dw > 2) u.method = Up::H2V2Fancy;
    else u.method = Up::Replicate;
    u.row.assign(static_cast<size_t>(c.dw) * u.hr + 8 * u.hr, 0);
  }
  bool rgb = false;
  if (d.ncomp == 3) {
    if (d.saw_jfif) rgb = false;
    else if (d.saw_adobe) rgb = d.adobe_transform == 0;
    else rgb = d.comp[0].id == 82 && d.comp[1].id == 71 && d.comp[2].id == 66;
  }
  for (int y = 0; y < H; y++) {
    uint8_t* o = out + static_cast<size_t>(y) * W * 3;
    if (d.ncomp == 1) {
      const uint8_t* g = ups[0].get(y, W);
      for (int x = 0; x < W; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = g[x];
      continue;
    }
    const uint8_t* c0 = ups[0].get(y, W);
    const uint8_t* c1 = ups[1].get(y, W);
    const uint8_t* c2 = ups[2].get(y, W);
    if (rgb) {
      for (int x = 0; x < W; x++) {
        o[3 * x] = c0[x];
        o[3 * x + 1] = c1[x];
        o[3 * x + 2] = c2[x];
      }
      continue;
    }
    for (int x = 0; x < W; x++) {
      int yy = c0[x], cb = c1[x], cr = c2[x];
      o[3 * x] = clamp255(yy + kColor.cr_r[cr]);
      o[3 * x + 1] = clamp255(yy + static_cast<int>((kColor.cb_g[cb] + kColor.cr_g[cr]) >> 16));
      o[3 * x + 2] = clamp255(yy + kColor.cb_b[cb]);
    }
  }
}

void header_size(const uint8_t* data, size_t size, int* h, int* w, int* c) {
  Decoder d(data, size);
  d.read_header();
  *h = d.height;
  *w = d.width;
  *c = d.ncomp;
}

std::vector<uint8_t> decode_image(const uint8_t* data, size_t size, bool fancy, int method,
                                  int scale, int* h, int* w) {
  if (method != kIslow && method != kIfast && method != kFloat)
    fail("unknown dct_method " + std::to_string(method));
  Decoder d(data, size);
  d.decode_all();
  d.set_scale(scale);
  std::vector<uint8_t> out(static_cast<size_t>(d.out_w) * d.out_h * 3);
  finish(d, out.data(), fancy, method);
  *h = d.out_h;
  *w = d.out_w;
  return out;
}

// ---------------------------------------------------------------------------
// Pillow's bilinear resample (libImaging/Resample.c), 8 bits per channel
// ---------------------------------------------------------------------------

constexpr int kPrecisionBits = 32 - 8 - 2;

inline double bilinear(double x) {
  if (x < 0.0) x = -x;
  if (x < 1.0) return 1.0 - x;
  return 0.0;
}

// precompute_coeffs + normalize_coeffs_8bpc for box (0, in_size).
int coeffs(int in_size, int out_size, std::vector<int>& bounds, std::vector<int32_t>& kk) {
  const float in0 = 0.0f, in1 = static_cast<float>(in_size);
  const double scale = static_cast<double>(in1 - in0) / out_size;
  double filterscale = scale;
  if (filterscale < 1.0) filterscale = 1.0;
  const double support = 1.0 * filterscale;
  const int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  bounds.assign(static_cast<size_t>(out_size) * 2, 0);
  kk.assign(static_cast<size_t>(out_size) * ksize, 0);
  std::vector<double> k(ksize);
  for (int xx = 0; xx < out_size; xx++) {
    const double center = in0 + (xx + 0.5) * scale;
    double ww = 0.0;
    const double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    int x = 0;
    for (; x < xmax; x++) {
      double wgt = bilinear((x + xmin - center + 0.5) * ss);
      k[x] = wgt;
      ww += wgt;
    }
    for (x = 0; x < xmax; x++)
      if (ww != 0.0) k[x] /= ww;
    for (; x < ksize; x++) k[x] = 0;
    for (x = 0; x < ksize; x++) {
      double v = k[x];
      kk[static_cast<size_t>(xx) * ksize + x] =
          v < 0 ? static_cast<int32_t>(-0.5 + v * (1 << kPrecisionBits))
                : static_cast<int32_t>(0.5 + v * (1 << kPrecisionBits));
    }
    bounds[xx * 2] = xmin;
    bounds[xx * 2 + 1] = xmax;
  }
  return ksize;
}

inline uint8_t clip8(int32_t in) {
  if (in >= (1 << kPrecisionBits << 8)) return 255;
  if (in <= 0) return 0;
  return static_cast<uint8_t>(in >> kPrecisionBits);
}

void resize_bilinear(const uint8_t* in, int ih, int iw, uint8_t* out, int oh, int ow) {
  if (ih == oh && iw == ow) {
    std::memcpy(out, in, static_cast<size_t>(ih) * iw * 3);
    return;
  }
  std::vector<int> bh, bv;
  std::vector<int32_t> kh, kv;
  const int ksh = coeffs(iw, ow, bh, kh);
  const int ksv = coeffs(ih, oh, bv, kv);
  const bool need_h = ow != iw, need_v = oh != ih;
  const int y_first = bv[0];
  const int y_last = bv[(oh - 1) * 2] + bv[(oh - 1) * 2 + 1];
  // Horizontal pass over the rows the vertical pass reads.
  std::vector<uint8_t> tmp;
  const uint8_t* src = in;
  int src_w = iw, row0 = 0;
  if (need_h) {
    const int rows = y_last - y_first;
    tmp.resize(static_cast<size_t>(rows) * ow * 3);
    for (int yy = 0; yy < rows; yy++) {
      const uint8_t* ir = in + static_cast<size_t>(yy + y_first) * iw * 3;
      uint8_t* orow = tmp.data() + static_cast<size_t>(yy) * ow * 3;
      for (int xx = 0; xx < ow; xx++) {
        const int xmin = bh[xx * 2], xmax = bh[xx * 2 + 1];
        const int32_t* k = kh.data() + static_cast<size_t>(xx) * ksh;
        int32_t s0 = 1 << (kPrecisionBits - 1), s1 = s0, s2 = s0;
        for (int x = 0; x < xmax; x++) {
          const uint8_t* px = ir + (x + xmin) * 3;
          s0 += px[0] * k[x];
          s1 += px[1] * k[x];
          s2 += px[2] * k[x];
        }
        orow[xx * 3] = clip8(s0);
        orow[xx * 3 + 1] = clip8(s1);
        orow[xx * 3 + 2] = clip8(s2);
      }
    }
    src = tmp.data();
    src_w = ow;
    row0 = y_first;
  }
  if (!need_v) {
    std::memcpy(out, src + static_cast<size_t>(0) * src_w * 3, static_cast<size_t>(oh) * ow * 3);
    return;
  }
  for (int yy = 0; yy < oh; yy++) {
    const int ymin = bv[yy * 2] - row0, ymax = bv[yy * 2 + 1];
    const int32_t* k = kv.data() + static_cast<size_t>(yy) * ksv;
    uint8_t* orow = out + static_cast<size_t>(yy) * ow * 3;
    for (int xx = 0; xx < ow * 3; xx++) {
      int32_t s = 1 << (kPrecisionBits - 1);
      for (int y = 0; y < ymax; y++) s += src[static_cast<size_t>(y + ymin) * src_w * 3 + xx] * k[y];
      orow[xx] = clip8(s);
    }
  }
}

void set_error(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) {
    std::strncpy(err, msg, static_cast<size_t>(errlen) - 1);
    err[errlen - 1] = '\0';
  }
}

template <typename F>
int guarded(char* err, int errlen, F&& f) {
  try {
    f();
    return 0;
  } catch (const Error& e) {
    set_error(err, errlen, e.what());
    return 1;
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
    return 2;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 3;
  }
}

template <typename F>
void parallel_for(int n, int nthreads, F&& f) {
  std::atomic<int> next(0);
  auto work = [&]() {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) f(i);
  };
  const int threads = std::max(1, std::min(nthreads, n));
  if (threads == 1) {
    work();
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) pool.emplace_back(work);
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// (height, width, components) from the header.
int jd_decode_size(const uint8_t* data, size_t size, int* h, int* w, int* c, char* err,
                   int errlen) {
  return guarded(err, errlen, [&] { header_size(data, size, h, w, c); });
}

// Decode to RGB at scale_num/8 (1..8) into out (capacity bytes); *h, *w
// receive the size.  dct: 0 islow, 1 ifast, 2 float.
int jd_decode(const uint8_t* data, size_t size, int fancy, int dct, int scale_num, uint8_t* out,
              size_t capacity, int* h, int* w, char* err, int errlen) {
  return guarded(err, errlen, [&] {
    std::vector<uint8_t> img = decode_image(data, size, fancy != 0, dct, scale_num, h, w);
    if (img.size() > capacity) fail("output buffer too small");
    std::memcpy(out, img.data(), img.size());
  });
}

// Decode n images on nthreads threads; rc[i] and err[i * errlen] per image.
// Returns the number of failures.
int jd_decode_batch(const uint8_t* const* datas, const size_t* sizes, int n, int fancy, int dct,
                    int scale_num, uint8_t* const* outs, const size_t* capacities, int* hs,
                    int* ws, int nthreads, int* rc, char* errs, int errlen) {
  std::atomic<int> failures(0);
  parallel_for(n, nthreads, [&](int i) {
    rc[i] = jd_decode(datas[i], sizes[i], fancy, dct, scale_num, outs[i], capacities[i], &hs[i],
                      &ws[i], errs + static_cast<size_t>(i) * errlen, errlen);
    if (rc[i]) failures.fetch_add(1);
  });
  return failures.load();
}

// One block of coefficients (natural order) through the IDCT that a
// component with DCT_scaled_size ssize runs (1..7, 8, 10, 12, 14), with the
// raw quantizers quant and, at 8, the method dct; the ssize x ssize samples
// go to out, rows stride bytes apart.
int jd_idct_block(int ssize, int dct, const int16_t* coef, const uint16_t* quant, uint8_t* out,
                  int stride, char* err, int errlen) {
  return guarded(err, errlen, [&] {
    Component c;
    std::memcpy(c.quant, quant, sizeof(c.quant));
    c.quant_latched = true;
    const int method = ssize == 8 ? dct : kIslow;
    Multipliers m;
    make_multipliers(c, method, m);
    idct_scaled(ssize, method, coef, m, out, stride);
  });
}

// Pillow BILINEAR resize of an RGB image [ih, iw, 3] to [oh, ow, 3].
int jd_resize_bilinear(const uint8_t* in, int ih, int iw, uint8_t* out, int oh, int ow,
                       char* err, int errlen) {
  return guarded(err, errlen, [&] {
    if (ih < 1 || iw < 1 || oh < 1 || ow < 1) fail("resize: empty image");
    resize_bilinear(in, ih, iw, out, oh, ow);
  });
}

// Decode each image (fancy upsampling, IDCT dct) and resize it to size x
// size into outs[i] (size * size * 3 bytes), on nthreads threads.  Returns
// the failures.
int jd_decode_resize_batch(const uint8_t* const* datas, const size_t* sizes, int n, int size,
                           int dct, uint8_t* const* outs, int nthreads, int* rc, char* errs,
                           int errlen) {
  std::atomic<int> failures(0);
  parallel_for(n, nthreads, [&](int i) {
    rc[i] = guarded(errs + static_cast<size_t>(i) * errlen, errlen, [&] {
      int h = 0, w = 0;
      std::vector<uint8_t> img = decode_image(datas[i], sizes[i], true, dct, 8, &h, &w);
      resize_bilinear(img.data(), h, w, outs[i], size, size);
    });
    if (rc[i]) failures.fetch_add(1);
  });
  return failures.load();
}

}  // extern "C"
