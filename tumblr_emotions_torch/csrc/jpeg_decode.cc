// JPEG decoder and PIL-bilinear resize for the port's host data path.
//
// Self-contained C++ (no libjpeg underneath) with a plain C ABI bound by
// ctypes from data/jpeg.py.  It decodes as libjpeg-turbo 2.1.5 does with
// dct_method=JDCT_ISLOW, do_fancy_upsampling and scale 8/8, bit for bit:
//
//   * markers: SOI, APPn (JFIF and Adobe are read, the rest skipped), COM,
//     DQT, DHT, SOF0/SOF1/SOF2, DRI, SOS, RSTn, EOI;
//   * Huffman entropy decoding, baseline (sequential, one or several scans)
//     and progressive (spectral selection, successive approximation), with
//     restart intervals;
//   * the islow integer IDCT of jidctint.c (CONST_BITS 13, PASS1_BITS 2,
//     the 1024-entry range-limit table of jdmaster.c);
//   * upsampling as jdsample.c: fancy h2v1, h1v2 and h2v2 (the triangle
//     filters, edge rows replicated as jdmainct.c does), replication for
//     every other integral factor and for components 2 samples wide or less;
//   * YCbCr->RGB with the fixed-point tables of jdcolor.c; RGB copied;
//     grayscale replicated to RGB.
//
// It refuses, with an error message, what the served path never needs:
// arithmetic coding, 12-bit samples, lossless and hierarchical JPEG,
// CMYK/YCCK, and components that do not divide the largest sampling factor.
// Where libjpeg would warn and go on (corrupt or truncated entropy data, a
// missing restart marker, no EOI), this decoder fails the image.
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

// jpeg_natural_order, with 16 extra entries so a corrupt run cannot index
// past the block (as libjpeg pads it).
constexpr int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ---------------------------------------------------------------------------
// Huffman tables (jpeg_make_d_derived_tbl)
// ---------------------------------------------------------------------------

constexpr int kLookBits = 9;

struct Huffman {
  bool present = false;  // read from a DHT segment
  bool derived = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};
  int32_t valoffset[18] = {};
  uint16_t look[1 << kLookBits] = {};  // (length << 8) | symbol; 0 = longer code

  void derive(bool is_dc) {
    int huffsize[257];
    uint32_t huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; l++) {
      int i = bits[l];
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
      if (static_cast<int64_t>(code) >= (int64_t{1} << si))
        fail("corrupt JPEG: bad Huffman table");
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (bits[l]) {
        valoffset[l] = p - static_cast<int32_t>(huffcode[p]);
        p += bits[l];
        maxcode[l] = static_cast<int32_t>(huffcode[p - 1]);
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0xFFFFF;
    std::memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= kLookBits; l++) {
      for (int i = 1; i <= bits[l]; i++, p++) {
        int lookbits = static_cast<int>(huffcode[p]) << (kLookBits - l);
        for (int ctr = 1 << (kLookBits - l); ctr > 0; ctr--)
          look[lookbits++] = static_cast<uint16_t>((l << 8) | vals[p]);
      }
    }
    if (is_dc) {
      for (int i = 0; i < numsymbols; i++)
        if (vals[i] > 15) fail("corrupt JPEG: bad DC Huffman table");
    }
    derived = true;
  }
};

// ---------------------------------------------------------------------------
// Entropy-coded segment reader
// ---------------------------------------------------------------------------

struct BitReader {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  uint64_t buf = 0;   // left-aligned
  int n = 0;          // bits in buf
  int stuffed = 0;    // trailing zero bits in buf that are not data
  bool at_marker = false;
  bool at_end = false;

  void start(const uint8_t* pos, const uint8_t* stop) {
    p = pos;
    end = stop;
    buf = 0;
    n = stuffed = 0;
    at_marker = at_end = false;
  }

  // libjpeg's jpeg_fill_bit_buffer: FF 00 is a data FF, FF FF.. 00 too;
  // FF followed by anything else is a marker, after which zero bits feed.
  void fill() {
    while (n <= 56) {
      uint32_t c = 0;
      if (!at_marker) {
        if (p >= end) {
          at_marker = at_end = true;
        } else {
          c = *p++;
          if (c == 0xFF) {
            const uint8_t* q = p;
            while (q < end && *q == 0xFF) q++;
            if (q >= end) {
              at_marker = at_end = true;
              p = q;
              c = 0;
            } else if (*q == 0) {
              p = q + 1;
            } else {
              at_marker = true;
              p = q - 1;  // the FF before the marker code
              c = 0;
            }
          }
        }
      }
      if (at_marker) stuffed += 8;
      buf |= static_cast<uint64_t>(c) << (56 - n);
      n += 8;
    }
  }

  void consume(int s) {
    buf <<= s;
    n -= s;
    if (n < stuffed) {
      if (at_end) fail("JPEG data truncated: entropy-coded data ends early");
      fail("corrupt JPEG data: premature end of entropy-coded segment");
    }
  }

  int bits(int s) {
    if (s == 0) return 0;
    if (n < s) fill();
    int v = static_cast<int>(buf >> (64 - s));
    consume(s);
    return v;
  }

  int decode(const Huffman& h) {
    if (n < 16) fill();
    int e = h.look[buf >> (64 - kLookBits)];
    if (e) {
      consume(e >> 8);
      return e & 0xFF;
    }
    for (int l = kLookBits + 1; l <= 16; l++) {
      int32_t code = static_cast<int32_t>(buf >> (64 - l));
      if (code <= h.maxcode[l]) {
        int idx = code + h.valoffset[l];
        if (idx < 0 || idx > 255) fail("corrupt JPEG data: bad Huffman code");
        consume(l);
        return h.vals[idx];
      }
    }
    fail("corrupt JPEG data: bad Huffman code");
  }

  // Drop what is left of the segment's bits (at a restart or scan end).
  void discard() {
    buf = 0;
    n = stuffed = 0;
  }
};

inline int extend(int v, int s) {  // HUFF_EXTEND
  return v < (1 << (s - 1)) ? v + static_cast<int>(~0u << s) + 1 : v;
}

// ---------------------------------------------------------------------------
// Decoder state
// ---------------------------------------------------------------------------

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;          // blocks holding the component's samples
  int bw_alloc = 0, bh_alloc = 0;  // blocks of the interleaved MCU grid
  int dw = 0, dh = 0;          // downsampled_width / height
  bool quant_latched = false;
  uint16_t quant[64] = {};     // natural order
  std::vector<int16_t> coef;   // bw_alloc * bh_alloc * 64
  int dc_pred = 0;
  std::vector<uint8_t> plane;  // IDCT output, stride bw * 8
};

struct Decoder {
  const uint8_t* data;
  const uint8_t* end;
  const uint8_t* pos;

  bool have_sof = false, progressive = false;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int mcus_x = 0, mcus_y = 0;
  Component comp[4];
  uint16_t qt[4][64] = {};
  bool qt_defined[4] = {};
  Huffman dc[4], ac[4];
  int restart_interval = 0;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;
  bool saw_eoi = false;
  int scans = 0;

  // Scan parameters.
  int ns = 0, scan_comp[4] = {}, scan_td[4] = {}, scan_ta[4] = {};
  int ss = 0, se = 0, ah = 0, al = 0;
  int eobrun = 0;
  BitReader br;

  Decoder(const uint8_t* d, size_t size) : data(d), end(d + size), pos(d) {}

  int byte() {
    if (pos >= end) fail("JPEG data truncated: no EOI marker");
    return *pos++;
  }
  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  // jdmarker.c next_marker: skip to FF, swallow FF padding, skip FF 00.
  int next_marker() {
    for (;;) {
      int c = byte();
      while (c != 0xFF) c = byte();
      do {
        c = byte();
      } while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  void skip_segment() {
    int len = word();
    if (len < 2) fail("corrupt JPEG: bad marker length");
    if (end - pos < len - 2) fail("JPEG data truncated: no EOI marker");
    pos += len - 2;
  }

  void read_app(int marker) {
    int len = word();
    if (len < 2) fail("corrupt JPEG: bad marker length");
    len -= 2;
    if (end - pos < len) fail("JPEG data truncated: no EOI marker");
    const uint8_t* b = pos;
    if (marker == 0xE0 && len >= 14 && std::memcmp(b, "JFIF\0", 5) == 0)
      saw_jfif = true;
    if (marker == 0xEE && len >= 12 && std::memcmp(b, "Adobe", 5) == 0) {
      saw_adobe = true;
      adobe_transform = b[11];
    }
    pos += len;
  }

  void read_dqt() {
    int len = word() - 2;
    while (len > 0) {
      int pq_tq = byte();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3) fail("corrupt JPEG: bad quantization table index");
      int count = pq ? 128 : 64;
      if (len < 1 + count) fail("corrupt JPEG: bad DQT length");
      for (int i = 0; i < 64; i++) {
        int v = pq ? word() : byte();
        qt[tq][kNatural[i]] = static_cast<uint16_t>(v);
      }
      qt_defined[tq] = true;
      len -= 1 + count;
    }
    if (len != 0) fail("corrupt JPEG: bad DQT length");
  }

  void read_dht() {
    int len = word() - 2;
    while (len > 16) {
      int index = byte();
      int tc = index >> 4, th = index & 15;
      Huffman h;
      int count = 0;
      for (int i = 1; i <= 16; i++) {
        h.bits[i] = static_cast<uint8_t>(byte());
        count += h.bits[i];
      }
      len -= 1 + 16;
      if (count > 256 || count > len) fail("corrupt JPEG: bad Huffman table");
      for (int i = 0; i < count; i++) h.vals[i] = static_cast<uint8_t>(byte());
      h.present = true;
      len -= count;
      if (tc > 1 || th > 3) fail("corrupt JPEG: bad Huffman table index");
      (tc ? ac : dc)[th] = h;
    }
    if (len != 0) fail("corrupt JPEG: bad DHT length");
  }

  void read_sof(int marker) {
    if (have_sof) fail("corrupt JPEG: more than one SOF marker");
    int len = word();
    int precision = byte();
    height = word();
    width = word();
    ncomp = byte();
    if (precision == 12) fail("unsupported JPEG: 12-bit samples");
    if (precision != 8)
      fail("unsupported JPEG: " + std::to_string(precision) + "-bit samples");
    if (len != 8 + 3 * ncomp) fail("corrupt JPEG: bad SOF length");
    if (height <= 0 || width <= 0 || ncomp <= 0)
      fail("corrupt JPEG: empty image (height, width or components 0)");
    if (ncomp == 4) fail("unsupported JPEG: CMYK/YCCK (4 components)");
    if (ncomp != 1 && ncomp != 3)
      fail("unsupported JPEG: " + std::to_string(ncomp) + " components");
    if (static_cast<long long>(width) * height > kMaxPixels)
      fail("unsupported JPEG: image of " + std::to_string(width) + "x" +
           std::to_string(height) + " pixels is too large");
    progressive = marker == 0xC2;
    hmax = vmax = 1;
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
        fail("corrupt JPEG: bad sampling factors");
      if (c.tq > 3) fail("corrupt JPEG: bad quantization table index");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
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
    have_sof = true;
  }

  // Everything up to the first SOS: what decode_size needs.
  void read_header() {
    if (end - pos < 2 || pos[0] != 0xFF || pos[1] != 0xD8)
      fail("not a JPEG: no SOI marker");
    pos += 2;
    for (;;) {
      int m = next_marker();
      if (handle_marker(m)) return;
    }
  }

  // Returns true at SOS (left unread for the scan).
  bool handle_marker(int m) {
    switch (m) {
      case 0xC0: case 0xC1: case 0xC2:
        read_sof(m);
        return false;
      case 0xC3: case 0xC5: case 0xC6: case 0xC7: case 0xCB: case 0xCD:
      case 0xCE: case 0xCF:
        fail("unsupported JPEG: lossless or hierarchical process (SOF" +
             std::to_string(m - 0xC0) + ")");
      case 0xC9: case 0xCA:
        fail("unsupported JPEG: arithmetic coding");
      case 0xCC:  // DAC: only arithmetic files use it
        skip_segment();
        return false;
      case 0xC4:
        read_dht();
        return false;
      case 0xDB:
        read_dqt();
        return false;
      case 0xDD: {
        if (word() != 4) fail("corrupt JPEG: bad DRI length");
        restart_interval = word();
        return false;
      }
      case 0xDA:
        if (!have_sof) fail("corrupt JPEG: SOS before SOF");
        return true;
      case 0xD8:
        fail("corrupt JPEG: second SOI marker");
      case 0xD9:
        saw_eoi = true;
        return true;
      case 0xDC:  // DNL: skipped, as libjpeg does
        skip_segment();
        return false;
      case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4: case 0xD5:
      case 0xD6: case 0xD7: case 0x01:
        return false;  // RSTn or TEM outside a scan: ignored, as libjpeg does
      default:
        if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE) {
          if (m == 0xE0 || m == 0xEE) read_app(m);
          else skip_segment();
          return false;
        }
        fail("corrupt JPEG: unknown marker " + std::to_string(m));
    }
  }

  void allocate() {
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp[i];
      c.coef.assign(static_cast<size_t>(c.bw_alloc) * c.bh_alloc * 64, 0);
    }
  }

  int16_t* block(Component& c, int by, int bx) {
    return c.coef.data() + (static_cast<size_t>(by) * c.bw_alloc + bx) * 64;
  }

  void read_sos() {
    int len = word();
    ns = byte();
    if (ns < 1 || ns > 4 || len != 6 + 2 * ns) fail("corrupt JPEG: bad SOS");
    for (int i = 0; i < ns; i++) {
      int id = byte(), t = byte();
      int ci = -1;
      for (int k = 0; k < ncomp; k++)
        if (comp[k].id == id) ci = k;
      if (ci < 0) fail("corrupt JPEG: SOS names an unknown component");
      for (int k = 0; k < i; k++)
        if (scan_comp[k] == ci) fail("corrupt JPEG: SOS names a component twice");
      scan_comp[i] = ci;
      scan_td[i] = t >> 4;
      scan_ta[i] = t & 15;
      if (scan_td[i] > 3 || scan_ta[i] > 3)
        fail("corrupt JPEG: bad Huffman table index");
    }
    ss = byte();
    se = byte();
    int a = byte();
    ah = a >> 4;
    al = a & 15;
    if (progressive) {
      // jdphuff.c start_pass_phuff_decoder's checks.
      bool bad = false;
      if (ss == 0) {
        if (se != 0) bad = true;
      } else {
        if (se < ss || se > 63 || ns != 1) bad = true;
      }
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad) fail("corrupt JPEG: bad progression parameters");
    }
    if (ns > 1) {
      int blocks = 0;
      for (int i = 0; i < ns; i++) blocks += comp[scan_comp[i]].h * comp[scan_comp[i]].v;
      if (blocks > 10) fail("corrupt JPEG: too many blocks in an MCU");
    }
    for (int i = 0; i < ns; i++) {
      Component& c = comp[scan_comp[i]];
      if (!c.quant_latched) {  // latch_quant_tables
        if (!qt_defined[c.tq]) fail("corrupt JPEG: missing quantization table");
        std::memcpy(c.quant, qt[c.tq], sizeof(c.quant));
        c.quant_latched = true;
      }
      const bool need_dc = !progressive || (ss == 0 && ah == 0);
      const bool need_ac = !progressive || ss != 0;
      if (need_dc) use_table(dc[scan_td[i]], true);
      if (need_ac) use_table(ac[scan_ta[i]], false);
    }
  }

  static void use_table(Huffman& h, bool is_dc) {
    if (!h.present) fail("corrupt JPEG: missing Huffman table");
    if (!h.derived) h.derive(is_dc);
  }

  // --- per-block decoders ---

  void baseline_block(int16_t* b, const Huffman& hd, const Huffman& ha, Component& c) {
    int s = br.decode(hd);
    if (s) s = extend(br.bits(s), s);
    long long pred = static_cast<long long>(c.dc_pred) + s;
    if (pred > INT32_MAX || pred < INT32_MIN) fail("corrupt JPEG data: bad DC coefficient");
    c.dc_pred = static_cast<int>(pred);
    b[0] = static_cast<int16_t>(c.dc_pred);
    for (int k = 1; k < 64; k++) {
      int rs = br.decode(ha);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        s = extend(br.bits(s), s);
        b[kNatural[k]] = static_cast<int16_t>(s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void dc_first_block(int16_t* b, const Huffman& hd, Component& c) {
    int s = br.decode(hd);
    if (s) s = extend(br.bits(s), s);
    long long pred = static_cast<long long>(c.dc_pred) + s;
    if (pred > INT32_MAX || pred < INT32_MIN) fail("corrupt JPEG data: bad DC coefficient");
    c.dc_pred = static_cast<int>(pred);
    b[0] = static_cast<int16_t>(static_cast<unsigned>(c.dc_pred) << al);
  }

  void dc_refine_block(int16_t* b) {
    if (br.bits(1)) b[0] = static_cast<int16_t>(b[0] | (1 << al));
  }

  void ac_first_block(int16_t* b, const Huffman& ha) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    for (int k = ss; k <= se; k++) {
      int rs = br.decode(ha);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        s = extend(br.bits(s), s);
        b[kNatural[k]] = static_cast<int16_t>(static_cast<unsigned>(s) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += br.bits(r);
        eobrun--;
        break;
      }
    }
  }

  void ac_refine_block(int16_t* b, const Huffman& ha) {
    const int p1 = 1 << al;
    const int m1 = -1 * (1 << al);
    int k = ss;
    auto correct = [&](int16_t* coef) {
      if (br.bits(1)) {
        if ((*coef & p1) == 0) {
          if (*coef >= 0) *coef = static_cast<int16_t>(*coef + p1);
          else *coef = static_cast<int16_t>(*coef + m1);
        }
      }
    };
    if (eobrun == 0) {
      for (; k <= se; k++) {
        int rs = br.decode(ha);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          // A newly nonzero coefficient has size 1 (libjpeg warns otherwise).
          s = br.bits(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.bits(r);
          break;
        }
        do {
          int16_t* coef = b + kNatural[k];
          if (*coef != 0) {
            correct(coef);
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= se);
        if (s) b[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t* coef = b + kNatural[k];
        if (*coef != 0) correct(coef);
      }
      eobrun--;
    }
  }

  void decode_block(int i, int16_t* b) {
    Component& c = comp[scan_comp[i]];
    if (!progressive) {
      baseline_block(b, dc[scan_td[i]], ac[scan_ta[i]], c);
    } else if (ss == 0) {
      if (ah == 0) dc_first_block(b, dc[scan_td[i]], c);
      else dc_refine_block(b);
    } else {
      if (ah == 0) ac_first_block(b, ac[scan_ta[i]]);
      else ac_refine_block(b, ac[scan_ta[i]]);
    }
  }

  // At an RSTn: the bits left are padding; the marker must be the next one.
  void restart(int& expected) {
    br.discard();
    pos = br.p;
    int m = next_marker();
    if (m != 0xD0 + expected)
      fail("corrupt JPEG data: expected RST" + std::to_string(expected) + " marker");
    expected = (expected + 1) & 7;
    br.start(pos, end);
    for (int i = 0; i < ns; i++) comp[scan_comp[i]].dc_pred = 0;
    eobrun = 0;
  }

  void decode_scan() {
    read_sos();
    for (int i = 0; i < ns; i++) comp[scan_comp[i]].dc_pred = 0;
    eobrun = 0;
    br.start(pos, end);
    int expected = 0;
    long long mcu = 0;
    if (ns == 1) {
      Component& c = comp[scan_comp[0]];
      for (int by = 0; by < c.bh; by++) {
        for (int bx = 0; bx < c.bw; bx++, mcu++) {
          if (restart_interval && mcu > 0 && mcu % restart_interval == 0) restart(expected);
          decode_block(0, block(c, by, bx));
        }
      }
    } else {
      for (int my = 0; my < mcus_y; my++) {
        for (int mx = 0; mx < mcus_x; mx++, mcu++) {
          if (restart_interval && mcu > 0 && mcu % restart_interval == 0) restart(expected);
          for (int i = 0; i < ns; i++) {
            Component& c = comp[scan_comp[i]];
            for (int v = 0; v < c.v; v++)
              for (int h = 0; h < c.h; h++)
                decode_block(i, block(c, my * c.v + v, mx * c.h + h));
          }
        }
      }
    }
    // Continue from the marker that ended the segment (or the bytes after
    // the last one read, for next_marker to skip).
    br.discard();
    pos = br.p;
    scans++;
  }

  void decode_all() {
    read_header();
    allocate();
    while (!saw_eoi) {
      // pos is just past an SOS marker code.
      decode_scan();
      for (;;) {
        int m = next_marker();
        if (handle_marker(m)) break;
      }
    }
    if (scans == 0) fail("corrupt JPEG: no image data");
  }
};

// ---------------------------------------------------------------------------
// IDCT (jidctint.c jpeg_idct_islow)
// ---------------------------------------------------------------------------

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t FIX_0_298631336 = 2446;
constexpr int32_t FIX_0_390180644 = 3196;
constexpr int32_t FIX_0_541196100 = 4433;
constexpr int32_t FIX_0_765366865 = 6270;
constexpr int32_t FIX_0_899976223 = 7373;
constexpr int32_t FIX_1_175875602 = 9633;
constexpr int32_t FIX_1_501321110 = 12299;
constexpr int32_t FIX_1_847759065 = 15137;
constexpr int32_t FIX_1_961570560 = 16069;
constexpr int32_t FIX_2_053119869 = 16819;
constexpr int32_t FIX_2_562915447 = 20995;
constexpr int32_t FIX_3_072711026 = 25172;

// prepare_range_limit_table, seen from the IDCT: idct_limit[x & 1023].
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; i++) {
      int v;
      if (i < 128) v = i + 128;
      else if (i < 512) v = 255;
      else if (i < 896) v = 0;
      else v = i - 896;
      t[i] = static_cast<uint8_t>(v);
    }
  }
};
const RangeLimit kRange;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t{1} << (n - 1))) >> n; }

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int col = 0; col < 8; col++) {
    const int16_t* ip = in + col;
    const uint16_t* qp = q + col;
    int* wp = ws + col;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 &&
        ip[48] == 0 && ip[56] == 0) {
      int dcval = static_cast<int>(static_cast<int64_t>(ip[0] * static_cast<int>(qp[0])) *
                                   (1 << kPass1Bits));
      for (int r = 0; r < 8; r++) wp[r * 8] = dcval;
      continue;
    }
    int64_t z2 = static_cast<int64_t>(ip[16]) * qp[16];
    int64_t z3 = static_cast<int64_t>(ip[48]) * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = static_cast<int64_t>(ip[0]) * qp[0];
    z3 = static_cast<int64_t>(ip[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * (int64_t{1} << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t{1} << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = static_cast<int64_t>(ip[56]) * qp[56];
    tmp1 = static_cast<int64_t>(ip[40]) * qp[40];
    tmp2 = static_cast<int64_t>(ip[24]) * qp[24];
    tmp3 = static_cast<int64_t>(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits - kPass1Bits;
    wp[0] = static_cast<int>(descale(tmp10 + tmp3, n));
    wp[56] = static_cast<int>(descale(tmp10 - tmp3, n));
    wp[8] = static_cast<int>(descale(tmp11 + tmp2, n));
    wp[48] = static_cast<int>(descale(tmp11 - tmp2, n));
    wp[16] = static_cast<int>(descale(tmp12 + tmp1, n));
    wp[40] = static_cast<int>(descale(tmp12 - tmp1, n));
    wp[24] = static_cast<int>(descale(tmp13 + tmp0, n));
    wp[32] = static_cast<int>(descale(tmp13 - tmp0, n));
  }
  const uint8_t* lim = kRange.t;
  for (int row = 0; row < 8; row++) {
    const int* wp = ws + row * 8;
    uint8_t* op = out + static_cast<size_t>(row) * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 && wp[6] == 0 &&
        wp[7] == 0) {
      uint8_t dc = lim[static_cast<int>(descale(wp[0], kPass1Bits + 3)) & 1023];
      std::memset(op, dc, 8);
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (static_cast<int64_t>(wp[0]) + wp[4]) * (int64_t{1} << kConstBits);
    int64_t tmp1 = (static_cast<int64_t>(wp[0]) - wp[4]) * (int64_t{1} << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits + kPass1Bits + 3;
    op[0] = lim[static_cast<int>(descale(tmp10 + tmp3, n)) & 1023];
    op[7] = lim[static_cast<int>(descale(tmp10 - tmp3, n)) & 1023];
    op[1] = lim[static_cast<int>(descale(tmp11 + tmp2, n)) & 1023];
    op[6] = lim[static_cast<int>(descale(tmp11 - tmp2, n)) & 1023];
    op[2] = lim[static_cast<int>(descale(tmp12 + tmp1, n)) & 1023];
    op[5] = lim[static_cast<int>(descale(tmp12 - tmp1, n)) & 1023];
    op[3] = lim[static_cast<int>(descale(tmp13 + tmp0, n)) & 1023];
    op[4] = lim[static_cast<int>(descale(tmp13 - tmp0, n)) & 1023];
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

void finish(Decoder& d, uint8_t* out, bool fancy) {
  const int W = d.width, H = d.height;
  std::vector<Upsampler> ups(d.ncomp);
  for (int i = 0; i < d.ncomp; i++) {
    Component& c = d.comp[i];
    if (d.hmax % c.h != 0 || d.vmax % c.v != 0)
      fail("unsupported JPEG: fractional sampling factors");
    if (!c.quant_latched) fail("corrupt JPEG: a component has no data");
    // IDCT of the blocks that hold the component's samples.
    const int stride = c.bw * 8;
    c.plane.assign(static_cast<size_t>(stride) * c.bh * 8, 0);
    for (int by = 0; by < c.bh; by++)
      for (int bx = 0; bx < c.bw; bx++)
        idct_islow(d.block(c, by, bx), c.quant,
                   c.plane.data() + static_cast<size_t>(by) * 8 * stride + bx * 8, stride);
    Upsampler& u = ups[i];
    u.c = &c;
    u.stride = stride;
    u.hr = d.hmax / c.h;
    u.vr = d.vmax / c.v;
    // jinit_upsampler's choice, in its order.
    if (u.hr == 1 && u.vr == 1) u.method = Up::Full;
    else if (u.hr == 2 && u.vr == 1 && fancy && c.dw > 2) u.method = Up::H2V1Fancy;
    else if (u.hr == 1 && u.vr == 2 && fancy) u.method = Up::H1V2Fancy;
    else if (u.hr == 2 && u.vr == 2 && fancy && c.dw > 2) u.method = Up::H2V2Fancy;
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
  if (d.saw_eoi) fail("corrupt JPEG: no image data");
  *h = d.height;
  *w = d.width;
  *c = d.ncomp;
}

std::vector<uint8_t> decode_image(const uint8_t* data, size_t size, bool fancy, int* h, int* w) {
  Decoder d(data, size);
  d.decode_all();
  std::vector<uint8_t> out(static_cast<size_t>(d.width) * d.height * 3);
  finish(d, out.data(), fancy);
  *h = d.height;
  *w = d.width;
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

// Decode to RGB into out (capacity bytes); *h, *w receive the size.
int jd_decode(const uint8_t* data, size_t size, int fancy, uint8_t* out, size_t capacity,
              int* h, int* w, char* err, int errlen) {
  return guarded(err, errlen, [&] {
    std::vector<uint8_t> img = decode_image(data, size, fancy != 0, h, w);
    if (img.size() > capacity) fail("output buffer too small");
    std::memcpy(out, img.data(), img.size());
  });
}

// Decode n images on nthreads threads; rc[i] and err[i * errlen] per image.
// Returns the number of failures.
int jd_decode_batch(const uint8_t* const* datas, const size_t* sizes, int n, int fancy,
                    uint8_t* const* outs, const size_t* capacities, int* hs, int* ws,
                    int nthreads, int* rc, char* errs, int errlen) {
  std::atomic<int> failures(0);
  parallel_for(n, nthreads, [&](int i) {
    rc[i] = jd_decode(datas[i], sizes[i], fancy, outs[i], capacities[i], &hs[i], &ws[i],
                      errs + static_cast<size_t>(i) * errlen, errlen);
    if (rc[i]) failures.fetch_add(1);
  });
  return failures.load();
}

// Pillow BILINEAR resize of an RGB image [ih, iw, 3] to [oh, ow, 3].
int jd_resize_bilinear(const uint8_t* in, int ih, int iw, uint8_t* out, int oh, int ow,
                       char* err, int errlen) {
  return guarded(err, errlen, [&] {
    if (ih < 1 || iw < 1 || oh < 1 || ow < 1) fail("resize: empty image");
    resize_bilinear(in, ih, iw, out, oh, ow);
  });
}

// Decode each image and resize it to size x size into outs[i]
// (size * size * 3 bytes), on nthreads threads.  Returns the failures.
int jd_decode_resize_batch(const uint8_t* const* datas, const size_t* sizes, int n, int size,
                           uint8_t* const* outs, int nthreads, int* rc, char* errs,
                           int errlen) {
  std::atomic<int> failures(0);
  parallel_for(n, nthreads, [&](int i) {
    rc[i] = guarded(errs + static_cast<size_t>(i) * errlen, errlen, [&] {
      int h = 0, w = 0;
      std::vector<uint8_t> img = decode_image(datas[i], sizes[i], true, &h, &w);
      resize_bilinear(img.data(), h, w, outs[i], size, size);
    });
    if (rc[i]) failures.fetch_add(1);
  });
  return failures.load();
}

}  // extern "C"
