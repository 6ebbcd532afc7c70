"""Write the JPEG fixtures of the port's decoder tests, and their manifest.

    python tests/data/jpeg/make_fixtures.py

Every image is made from a seeded, smooth numpy image (a coarse random grid
upscaled, plus mild noise).  Most are written by PIL (libjpeg-turbo): the
4:4:4, 4:2:2 and 4:2:0 layouts, progressive 4:2:0 and 4:4:4, grayscale,
restart markers (``restart_marker_blocks``/``restart_marker_rows``) and odd
sizes.  PIL cannot write other sampling factors, so a small baseline
encoder here (float DCT, the standard Huffman tables taken from a PIL file)
writes 4:4:0 (h1v2), 4:1:1, mixed chroma factors, grayscale with 2x2
factors and an RGB (no colour transform) file.

Beside them, in subdirectories (so the tests that take every ``*.jpg`` of
this directory as a data set keep theirs):

- ``arith/``: arithmetic-coded files (sequential 4:2:0, 4:4:4 with restarts
  and DAC conditioning, progressive 4:2:0, grayscale), transcoded from the
  fixtures above with ``arith_code`` set, as ``jpegtran -arithmetic`` does,
  by a small C helper compiled here against this machine's ``jpeglib.h``;
- ``crafted/``: coefficients and quantizers that overflow the 16-bit SIMD
  IDCTs, a sequential file without DHT (the standard tables), a stray FF in
  a scan (libjpeg's fast Huffman path and its fall-back), and a
  hand-encoded file with 4x2 luma factors (scaled decoding scales its
  chroma up from a factor of 4 in the IDCT, then upsamples it h2v1);
- ``corrupt/``: a seeded set of corrupt variants of the fixtures: cuts
  inside the scans, no EOI, removed and duplicated restart markers, garbage
  before markers, byte flips, and forms the reference refuses.

``manifest.json`` records, per file, its layout and either that the JAX
package's decoder (``tumblr_emotions_tpu.data.jpeg.decode``, libjpeg-turbo,
fancy upsampling) refuses it, or the sha256 of its decode under each
``dct_method`` (``decode_sha256`` is islow's), of its decode at each
``scale_num`` from 1 to 7 under each ``dct_method``
(``decode_sha256_by_scale``, null where the reference refuses it) and of PIL's
BILINEAR resize of the islow decode to 347x347
(``tumblr_emotions_tpu.data.pipeline._host_resize_uint8``).  The port's
tests and ``chip_smoke.py`` hold the port's decoder and resize to these
hashes.  This is the one file that imports PIL and the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import io
import json
import math
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[2]))

from tumblr_emotions_tpu.data import jpeg as ref_jpeg  # noqa: E402
from tumblr_emotions_tpu.data.pipeline import _host_resize_uint8  # noqa: E402

HOST_SIZE = 347
METHODS = ("islow", "ifast", "float")
SCALES = range(1, 8)  # scale_num of the scaled hashes (8 is decode_sha256_by_method)
SUBDIRS = ("arith", "crafted", "corrupt")
NATURAL = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48,
           41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15,
           23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]


def smooth(rng, h, w, channels=3, grid=5, noise=6.0):
    lo = rng.uniform(0, 255, (grid, grid, channels)).astype(np.uint8)
    im = np.asarray(Image.fromarray(lo if channels == 3 else lo[..., 0]).resize(
        (w, h), Image.BICUBIC), np.float32)
    im = im + rng.normal(0, noise, im.shape)
    return np.clip(im, 0, 255).astype(np.uint8)


def pil_jpeg(a, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, format="JPEG", **kw)
    return buf.getvalue()


# ---- a minimal baseline encoder for the factors PIL cannot write ----

def segments(data: bytes):
    """(marker, payload) of each marker segment before the first SOS."""
    i = 2
    while i < len(data):
        m = data[i + 1]
        n = int.from_bytes(data[i + 2:i + 4], "big")
        yield m, data[i + 4:i + 2 + n]
        if m == 0xDA:
            return
        i += 2 + n


def standard_tables():
    """The DC and AC tables 0 of a PIL (libjpeg) file: Annex K's luminance
    tables, as (bits[16], values) each."""
    tables = {}
    for m, p in segments(pil_jpeg(np.zeros((8, 8, 3), np.uint8))):
        if m != 0xC4:
            continue
        j = 0
        while j < len(p):
            tc_th, bits = p[j], list(p[j + 1:j + 17])
            vals = list(p[j + 17:j + 17 + sum(bits)])
            tables[tc_th] = (bits, vals)
            j += 17 + sum(bits)
    return tables[0x00], tables[0x10]


def codes(bits, vals):
    out, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            out[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


class BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value, length):
        for i in range(length - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc = self.n = 0

    def flush(self):
        while self.n:
            self.put(1, 1)


def dct_matrix():
    d = np.zeros((8, 8))
    for u in range(8):
        for x in range(8):
            d[u, x] = math.sqrt((1 if u == 0 else 2) / 8) * math.cos((2 * x + 1) * u * math.pi / 16)
    return d


def encode(planes, factors, width, height, ids=(1, 2, 3), quant=6, restart=0) -> bytes:
    """Baseline JPEG of component planes (each already at its own sampling:
    ceil(height * v / vmax) x ceil(width * h / hmax)), one interleaved scan
    (or one component scan), quantizer ``quant`` everywhere."""
    (dc_bits, dc_vals), (ac_bits, ac_vals) = standard_tables()
    dc_codes, ac_codes = codes(dc_bits, dc_vals), codes(ac_bits, ac_vals)
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    mx, my = math.ceil(width / (8 * hmax)), math.ceil(height / (8 * vmax))
    D = dct_matrix()
    coefs = []
    for plane, (h, v) in zip(planes, factors):
        if len(planes) == 1:
            bh, bw = math.ceil(plane.shape[0] / 8), math.ceil(plane.shape[1] / 8)
        else:
            bh, bw = my * v, mx * h
        p = np.pad(plane.astype(np.float64) - 128,
                   ((0, bh * 8 - plane.shape[0]), (0, bw * 8 - plane.shape[1])), mode="edge")
        blocks = p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        coefs.append(np.rint(D @ blocks @ D.T / quant).astype(int))
    bw = BitWriter()
    pred = [0] * len(planes)

    def category(x):
        return 0 if x == 0 else int(abs(x)).bit_length()

    def put_value(x, s):
        bw.put(x if x >= 0 else x + (1 << s) - 1, s)

    def block(ci, blk):
        z = blk.reshape(64)[NATURAL]
        diff = int(z[0]) - pred[ci]
        pred[ci] = int(z[0])
        s = category(diff)
        bw.put(*dc_codes[s])
        put_value(diff, s)
        run = 0
        for k in range(1, 64):
            if z[k] == 0:
                run += 1
                continue
            while run > 15:
                bw.put(*ac_codes[0xF0])
                run -= 16
            s = category(int(z[k]))
            bw.put(*ac_codes[(run << 4) | s])
            put_value(int(z[k]), s)
            run = 0
        if run:
            bw.put(*ac_codes[0x00])

    units = []
    if len(planes) == 1:
        c = coefs[0]
        units = [[(0, c[y, x])] for y in range(c.shape[0]) for x in range(c.shape[1])]
    else:
        for y in range(my):
            for x in range(mx):
                units.append([(ci, coefs[ci][y * v + dy, x * h + dx])
                              for ci, (h, v) in enumerate(factors)
                              for dy in range(v) for dx in range(h)])
    data = bytearray()
    for k, unit in enumerate(units):
        if restart and k and k % restart == 0:
            bw.flush()
            data += bw.out + bytes([0xFF, 0xD0 + (k // restart - 1) % 8])
            bw.out = bytearray()
            pred = [0] * len(planes)
        for ci, blk in unit:
            block(ci, blk)
    bw.flush()
    data += bw.out

    def seg(marker, payload):
        return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload

    out = bytearray(b"\xff\xd8")
    out += seg(0xDB, bytes([0]) + bytes([quant] * 64))
    sof = bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big") + bytes([len(planes)])
    for cid, (h, v) in zip(ids, factors):
        sof += bytes([cid, (h << 4) | v, 0])
    out += seg(0xC0, sof)
    out += seg(0xC4, bytes([0x00]) + bytes(dc_bits) + bytes(dc_vals)
               + bytes([0x10]) + bytes(ac_bits) + bytes(ac_vals))
    if restart:
        out += seg(0xDD, restart.to_bytes(2, "big"))
    sos = bytes([len(planes)])
    for cid in ids[:len(planes)]:
        sos += bytes([cid, 0x00])
    out += seg(0xDA, sos + bytes([0, 63, 0]))
    out += data + b"\xff\xd9"
    return bytes(out)


def planes_for(rng, width, height, factors):
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    return [smooth(rng, math.ceil(height * v / vmax), math.ceil(width * h / hmax), channels=1)
            for h, v in factors]


def fixtures():
    rng = np.random.RandomState(0)
    out = {}

    def pil(name, layout, h, w, gray=False, **kw):
        a = smooth(rng, h, w, channels=1 if gray else 3)
        out[name] = (layout, pil_jpeg(a, **kw))

    pil("baseline_444_64x48.jpg", "baseline 4:4:4", 48, 64, quality=90, subsampling=0)
    pil("baseline_422_57x41.jpg", "baseline 4:2:2 (h2v1)", 41, 57, quality=90, subsampling=1)
    pil("baseline_420_403x301.jpg", "baseline 4:2:0 (h2v2), odd size", 301, 403, quality=85,
        subsampling=2)
    pil("progressive_420_161x97.jpg", "progressive 4:2:0", 97, 161, quality=88, subsampling=2,
        progressive=True)
    pil("progressive_444_49x35.jpg", "progressive 4:4:4", 35, 49, quality=92, subsampling=0,
        progressive=True)
    pil("gray_31x23.jpg", "baseline grayscale", 23, 31, gray=True, quality=90)
    pil("restart4_420_96x80.jpg", "baseline 4:2:0, restart every 4 MCUs", 80, 96, quality=90,
        subsampling=2, restart_marker_blocks=4)
    pil("gray_progressive_restart_40x24.jpg", "progressive grayscale, restart every MCU row",
        24, 40, gray=True, quality=90, progressive=True, restart_marker_rows=1)
    pil("tiny_420_1x1.jpg", "baseline 4:2:0, 1x1", 1, 1, quality=90, subsampling=2)
    pil("odd_420_17x9.jpg", "baseline 4:2:0, 17x9", 9, 17, quality=90, subsampling=2)

    def hand(name, layout, w, h, factors, **kw):
        out[name] = (layout, encode(planes_for(rng, w, h, factors), factors, w, h, **kw))

    hand("h1v2_440_37x29.jpg", "baseline 4:4:0 (Y 1x2), hand-encoded", 37, 29,
         [(1, 2), (1, 1), (1, 1)])
    hand("h4v1_411_45x21.jpg", "baseline 4:1:1 (Y 4x1), hand-encoded", 45, 21,
         [(4, 1), (1, 1), (1, 1)])
    hand("mixed_y22_cb12_cr21_33x19.jpg",
         "baseline Y 2x2, Cb 1x2, Cr 2x1, restart every 2 MCUs, hand-encoded", 33, 19,
         [(2, 2), (1, 2), (2, 1)], restart=2)
    hand("gray_22_23x13.jpg", "baseline grayscale with 2x2 factors, hand-encoded", 23, 13,
         [(2, 2)])
    hand("rgb_444_16x12.jpg", "baseline RGB (component ids R, G, B: no colour transform), "
         "hand-encoded", 16, 12, [(1, 1), (1, 1), (1, 1)], ids=(82, 71, 66))
    return out


# ---- transcoding with libjpeg (arithmetic coding, crafted coefficients) ----

HELPER = r"""
#include <setjmp.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <jpeglib.h>

struct err { struct jpeg_error_mgr pub; jmp_buf jb; };
static void on_error(j_common_ptr c) { longjmp(((struct err*)c->err)->jb, 1); }
static void quiet(j_common_ptr c, int l) { (void)c; (void)l; }

/* Rewrite a JPEG's coefficients, as jpegtran does: arith sets arith_code,
   progressive the standard progression, restart_rows a restart interval,
   dac (L, U, K) the arithmetic conditioning of every table; coefs, when
   given, replaces every block (component by component, row by row, 64
   quantized values in natural order) and quant every nonzero quantizer
   (table slot by slot).  Returns 0 and a malloc'd buffer. */
int transcode(const unsigned char* in, unsigned long insize, int arith, int progressive,
              int restart_rows, const int* dac, const short* coefs,
              const unsigned short* quant, unsigned char** out, unsigned long* outsize) {
  struct jpeg_decompress_struct src;
  struct jpeg_compress_struct dst;
  struct err e1, e2;
  src.err = jpeg_std_error(&e1.pub);
  e1.pub.error_exit = on_error;
  e1.pub.emit_message = quiet;
  dst.err = jpeg_std_error(&e2.pub);
  e2.pub.error_exit = on_error;
  e2.pub.emit_message = quiet;
  *out = NULL;
  *outsize = 0;
  jpeg_create_decompress(&src);
  jpeg_create_compress(&dst);
  if (setjmp(e1.jb) || setjmp(e2.jb)) {
    jpeg_destroy_decompress(&src);
    jpeg_destroy_compress(&dst);
    return 1;
  }
  jpeg_mem_src(&src, (unsigned char*)in, insize);
  jpeg_read_header(&src, TRUE);
  jvirt_barray_ptr* arrays = jpeg_read_coefficients(&src);
  jpeg_copy_critical_parameters(&src, &dst);
  if (quant)
    for (int t = 0; t < 4; t++)
      if (dst.quant_tbl_ptrs[t])
        for (int k = 0; k < 64; k++)
          if (quant[t * 64 + k]) dst.quant_tbl_ptrs[t]->quantval[k] = quant[t * 64 + k];
  if (coefs) {
    long at = 0;
    for (int ci = 0; ci < src.num_components; ci++) {
      jpeg_component_info* c = &src.comp_info[ci];
      for (JDIMENSION r = 0; r < c->height_in_blocks; r++) {
        JBLOCKARRAY row = (*src.mem->access_virt_barray)((j_common_ptr)&src, arrays[ci], r, 1,
                                                          TRUE);
        for (JDIMENSION b = 0; b < c->width_in_blocks; b++, at += 64)
          memcpy(row[0][b], coefs + at, 64 * sizeof(short));
      }
    }
  }
  dst.arith_code = arith ? TRUE : FALSE;
  dst.optimize_coding = arith ? FALSE : TRUE;
  if (dac)
    for (int t = 0; t < 16; t++) {
      dst.arith_dc_L[t] = (UINT8)dac[0];
      dst.arith_dc_U[t] = (UINT8)dac[1];
      dst.arith_ac_K[t] = (UINT8)dac[2];
    }
  if (progressive) jpeg_simple_progression(&dst);
  dst.restart_in_rows = restart_rows;
  jpeg_mem_dest(&dst, out, outsize);
  jpeg_write_coefficients(&dst, arrays);
  jpeg_finish_compress(&dst);
  jpeg_destroy_compress(&dst);
  jpeg_finish_decompress(&src);
  jpeg_destroy_decompress(&src);
  return 0;
}

void release(unsigned char* p) { free(p); }
"""


def helper(tmp: Path) -> ctypes.CDLL:
    """The transcoding helper, compiled against this machine's libjpeg."""
    (tmp / "transcode.c").write_text(HELPER)
    subprocess.run(["cc", "-O2", "-shared", "-fPIC", "-o", str(tmp / "libtranscode.so"),
                    str(tmp / "transcode.c"), "-ljpeg"], check=True)
    lib = ctypes.CDLL(str(tmp / "libtranscode.so"))
    p = ctypes.c_void_p
    lib.transcode.argtypes = [ctypes.c_char_p, ctypes.c_ulong, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, p, p, p, ctypes.POINTER(p),
                              ctypes.POINTER(ctypes.c_ulong)]
    lib.release.argtypes = [p]
    return lib


def transcode(lib, data: bytes, arith=False, progressive=False, restart_rows=0, dac=None,
              coefs=None, quant=None) -> bytes:
    out, size = ctypes.c_void_p(), ctypes.c_ulong()
    dac_a = None if dac is None else np.asarray(dac, np.int32)
    args = [None if a is None else a.ctypes.data for a in (dac_a, coefs, quant)]
    if lib.transcode(data, len(data), int(arith), int(progressive), restart_rows, *args,
                     ctypes.byref(out), ctypes.byref(size)):
        raise RuntimeError("libjpeg refused the transcode")
    body = ctypes.string_at(out, size.value)
    lib.release(out)
    return body


def blocks_of(data: bytes) -> int:
    """Blocks of every component (width_in_blocks x height_in_blocks)."""
    m = next((m, p) for m, p in segments(data) if m in (0xC0, 0xC1, 0xC2))[1]
    h, w, n = int.from_bytes(m[1:3], "big"), int.from_bytes(m[3:5], "big"), m[5]
    hv = [(m[7 + 3 * k] >> 4, m[7 + 3 * k] & 15) for k in range(n)]
    hmax, vmax = max(a for a, _ in hv), max(b for _, b in hv)
    return sum(math.ceil(math.ceil(w * a / hmax) / 8) * math.ceil(math.ceil(h * b / vmax) / 8)
               for a, b in hv)


def coded(lib, base):
    """The arithmetic-coded and crafted files, from the fixtures ``base``."""
    rng = np.random.RandomState(1)
    out = {
        "arith/seq_420_96x80.jpg": ("arithmetic sequential 4:2:0", transcode(
            lib, base["restart4_420_96x80.jpg"], arith=True)),
        "arith/seq_444_restart_dac_64x48.jpg": (
            "arithmetic sequential 4:4:4, restart every MCU row, DAC conditioning "
            "(L=1, U=4, K=10)", transcode(lib, base["baseline_444_64x48.jpg"], arith=True,
                                          restart_rows=1, dac=(1, 4, 10))),
        "arith/progressive_420_161x97.jpg": ("arithmetic progressive 4:2:0", transcode(
            lib, base["progressive_420_161x97.jpg"], arith=True, progressive=True)),
        "arith/gray_31x23.jpg": ("arithmetic sequential grayscale", transcode(
            lib, base["gray_31x23.jpg"], arith=True)),
    }
    gray = base["gray_31x23.jpg"]
    coefs = rng.randint(-1023, 1024, blocks_of(gray) * 64).astype(np.int16)
    coefs.reshape(-1, 64)[::3, 8:] = 0                # some blocks DC-row only
    coefs.reshape(-1, 64)[:, 0] = rng.randint(-1000, 1000, blocks_of(gray))
    quant = rng.randint(1, 65536, 256).astype(np.uint16)
    out["crafted/extreme_coefficients_gray_31x23.jpg"] = (
        "huge coefficients and 16-bit quantizers: the SIMD IDCTs' 16-bit wrap and "
        "saturation", transcode(lib, gray, coefs=coefs, quant=quant))
    out["crafted/extreme_coefficients_420_17x9.jpg"] = (
        "huge coefficients and 8-bit quantizers, 4:2:0", transcode(
            lib, base["odd_420_17x9.jpg"], quant=rng.randint(100, 256, 256).astype(np.uint16),
            coefs=rng.randint(-400, 400, blocks_of(base["odd_420_17x9.jpg"]) * 64)
            .astype(np.int16)))
    d = base["baseline_444_64x48.jpg"]
    j = d.index(b"\xff\x00", scan_span(d)[0])
    out["crafted/stray_ff_444_64x48.jpg"] = (
        "an FF inserted before an FF 00 of the scan: libjpeg's fast Huffman path reads a "
        "marker there and the slow path decodes the MCU again over its writes",
        d[:j] + b"\xff" + d[j:])
    d = base["baseline_422_57x41.jpg"]
    for m, p in list(segments(d)):
        if m == 0xC4:
            d = d.replace(b"\xff\xc4" + (len(p) + 2).to_bytes(2, "big") + p, b"", 1)
    out["crafted/no_dht_422_57x41.jpg"] = (
        "baseline 4:2:2 without DHT: the standard Huffman tables", d)
    factors = [(4, 2), (1, 1), (1, 1)]
    out["crafted/h4v2_42x26.jpg"] = (
        "baseline Y 4x2, Cb and Cr 1x1, hand-encoded: at scale_num below 8 the chroma's "
        "IDCT is twice the luma's and the upsampler's factors are 2x1",
        encode(planes_for(np.random.RandomState(3), 42, 26, factors), factors, 42, 26))
    return out


def scan_span(data: bytes):
    """(start, end) of the entropy-coded data after the first SOS."""
    i = data.index(b"\xff\xda")
    return i + 2 + int.from_bytes(data[i + 2:i + 4], "big"), len(data) - 2


def corrupt(files):
    """Seeded corrupt variants of ``files``: {name: (layout, bytes)}."""
    rng = np.random.RandomState(2)
    out = {}

    def add(name, layout, body):
        out["corrupt/" + name] = (layout, bytes(body))

    for src, stem in (("restart4_420_96x80.jpg", "restart4_420"),
                      ("progressive_420_161x97.jpg", "progressive_420"),
                      ("arith/progressive_420_161x97.jpg", "arith_progressive_420"),
                      ("h1v2_440_37x29.jpg", "h1v2_440")):
        d = files[src][1]
        s, e = scan_span(d)
        for frac in (0.3, 0.75):
            add(f"{stem}_cut{int(frac * 100)}.jpg", f"{src} cut at {frac:.0%} of its data",
                d[:s + int((e - s) * frac)])
    for src, stem in (("baseline_422_57x41.jpg", "baseline_422"),
                      ("arith/seq_420_96x80.jpg", "arith_seq_420")):
        add(f"{stem}_no_eoi.jpg", f"{src} without its EOI", files[src][1][:-2])
    for src, stem in (("restart4_420_96x80.jpg", "restart4_420"),
                      ("gray_progressive_restart_40x24.jpg", "gray_progressive_restart"),
                      ("arith/seq_444_restart_dac_64x48.jpg", "arith_seq_444_restart")):
        d = files[src][1]
        rst = [m.start() for m in re.finditer(b"\xff[\xd0-\xd7]", d)]
        i = rst[len(rst) // 2]
        add(f"{stem}_rst_removed.jpg", f"{src} with a restart marker removed", d[:i] + d[i + 2:])
        i = rst[len(rst) // 3]
        add(f"{stem}_rst_duplicated.jpg", f"{src} with a restart marker duplicated",
            d[:i] + d[i:i + 2] + d[i:])
    for src, stem in (("baseline_444_64x48.jpg", "baseline_444"),
                      ("progressive_444_49x35.jpg", "progressive_444")):
        d = files[src][1]
        marks = [m.start() for m in re.finditer(b"\xff[\xc4\xda\xd9]", d)]
        for k, i in enumerate((marks[len(marks) // 2], marks[-1])):
            junk = bytes(rng.randint(0, 255, 5).astype(np.uint8))
            add(f"{stem}_garbage{k}.jpg", f"{src} with bytes before a marker",
                d[:i] + junk + d[i:])
    for src, stem in (("restart4_420_96x80.jpg", "restart4_420"),
                      ("mixed_y22_cb12_cr21_33x19.jpg", "mixed"),
                      ("arith/gray_31x23.jpg", "arith_gray")):
        d = bytearray(files[src][1])
        s, e = scan_span(bytes(d))
        for _ in range(3):
            d[rng.randint(s, e)] ^= 1 << rng.randint(8)
        add(f"{stem}_flipped.jpg", f"{src} with three bits of its data flipped", d)
    base = files["baseline_444_64x48.jpg"][1]
    add("refused_cut_in_headers.jpg", "baseline_444_64x48.jpg cut inside its headers",
        base[:120])
    sof = base.index(b"\xff\xc0")
    add("refused_lossless.jpg", "baseline_444_64x48.jpg marked lossless (SOF3)",
        base[:sof + 1] + b"\xc3" + base[sof + 2:])
    add("refused_12bit.jpg", "baseline_444_64x48.jpg marked 12-bit",
        base[:sof + 4] + b"\x0c" + base[sof + 5:])
    return out


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def scaled_sha(data: bytes, method: str, scale: int):
    try:
        return sha(ref_jpeg.decode(data, dct_method=method, scale_num=scale))
    except ValueError:
        return None


def entry(layout: str, data: bytes) -> dict:
    by_scale = {str(s): {m: scaled_sha(data, m, s) for m in METHODS} for s in SCALES}
    try:
        img = ref_jpeg.decode(data)
    except ValueError:
        return {"layout": layout, "refused": True, "decode_sha256_by_scale": by_scale}
    by_method = {m: sha(ref_jpeg.decode(data, dct_method=m)) for m in METHODS}
    return {"layout": layout, "shape": list(img.shape), "decode_sha256": by_method["islow"],
            "decode_sha256_by_method": by_method, "decode_sha256_by_scale": by_scale,
            "resize_347_sha256": sha(_host_resize_uint8(img, HOST_SIZE))}


def main():
    manifest = {"host_size": HOST_SIZE, "files": {}, "variants": {}}
    for old in HERE.glob("*.jpg"):
        old.unlink()
    for sub in SUBDIRS:
        (HERE / sub).mkdir(exist_ok=True)
        for old in (HERE / sub).glob("*.jpg"):
            old.unlink()
    files = fixtures()
    for name, (layout, data) in files.items():
        (HERE / name).write_bytes(data)
        manifest["files"][name] = entry(layout, data)
    with tempfile.TemporaryDirectory() as tmp:
        more = coded(helper(Path(tmp)), {n: d for n, (_, d) in files.items()})
    files.update(more)
    more.update(corrupt(files))
    for name, (layout, data) in more.items():
        (HERE / name).write_bytes(data)
        manifest["variants"][name] = entry(layout, data)
    (HERE / "manifest.json").write_text(json.dumps(manifest, indent=1, sort_keys=True) + "\n")
    sizes = [p.stat().st_size for sub in SUBDIRS for p in (HERE / sub).glob("*.jpg")]
    print(f"{len(manifest['files'])} fixtures and {len(manifest['variants'])} variants "
          f"({sum(sizes)} bytes in the subdirectories)")


if __name__ == "__main__":
    main()
