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

``manifest.json`` records, per file, its layout, the sha256 of the JAX
package's decode (``tumblr_emotions_tpu.data.jpeg.decode``, libjpeg, islow,
fancy upsampling) and the sha256 of PIL's BILINEAR resize of that decode to
347x347 (``tumblr_emotions_tpu.data.pipeline._host_resize_uint8``).  The
port's tests and ``chip_smoke.py`` hold the port's decoder and resize to
these hashes.  This is the one file that imports PIL and the JAX package.
"""

from __future__ import annotations

import hashlib
import io
import json
import math
import sys
from pathlib import Path

import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[2]))

from tumblr_emotions_tpu.data import jpeg as ref_jpeg  # noqa: E402
from tumblr_emotions_tpu.data.pipeline import _host_resize_uint8  # noqa: E402

HOST_SIZE = 347
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


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def main():
    manifest = {"host_size": HOST_SIZE, "files": {}}
    for old in HERE.glob("*.jpg"):
        old.unlink()
    for name, (layout, data) in fixtures().items():
        (HERE / name).write_bytes(data)
        img = ref_jpeg.decode(data)
        manifest["files"][name] = {
            "layout": layout, "shape": list(img.shape),
            "decode_sha256": sha(img),
            "resize_347_sha256": sha(_host_resize_uint8(img, HOST_SIZE)),
        }
    (HERE / "manifest.json").write_text(json.dumps(manifest, indent=1, sort_keys=True) + "\n")
    total = sum(p.stat().st_size for p in HERE.iterdir())
    print(f"{len(manifest['files'])} fixtures, {total} bytes in {HERE}")


if __name__ == "__main__":
    main()
