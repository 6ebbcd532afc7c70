"""The port's JPEG decoder and host resize (``tumblr_emotions_torch/data/jpeg.py``
over ``csrc/jpeg_decode.cc``, built here by the host C++ compiler) against
the JAX package's decoder (its C++ over libjpeg-turbo) and PIL's BILINEAR
resize, bit for bit.

Fixtures: ``tests/data/jpeg/`` (written by ``make_fixtures.py``, with the
reference's decode and resize hashes in ``manifest.json``), and beside them
arithmetic-coded, crafted and corrupt variants under ``arith/``,
``crafted/`` and ``corrupt/`` (the manifest's ``variants``, each with its
hash under every ``dct_method``, at full size and at each ``scale_num`` from
1 to 7, or the reference's refusal)."""

import ctypes
import hashlib
import io
import json
import subprocess
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from tumblr_emotions_tpu.data import jpeg as ref
from tumblr_emotions_torch.data import jpeg
from tumblr_emotions_torch.data.pipeline import _host_resize_uint8

FIXTURES = Path(__file__).resolve().parent / "data" / "jpeg"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())
NAMES = sorted(MANIFEST["files"])
ENTRIES = {**MANIFEST["files"], **MANIFEST["variants"]}
METHODS = ("islow", "ifast", "float")
SCALES = range(1, 8)


def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _read(name):
    return (FIXTURES / name).read_bytes()


def _smooth(rng, h, w, gray=False, noise=6.0):
    c = 1 if gray else 3
    lo = rng.uniform(0, 255, (4, 4, c)).astype(np.uint8)
    im = np.asarray(Image.fromarray(lo[..., 0] if gray else lo).resize((w, h), Image.BICUBIC),
                    np.float32)
    return np.clip(im + rng.normal(0, noise, im.shape), 0, 255).astype(np.uint8)


def _pil_jpeg(a, **kw):
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, format="JPEG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("name", NAMES)
def test_decode_is_the_reference_decode_on_every_fixture(name):
    data, entry = _read(name), MANIFEST["files"][name]
    got = jpeg.decode(data)
    want = ref.decode(data)
    assert got.dtype == np.uint8 and got.shape == want.shape == tuple(entry["shape"])
    assert int((got != want).sum()) == 0
    assert _sha(got) == entry["decode_sha256"]
    assert _sha(_host_resize_uint8(got, MANIFEST["host_size"])) == entry["resize_347_sha256"]


# Written on the fly from seeded images: every PIL layout, quality extremes,
# noise (large coefficients), restart intervals, sizes below one MCU.
ON_THE_FLY = [
    ((29, 43), dict(subsampling=0, quality=100)),
    ((29, 43), dict(subsampling=1, quality=5)),
    ((66, 35), dict(subsampling=2, quality=75, optimize=True)),
    ((5, 3), dict(subsampling=2, quality=90)),
    ((2, 2), dict(subsampling=1, quality=90)),
    ((70, 90), dict(subsampling=2, quality=93, progressive=True, restart_marker_blocks=3)),
    ((33, 65), dict(subsampling=0, quality=60, progressive=True)),
    ((57, 31), dict(subsampling=1, quality=85, progressive=True)),
    ((48, 48), dict(gray=True, quality=95, progressive=True)),
    ((64, 40), dict(noise=True, subsampling=2, quality=95)),
    ((40, 64), dict(noise=True, subsampling=0, quality=90, progressive=True)),
]


@pytest.mark.parametrize("size,kw", ON_THE_FLY, ids=[str(i) for i in range(len(ON_THE_FLY))])
def test_decode_is_the_reference_decode_on_seeded_jpegs(size, kw):
    """At every scale_num, with fancy upsampling and without it (where all
    three components share the scale, as 4:2:2 does below 8, libjpeg runs
    its merged upsampler without fancy upsampling)."""
    rng = np.random.RandomState(sum(size))
    kw = dict(kw)
    gray, noise = kw.pop("gray", False), kw.pop("noise", False)
    a = rng.randint(0, 256, size + (3,), np.uint8) if noise else _smooth(rng, *size, gray=gray)
    data = _pil_jpeg(a, **kw)
    for scale in range(1, 9):
        for fancy in (True, False):
            got = jpeg.decode(data, fancy=fancy, scale_num=scale)
            want = ref.decode(data, fancy=fancy, scale_num=scale)
            assert got.shape == want.shape, (scale, fancy)
            np.testing.assert_array_equal(got, want, err_msg=f"scale_num={scale} fancy={fancy}")


def test_decode_batch_equals_decode_on_any_thread_count():
    datas = [_read(n) for n in NAMES]
    want = [jpeg.decode(d) for d in datas]
    for threads in (1, 8):
        got = jpeg.decode_batch(datas, num_threads=threads)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert jpeg.decode_batch([]) == []


def test_decode_batch_names_the_first_bad_index():
    datas = [_read(NAMES[0]), b"not a jpeg", _read(NAMES[1]), b""]
    with pytest.raises(ValueError, match=r"2 images \(first index 1"):
        jpeg.decode_batch(datas, num_threads=4)


def test_decode_resize_batch_is_decode_then_resize():
    datas = [_read(n) for n in NAMES[:6]] + [b"\xff\xd8\xff"]
    out = np.zeros((len(datas), 64, 64, 3), np.uint8)
    errors = jpeg.decode_resize_batch(datas, 64, out, num_threads=3)
    assert errors[:-1] == [None] * 6 and "truncated" in errors[-1]
    for d, o in zip(datas[:-1], out):
        np.testing.assert_array_equal(o, _host_resize_uint8(jpeg.decode(d), 64))
    with pytest.raises(ValueError):
        jpeg.decode_resize_batch(datas, 64, out[:2])


@pytest.mark.parametrize("name", NAMES[:4])
def test_decode_size_is_the_reference(name):
    data = _read(name)
    assert jpeg.decode_size(data) == ref.decode_size(data)


def test_corrupt_truncated_and_empty_bytes_raise_value_error():
    """What the reference refuses raises ValueError; a file cut inside its
    entropy data or without its EOI decodes, as libjpeg decodes it (the
    data it lacks read as zero bits, after a fake EOI)."""
    good = _read("progressive_420_161x97.jpg")
    for bad in (b"", b"\xff", b"\xff\xd8", b"not a jpeg", good[:2], good[:40],
                good.replace(b"\xff\xda", b"\xff\xdb", 1)):
        assert _outcome(ref, bad) is None
        with pytest.raises(ValueError):
            jpeg.decode(bad)
    for cut in (good[:len(good) // 2], good[:-2]):
        np.testing.assert_array_equal(jpeg.decode(cut), ref.decode(cut))
    with pytest.raises(ValueError):
        jpeg.decode("a string, not bytes")


def test_mutated_jpegs_never_crash():
    """Seeded byte flips, cuts and insertions in baseline, progressive and
    restart files: each decode returns an image or raises ValueError."""
    rng = np.random.RandomState(0)
    bases = [_read(n) for n in ("restart4_420_96x80.jpg", "progressive_420_161x97.jpg",
                                "gray_progressive_restart_40x24.jpg", "h1v2_440_37x29.jpg")]
    outcomes = {"decoded": 0, "refused": 0}
    for i in range(400):
        d = bytearray(bases[i % len(bases)])
        k = rng.randint(3)
        at = rng.randint(2, len(d))
        if k == 0:
            for _ in range(rng.randint(1, 6)):
                d[rng.randint(2, len(d))] = rng.randint(256)
        elif k == 1:
            d = d[:at] + d[at + rng.randint(1, 40):]
        else:
            d = d[:at] + bytes(rng.randint(0, 256, rng.randint(1, 40)).astype(np.uint8)) + d[at:]
        try:
            img = jpeg.decode(bytes(d))
            assert img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3
            outcomes["decoded"] += 1
        except ValueError:
            outcomes["refused"] += 1
    assert outcomes["refused"] > 0 and sum(outcomes.values()) == 400


def _patch_sof(data, marker=None, precision=None):
    i = data.index(b"\xff\xc0")
    d = bytearray(data)
    if marker is not None:
        d[i + 1] = marker
    if precision is not None:
        d[i + 4] = precision
    return bytes(d)


def _outcome(module, data, **kw):
    """The decode, or None where the decoder raises ValueError."""
    try:
        return module.decode(data, **kw)
    except ValueError:
        return None


def test_refused_forms_raise_value_error():
    """12-bit samples, a lossless process and CMYK are refused, by the port
    as by the reference; an arithmetic-coded body (here Huffman data read as
    arithmetic, as libjpeg reads it), the ifast and float IDCTs and
    scale_num 4 decode as the reference decodes them."""
    base = _read("baseline_444_64x48.jpg")
    with pytest.raises(ValueError, match="lossless"):
        jpeg.decode(_patch_sof(base, marker=0xC3))
    with pytest.raises(ValueError, match="12-bit"):
        jpeg.decode(_patch_sof(base, precision=12))
    cmyk = io.BytesIO()
    Image.fromarray(np.full((16, 16, 4), 90, np.uint8), "CMYK").save(cmyk, format="JPEG")
    with pytest.raises(ValueError, match="CMYK"):
        jpeg.decode(cmyk.getvalue())
    for bad in (_patch_sof(base, marker=0xC3), _patch_sof(base, precision=12), cmyk.getvalue()):
        with pytest.raises(ValueError):
            ref.decode(bad)
    arith = _patch_sof(base, marker=0xC9)
    np.testing.assert_array_equal(jpeg.decode(arith), ref.decode(arith))
    for kw in (dict(dct_method="ifast"), dict(dct_method="float")):
        np.testing.assert_array_equal(jpeg.decode(base, **kw), ref.decode(base, **kw))
        np.testing.assert_array_equal(jpeg.decode_batch([base], **kw)[0], ref.decode(base, **kw))
    np.testing.assert_array_equal(jpeg.decode(base, scale_num=4), ref.decode(base, scale_num=4))
    np.testing.assert_array_equal(jpeg.decode_batch([base], scale_num=4)[0],
                                  ref.decode_batch([base], scale_num=4)[0])
    with pytest.raises(ValueError):
        jpeg.decode(base, dct_method="fastest")
    with pytest.raises(ValueError):
        jpeg.decode_batch([base], dct_method="fastest")


def _cmyk(transform):
    """A CMYK JPEG from PIL with its Adobe marker's transform set (2: YCCK)."""
    buf = io.BytesIO()
    Image.fromarray(np.full((16, 16, 4), 90, np.uint8), "CMYK").save(buf, format="JPEG")
    d = bytearray(buf.getvalue())
    i = d.index(b"Adobe")
    d[i + 11] = transform
    return bytes(d)


REFUSALS = {
    "12-bit": (lambda b: _patch_sof(b, precision=12), "12-bit"),
    "16-bit": (lambda b: _patch_sof(b, precision=16), "16-bit"),
    "lossless_sof3": (lambda b: _patch_sof(b, marker=0xC3), "lossless"),
    "hierarchical_sof5": (lambda b: _patch_sof(b, marker=0xC5), "hierarchical"),
    "hierarchical_sof6": (lambda b: _patch_sof(b, marker=0xC6), "hierarchical"),
    "hierarchical_sof7": (lambda b: _patch_sof(b, marker=0xC7), "hierarchical"),
    "lossless_sof11": (lambda b: _patch_sof(b, marker=0xCB), "lossless"),
    "hierarchical_sof13": (lambda b: _patch_sof(b, marker=0xCD), "hierarchical"),
    "hierarchical_sof14": (lambda b: _patch_sof(b, marker=0xCE), "hierarchical"),
    "hierarchical_sof15": (lambda b: _patch_sof(b, marker=0xCF), "hierarchical"),
    "cmyk": (lambda b: _cmyk(0), "CMYK"),
    "ycck": (lambda b: _cmyk(2), "YCCK"),
}


@pytest.mark.parametrize("form", sorted(REFUSALS))
def test_forms_the_reference_refuses_are_refused_with_their_reason(form):
    """What libjpeg-turbo 2.1.5 refuses, the port refuses with a specific
    reason: the reference is asked on the same bytes, under every method."""
    make, reason = REFUSALS[form]
    data = make(_read("baseline_444_64x48.jpg"))
    for method in METHODS:
        assert _outcome(ref, data, dct_method=method) is None
        with pytest.raises(ValueError, match=reason):
            jpeg.decode(data, dct_method=method)
    # At a scale the form is refused all the same; the file it was made
    # from decodes there as the reference decodes it.
    assert _outcome(ref, data, scale_num=4) is None
    with pytest.raises(ValueError, match=reason):
        jpeg.decode(data, scale_num=4)
    base = _read("baseline_444_64x48.jpg")
    assert jpeg.decode(base, scale_num=4).shape == ref.decode(base, scale_num=4).shape == (24, 32, 3)
    np.testing.assert_array_equal(jpeg.decode(base, scale_num=4), ref.decode(base, scale_num=4))


@pytest.mark.parametrize("name,method", [(n, m) for n in sorted(ENTRIES) for m in METHODS],
                         ids=[f"{n}-{m}" for n in sorted(ENTRIES) for m in METHODS])
def test_every_fixture_and_variant_is_the_reference_under_every_method(name, method):
    """Each fixture and each arithmetic, crafted and corrupt variant, under
    islow, ifast and float: the port's bytes are the reference's and the
    manifest's, or both refuse it."""
    data, entry = _read(name), ENTRIES[name]
    got, want = _outcome(jpeg, data, dct_method=method), _outcome(ref, data, dct_method=method)
    if entry.get("refused"):
        assert got is None and want is None
        return
    assert got is not None and want is not None and got.shape == tuple(entry["shape"])
    np.testing.assert_array_equal(got, want)
    assert _sha(got) == entry["decode_sha256_by_method"][method]


@pytest.mark.parametrize("scale,method", [(s, m) for s in SCALES for m in METHODS],
                         ids=[f"{s}-{m}" for s in SCALES for m in METHODS])
def test_every_fixture_and_variant_is_the_reference_at_every_scale(scale, method):
    """Each fixture and variant decoded at scale_num 1 to 7 under each
    method, with fancy upsampling and without: the port's bytes and shape
    are the reference's (and, with fancy upsampling, the manifest's), or
    both refuse it.  Among them are the inputs whose 2x2 and 4x4 IDCTs
    only the SSE2 code's 16-bit packing decodes as the reference does
    (the extreme-coefficient files and the arithmetic restart variants)."""
    for name in sorted(ENTRIES):
        data, want_sha = _read(name), ENTRIES[name]["decode_sha256_by_scale"][str(scale)][method]
        for fancy in (True, False):
            got = _outcome(jpeg, data, dct_method=method, scale_num=scale, fancy=fancy)
            want = _outcome(ref, data, dct_method=method, scale_num=scale, fancy=fancy)
            if want is None:
                assert got is None and want_sha is None, name
                continue
            assert got is not None and got.shape == want.shape, (name, fancy)
            np.testing.assert_array_equal(got, want, err_msg=f"{name} fancy={fancy}")
            if fancy:
                assert _sha(got) == want_sha, name


def test_4_2_0_at_scale_4_runs_the_methods_8x8_idct_on_its_chroma():
    """At scale_num 4 a 4:2:0 image's luma runs the 4x4 IDCT on the raw
    quantizers and its chroma the chosen method's 8x8 with that method's
    multipliers: the three methods give three images, each the reference's."""
    for name in ("baseline_420_403x301.jpg", "odd_420_17x9.jpg", "progressive_420_161x97.jpg",
                 "restart4_420_96x80.jpg"):
        data = _read(name)
        got = {m: jpeg.decode(data, dct_method=m, scale_num=4) for m in METHODS}
        for m in METHODS:
            np.testing.assert_array_equal(got[m], ref.decode(data, dct_method=m, scale_num=4))
        assert len({g.tobytes() for g in got.values()}) == 3, name


@pytest.mark.parametrize("threads", [1, 4, 8])
def test_decode_batch_at_a_scale_is_the_reference_on_any_thread_count(threads):
    names = [n for n in sorted(ENTRIES) if not ENTRIES[n].get("refused")]
    datas = [_read(n) for n in names]
    for scale in (3, 4):
        got = jpeg.decode_batch(datas, scale_num=scale, num_threads=threads)
        want = ref.decode_batch(datas, scale_num=scale, num_threads=threads)
        assert len(got) == len(want) == len(names)
        for name, g, w in zip(names, got, want):
            assert g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("scale", [0, -1, 9, 16])
def test_scale_num_outside_1_to_8_is_what_the_reference_makes_of_it(scale):
    """The reference's C ignores a scale_num outside 1..8 and its Python
    sizes the buffer from it: 0 and -1 raise ValueError, 9 and 16 decode at
    full size.  Above 8 the reference's buffer is larger than the image its
    C writes, packed, at the start, and its slice re-strides the rows (only
    the first row is the image's, and some bytes were never written): the
    port returns the full-size image that the reference's C decodes."""
    for name in ("baseline_420_403x301.jpg", "tiny_420_1x1.jpg"):
        data = _read(name)
        want = _outcome(ref, data, scale_num=scale)
        if want is None:
            assert scale < 1
            with pytest.raises(ValueError):
                jpeg.decode(data, scale_num=scale)
            with pytest.raises(ValueError):
                ref.decode_batch([data], scale_num=scale)
            with pytest.raises(ValueError):
                jpeg.decode_batch([data], scale_num=scale)
            continue
        full = ref.decode(data)
        assert want.shape == full.shape == tuple(ENTRIES[name]["shape"])
        np.testing.assert_array_equal(want[0], full[0])
        np.testing.assert_array_equal(jpeg.decode(data, scale_num=scale), full)
        np.testing.assert_array_equal(jpeg.decode_batch([data], scale_num=scale)[0], full)


# sha256 over every fixture's name, bytes and full-size hashes: rewriting the
# fixtures (make_fixtures.py) must leave them as they are.
PINNED_FIXTURES = "3d204901e48a5dd0a4693dde5d38de5146652b17d7691fe55023a54735a3087d"


def test_fixture_bytes_and_full_size_hashes_are_pinned():
    h = hashlib.sha256()
    for name in sorted(ENTRIES):
        e = ENTRIES[name]
        kept = {k: e.get(k) for k in ("refused", "shape", "decode_sha256",
                                       "decode_sha256_by_method", "resize_347_sha256")}
        h.update(name.encode() + _read(name) + json.dumps(kept, sort_keys=True).encode())
    assert h.hexdigest() == PINNED_FIXTURES


# libjpeg's own IDCTs: a JPEG opened at scale_num/8 gives, through
# cinfo->idct (jpegint.h's struct jpeg_inverse_dct), the function the
# library dispatches for each component (the SSE2 2x2 and 4x4 on x86-64),
# run here on chosen blocks with chosen quantizers.
LIBJPEG_IDCT = r"""
#include <setjmp.h>
#include <stdio.h>
#include <string.h>
#include <jpeglib.h>

typedef void (*idct_fn)(j_decompress_ptr, jpeg_component_info*, JCOEFPTR, JSAMPARRAY,
                        JDIMENSION);
struct inverse_dct { void (*start_pass)(j_decompress_ptr); idct_fn inverse_DCT[MAX_COMPONENTS]; };
struct err { struct jpeg_error_mgr pub; jmp_buf jb; };
static void on_error(j_common_ptr c) { longjmp(((struct err*)c->err)->jb, 1); }
static struct jpeg_decompress_struct cinfo;
static struct err e;
static short coef[64] __attribute__((aligned(32)));
static short quant[64] __attribute__((aligned(32)));

/* Open a JPEG at scale/8; returns component comp's DCT_scaled_size. */
int open_at(const unsigned char* d, unsigned long n, int scale, int comp) {
  cinfo.err = jpeg_std_error(&e.pub);
  e.pub.error_exit = on_error;
  if (setjmp(e.jb)) return -1;
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, (unsigned char*)d, n);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.scale_num = scale;
  cinfo.scale_denom = 8;
  jpeg_start_decompress(&cinfo);
  return cinfo.comp_info[comp].DCT_scaled_size;
}

void close_it(void) { jpeg_destroy_decompress(&cinfo); }

/* One block through component comp's IDCT into out (16 x 16). */
void idct(int comp, const short* c, const short* q, unsigned char* out) {
  unsigned char* rows[16];
  for (int i = 0; i < 16; i++) rows[i] = out + 16 * i;
  memcpy(coef, c, sizeof(coef));
  memcpy(quant, q, sizeof(quant));
  jpeg_component_info* ci = &cinfo.comp_info[comp];
  void* table = ci->dct_table;
  ci->dct_table = quant;
  ((struct inverse_dct*)cinfo.idct)->inverse_DCT[comp](&cinfo, ci, coef, rows, 0);
  ci->dct_table = table;
}
"""


@pytest.fixture(scope="module")
def libjpeg_idct(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("libjpeg_idct")
    (tmp / "idct.c").write_text(LIBJPEG_IDCT)
    subprocess.run(["cc", "-O2", "-shared", "-fPIC", "-o", str(tmp / "libidct.so"),
                    str(tmp / "idct.c"), "-ljpeg"], check=True)
    lib = ctypes.CDLL(str(tmp / "libidct.so"))
    lib.open_at.argtypes = [ctypes.c_char_p, ctypes.c_ulong, ctypes.c_int, ctypes.c_int]
    lib.idct.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    return lib


def _blocks(rng, n):
    """Seeded blocks and quantizers: typical, huge, the 16-bit extremes,
    sparse, DC only, and AC rows 1-3 and 5-7 zero (the 4x4's shortcut)."""
    for i in range(n):
        k = i % 6
        if k == 0:
            c, q = rng.randint(-1024, 1024, 64), rng.randint(1, 256, 64)
        elif k == 1:
            c, q = rng.randint(-32768, 32768, 64), rng.randint(0, 65536, 64)
        elif k == 2:
            c = rng.choice([-32768, -32767, -1, 0, 1, 2047, -2048, 32767], 64)
            q = rng.choice([1, 2, 128, 255, 32767, 32768, 65535], 64)
        elif k == 3:
            c = np.zeros(64, np.int64)
            at = rng.randint(0, 64, rng.randint(1, 5))
            c[at] = rng.randint(-2048, 2048, len(at))
            q = rng.randint(1, 65536, 64)
        elif k == 4:
            c = np.zeros(64, np.int64)
            c[0] = rng.randint(-32768, 32768)
            q = rng.randint(0, 65536, 64)
        else:
            c = np.zeros(64, np.int64)
            c[:8] = rng.randint(-4096, 4096, 8)
            c[32:40] = rng.randint(-32768, 32768, 8)
            q = rng.randint(1, 65536, 64)
        yield (np.ascontiguousarray(c.astype(np.int16)),
               np.ascontiguousarray(q.astype(np.uint16)))


@pytest.mark.parametrize("scale", SCALES)
def test_scaled_idcts_are_the_reference_librarys_on_extreme_blocks(scale, libjpeg_idct):
    """At scale_num/8 a 4:2:0 file's luma runs the scale x scale IDCT and
    its chroma twice that (8 excepted, the method's own, held by the
    fixtures): each, on 1200 seeded blocks, gives the samples of the IDCT
    libjpeg dispatches for that component."""
    data = _read("baseline_420_403x301.jpg")
    lib, err = jpeg.library(), ctypes.create_string_buffer(256)
    rng = np.random.RandomState(scale)
    for comp in (0, 1):
        n = libjpeg_idct.open_at(data, len(data), scale, comp)
        assert n == (scale if comp == 0 else 2 * scale)
        if n != 8:
            for c, q in _blocks(rng, 1200):
                want, got = np.zeros((16, 16), np.uint8), np.zeros((16, 16), np.uint8)
                libjpeg_idct.idct(comp, c.ctypes.data, q.ctypes.data, want.ctypes.data)
                assert lib.jd_idct_block(n, 0, c.ctypes.data, q.ctypes.data, got.ctypes.data, 16,
                                         err, 256) == 0, err.value
                assert np.array_equal(got[:n, :n], want[:n, :n]), (n, c.tolist(), q.tolist())
        libjpeg_idct.close_it()


def _mutations(n=400):
    """test_mutated_jpegs_never_crash's seeded corpus."""
    rng = np.random.RandomState(0)
    bases = [_read(n) for n in ("restart4_420_96x80.jpg", "progressive_420_161x97.jpg",
                                "gray_progressive_restart_40x24.jpg", "h1v2_440_37x29.jpg")]
    for i in range(n):
        d = bytearray(bases[i % len(bases)])
        k = rng.randint(3)
        at = rng.randint(2, len(d))
        if k == 0:
            for _ in range(rng.randint(1, 6)):
                d[rng.randint(2, len(d))] = rng.randint(256)
        elif k == 1:
            d = d[:at] + d[at + rng.randint(1, 40):]
        else:
            d = d[:at] + bytes(rng.randint(0, 256, rng.randint(1, 40)).astype(np.uint8)) + d[at:]
        yield bytes(d)


def _cuts():
    """Every fixture (and arithmetic file) cut at each 1/16 of its first
    scan's data to its end, and without its EOI."""
    for name in NAMES + sorted(n for n in MANIFEST["variants"] if n.startswith("arith/")):
        d = _read(name)
        i = d.index(b"\xff\xda")
        start = i + 2 + int.from_bytes(d[i + 2:i + 4], "big")
        for k in range(1, 16):
            yield d[:start + (len(d) - 2 - start) * k // 16]
        yield d[:-2]


def test_port_and_reference_agree_on_the_seeded_corrupt_corpus():
    """The 400 seeded mutations of test_mutated_jpegs_never_crash and the
    cuts of every fixture, each at full size and at a scale_num drawn for
    it from 1 to 7: for each input both decoders refuse, or both decode it
    to the same bytes.  None may differ."""
    tally = {"equal": 0, "both_refuse": 0, "differ": 0}
    differ = []
    scales = np.random.RandomState(5)
    for i, data in enumerate(list(_mutations()) + list(_cuts())):
        for scale in (8, int(scales.randint(1, 8))):
            got, want = _outcome(jpeg, data, scale_num=scale), _outcome(ref, data, scale_num=scale)
            if got is None and want is None:
                tally["both_refuse"] += 1
            elif got is not None and want is not None and got.shape == want.shape and \
                    np.array_equal(got, want):
                tally["equal"] += 1
            else:
                tally["differ"] += 1
                differ.append((i, scale))
    assert tally["differ"] == 0, (tally, differ[:20])
    assert tally["equal"] > 1000 and tally["both_refuse"] > 100, tally


RESIZES = [((301, 403), (347, 347)), ((1, 1), (347, 347)), ((9, 17), (347, 347)),
           ((500, 300), (347, 347)), ((750, 1000), (347, 347)), ((2, 700), (347, 347)),
           ((360, 347), (347, 347)), ((347, 340), (347, 347)), ((640, 480), (299, 299)),
           ((100, 50), (1, 1)), ((48, 64), (17, 91))]


@pytest.mark.parametrize("shape,out", RESIZES, ids=[f"{s}->{o}" for s, o in RESIZES])
def test_resize_is_pil_bilinear(shape, out):
    a = np.random.RandomState(shape[0]).randint(0, 256, shape + (3,), np.uint8)
    want = np.asarray(Image.fromarray(a).resize((out[1], out[0]), Image.BILINEAR))
    np.testing.assert_array_equal(jpeg.resize_bilinear(a, *out), want)


def test_host_resize_keeps_an_image_of_the_size():
    a = np.random.RandomState(0).randint(0, 256, (347, 347, 3), np.uint8)
    assert _host_resize_uint8(a, 347) is a
    with pytest.raises(ValueError):
        jpeg.resize_bilinear(a[..., 0], 10, 10)


def test_build_is_cached_by_hash_and_a_failed_build_raises(tmp_path, monkeypatch):
    lib = jpeg.build()
    assert lib.parent == jpeg.BUILD_DIR and lib.exists() and lib.name.endswith(".so")
    assert jpeg.build() == lib
    monkeypatch.setattr(jpeg, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(jpeg, "_compiler", lambda: "false")
    with pytest.raises(RuntimeError, match="failed"):
        jpeg.build()
    assert not list(tmp_path.iterdir())
