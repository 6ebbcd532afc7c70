"""The port's JPEG decoder and host resize (``tumblr_emotions_torch/data/jpeg.py``
over ``csrc/jpeg_decode.cc``, built here by the host C++ compiler) against
the JAX package's decoder (its C++ over libjpeg-turbo) and PIL's BILINEAR
resize, bit for bit.

Fixtures: ``tests/data/jpeg/`` (written by ``make_fixtures.py``, with the
reference's decode and resize hashes in ``manifest.json``), and beside them
arithmetic-coded, crafted and corrupt variants under ``arith/``,
``crafted/`` and ``corrupt/`` (the manifest's ``variants``, each with its
hash under every ``dct_method`` or the reference's refusal)."""

import hashlib
import io
import json
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
    rng = np.random.RandomState(sum(size))
    kw = dict(kw)
    gray, noise = kw.pop("gray", False), kw.pop("noise", False)
    a = rng.randint(0, 256, size + (3,), np.uint8) if noise else _smooth(rng, *size, gray=gray)
    data = _pil_jpeg(a, **kw)
    for fancy in (True, False):
        np.testing.assert_array_equal(jpeg.decode(data, fancy=fancy), ref.decode(data, fancy=fancy))


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
    arithmetic, as libjpeg reads it) and the ifast and float IDCTs decode as
    the reference decodes them; scale_num other than 8 is refused."""
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
    for kw in (dict(scale_num=4), dict(dct_method="fastest")):
        with pytest.raises(ValueError):
            jpeg.decode(base, **kw)
        with pytest.raises(ValueError):
            jpeg.decode_batch([base], **kw)


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
    # scale_num: the reference downscales (DCT scaling), the port refuses
    # it (ROADMAP Queue 1); no caller outside data/jpeg.py passes it.
    base = _read("baseline_444_64x48.jpg")
    assert ref.decode(base, scale_num=4).shape == (24, 32, 3)
    with pytest.raises(ValueError, match="scale_num"):
        jpeg.decode(base, scale_num=4)


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
    cuts of every fixture: for each input both decoders refuse, or both
    decode it to the same bytes.  None may differ."""
    tally = {"equal": 0, "both_refuse": 0, "differ": 0}
    differ = []
    for i, data in enumerate(list(_mutations()) + list(_cuts())):
        got, want = _outcome(jpeg, data), _outcome(ref, data)
        if got is None and want is None:
            tally["both_refuse"] += 1
        elif got is not None and want is not None and got.shape == want.shape and \
                np.array_equal(got, want):
            tally["equal"] += 1
        else:
            tally["differ"] += 1
            differ.append(i)
    assert tally["differ"] == 0, (tally, differ[:20])
    assert tally["equal"] > 500 and tally["both_refuse"] > 50, tally


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
