"""JPEG decode and the fixed-size host resize, on the host, without libjpeg
or PIL.

The port's counterpart of ``tumblr_emotions_tpu/data/jpeg.py`` (the
reference's C++ decoder over libjpeg-turbo 2.1.5) and of the PIL bilinear
resize in ``tumblr_emotions_tpu/data/pipeline.py::_host_resize_uint8``.  Both
run in ``csrc/jpeg_decode.cc``, a self-contained C++ decoder that follows
libjpeg-turbo bit for bit, and Pillow's bilinear resample.  It has a plain C
interface bound with ctypes.

The decoder takes what libjpeg-turbo 2.1.5 takes, and gives its bytes:
baseline, extended and progressive JPEG, Huffman or arithmetic coded, with
restart intervals, every integral sampling layout, and the three IDCTs
(``dct_method`` ``"islow"``, ``"ifast"``, ``"float"``, each as the library's
x86-64 SIMD code computes it).  Where libjpeg warns and goes on, so does it:
data cut short or corrupt (the rest of a segment decodes as libjpeg pads
it), missing or misplaced restart markers, bytes before a marker, no EOI, a
progressive file cut before its last scan (block-smoothed as libjpeg does).
What libjpeg refuses raises ``ValueError`` with the decoder's reason: 12-bit
samples, lossless and hierarchical JPEG, CMYK/YCCK, a cut inside the
headers, and every other fatal error.  ``fancy`` is libjpeg's fancy
upsampling (or plain replication).  ``scale_num`` is libjpeg's DCT-domain
scaling to ``scale_num``/8 of the size, rounded up (1 to 8; above 8 decodes
at full size, as the reference's decoder ignores it; 0 or less raises
``ValueError``).

The library is built at first use by the host C++ compiler (``c++`` or
``g++`` on ``PATH``; no nvcc) into ``build/host_jpeg/`` beside the package,
named by a hash of the source and the flags, and written by an atomic
rename, so concurrent processes may build at once.  It is built with
``-ffp-contract=off``: the float IDCT must not fuse products and sums.  There
is no fallback: a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from tumblr_emotions_torch.utils import host_lib

SOURCE = host_lib.PKG / "csrc" / "jpeg_decode.cc"
BUILD_DIR = host_lib.BUILD_ROOT / "host_jpeg"
FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-ffp-contract=off"]
DCT_METHODS = {"islow": 0, "ifast": 1, "float": 2}
_ERRLEN = 256
_compiler = host_lib.compiler

_P, _I, _S = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "jd_decode_size": [_P, _S, _IP, _IP, _IP, ctypes.c_char_p, _I],
    "jd_decode": [_P, _S, _I, _I, _I, _P, _S, _IP, _IP, ctypes.c_char_p, _I],
    "jd_decode_batch": [_P, _P, _I, _I, _I, _I, _P, _P, _IP, _IP, _I, _IP, ctypes.c_char_p, _I],
    "jd_resize_bilinear": [_P, _I, _I, _P, _I, _I, ctypes.c_char_p, _I],
    "jd_decode_resize_batch": [_P, _P, _I, _I, _I, _P, _I, _IP, ctypes.c_char_p, _I],
    "jd_idct_block": [_I, _I, _P, _P, _P, _I, ctypes.c_char_p, _I],
}


def build() -> Path:
    """Compile ``csrc/jpeg_decode.cc`` unless its library exists; return
    the library's path.  Raises ``RuntimeError`` if the compiler fails."""
    return host_lib.build(SOURCE, BUILD_DIR, "libjpeg_decode", FLAGS, _compiler())


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, _I
    return lib


def _dct(dct_method: str) -> int:
    """The C ABI's code of ``dct_method``; unknown names raise ``ValueError``."""
    if dct_method not in DCT_METHODS:
        raise ValueError(f"dct_method={dct_method!r} is not one of {sorted(DCT_METHODS)}")
    return DCT_METHODS[dct_method]


def _scale(scale_num: int) -> int:
    """The scale the reference decodes at: 1-8 as given, full size (8) above
    8; 0 or less raises ``ValueError``, as the reference does."""
    if scale_num < 1:
        raise ValueError(f"scale_num={scale_num} is not a scale: decode at scale_num/8 "
                         "for scale_num 1 to 8")
    return min(int(scale_num), 8)


def _scaled(h: int, w: int, scale: int) -> Tuple[int, int]:
    return -(-h * scale // 8), -(-w * scale // 8)


def _bytes(data) -> bytes:
    if not isinstance(data, (bytes, bytearray, memoryview)):
        raise ValueError(f"expected JPEG bytes, got {type(data).__name__}")
    return bytes(data)


def decode_size(data: bytes) -> Tuple[int, int, int]:
    """(height, width, components) from the JPEG header."""
    data = _bytes(data)
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERRLEN)
    if library().jd_decode_size(data, len(data), ctypes.byref(h), ctypes.byref(w),
                                ctypes.byref(c), err, _ERRLEN):
        raise ValueError(err.value.decode())
    return h.value, w.value, c.value


def decode(data: bytes, dct_method: str = "islow", fancy: bool = True,
           scale_num: int = 8) -> np.ndarray:
    """Decode one JPEG to an RGB uint8 array [ceil(H * s / 8), ceil(W * s / 8),
    3], s = ``scale_num``."""
    dct, scale = _dct(dct_method), _scale(scale_num)
    data = _bytes(data)
    h0, w0, _ = decode_size(data)
    out = np.empty(_scaled(h0, w0, scale) + (3,), np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERRLEN)
    if library().jd_decode(data, len(data), int(fancy), dct, scale, out.ctypes.data, out.nbytes,
                           ctypes.byref(h), ctypes.byref(w), err, _ERRLEN):
        raise ValueError(f"JPEG decode failed: {err.value.decode()}")
    return out


def _pointers(datas: Sequence[bytes]):
    n = len(datas)
    bufs = [_bytes(d) for d in datas]
    ptrs = (ctypes.c_char_p * n)(*bufs)
    sizes = (ctypes.c_size_t * n)(*[len(b) for b in bufs])
    return bufs, ptrs, sizes


def _errors(rc, errs, n: int) -> List[Optional[str]]:
    return [errs[i * _ERRLEN:(i + 1) * _ERRLEN].split(b"\0", 1)[0].decode()
            if rc[i] else None for i in range(n)]


def decode_batch(datas: Sequence[bytes], dct_method: str = "islow",
                 fancy: bool = True, scale_num: int = 8,
                 num_threads: int = 8) -> List[np.ndarray]:
    """Decode a batch of JPEGs on ``num_threads`` threads -> list of
    [H, W, 3] uint8 (scaled as :func:`decode` scales).  Any failure raises
    one ``ValueError`` that counts the failures and names the first bad
    index, as the reference does."""
    dct, scale = _dct(dct_method), _scale(scale_num)
    n = len(datas)
    if n == 0:
        return []
    dims = []
    for d in datas:
        try:
            dims.append(_scaled(*decode_size(d)[:2], scale))
        except ValueError:
            dims.append((1, 1))  # the batch decode reports the failure
    outs = [np.empty((h, w, 3), np.uint8) for h, w in dims]
    bufs, ptrs, sizes = _pointers(datas)
    out_p = (ctypes.c_void_p * n)(*[o.ctypes.data for o in outs])
    caps = (ctypes.c_size_t * n)(*[o.nbytes for o in outs])
    hs, ws, rc = (ctypes.c_int * n)(), (ctypes.c_int * n)(), (ctypes.c_int * n)()
    errs = ctypes.create_string_buffer(_ERRLEN * n)
    failures = library().jd_decode_batch(ptrs, sizes, n, int(fancy), dct, scale, out_p, caps,
                                         hs, ws, int(num_threads), rc, errs, _ERRLEN)
    if failures:
        bad = [i for i in range(n) if rc[i]]
        raise ValueError(f"JPEG decode failed for {len(bad)} images (first index "
                         f"{bad[0]}: {_errors(rc, errs.raw, n)[bad[0]]})")
    return outs


def decode_resize_batch(datas: Sequence[bytes], size: int, out: np.ndarray,
                        num_threads: int = 8, dct_method: str = "islow") -> List[Optional[str]]:
    """Decode each JPEG (fancy upsampling, ``dct_method``) and resize it to
    ``size`` x ``size`` (PIL bilinear, as :func:`resize_bilinear`) into
    ``out[i]``, in one call on ``num_threads`` threads.  ``out`` is a
    C-contiguous uint8 array [>= n, size, size, 3].  Returns, per image,
    None or the reason it failed (its row of ``out`` is then
    unspecified)."""
    dct = _dct(dct_method)
    n = len(datas)
    if out.dtype != np.uint8 or out.ndim != 4 or out.shape[1:] != (size, size, 3) \
            or out.shape[0] < n or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous uint8 [>={n},{size},{size},3] "
                         f"array, got {out.dtype} {out.shape}")
    if n == 0:
        return []
    bufs, ptrs, sizes = _pointers(datas)
    out_p = (ctypes.c_void_p * n)(*[out[i].ctypes.data for i in range(n)])
    rc = (ctypes.c_int * n)()
    errs = ctypes.create_string_buffer(_ERRLEN * n)
    library().jd_decode_resize_batch(ptrs, sizes, n, int(size), dct, out_p, int(num_threads),
                                     rc, errs, _ERRLEN)
    return _errors(rc, errs.raw, n)


def resize_bilinear(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """PIL ``Image.resize((width, height), Image.BILINEAR)`` of an RGB uint8
    image [H, W, 3], bit for bit."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an RGB uint8 [H,W,3] image, got {img.dtype} {img.shape}")
    out = np.empty((height, width, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    if library().jd_resize_bilinear(img.ctypes.data, img.shape[0], img.shape[1],
                                    out.ctypes.data, height, width, err, _ERRLEN):
        raise ValueError(err.value.decode())
    return out
