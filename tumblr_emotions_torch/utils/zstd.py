"""zstd through the machine's ``libzstd.so.1``, bound with ctypes.

The compression of riegeli records files, and so of ArrayRecord shards
(``data/records.py``): riegeli's default ``zstd:3`` writes each chunk's
sizes and values as one zstd frame each, at level 3 with a window of
2**20 bytes, fed to the compressor 64 KiB at a time as riegeli's buffered
writer feeds it (so input that fits in one piece is compressed in one
pass, its size in the frame header, and longer input streams without it).

The library is the system's, as on any machine with zstd installed, opened
from its file and bound to its own symbols (``RTLD_DEEPBIND``): a process
may already hold another copy of zstd under the same name (a wheel's
bundled one, or one a library exports), whose functions must not be mixed
into it.  Where it is missing, :func:`library` raises an error that names
it, and nothing falls back to another path.
"""

from __future__ import annotations

import ctypes
import functools
import os

LIBRARY = "libzstd.so.1"
# where the system's shared libraries are installed (multiarch and others)
_SYSTEM_DIRS = ("/lib/x86_64-linux-gnu", "/usr/lib/x86_64-linux-gnu", "/lib/aarch64-linux-gnu",
                "/usr/lib/aarch64-linux-gnu", "/lib64", "/usr/lib64", "/usr/lib",
                "/usr/local/lib")
# ZSTD_cParameter values (zstd.h, stable since v1.4.0)
_C_COMPRESSION_LEVEL = 100
_C_WINDOW_LOG = 101
_E_CONTINUE, _E_END = 0, 2      # ZSTD_EndDirective
_PIECE = 1 << 16                # riegeli's writer buffer


class _Buffer(ctypes.Structure):  # ZSTD_inBuffer and ZSTD_outBuffer
    _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    path = next((os.path.join(d, LIBRARY) for d in _SYSTEM_DIRS
                 if os.path.exists(os.path.join(d, LIBRARY))), LIBRARY)
    try:
        lib = ctypes.CDLL(path, mode=os.RTLD_LOCAL | os.RTLD_DEEPBIND)
    except OSError as e:
        raise RuntimeError(f"{LIBRARY} (the zstd library) is not on this machine; "
                           f"zstd-compressed ArrayRecord shards need it: {e}") from e
    size_t, vp = ctypes.c_size_t, ctypes.c_void_p
    for name, args, res in (
            ("ZSTD_createCCtx", [], vp),
            ("ZSTD_freeCCtx", [vp], size_t),
            ("ZSTD_CCtx_setParameter", [vp, ctypes.c_int, ctypes.c_int], size_t),
            ("ZSTD_compressStream2", [vp, ctypes.POINTER(_Buffer),
                                      ctypes.POINTER(_Buffer), ctypes.c_int], size_t),
            ("ZSTD_compressBound", [size_t], size_t),
            ("ZSTD_decompress", [vp, size_t, ctypes.c_char_p, size_t], size_t),
            ("ZSTD_isError", [size_t], ctypes.c_uint),
            ("ZSTD_getErrorName", [size_t], ctypes.c_char_p),
            ("ZSTD_versionString", [], ctypes.c_char_p)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def version() -> str:
    return library().ZSTD_versionString().decode()


def _check(lib, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(f"zstd {what}: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def compress(data: bytes, level: int = 3, window_log: int = 20) -> bytes:
    """One zstd frame of ``data`` (no checksum), as riegeli writes it."""
    lib = library()
    cctx = lib.ZSTD_createCCtx()
    if not cctx:
        raise MemoryError("ZSTD_createCCtx failed")
    try:
        _check(lib, lib.ZSTD_CCtx_setParameter(cctx, _C_COMPRESSION_LEVEL, level), "level")
        _check(lib, lib.ZSTD_CCtx_setParameter(cctx, _C_WINDOW_LOG, window_log), "window_log")
        src = ctypes.create_string_buffer(data, len(data))
        out = ctypes.create_string_buffer(lib.ZSTD_compressBound(len(data)) + _PIECE)
        ob = _Buffer(ctypes.addressof(out), len(out), 0)
        pos = 0
        while True:
            n = min(_PIECE, len(data) - pos)
            last = pos + n == len(data)
            ib = _Buffer(ctypes.addressof(src) + pos, n, 0)
            while True:
                left = _check(lib, lib.ZSTD_compressStream2(
                    cctx, ctypes.byref(ob), ctypes.byref(ib), _E_END if last else _E_CONTINUE),
                    "compress")
                if (left == 0 if last else ib.pos == ib.size):
                    break
                if ob.pos == ob.size:
                    raise ValueError("zstd output outgrew its bound")
            if last:
                return out.raw[:ob.pos]
            pos += n
    finally:
        lib.ZSTD_freeCCtx(cctx)


def decompress(frame: bytes, size: int) -> bytes:
    """The ``size`` bytes that ``frame`` (one or more zstd frames) decodes to;
    a frame that decodes to another size is refused."""
    lib = library()
    out = ctypes.create_string_buffer(max(size, 1))
    n = _check(lib, lib.ZSTD_decompress(out, size, frame, len(frame)), "decompress")
    if n != size:
        raise ValueError(f"zstd frame decodes to {n} bytes, expected {size}")
    return out.raw[:size]
