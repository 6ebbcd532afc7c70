"""HighwayHash-64 on the host, in C++ (``csrc/highwayhash.cc``, bound with ctypes).

The hash of riegeli records files, which ArrayRecord shards are
(``data/arrayrecord.py``): every block header and every chunk header
carries the HighwayHash-64 of its other fields, and every chunk header
that of its data, all under riegeli's key, the bytes
``"Riegeli/records\\n"`` twice as four little-endian 64-bit words.  The
library is built at first use with the host C++ compiler
(``utils/host_lib.py``), as ``utils/crc32c.py`` is.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from pathlib import Path

from tumblr_emotions_torch.utils import host_lib

SOURCE = host_lib.PKG / "csrc" / "highwayhash.cc"
FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]
RIEGELI_KEY = struct.unpack("<4Q", b"Riegeli/records\n" * 2)


def build() -> Path:
    return host_lib.build(SOURCE, host_lib.BUILD_ROOT / "host_highwayhash",
                          "libhighwayhash", FLAGS)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.highwayhash64.argtypes = [ctypes.POINTER(ctypes.c_uint64), ctypes.c_char_p,
                                  ctypes.c_size_t]
    lib.highwayhash64.restype = ctypes.c_uint64
    return lib


def hash64(data: bytes, key=RIEGELI_KEY) -> int:
    """HighwayHash-64 of ``data`` (bytes) under ``key`` (four 64-bit words;
    default riegeli's)."""
    data = bytes(data)
    return library().highwayhash64((ctypes.c_uint64 * 4)(*key), data, len(data))
