"""CRC-32C on the host, in C++ (``csrc/crc32c.cc``, bound with ctypes).

The checksum of TFRecord framing (``data/records.py``) and of TF's
tensor-bundle checkpoints (``utils/checkpoint.py``): the reference takes it
from ``google_crc32c``; the port builds its own at first use with the host
C++ compiler (``utils/host_lib.py``), on the SSE4.2 ``crc32`` instruction
where the CPU has it, else a slicing-by-8 table loop.  Checkpoint shards
run to hundreds of MB, so the crc is not computed in Python.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from tumblr_emotions_torch.utils import host_lib

SOURCE = host_lib.PKG / "csrc" / "crc32c.cc"
FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]
_MASK_DELTA = 0xA282EAD8


def build() -> Path:
    return host_lib.build(SOURCE, host_lib.BUILD_ROOT / "host_crc32c", "libcrc32c", FLAGS)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name in ("crc32c_extend", "crc32c_extend_tables"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_uint32, ctypes.c_void_p, ctypes.c_size_t]
        fn.restype = ctypes.c_uint32
    lib.crc32c_hardware.argtypes, lib.crc32c_hardware.restype = [], ctypes.c_int
    return lib


def _pointer(data):
    """(pointer, nbytes) of bytes, a buffer or a C-contiguous array, without a copy."""
    if isinstance(data, bytes):
        return data, len(data)
    arr = data if isinstance(data, np.ndarray) else np.frombuffer(data, np.uint8)
    if not arr.flags.c_contiguous:
        raise ValueError("crc32c needs a C-contiguous array")
    return ctypes.c_void_p(arr.ctypes.data), arr.nbytes


def extend(crc: int, data) -> int:
    """The CRC-32C of ``data`` continued from ``crc`` (that of the bytes before it)."""
    ptr, n = _pointer(data)
    return library().crc32c_extend(crc, ptr, n)


def value(data) -> int:
    """The CRC-32C of ``data`` (bytes, a buffer or a C-contiguous array)."""
    return extend(0, data)


def mask(crc: int) -> int:
    """TF's masked crc: rotated right by 15 bits plus a constant, so a crc
    stored beside its data does not checksum to a fixed value."""
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def unmask(masked: int) -> int:
    rot = (masked - _MASK_DELTA) & 0xFFFFFFFF
    return ((rot >> 17) | (rot << 15)) & 0xFFFFFFFF


def masked(data) -> int:
    return mask(value(data))
