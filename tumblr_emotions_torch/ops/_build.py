"""Build the port's CUDA kernels at first use and bind them with ctypes.

``csrc/inception_blocks.cu`` has a plain C interface, so it is compiled by
``nvcc`` alone into a shared library (seconds, where a source that includes
PyTorch's headers takes minutes) under ``build/torch_kernels/`` beside the
package, named by a hash of the source and flags so an edited source is
rebuilt.  Pointers and the stream are passed as ``ctypes.c_void_p``; each
entry point returns ``cudaGetLastError()`` and :func:`check` raises on it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "inception_blocks.cu"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); the "
                           "CUDA toolkit is needed to build the kernels")
    return nvcc


def build() -> Path:
    """Compile the kernels if this source has no library yet; return its path.

    The compiler's resource report (``-Xptxas -v``) is kept beside the
    library as ``.log``.
    """
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode())
    lib = BUILD_DIR / f"libinception_blocks_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    r = subprocess.run([_nvcc(), *FLAGS, "-o", str(tmp), str(SOURCE)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stdout}{r.stderr}")
    lib.with_suffix(".log").write_text(r.stdout + r.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.conv_same_bias_relu_bf16.argtypes = [P, I, P, P, P, I, I, I, I, I, I, I, I, P]
    lib.conv_same_bias_relu_bf16.restype = I
    lib.avg_pool3_same_bf16.argtypes = [P, P, I, I, I, I, P]
    lib.avg_pool3_same_bf16.restype = I
    lib.inception_blocks_error_string.argtypes = [I]
    lib.inception_blocks_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err:
        msg = library().inception_blocks_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
