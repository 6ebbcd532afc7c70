"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every ``csrc/*.cu`` has a plain C interface, so each is compiled by ``nvcc``
alone into its own shared library (seconds, where a source that includes
PyTorch's headers takes minutes) under ``build/torch_kernels/`` beside the
package, named by a hash of the source, the shared headers (``csrc/*.cuh``)
and the flags, so an edited source or header is rebuilt.  :func:`build`
starts one ``nvcc`` per missing library, all at once.  Pointers and the
stream are passed as ``ctypes.c_void_p``; each entry point returns
``cudaGetLastError()`` and :func:`check` raises on it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

def launched(dev: torch.device) -> bool:
    """Whether a kernel just launched on ``dev``'s current stream ran: not
    while that stream is being captured into a CUDA graph, which records the
    launch.  The wrappers' launch counts count the kernels run; a graph's
    kernels are counted from the graph (``utils.compile_opts``)."""
    with torch.cuda.device(dev):
        return not torch.cuda.is_current_stream_capturing()


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# Entry points of each source: name -> argtypes (all return an int error).
SIGNATURES: Dict[str, Dict[str, list]] = {
    "inception_blocks": {
        "conv_bf16": [_P, _L, _P, _P] + [_I] * 8 + [_I, _P, _P, _P] + [_I] * 3 + [_P],
    },
    "int8_conv": {
        "conv_int8": [_P, _L, _P] + [_I] * 13 + [_P] * 4 + [_I, _P, _P, _P, _P]
                     + [_I] * 4 + [_P],
    },
    "int8_pool": {
        "maxpool3x3s2_int8": [_P, _L, _P, _L, _I, _I, _I, _I, _I, _F, _P],
    },
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); the "
                           "CUDA toolkit is needed to build the kernels")
    return nvcc


def _target(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source, the
    headers under ``csrc/`` (any of which it may include) and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build() -> Dict[str, Path]:
    """Compile every source that has no library yet, in parallel; return
    {source name: library path}.

    The compiler's resource report (``-Xptxas -v``) is kept beside each
    library as ``.log``.
    """
    libs = {name: _target(name) for name in SIGNATURES}
    todo = {name: lib for name, lib in libs.items() if not lib.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name, lib in todo.items():
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            procs[name] = (tmp, subprocess.Popen(
                [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}.cu ({proc.returncode}):\n{out}")
                continue
            lib = todo[name]
            lib.with_suffix(".log").write_text(out)
            os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return libs


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (all built on first call)."""
    lib = ctypes.CDLL(str(build()[name]))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = _I
    err = getattr(lib, f"{name}_error_string")
    err.argtypes, err.restype = [_I], ctypes.c_char_p
    return lib


def raw_stream(dev) -> int:
    """The current stream's handle on ``dev``, by the call PyTorch's own
    kernel launchers use (a fraction of ``current_stream(dev).cuda_stream``'s
    host time) where this build of PyTorch has it."""
    get = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return get(dev.index) if get is not None else torch.cuda.current_stream(dev).cuda_stream


def check(err: int, name: str, source: str) -> None:
    """Raise if a launch of ``name`` (from ``csrc/<source>.cu``) reported a
    CUDA error."""
    if err:
        msg = getattr(library(source), f"{source}_error_string")(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
