"""Build a host C++ source of the package into a shared library at first use.

The library goes to a directory under ``build/`` beside the package, named by a hash
of the source and the flags, and is written by an atomic rename, so
concurrent processes may build at once and a changed source builds anew.
The compiler is ``c++`` or ``g++`` on ``PATH``; there is no fallback: a
failed build raises.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence

PKG = Path(__file__).resolve().parent.parent
BUILD_ROOT = PKG.parent / "build"


def compiler() -> str:
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (c++ or g++ on PATH)")
    return cxx


def target(source: Path, build_dir: Path, stem: str, flags: Sequence[str]) -> Path:
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join(flags).encode())
    return build_dir / f"{stem}_{digest.hexdigest()[:16]}.so"


def build(source: Path, build_dir: Path, stem: str, flags: Sequence[str],
          cxx: Optional[str] = None) -> Path:
    """Compile ``source`` into ``build_dir`` with ``cxx`` (default
    :func:`compiler`) unless its library exists; return the library's path.
    Raises ``RuntimeError`` if the compiler fails."""
    lib = target(source, build_dir, stem, flags)
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        r = subprocess.run([cxx or compiler(), *flags, "-o", str(tmp), str(source)],
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building {source.name} failed ({r.returncode}):\n"
                               f"{r.stdout}{r.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return lib
