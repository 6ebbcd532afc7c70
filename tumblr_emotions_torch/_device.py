"""Device selection for the port's entry points.

Entry points default to ``"cuda"`` and raise when no card is present: a
served program that silently drops to the CPU would report CPU numbers under
a GPU's name.  Callers that want the CPU (the tests) ask for it.
"""

from __future__ import annotations

import contextlib
import subprocess

import torch


def card_line() -> str:
    """The first card's name and power limit as nvidia-smi reports them
    (``"NVIDIA H100 80GB HBM3, 700.00 W"``): a card set below its maximum
    power runs slower, so every time measured on it carries this line."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@contextlib.contextmanager
def full_f32():
    """Run float32 convolutions and matmuls without TF32 on the card.

    cuDNN convolutions default to TF32 (``torch.backends.cudnn.allow_tf32``
    is True), which keeps about three decimal digits; the f32 reference path
    runs at ``precision="highest"`` in the JAX package.
    """
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32, matmul.allow_tf32 = False, False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


@contextlib.contextmanager
def tf32_convs():
    """Let cuDNN run float32 convolutions in TF32, for convs whose operands
    are bf16 values held in float32: TF32 keeps 10 mantissa bits, so it
    holds every bf16 value exactly, and the tensor cores form the products
    exactly and accumulate in float32.  Nothing else runs in TF32 inside."""
    cudnn = torch.backends.cudnn
    saved = cudnn.allow_tf32
    cudnn.allow_tf32 = True
    try:
        yield
    finally:
        cudnn.allow_tf32 = saved


@contextlib.contextmanager
def deterministic_convs():
    """Let cuDNN pick only deterministic algorithms.  Its default weight-
    gradient algorithms sum by atomics in another order each run, so two
    runs of one train step on the card differ in the last bits of many
    leaves (``chip_smoke.py`` train_captured counts them), and neither a
    resumed nor a captured step could equal the step it replaces."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic
    cudnn.deterministic = True
    try:
        yield
    finally:
        cudnn.deterministic = saved
