"""Eval-time image preprocessing with TF/slim ``inception_preprocessing``
semantics, in PyTorch (port of the eval part of
``tumblr_emotions_tpu/data/preprocessing.py``):

    uint8 -> [0, 1] -> central_crop(0.875) -> resize_bilinear(299, 299,
    align_corners=False, half_pixel_centers=False) -> x*2 - 1

The resize is two separable 1-D interpolations, each a dense [out, in]
matrix product.  In float32 they run in full f32 on the card (no TF32).
The space-to-depth front and the train-time distortions come with later
slices.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from tumblr_emotions_torch._device import full_f32


def _interp_matrix(out_size: int, in_size: int, method: str) -> np.ndarray:
    """Dense [out_size, in_size] bilinear interpolation matrix (f32).

    method: "tf1"        — legacy TF1 resize_bilinear: src = dst * in/out
            "half_pixel" — TF2 semantics: src = (dst+0.5)*in/out - 0.5
    """
    m = np.zeros((out_size, in_size), np.float32)
    if in_size == out_size:
        np.fill_diagonal(m, 1.0)
        return m
    # The source grid is computed in float32 as TF's kernels do; a float64
    # grid drifts by ~2e-5 against TF.
    scale = np.float32(in_size) / np.float32(out_size)
    for o in range(out_size):
        if method == "tf1":
            src = float(np.float32(o) * scale)
        elif method == "half_pixel":
            src = float((np.float32(o) + np.float32(0.5)) * scale - np.float32(0.5))
        else:
            raise ValueError(f"unknown resize method {method!r}")
        src = min(max(src, 0.0), in_size - 1)
        lo = int(np.floor(src))
        hi = min(lo + 1, in_size - 1)
        frac = src - lo
        m[o, lo] += 1.0 - frac
        m[o, hi] += frac
    return m


@functools.lru_cache(maxsize=64)
def _interp_matrix_cached(out_size: int, in_size: int, method: str) -> np.ndarray:
    m = _interp_matrix(out_size, in_size, method)
    m.flags.writeable = False
    return m


def resize_bilinear(images: torch.Tensor, out_h: int, out_w: int,
                    method: str = "tf1",
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Batched NHWC bilinear resize as two matrix products."""
    n, h, w, c = images.shape
    dev = images.device
    rh = torch.tensor(_interp_matrix_cached(out_h, h, method), dtype=dtype, device=dev)
    rw = torch.tensor(_interp_matrix_cached(out_w, w, method), dtype=dtype, device=dev)
    x = images.to(dtype)
    with full_f32():
        x = torch.einsum("oh,nhwc->nowc", rh, x)
        return torch.einsum("pw,nowc->nopc", rw, x)


def central_crop_sizes(h: int, w: int, fraction: float) -> Tuple[int, int, int, int]:
    """tf.image.central_crop offsets and sizes (its integer arithmetic)."""
    off_h = int((h - h * fraction) / 2.0)
    off_w = int((w - w * fraction) / 2.0)
    return off_h, off_w, h - 2 * off_h, w - 2 * off_w


def preprocess_for_eval(images: torch.Tensor, height: int = 299, width: int = 299,
                        central_fraction: float = 0.875,
                        resize_method: str = "tf1",
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """slim preprocess_for_eval on an NHWC batch.

    images: [N, H, W, C] uint8 (0..255) or float already in [0, 1].
    Returns [N, height, width, C] in [-1, 1], in ``dtype``.
    """
    n, h, w, c = images.shape
    x = images.to(dtype)
    if not images.is_floating_point():
        x = x / 255.0  # tf.image.convert_image_dtype
    if central_fraction and central_fraction < 1.0:
        oh, ow, ch, cw = central_crop_sizes(h, w, central_fraction)
        x = x[:, oh:oh + ch, ow:ow + cw, :]
    x = resize_bilinear(x, height, width, method=resize_method, dtype=dtype)
    return x * 2.0 - 1.0
