"""Eval-time image preprocessing with TF/slim ``inception_preprocessing``
semantics, in PyTorch (port of the eval part of
``tumblr_emotions_tpu/data/preprocessing.py``):

    uint8 -> [0, 1] -> central_crop(0.875) -> resize_bilinear(299, 299,
    align_corners=False, half_pixel_centers=False) -> x*2 - 1

The resize is two separable 1-D interpolations, each a dense [out, in]
matrix product.  In float32 they run in full f32 on the card (no TF32).
``preprocess_for_eval_s2d`` emits the 2x2 space-to-depth layout of the int8
engine's stem straight from the two resize products.  The train-time
distortions come with a later slice.
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


@functools.lru_cache(maxsize=64)
def _interp_tensor(out_size: int, in_size: int, method: str, dtype: torch.dtype,
                   device: torch.device, s2d: bool = False) -> torch.Tensor:
    """The interpolation matrix as a tensor on ``device``, uploaded once (an
    upload from pageable memory per batch would make the host wait for the
    card); ``s2d``: zero-padded to an even row count and reshaped to
    [out/2, 2, in]."""
    m = _interp_matrix_cached(out_size, in_size, method)
    if s2d:
        m = np.pad(m, ((0, -out_size % 2), (0, 0))).reshape(-1, 2, in_size)
    return torch.tensor(m, dtype=dtype, device=device)


def resize_bilinear(images: torch.Tensor, out_h: int, out_w: int,
                    method: str = "tf1",
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Batched NHWC bilinear resize as two matrix products."""
    n, h, w, c = images.shape
    dev = images.device
    rh = _interp_tensor(out_h, h, method, dtype, dev)
    rw = _interp_tensor(out_w, w, method, dtype, dev)
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


def space_to_depth_2x2(x: torch.Tensor) -> torch.Tensor:
    """[B,H,W,C] -> [B,ceil(H/2),ceil(W/2),4C]; odd H/W zero-pad at the end.

    A kxk stride-2 conv over [H,W,C] equals a ceil(k/2) x ceil(k/2)
    stride-1 conv over this layout with the kernel rearranged by
    ``ops.quant._s2d_kernel`` (the padded row/col only meets zero kernel
    taps).  Merged channel order is (dy, dx, c).
    """
    b, h, w, c = x.shape
    ph, pw = -h % 2, -w % 2
    if ph or pw:
        x = torch.nn.functional.pad(x, (0, 0, 0, pw, 0, ph))
    x = x.reshape(b, (h + ph) // 2, 2, (w + pw) // 2, 2, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h + ph) // 2, (w + pw) // 2, 4 * c)


def preprocess_for_eval_s2d(images: torch.Tensor, height: int = 299, width: int = 299,
                            central_fraction: float = 0.875,
                            resize_method: str = "tf1",
                            dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``preprocess_for_eval`` emitting the 2x2 space-to-depth layout directly.

    Returns [N, ceil(height/2), ceil(width/2), 4C] such that
    ``space_to_depth_2x2(preprocess_for_eval(images))`` holds (channel
    order (dy, dx, c)) on every real lane: the row and column interpolation
    matrices are reshaped to [out/2, 2, in], so the two resize products
    emit the (dy, dx) parity planes as separate dims and the merge to 4C is
    a reshape.  Same arithmetic in another contraction order, so bf16/f32
    results can differ from the non-s2d path by about one ulp.  For an odd
    height/width the padded parity plane holds -1 (the ``x*2 - 1`` of a
    zero row), where ``space_to_depth_2x2`` pads 0: it is inert, since the
    s2d kernel's padded taps are zero.
    """
    n, h, w, c = images.shape
    x = images.to(dtype)
    if not images.is_floating_point():
        x = x / 255.0
    if central_fraction and central_fraction < 1.0:
        oh, ow, ch, cw = central_crop_sizes(h, w, central_fraction)
        x = x[:, oh:oh + ch, ow:ow + cw, :]
        h, w = ch, cw
    ph, pw = -height % 2, -width % 2
    rh3 = _interp_tensor(height, h, resize_method, dtype, images.device, s2d=True)
    rw3 = _interp_tensor(width, w, resize_method, dtype, images.device, s2d=True)
    with full_f32():
        y = torch.einsum("idh,nhwc->nidwc", rh3, x)
        z = torch.einsum("jew,nidwc->nijdec", rw3, y)
    z = z.reshape(n, (height + ph) // 2, (width + pw) // 2, 4 * c)
    return z * 2.0 - 1.0
