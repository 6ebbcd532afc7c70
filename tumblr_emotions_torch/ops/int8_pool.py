"""int8 3x3 stride-2 VALID max pool for Hopper: the port of K4a/K4b.

Replaces ``experiments/pallas_pool.py::pallas_pool_3d`` and
``::pallas_pool_2d``, which compute one function (the int8 3x3/2 VALID max
pool at MaxPool_3a's ``[B,147,147,32]``) in two TPU layouts; their parity
oracle, ``reduce_window``, is what ``tumblr_emotions_tpu/ops/quant.py::
_Int8Ops.maxpool`` runs four times per forward, with an optional rescale
to the block's scale (Mixed_6a/7a's pool branch):
``clip(float(max) * (s / s_out) + 0.5, 0, 127)`` -> int8 by truncation.

``maxpool3x3s2_int8`` (``csrc/int8_pool.cu``) moves 16 channels per thread
in 16-byte loads where C and the pixel strides are multiples of 16, one
channel per thread otherwise, and may write into a channel slice of a
block's concat buffer.  Its plain version pools the values widened to
float32 (exact) and rescales with one rounded multiply and one rounded add,
as the kernel does.  The wrapper takes the plain version only for a tensor
on the CPU; for a CUDA tensor it launches the kernel or raises.
``maxpool3x3s2_int8.launches`` counts launches (run, not recorded into a
CUDA graph).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from tumblr_emotions_torch.models.layers import to_nchw, to_nhwc
from tumblr_emotions_torch.ops import _build
from tumblr_emotions_torch.ops.fused_inception import _pixel_stride


def _pooled_shape(x: torch.Tensor):
    B, H, W, C = x.shape
    if H < 3 or W < 3:
        raise ValueError(f"maxpool3x3s2_int8: input {tuple(x.shape)} is smaller than the window")
    return B, (H - 3) // 2 + 1, (W - 3) // 2 + 1, C


def maxpool3x3s2_int8_plain(x: torch.Tensor, rescale: Optional[float] = None,
                            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`maxpool3x3s2_int8`."""
    y = to_nhwc(F.max_pool2d(to_nchw(x).float(), 3, 2))
    if rescale is None:
        y = y.to(torch.int8)
    else:
        # the f32 value as a Python scalar: the same f32 product as a 0-d f32
        # tensor, with no host-to-card copy (which a CUDA graph capture refuses)
        y = (y * float(np.float32(rescale)) + 0.5).clamp(0.0, 127.0).to(torch.int8)
    return y if out is None else out.copy_(y)


def maxpool3x3s2_int8(x: torch.Tensor, rescale: Optional[float] = None,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """3x3 stride-2 VALID max pool of int8 NHWC ``x`` (a channel slice
    qualifies); with ``rescale`` = s / s_out the max is requantized to the
    output scale (values are post-ReLU).  ``out``: optional [B,Ho,Wo,C] int8
    destination, e.g. a channel slice of a block's output."""
    shape = _pooled_shape(x)
    if out is not None and (tuple(out.shape) != shape or out.dtype != torch.int8):
        raise ValueError(f"maxpool3x3s2_int8: out {tuple(out.shape)} {out.dtype}, "
                         f"expected {shape} torch.int8")
    if x.device.type == "cpu":
        return maxpool3x3s2_int8_plain(x, rescale, out)
    if x.dtype != torch.int8:
        raise ValueError(f"maxpool3x3s2_int8: x is {x.dtype}, the kernel takes torch.int8")
    if out is None:
        out = torch.empty(shape, dtype=torch.int8, device=x.device)
    if out.device != x.device:
        raise ValueError(f"maxpool3x3s2_int8: out on {out.device}, expected {x.device}")
    B, H, W, C = x.shape
    with torch.cuda.device(x.device):
        err = _build.library("int8_pool").maxpool3x3s2_int8(
            x.data_ptr(), _pixel_stride(x, "x"), out.data_ptr(), _pixel_stride(out, "out"),
            B, H, W, C, int(rescale is not None),
            float(np.float32(rescale)) if rescale is not None else 0.0,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "maxpool3x3s2_int8", "int8_pool")
    if _build.launched(x.device):
        maxpool3x3s2_int8.launches += 1
    return out


maxpool3x3s2_int8.launches = 0


def reset_launches() -> None:
    maxpool3x3s2_int8.launches = 0
