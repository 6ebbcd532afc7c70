"""Slim-semantics building blocks in PyTorch (eval mode), NHWC at the edges.

Ports ``tumblr_emotions_tpu/models/layers.py``: every conv is slim.conv2d,
i.e. conv without bias -> batch norm with ``scale=False``, ``epsilon=0.001``
-> ReLU.  Parameter names mirror the slim variable names (``weights``,
``BatchNorm.beta``, ``BatchNorm.moving_mean`` ...), so ``convert.py`` maps
the JAX package's tree onto ``state_dict()`` keys by string alone.

The f32 path is the parity reference: it runs with TF32 off (see
``_device.full_f32``), as the JAX package runs ``precision="highest"``.
Train mode (batch statistics, moving-average updates) comes with the
train slice; the modules here raise if asked for it.  ``Dense`` is flax's
dense layer for the text and joint heads.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC tensor -> NCHW view (channels_last strides, no copy)."""
    return x.permute(0, 3, 1, 2)


def to_nhwc(y: torch.Tensor) -> torch.Tensor:
    """NCHW tensor -> contiguous NHWC (no copy if ``y`` is channels_last)."""
    return y.permute(0, 2, 3, 1).contiguous()


def same_padding(kernel: Tuple[int, int], strides: Tuple[int, int]) -> Tuple[int, int]:
    """Symmetric padding equal to TF's SAME for the convs this tower has.

    TF pads ``max(k - s, 0)`` split low/high with the extra pixel high; for
    stride 1 and an odd kernel that is exactly ``k // 2`` on both sides.
    Every SAME conv and pool in Inception-v3 is of that kind.
    """
    kh, kw = kernel
    if tuple(strides) != (1, 1) or kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(
            f"SAME padding is implemented for stride 1 and odd kernels only, "
            f"got kernel={kernel} strides={strides}")
    return kh // 2, kw // 2


class SlimBatchNorm(nn.Module):
    """Batch norm with slim's names: ``beta`` (and ``gamma`` iff scale)
    parameters, ``moving_mean`` / ``moving_variance`` buffers.  Eval only.

    Not ``nn.BatchNorm2d``: torch's default eps is 1e-5 and its running
    statistics follow other conventions than slim's.
    """

    def __init__(self, features: int, epsilon: float = 0.001,
                 scale: bool = False, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.beta = nn.Parameter(torch.zeros(features, device=device))
        self.gamma = (nn.Parameter(torch.ones(features, device=device))
                      if scale else None)
        self.register_buffer("moving_mean", torch.zeros(features, device=device))
        self.register_buffer("moving_variance", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError("train-mode batch norm is not ported yet")
        inv = torch.rsqrt(self.moving_variance + self.epsilon)
        if self.gamma is not None:
            inv = inv * self.gamma
        # y = (x - mean) * inv + beta, folded into one multiply-add.
        return x.float() * inv + (self.beta - self.moving_mean * inv)


class ConvBN(nn.Module):
    """slim.conv2d on NHWC input: conv (OIHW ``weights``) [+ ``biases``]
    [-> SlimBatchNorm] [-> ReLU]."""

    def __init__(self, in_features: int, features: int,
                 kernel: Tuple[int, int], strides: Tuple[int, int] = (1, 1),
                 padding: str = "SAME", use_bn: bool = True,
                 use_bias: bool = False, relu: bool = True,
                 bn_epsilon: float = 0.001, bn_scale: bool = False,
                 device=None):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
        self.strides = tuple(strides)
        self.pad = same_padding(kernel, strides) if padding == "SAME" else (0, 0)
        self.relu = relu
        self.weights = nn.Parameter(
            torch.zeros(features, in_features, *kernel, device=device))
        self.biases = (nn.Parameter(torch.zeros(features, device=device))
                       if use_bias else None)
        self.BatchNorm: Optional[SlimBatchNorm] = (
            SlimBatchNorm(features, bn_epsilon, bn_scale, device=device)
            if use_bn else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = to_nhwc(F.conv2d(to_nchw(x), self.weights, stride=self.strides,
                             padding=self.pad))
        if self.biases is not None:
            y = y + self.biases
        if self.BatchNorm is not None:
            y = self.BatchNorm(y)
        return torch.relu(y) if self.relu else y


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel^T + bias``, with ``kernel`` held
    [out, in] (``convert.py`` transposes flax's [in, out])."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(features, in_features, device=device))
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.kernel, self.bias)


def max_pool(x: torch.Tensor, window: Tuple[int, int],
             strides: Tuple[int, int]) -> torch.Tensor:
    """VALID max pool on NHWC."""
    return to_nhwc(F.max_pool2d(to_nchw(x), window, strides))


def avg_pool(x: torch.Tensor, window: Tuple[int, int], strides: Tuple[int, int],
             padding: str = "SAME") -> torch.Tensor:
    """Average pool on NHWC dividing by the in-image taps only, as TF's
    AvgPool does (``count_include_pad=False``)."""
    pad = same_padding(window, strides) if padding == "SAME" else (0, 0)
    return to_nhwc(F.avg_pool2d(to_nchw(x), window, strides, padding=pad,
                                count_include_pad=False))
