"""Fused Inception-A/B blocks for Hopper: ports of the TPU Pallas blocks.

Replaces ``tumblr_emotions_tpu/ops/fused_inception.py::fused_inception_a``
(Mixed_5b/5c/5d, 35x35) and ``::fused_inception_b`` (Mixed_6b..6e, 17x17).
On the TPU each block is one Pallas program per image that keeps the whole
plane in VMEM and computes every SAME conv as masked row-shifted matmuls.
An H100 block has 227 KB of shared memory, less than one plane (35x35x288
bf16 is 0.7 MB), so the port splits each block into its convs instead:

- ``conv_same_bias_relu`` (``csrc/inception_blocks.cu``): a stride-1 SAME
  conv as an implicit GEMM (M = B*H*W pixels, N = Cout, K = kh*kw*Cin) on
  bf16 tensor cores with an f32 accumulator, + bias, ReLU, rounded to bf16,
  written straight into its channel slice of the block's output, so there
  is no concat.  Out-of-image taps read zero, as ``_valid_mask`` does.
- ``avg_pool3_same``: 3x3 stride-1 SAME average pool dividing by the
  in-image taps (``count_include_pad=False``), summed in f32 as ``_avg_pool3``.

The block functions launch each branch chain in the Pallas order (the pool
branch pools the block input, then runs its 1x1 conv) on the current stream.
Intermediates go through device memory (mostly L2), where the TPU kept them
in VMEM.

What bounds a block on an H100 (989 TFLOP/s bf16, 3.35 TB/s): per image,
Mixed_5b does 0.62 GFLOP against 1.10 MB of block input and output (570
FLOP per byte), Mixed_6b 0.75 GFLOP against 0.89 MB (840 FLOP per byte);
both are above the 295 FLOP per byte at which the tensor cores, not
memory, are the limit.  So the design keeps every product on the tensor
cores and overlaps the next K-tile's global loads with the current tile's
MMAs; it does not yet use ``wgmma``/TMA or keep a tile's branches in
shared memory, which is what the intermediates' extra traffic would need.

Each kernel has a plain PyTorch version beside it (f32 math, rounded to the
working type after every conv, where the kernel rounds).  A wrapper takes
the plain version only for a tensor on the CPU; for a CUDA tensor it
launches the kernel or raises.  ``launches`` on each wrapper counts the
kernel launches it made.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tumblr_emotions_torch._device import full_f32
from tumblr_emotions_torch.models.inception_v3 import inception_a_names
from tumblr_emotions_torch.models.layers import to_nchw, to_nhwc
from tumblr_emotions_torch.ops import _build

Taps = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


# ---------------------------------------------------------------------------
# Batch-norm folding (inference)
# ---------------------------------------------------------------------------

def fold_batchnorm(state: Dict[str, torch.Tensor], eps: float = 0.001
                   ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Fold slim BN (scale=False) into the conv weights of a port state dict.

    Returns {conv_scope: (w_folded [Cout,Cin,kh,kw] f32, b_folded [Cout] f32)}
    on the CPU.  y = (x*w - mean) * inv + beta == x @ (w*inv) + (beta - mean*inv).
    Convs without BN (the Logits/AuxLogits heads) pass through with their biases.
    The arithmetic is numpy float32, as in the JAX package, so the folded
    weights are bit-equal to its own.
    """
    f32 = {k: v.detach().cpu().numpy().astype(np.float32) for k, v in state.items()}
    out: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
    for key, w in f32.items():
        if not key.endswith(".weights"):
            continue
        scope = key[: -len(".weights")]
        mean = f32.get(f"{scope}.BatchNorm.moving_mean")
        if mean is not None:
            var = f32[f"{scope}.BatchNorm.moving_variance"]
            inv = 1.0 / np.sqrt(var + eps)
            gamma = f32.get(f"{scope}.BatchNorm.gamma")
            if gamma is not None:
                inv = inv * gamma
            w, b = w * inv[:, None, None, None], f32[f"{scope}.BatchNorm.beta"] - mean * inv
        else:
            b = f32.get(f"{scope}.biases", np.zeros(w.shape[0], np.float32))
        out[scope] = (torch.from_numpy(w), torch.from_numpy(b))
    return out


def _taps(w: torch.Tensor) -> torch.Tensor:
    """[Cout,Cin,kh,kw] -> [kh*kw, Cin, Cout] tap stack (contiguous)."""
    co, ci, kh, kw = w.shape
    return w.permute(2, 3, 1, 0).reshape(kh * kw, ci, co).contiguous()


# ---------------------------------------------------------------------------
# The kernels and their plain versions
# ---------------------------------------------------------------------------

def conv_same_bias_relu_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                              kernel: Tuple[int, int], out: torch.Tensor = None
                              ) -> torch.Tensor:
    """Plain version: f32 SAME conv of NHWC ``x`` with tap stack ``w``
    [kh*kw, Cin, Cout], + bias, ReLU, rounded to ``x.dtype`` (copied into
    ``out`` if given)."""
    kh, kw = kernel
    w4 = w.float().reshape(kh, kw, w.shape[1], w.shape[2]).permute(3, 2, 0, 1)
    with full_f32():
        y = F.conv2d(to_nchw(x.float()), w4, padding=(kh // 2, kw // 2))
    y = torch.relu(to_nhwc(y) + bias.float()).to(x.dtype)
    return y if out is None else out.copy_(y)


def avg_pool3_same_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version: 3x3 stride-1 SAME average pool, count_include_pad=False,
    in f32, rounded to ``x.dtype``."""
    y = F.avg_pool2d(to_nchw(x.float()), 3, 1, padding=1, count_include_pad=False)
    return to_nhwc(y).to(x.dtype)


def _pixel_stride(t: torch.Tensor, what: str) -> int:
    """Stride between pixels of an NHWC tensor whose channels are contiguous
    (a channel slice of a larger NHWC tensor qualifies)."""
    B, H, W, C = t.shape
    s = t.stride()
    if not (s[3] == 1 and s[2] >= C and s[1] == W * s[2] and s[0] == H * s[1]):
        raise ValueError(f"{what}: NHWC layout with contiguous channels "
                         f"expected, got shape {tuple(t.shape)} strides {s}")
    return s[2]


def _check_cuda(name: str, tensors: Dict[str, torch.Tensor], dtypes: Dict[str, torch.dtype]):
    dev = next(iter(tensors.values())).device
    for k, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {k} on {t.device}, expected {dev}")
        if t.dtype != dtypes[k]:
            raise ValueError(f"{name}: {k} is {t.dtype}, the kernel takes {dtypes[k]}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {k} is not 16-byte aligned")


def conv_same_bias_relu(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                        kernel: Tuple[int, int], out: torch.Tensor = None) -> torch.Tensor:
    """relu(SAME_conv(x, w) + bias) -> bf16, for stride 1 and an odd kernel.

    x: [B,H,W,Cin] NHWC; may be a channel slice of a larger NHWC tensor.
    w: [kh*kw, Cin, Cout] tap stack (``_taps``).  bias: [Cout] f32.
    out: optional [B,H,W,Cout] destination, e.g. a channel slice of a
    block's output; allocated if None.  On the card the kernel takes bf16
    with Cin, Cout and the pixel strides multiples of 8.
    """
    kh, kw = kernel
    B, H, W, cin = x.shape
    taps, cin_w, cout = w.shape
    if taps != kh * kw or cin_w != cin or kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"conv_same_bias_relu: kernel {kernel}, x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)} do not fit")
    if out is not None and tuple(out.shape) != (B, H, W, cout):
        raise ValueError(f"conv_same_bias_relu: out {tuple(out.shape)} != "
                         f"{(B, H, W, cout)}")
    if x.device.type == "cpu":
        return conv_same_bias_relu_plain(x, w, bias, kernel, out)
    if out is None:
        out = torch.empty(B, H, W, cout, dtype=x.dtype, device=x.device)
    _check_cuda("conv_same_bias_relu", dict(x=x, w=w, bias=bias, out=out),
                dict(x=torch.bfloat16, w=torch.bfloat16, bias=torch.float32,
                     out=torch.bfloat16))
    xs, os_ = _pixel_stride(x, "x"), _pixel_stride(out, "out")
    if not (w.is_contiguous() and bias.is_contiguous()) or bias.shape != (cout,):
        raise ValueError("conv_same_bias_relu: w and bias must be contiguous, "
                         f"bias of shape ({cout},)")
    if cin % 8 or cout % 8 or xs % 8 or os_ % 8:
        raise ValueError("conv_same_bias_relu: the kernel takes Cin, Cout and "
                         f"pixel strides that are multiples of 8, got {cin}, "
                         f"{cout}, {xs}, {os_}")
    with torch.cuda.device(x.device):
        err = _build.library("inception_blocks").conv_same_bias_relu_bf16(
            x.data_ptr(), xs, w.data_ptr(), bias.data_ptr(), out.data_ptr(), os_,
            B, H, W, cin, cout, kh, kw, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "conv_same_bias_relu", "inception_blocks")
    conv_same_bias_relu.launches += 1
    return out


conv_same_bias_relu.launches = 0


def avg_pool3_same(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME average pool of contiguous NHWC ``x``, dividing by
    the in-image taps; on the card bf16 with C a multiple of 8."""
    if x.device.type == "cpu":
        return avg_pool3_same_plain(x)
    B, H, W, C = x.shape
    if not x.is_contiguous() or C % 8:
        raise ValueError("avg_pool3_same: x must be contiguous NHWC with C a "
                         f"multiple of 8, got {tuple(x.shape)}")
    out = torch.empty_like(x)
    _check_cuda("avg_pool3_same", dict(x=x, out=out),
                dict(x=torch.bfloat16, out=torch.bfloat16))
    with torch.cuda.device(x.device):
        err = _build.library("inception_blocks").avg_pool3_same_bf16(
            x.data_ptr(), out.data_ptr(), B, H, W, C,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "avg_pool3_same", "inception_blocks")
    avg_pool3_same.launches += 1
    return out


avg_pool3_same.launches = 0


# ---------------------------------------------------------------------------
# The blocks
# ---------------------------------------------------------------------------

# A block is four branches; each is (starts with the 3x3 avg pool?, its
# chain of (conv name, kernel)).  The last conv of a branch writes its
# channel slice of the output.
Branches = Sequence[Tuple[bool, List[Tuple[str, Tuple[int, int]]]]]


def inception_a_branches(quirky_5c: bool) -> Branches:
    n1 = inception_a_names(quirky_5c)
    return [
        (False, [("Branch_0/Conv2d_0a_1x1", (1, 1))]),
        (False, [(f"Branch_1/{n1[0]}", (1, 1)), (f"Branch_1/{n1[1]}", (5, 5))]),
        (False, [("Branch_2/Conv2d_0a_1x1", (1, 1)),
                 ("Branch_2/Conv2d_0b_3x3", (3, 3)),
                 ("Branch_2/Conv2d_0c_3x3", (3, 3))]),
        (True, [("Branch_3/Conv2d_0b_1x1", (1, 1))]),
    ]


INCEPTION_B_BRANCHES: Branches = [
    (False, [("Branch_0/Conv2d_0a_1x1", (1, 1))]),
    (False, [("Branch_1/Conv2d_0a_1x1", (1, 1)),
             ("Branch_1/Conv2d_0b_1x7", (1, 7)),
             ("Branch_1/Conv2d_0c_7x1", (7, 1))]),
    (False, [("Branch_2/Conv2d_0a_1x1", (1, 1)),
             ("Branch_2/Conv2d_0b_7x1", (7, 1)),
             ("Branch_2/Conv2d_0c_1x7", (1, 7)),
             ("Branch_2/Conv2d_0d_7x1", (7, 1)),
             ("Branch_2/Conv2d_0e_1x7", (1, 7))]),
    (True, [("Branch_3/Conv2d_0b_1x1", (1, 1))]),
]


def _run_block(x: torch.Tensor, taps: Taps, scope: str, branches: Branches,
               conv: Callable, pool: Callable) -> torch.Tensor:
    B, H, W, _ = x.shape
    couts = [taps[f"{scope}/{chain[-1][0]}"][0].shape[-1] for _, chain in branches]
    out = torch.empty(B, H, W, sum(couts), dtype=x.dtype, device=x.device)
    off = 0
    for (pooled, chain), cout in zip(branches, couts):
        h = pool(x) if pooled else x
        for i, (name, kernel) in enumerate(chain):
            w, b = taps[f"{scope}/{name}"]
            dst = out[..., off:off + cout] if i == len(chain) - 1 else None
            h = conv(h, w, b, kernel, out=dst)
        off += cout
    return out


def fused_inception_a_plain(x: torch.Tensor, taps: Taps, scope: str,
                            quirky_5c: bool = False) -> torch.Tensor:
    """Plain version of ``fused_inception_a``, on any device."""
    return _run_block(x, taps, scope, inception_a_branches(quirky_5c),
                      conv_same_bias_relu_plain, avg_pool3_same_plain)


def fused_inception_b_plain(x: torch.Tensor, taps: Taps, scope: str) -> torch.Tensor:
    """Plain version of ``fused_inception_b``, on any device."""
    return _run_block(x, taps, scope, INCEPTION_B_BRANCHES,
                      conv_same_bias_relu_plain, avg_pool3_same_plain)


def fused_inception_a(x: torch.Tensor, taps: Taps, scope: str,
                      quirky_5c: bool = False) -> torch.Tensor:
    """Inception-A: x [B,H,W,Cin] -> [B,H,W,Cout], BN-folded.

    ``taps``: {conv_scope: (tap stack [kh*kw,Cin,Cout], bias f32)} on x's
    device, e.g. ``FusedInceptionV3.taps``; ``scope`` e.g. "Mixed_5b";
    ``quirky_5c`` selects slim's Mixed_5c names.
    """
    if x.device.type == "cpu":
        return fused_inception_a_plain(x, taps, scope, quirky_5c)
    out = _run_block(x, taps, scope, inception_a_branches(quirky_5c),
                     conv_same_bias_relu, avg_pool3_same)
    fused_inception_a.launches += 1
    return out


fused_inception_a.launches = 0


def fused_inception_b(x: torch.Tensor, taps: Taps, scope: str) -> torch.Tensor:
    """Inception-B (factorized 7x7): x [B,H,W,Cin] -> [B,H,W,Cout]."""
    if x.device.type == "cpu":
        return fused_inception_b_plain(x, taps, scope)
    out = _run_block(x, taps, scope, INCEPTION_B_BRANCHES,
                     conv_same_bias_relu, avg_pool3_same)
    fused_inception_b.launches += 1
    return out


fused_inception_b.launches = 0


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in (conv_same_bias_relu, avg_pool3_same, fused_inception_a,
               fused_inception_b):
        fn.launches = 0
