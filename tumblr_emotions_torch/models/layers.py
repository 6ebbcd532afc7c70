"""Slim-semantics building blocks in PyTorch, NHWC at the edges.

Ports ``tumblr_emotions_tpu/models/layers.py``: every conv is slim.conv2d,
i.e. conv without bias -> batch norm with ``scale=False``, ``epsilon=0.001``
-> ReLU.  Parameter names mirror the slim variable names (``weights``,
``BatchNorm.beta``, ``BatchNorm.moving_mean`` ...), so ``convert.py`` maps
the JAX package's tree onto ``state_dict()`` keys by string alone.

The f32 path is the parity reference: it runs with TF32 off (see
``_device.full_f32``), as the JAX package runs ``precision="highest"``.
``dtype=torch.bfloat16`` is the JAX package's ``precision_mode="perf"``
model (``tumblr_emotions_tpu/models/layers.py:72-73,114-123``) as its
jitted program computes it:

- each conv takes bf16 operands and accumulates in f32
  (:func:`conv_f32_accumulate`, the conv the bf16 engine's cuDNN convs
  run); batch norm computes ``x.f32 * inv + (beta - mean * inv)`` on that
  f32 accumulator and rounds once to bf16 (XLA drops the conv output's
  bf16 round trip ahead of the norm);
- a conv without norm, and a Dense, rounds its product and adds its bf16
  bias; a head's softmax reads that sum before its last rounding
  (``unrounded``);
- ReLU, max pools and concatenations stay in bf16; an average pool sums
  its window in bf16, tap by tap in row-major order, and scales by the f32
  reciprocal of the count, returning f32 (flax's ``avg_pool`` on a bf16
  input).

In train mode (``module.train()``) batch norm normalises with the batch's
own statistics and moves its buffers towards them, as slim and the JAX
package do (:class:`SlimBatchNorm`), and :class:`Dropout` is flax's.
``Dense`` is flax's dense layer for the text and joint heads.

The bf16 model trains on f32 master weights, as the reference's jitted
perf step does.  Its optimized program (XLA on the CPU, read from the
compiled HLO of a two-layer ``ConvBN`` net under ``jax.value_and_grad``)
keeps these roundings and drops the others, and the port follows it:

- forward: as in eval, the conv's f32 accumulator reaches batch norm
  unrounded, for the batch statistics (f32) as for the normalisation; the
  norm's output is rounded once; a head's product is rounded before its
  bf16 bias;
- the cotangent batch norm passes back to its input is rounded to bf16 on
  each of its two paths (the normalisation and the statistics, the VJPs of
  the two ``astype(f32)``), and their sum is rounded again
  (:func:`round_grad`, then the conv's backward rounds its incoming
  gradient);
- a conv's weight gradient is the f32 product of bf16 values, left
  unrounded (XLA drops the bf16 round trip of the transposed conv and of
  the VJP of ``w.astype(bf16)``), and so is its input gradient where the
  input was f32 (an average pool's output, ``PreLogits``); where the input
  was bf16 (a ReLU's output) the input gradient is rounded to bf16
  (:class:`_Bf16Conv`); a Dense's weight gradient is rounded to bf16 in
  the text model's heads, not in the joint model's fusion head nor in the
  LSTM, whose scan sums it over the steps in f32 (read from the compiled
  program as it stands; :class:`_Bf16Linear`, ``Dense.round_weight_grad``);
- a head's logits reach the loss unrounded (XLA drops their round trip
  before cross-entropy's ``astype(f32)``) and their gradient is rounded to
  bf16 (:func:`train_logits`);
- an average pool's backward scales by the f32 reciprocal count, rounds to
  bf16 and sums the window back in bf16, tap by tap, as its forward does
  (:class:`_Bf16AvgPool`).

A batch-normed conv with a ReLU and no bias or scale (every one of the
tower's) runs in bf16 train mode as one autograd step,
:class:`_Bf16ConvBNReLU`, with those roundings at the same places: the
conv's f32 output goes to the batch norm's kernels (``ops/batch_norm``:
Triton on the card, their plain versions on the CPU), which sum its
statistics and write ``relu(bf16(x * inv + shift))`` in one more pass; the
backward recomputes the ReLU's mask from that output, sums the gradient's
statistics, and writes the normalisation path's and the statistics path's
gradients each rounded to bf16 and their sum rounded again, held in f32,
which is what the conv's backward takes: its own rounding of the incoming
gradient has nothing left to do and is not run.  :class:`SlimBatchNorm`,
:func:`round_grad` and :class:`_Bf16Conv` compute every other layer, and
every layer in f32 and in eval mode.

Under data parallelism each :class:`SlimBatchNorm` of the model is given
the process group (:func:`set_data_parallel`): its statistics are then
those of the global batch, as under the reference's pjit, through an
all-reduce that gradients flow back through; :class:`Dropout` draws its
mask for the global batch and keeps the process's rows.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tumblr_emotions_torch._device import tf32_convs
from tumblr_emotions_torch.ops import batch_norm as bn_ops
from tumblr_emotions_torch.parallel.distributed import all_reduce, all_reduce_


def set_data_parallel(model: nn.Module, group=None, rank: int = 0, world: int = 1) -> None:
    """Make ``model``'s batch norms reduce their statistics over ``group``
    (None: the local batch) and its dropouts draw for a global batch of
    ``world`` equal process batches, keeping rows ``[rank*b, (rank+1)*b)``."""
    for m in model.modules():
        if isinstance(m, SlimBatchNorm):
            m.group = group
        elif isinstance(m, Dropout):
            m.rank, m.world = rank, world


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 and held in f32."""
    return t.to(torch.bfloat16).float()


class _RoundGrad(torch.autograd.Function):
    """The identity, whose backward rounds the gradient to bf16: the VJP of
    a bf16 value's ``astype(f32)`` whose forward round trip XLA drops."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _bf16(g).to(g.dtype)


def round_grad(x: torch.Tensor) -> torch.Tensor:
    return _RoundGrad.apply(x)


def train_logits(pre: torch.Tensor, module: nn.Module) -> torch.Tensor:
    """A head's logits from its output before the last rounding (``pre``,
    f32): rounded to the model's dtype, except in bf16 train mode, where
    the loss reads them unrounded and rounds their gradient."""
    if module.training and module.dtype != torch.float32:
        return round_grad(pre)
    return pre.to(module.dtype)


class _Bf16Conv(torch.autograd.Function):
    """:func:`conv_f32_accumulate` of ``x`` (NHWC) and ``w`` (OIHW) rounded
    to bf16, f32 out, with the reference's backward: the incoming gradient
    rounded to bf16, the input gradient in ``x``'s dtype (rounded iff ``x``
    is bf16), the weight gradient in f32, unrounded (module docstring)."""

    @staticmethod
    def forward(ctx, x, w, strides, pad):
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        ctx.save_for_backward(xb, wb)
        ctx.conf = (tuple(strides), tuple(pad), x.dtype, w.dtype)
        return conv_f32_accumulate(xb, wb, strides, pad)

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        strides, pad, x_dtype, w_dtype = ctx.conf
        gx, gw = conv_f32_backward(_bf16(g), xb, wb, strides, pad,
                                   ctx.needs_input_grad[0], ctx.needs_input_grad[1])
        return (None if gx is None else gx.to(x_dtype),
                None if gw is None else gw.to(w_dtype), None, None)


def conv_f32_backward(g, xb, wb, strides, pad, need_x: bool, need_w: bool):
    """The input (NHWC) and weight (OIHW) gradients of
    :func:`conv_f32_accumulate` for the gradient ``g`` (NHWC, bf16 values),
    accumulated and returned in f32 (None where not needed); TF32 on the
    card, exact on bf16 values."""
    with tf32_convs():
        gx, gw, _ = torch.ops.aten.convolution_backward(
            to_nchw(g), to_nchw(xb.float()), wb.float(), None, strides, pad,
            (1, 1), False, (0, 0), 1, [need_x, need_w, False])
    return (None if gx is None else to_nhwc(gx)), gw


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of bf16 values held in f32, accumulated in f32."""
    return a @ b


class _Bf16Linear(torch.autograd.Function):
    """``x @ w^T`` of ``x`` and ``w`` rounded to bf16, accumulated and
    returned in f32, with the reference's backward: the incoming gradient
    rounded to bf16, the input gradient in ``x``'s dtype (rounded iff ``x``
    is bf16), the weight gradient in f32, rounded to bf16 iff
    ``round_weight_grad`` (module docstring)."""

    @staticmethod
    def forward(ctx, x, w, round_weight_grad):
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        ctx.save_for_backward(xb, wb)
        ctx.conf = (x.dtype, w.dtype, round_weight_grad)
        return matmul_f32(xb.float(), wb.float().t())

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        x_dtype, w_dtype, round_w = ctx.conf
        g = _bf16(g)
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = matmul_f32(g, wb.float()).to(x_dtype)
        if ctx.needs_input_grad[1]:
            gw = matmul_f32(g.reshape(-1, g.shape[-1]).t(),
                            xb.float().reshape(-1, xb.shape[-1]))
            gw = (_bf16(gw) if round_w else gw).to(w_dtype)
        return gx, gw, None


def bf16_linear(x: torch.Tensor, w: torch.Tensor, round_weight_grad: bool = True
                ) -> torch.Tensor:
    return _Bf16Linear.apply(x, w, round_weight_grad)


def linear_f64(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """``x @ w^T + b`` (``w`` [out, in]) summed in float64 and rounded once to
    f32.  A row's answer then does not depend on how many rows the call
    holds, as an f32 GEMM's does (cuBLAS picks its kernel, and so its
    summation order, by the row count), unless a float64 sum lies within
    its own error of an f32 rounding point: the served heads use it, so a
    batch split over devices is answered as the whole batch is."""
    return F.linear(x.double(), w.double(), None if b is None else b.double()).float()


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


def conv_f32_accumulate(x: torch.Tensor, w: torch.Tensor, strides=(1, 1),
                        padding=(0, 0)) -> torch.Tensor:
    """NHWC conv of bf16-valued operands (``x`` NHWC, ``w`` OIHW, any float
    dtype holding bf16 values) accumulated in f32 and returned unrounded in
    f32: the caller adds its bias and rounds once, as the JAX package's bf16
    convs do (``F.conv2d`` on bf16 would round the accumulator itself).  On
    the card cuDNN may run it in TF32, which is exact here: TF32 holds every
    bf16 value, and the tensor cores form the products exactly and
    accumulate in f32."""
    with tf32_convs():
        return to_nhwc(F.conv2d(to_nchw(x).float(), w.float(), stride=tuple(strides),
                                padding=tuple(padding)))


class SlimBatchNorm(nn.Module):
    """Batch norm with slim's names: ``beta`` (and ``gamma`` iff scale)
    parameters, ``moving_mean`` / ``moving_variance`` buffers.

    In train mode the mean and the biased variance over N, H, W (in f32)
    normalise the batch, and the buffers move to ``m * old + (1 - m) *
    batch`` with slim's decay ``m = momentum`` (0.9997).  Not
    ``nn.BatchNorm2d`` / ``F.batch_norm``: torch's default eps is 1e-5, and
    its running variance takes the unbiased estimate with the momentum
    counted the other way.  Gradients flow through the batch statistics,
    as ``jax.grad`` of the reference's expression does.

    With a process ``group`` (set by :func:`set_data_parallel`) the
    statistics are the global batch's: the mean from all-reduced sums, then
    the biased variance about it in a second pass, as ``jnp.mean`` and
    ``jnp.var`` compute them over an array sharded on the batch axis, both
    through an autograd all-reduce (``parallel.distributed.all_reduce``).  Not
    ``nn.SyncBatchNorm``, for the reasons above.  ``dtype`` bf16: the
    model's perf mode, whose backward rounds (module docstring).
    """

    def __init__(self, features: int, epsilon: float = 0.001,
                 scale: bool = False, momentum: float = 0.9997, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum
        self.dtype = dtype
        self.group = None
        self.beta = nn.Parameter(torch.zeros(features, device=device))
        self.gamma = (nn.Parameter(torch.ones(features, device=device))
                      if scale else None)
        self.register_buffer("moving_mean", torch.zeros(features, device=device))
        self.register_buffer("moving_variance", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.training:
            xs = x
            if self.dtype != torch.float32 and torch.is_grad_enabled():
                xs, x = round_grad(x), round_grad(x)
            mean, var = self.batch_moments(xs)
            with torch.no_grad():
                m = self.momentum
                self.moving_mean.copy_(m * self.moving_mean + (1.0 - m) * mean)
                self.moving_variance.copy_(m * self.moving_variance + (1.0 - m) * var)
        else:
            mean, var = self.moving_mean, self.moving_variance
        inv = torch.rsqrt(var + self.epsilon)
        if self.gamma is not None:
            inv = inv * self.gamma
        # y = (x - mean) * inv + beta, folded into one multiply-add.
        return x * inv + (self.beta - mean * inv)

    def batch_moments(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, biased variance) over every axis but the last, over the
        process group's global batch when there is one."""
        axes = tuple(range(x.ndim - 1))
        if self.group is None:
            var, mean = torch.var_mean(x, dim=axes, correction=0)
            return mean, var
        n = x.numel() // x.shape[-1] * torch.distributed.get_world_size(self.group)
        mean = all_reduce(x.sum(axes), group=self.group, kind="batch_norm") / n
        var = all_reduce(((x - mean) ** 2).sum(axes), group=self.group, kind="batch_norm") / n
        return mean, var


class Dropout(nn.Module):
    """flax ``nn.Dropout`` in train mode: each element is kept with
    probability ``keep_prob`` (``rand < keep_prob``, drawn from
    ``generator``, torch's default generator of the tensor's device when
    None) and scaled as :func:`dropout_scale` scales it; the others are 0.
    The identity in eval mode or when ``keep_prob >= 1``.  Under data
    parallelism (``world`` > 1) the mask is drawn for the global batch and
    rows ``[rank*b, (rank+1)*b)`` are kept, as the reference draws over the
    global array."""

    def __init__(self, keep_prob: float):
        super().__init__()
        self.keep_prob = keep_prob
        self.rank, self.world = 0, 1

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        if not self.training or self.keep_prob >= 1.0:
            return x
        b = x.shape[0]
        u = torch.rand((b * self.world,) + tuple(x.shape[1:]), generator=generator,
                       device=x.device)
        keep = u[self.rank * b:(self.rank + 1) * b] < self.keep_prob
        return torch.where(keep, dropout_scale(x, self.keep_prob),
                           torch.zeros((), dtype=x.dtype, device=x.device))


def dropout_scale(x: torch.Tensor, keep_prob: float) -> torch.Tensor:
    """flax's ``inputs / keep_prob`` as the reference's jitted step computes
    it.  XLA rewrites the division by the constant into a product with its
    f32 reciprocal (the compiled HLO on the CPU: ``multiply(x, 1.25)`` for
    0.8): in f32, ``x * (1 / f32(keep_prob))``; in bf16 (perf mode), where
    ``keep_prob`` is weakly typed to bf16 (0.8 -> 0.80078125), ``x`` is
    widened to f32, multiplied by ``1 / f32(bf16(keep_prob))`` and the
    product rounded once to bf16.  A product of two f32 values rounds the
    same on the card and on the CPU (a division by a Python float does not:
    the CPU divides, the card multiplies by the reciprocal)."""
    if x.dtype == torch.bfloat16:
        kp = np.float32(torch.tensor(keep_prob, dtype=torch.bfloat16).float())
        return (x.float() * float(np.float32(1) / kp)).to(torch.bfloat16)
    return x * float(np.float32(1) / np.float32(keep_prob))


class ConvBN(nn.Module):
    """slim.conv2d on NHWC input: conv (OIHW ``weights``) [+ ``biases``]
    [-> SlimBatchNorm] [-> ReLU]."""

    def __init__(self, in_features: int, features: int,
                 kernel: Tuple[int, int], strides: Tuple[int, int] = (1, 1),
                 padding: str = "SAME", use_bn: bool = True,
                 use_bias: bool = False, relu: bool = True,
                 bn_epsilon: float = 0.001, bn_scale: bool = False,
                 bn_momentum: float = 0.9997, dtype=torch.float32, device=None):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
        self.strides = tuple(strides)
        self.pad = same_padding(kernel, strides) if padding == "SAME" else (0, 0)
        self.relu = relu
        self.dtype = dtype
        self.weights = nn.Parameter(
            torch.zeros(features, in_features, *kernel, device=device))
        self.biases = (nn.Parameter(torch.zeros(features, device=device))
                       if use_bias else None)
        self.BatchNorm: Optional[SlimBatchNorm] = (
            SlimBatchNorm(features, bn_epsilon, bn_scale, bn_momentum, dtype=dtype,
                          device=device)
            if use_bn else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bn = self.BatchNorm
        if (self.dtype == torch.bfloat16 and bn is not None and bn.training
                and bn.gamma is None and self.biases is None and self.relu):
            return _Bf16ConvBNReLU.apply(x, self.weights, bn.beta, bn, self.strides, self.pad)
        y = self.unrounded(x).to(self.dtype)
        return torch.relu(y) if self.relu else y

    def unrounded(self, x: torch.Tensor) -> torch.Tensor:
        """The layer before its ReLU and its last rounding to ``dtype``
        (f32): a head's softmax reads its logits so in the jitted
        reference."""
        d = self.dtype
        if d == torch.float32:
            y = to_nhwc(F.conv2d(to_nchw(x.float()), self.weights, stride=self.strides,
                                 padding=self.pad))
        else:
            y = _Bf16Conv.apply(x, self.weights, self.strides, self.pad)
            if self.BatchNorm is None:
                y = y.to(d).float()
        if self.biases is not None:
            y = y + self.biases.to(d).float()
        if self.BatchNorm is not None:
            y = self.BatchNorm(y)
        return y


class _Bf16ConvBNReLU(torch.autograd.Function):
    """:class:`ConvBN` in bf16 train mode (conv, batch norm with the batch's
    statistics and no scale, rounding to bf16, ReLU) as one step: the conv
    as :class:`_Bf16Conv` runs it, the batch norm's passes in the kernels of
    ``ops/batch_norm`` (Triton on the card, their plain versions on the
    CPU), the per-channel arithmetic in PyTorch as :class:`SlimBatchNorm`
    does it.  The same roundings as the unfused layers (module docstring):
    the norm's output rounded once; in the backward the ReLU's mask from
    that output, the gradient's normalisation path and statistics path each
    rounded to bf16 and their sum rounded, which is the conv's incoming
    gradient as it is.  With a process group, the statistics' two sums and
    the backward's two sums are all-reduced, four all-reduces a layer as
    :class:`SlimBatchNorm`'s autograd all-reduces make.  ``conv_f32_accumulate``
    and ``conv_f32_backward`` are looked up when called, so
    ``train/noise_floor.float64_accumulation`` swaps them here too."""

    @staticmethod
    def forward(ctx, x, w, beta, bn, strides, pad):
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        y = conv_f32_accumulate(xb, wb, strides, pad)
        rows, group = y.view(-1, y.shape[-1]), bn.group
        n = rows.shape[0] * (1 if group is None else torch.distributed.get_world_size(group))
        # the mean, then the centred squares' sums about it, each summed
        # over the group's global batch as SlimBatchNorm.batch_moments sums
        s = bn_ops.sums(rows)
        if group is not None:
            all_reduce_(s, group, kind="batch_norm")
        mean = s / n
        q = bn_ops.sums(rows, mean)
        if group is not None:
            all_reduce_(q, group, kind="batch_norm")
        var = q / n
        m = bn.momentum
        bn.moving_mean.copy_(m * bn.moving_mean + (1.0 - m) * mean)
        bn.moving_variance.copy_(m * bn.moving_variance + (1.0 - m) * var)
        inv = torch.rsqrt(var + bn.epsilon)
        shift = beta - mean * inv
        ctx.save_for_backward(xb, wb, y, mean, inv, shift)
        ctx.conf = (tuple(strides), tuple(pad), x.dtype, w.dtype, group, n)
        return bn_ops.normalize(rows, inv, shift).view(y.shape)

    @staticmethod
    def backward(ctx, g):
        xb, wb, y, mean, inv, shift = ctx.saved_tensors
        strides, pad, x_dtype, w_dtype, group, n = ctx.conf
        rows, g = y.view(-1, y.shape[-1]), bn_ops.as_rows(g)
        C = rows.shape[1]
        s = bn_ops.grad_sums(g, rows, inv, shift, mean)
        dbeta = s[:C]
        if group is not None:
            dbeta = dbeta.clone()        # beta's own gradient is the process's
            all_reduce_(s[:C], group, kind="batch_norm")
            all_reduce_(s[C:], group, kind="batch_norm")
        c1 = -(inv * s[:C]) / n
        c2 = -(inv * inv * inv * s[C:]) / n
        gy = bn_ops.grad(g, rows, inv, shift, mean, c1, c2).view(y.shape)
        gx, gw = conv_f32_backward(gy, xb, wb, strides, pad,
                                   ctx.needs_input_grad[0], ctx.needs_input_grad[1])
        return (None if gx is None else gx.to(x_dtype),
                None if gw is None else gw.to(w_dtype),
                dbeta if ctx.needs_input_grad[2] else None, None, None, None)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel^T + bias``, with ``kernel`` held
    [out, in] (``convert.py`` transposes flax's [in, out]).  In bf16 the
    input, kernel and bias are cast to bf16, the product is accumulated in
    f32 and rounded, and the bias is added in bf16; in train mode the
    kernel's gradient is rounded to bf16 iff ``round_weight_grad``."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype=torch.float32, device=None, round_weight_grad: bool = True):
        super().__init__()
        self.dtype = dtype
        self.round_weight_grad = round_weight_grad
        self.kernel = nn.Parameter(torch.zeros(features, in_features, device=device))
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if use_bias else None)

    def forward(self, x: torch.Tensor, exact: bool = False) -> torch.Tensor:
        return self.unrounded(x, exact).to(self.dtype)

    def unrounded(self, x: torch.Tensor, exact: bool = False) -> torch.Tensor:
        """The output before its last rounding to ``dtype`` (f32), as a
        head's softmax reads it in the jitted reference.  ``exact``: the
        product summed in float64 (:func:`linear_f64`), the served heads' form."""
        d = self.dtype
        if d == torch.float32:
            return linear_f64(x, self.kernel, self.bias) if exact else \
                F.linear(x, self.kernel, self.bias)
        y = (linear_f64(x.to(d), self.kernel.to(d)) if exact else
             bf16_linear(x, self.kernel, self.round_weight_grad)).to(d).float()
        return y if self.bias is None else y + self.bias.to(d).float()


def max_pool(x: torch.Tensor, window: Tuple[int, int],
             strides: Tuple[int, int]) -> torch.Tensor:
    """VALID max pool on NHWC."""
    return to_nhwc(F.max_pool2d(to_nchw(x), window, strides))


def avg_pool(x: torch.Tensor, window: Tuple[int, int], strides: Tuple[int, int],
             padding: str = "SAME") -> torch.Tensor:
    """Average pool on NHWC dividing by the in-image taps only, as TF's
    AvgPool does (``count_include_pad=False``).  A bf16 input is summed in
    bf16, one tap at a time in row-major window order (XLA's reduce_window
    on a bf16 operand), and the sum multiplied by the f32 reciprocal of the
    count (the jitted program folds flax's divide by the constant count so):
    the result is f32, as flax's ``avg_pool`` returns it."""
    pad = same_padding(window, strides) if padding == "SAME" else (0, 0)
    if x.dtype == torch.bfloat16:
        return _avg_pool_bf16(x, window, strides, pad)
    if pad != (0, 0):
        return to_nhwc(_SameAvgPool.apply(to_nchw(x), tuple(window), pad))
    return to_nhwc(F.avg_pool2d(to_nchw(x), window, strides, count_include_pad=False))


def _window_counts(x: torch.Tensor, window, pad) -> torch.Tensor:
    """[1,1,H,W]: the in-image taps of each stride-1 window."""
    ones = torch.ones(1, 1, x.shape[-2], x.shape[-1], dtype=x.dtype, device=x.device)
    return F.avg_pool2d(ones, window, 1, padding=pad, divisor_override=1)


class _SameAvgPool(torch.autograd.Function):
    """The SAME (stride 1, padded) ``count_include_pad=False`` average pool
    of an NCHW tensor, with its backward written out as the exact adjoint:
    ``grad / count``, summed back over each window with forward pool
    kernels.  PyTorch's own CUDA backward of this pool on a channels-last
    tensor divides by the wrong count (torch 2.11 on an H100: gradients
    off by ~100%, the forward exact), which training reaches through every
    Inception block's pool branch."""

    @staticmethod
    def forward(ctx, x, window, pad):
        ctx.window, ctx.pad = window, pad
        return F.avg_pool2d(x, window, 1, padding=pad, count_include_pad=False)

    @staticmethod
    def backward(ctx, grad):
        g = grad / _window_counts(grad, ctx.window, ctx.pad)
        return F.avg_pool2d(g, ctx.window, 1, padding=ctx.pad, divisor_override=1), None, None


class _Bf16AvgPool(torch.autograd.Function):
    """flax's ``avg_pool`` of a bf16 NHWC input as the jitted reference
    computes it: the window summed in bf16, one tap at a time in row-major
    order, times the f32 reciprocal of the in-image count, f32 out.  The
    backward is its adjoint in the same precision: the gradient times the
    reciprocal count rounded to bf16, then each tap's share added back in
    bf16, tap by tap."""

    @staticmethod
    def forward(ctx, x, window, strides, pad):
        (kh, kw), (sh, sw), (ph, pw) = window, strides, pad
        xp = F.pad(x, (0, 0, pw, pw, ph, ph))
        ho = (xp.shape[1] - kh) // sh + 1
        wo = (xp.shape[2] - kw) // sw + 1
        acc = torch.zeros(x.shape[0], ho, wo, x.shape[3], dtype=x.dtype, device=x.device)
        for i, j in _taps(window):
            acc = acc + xp[:, i:i + sh * (ho - 1) + 1:sh, j:j + sw * (wo - 1) + 1:sw]
        ones = torch.ones(1, 1, x.shape[1], x.shape[2], device=x.device)
        recip = 1.0 / to_nhwc(F.avg_pool2d(ones, window, strides, padding=pad,
                                           divisor_override=1))
        ctx.conf = (window, strides, pad, tuple(xp.shape))
        ctx.save_for_backward(recip)
        return acc.float() * recip

    @staticmethod
    def backward(ctx, g):
        (recip,) = ctx.saved_tensors
        (kh, kw), (sh, sw), (ph, pw), shape = ctx.conf
        gs = (g * recip).to(torch.bfloat16)
        ho, wo = gs.shape[1], gs.shape[2]
        gp = torch.zeros(shape, dtype=torch.bfloat16, device=g.device)
        for i, j in _taps((kh, kw)):
            gp[:, i:i + sh * (ho - 1) + 1:sh, j:j + sw * (wo - 1) + 1:sw] += gs
        return gp[:, ph:shape[1] - ph, pw:shape[2] - pw], None, None, None


def _taps(window):
    return [(i, j) for i in range(window[0]) for j in range(window[1])]


def _avg_pool_bf16(x, window, strides, pad):
    return _Bf16AvgPool.apply(x, tuple(window), tuple(strides), tuple(pad))
