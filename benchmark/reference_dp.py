"""The float32 reference over a data-parallel cell's global batch, and the
scale on which its comparison reads each leaf's gradient.

The reference is ``benchmark/reference/`` as it stands, run through
``drivers/train_steps.reference_steps``: one process on one card over the
global batch (every process's rows of a step, in rank order).  At 512 rows
of 299 px its autograd graph would not fit on an 80 GB card, so each conv
layer of the tower in train mode (conv, batch norm over the batch, ReLU) is
recomputed in the backward (``torch.utils.checkpoint``, non-reentrant): the
forward keeps each layer's input, not its intermediates.  Recomputation
repeats the same operations on the same values.

The scale (``terms``): a conv layer's gradients are sums over the batch and
the positions.  ``beta`` receives the loss's derivative before the ReLU
summed over them; the conv's ``weights`` receive, per element, the products
of an input tap and the derivative at the conv's output.  Where a
train-mode batch norm follows (every ``beta``: the next layer's norm takes
out the terms' mean, and a 1x1 conv passes that through exactly), and over
inputs that vary slowly (the first convs' weights over smooth images), the
terms nearly cancel: the sum is tens to a thousand times smaller than the
sum of their magnitudes.  A step in another precision rounds every term,
and its sum moves by that rounding times the terms' magnitudes, so the
float32 sum is no scale for it.  In the first step's backward ``terms``
records, for every conv layer, the sum of its terms' magnitudes per element
(float64): ``|d before ReLU|`` for ``beta`` and the weight gradient of
``|input|`` and ``|d at the conv's output|`` for ``weights``.
"""

from __future__ import annotations

import types
from typing import Dict, Optional
from unittest import mock

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.drivers import train_steps
from benchmark.reference import model


class _BetaTerms(torch.autograd.Function):
    """The identity on a ReLU's output, whose backward adds the magnitude of
    the derivative before the ReLU (the incoming one where the output is
    positive), summed over every axis but the channels, to ``into[key]``."""

    @staticmethod
    def forward(ctx, y, key, into):
        ctx.key, ctx.into = key, into
        ctx.save_for_backward(y > 0)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        (on,) = ctx.saved_tensors
        _add(ctx.into, ctx.key, (g.double().abs() * on).sum((0, 2, 3)))
        return g, None, None


class _WeightTerms(torch.autograd.Function):
    """The identity on a conv's output ``y = conv(x, w)``, whose backward
    adds the weight gradient of ``|x|`` and ``|g|`` (each element's terms'
    magnitudes) to ``into[key]``."""

    @staticmethod
    def forward(ctx, y, x, w, stride, padding, key, into):
        ctx.conf, ctx.key, ctx.into = (stride, padding), key, into
        ctx.save_for_backward(x, w)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding = ctx.conf
        s = (stride, stride) if isinstance(stride, int) else tuple(stride)
        _, gw, _ = torch.ops.aten.convolution_backward(
            g.abs(), x.abs(), w, None, s, tuple(padding), (1, 1), False, (0, 0), 1,
            [False, True, False])
        _add(ctx.into, ctx.key, gw.double())
        return g, None, None, None, None, None, None


def _add(into: Dict[str, torch.Tensor], key: str, t: torch.Tensor) -> None:
    into[key] = into[key] + t if key in into else t


class Recomputed(model.Tower):
    """The reference's tower, each train-mode conv layer recomputed in the
    backward; while ``terms`` is set (a dict), every conv layer's terms are
    recorded into it."""

    terms: Optional[Dict[str, torch.Tensor]] = None
    weights: Dict[int, str] = {}      # id of a weights tensor -> its key

    def conv(self, x, scope, cout, k, stride=1, padding="SAME", head=False):
        if Recomputed.terms is not None and self.params is not None:
            key = f"{self.prefix}{scope}.weights"
            Recomputed.weights[id(self.params[key])] = key
        if head or not self.train or not torch.is_grad_enabled():
            return super().conv(x, scope, cout, k, stride, padding, head)
        y = checkpoint(super().conv, x, scope, cout, k, stride, padding, head,
                       use_reentrant=False)
        if Recomputed.terms is not None:
            y = _BetaTerms.apply(y, f"{self.prefix}{scope}.BatchNorm.beta", Recomputed.terms)
        return y


def _conv2d(x, w, bias=None, stride=1, padding=0, **kw):
    y = F.conv2d(x, w, bias, stride=stride, padding=padding, **kw)
    key = Recomputed.weights.get(id(w))
    if Recomputed.terms is None or key is None or not torch.is_grad_enabled():
        return y
    return _WeightTerms.apply(y, x, w, stride, padding, key, Recomputed.terms)


class _Functional(types.ModuleType):
    """``torch.nn.functional`` with ``conv2d`` recording the weights' terms."""

    conv2d = staticmethod(_conv2d)

    def __getattr__(self, name):
        return getattr(F, name)


def reference_steps(ctx, pool, **kw) -> Dict:
    """``train_steps.reference_steps`` over ``pool`` (global batches) with
    the tower recomputed; the result has ``terms``: per conv layer's
    ``beta`` and ``weights`` leaf, the first step's sum of its terms'
    magnitudes per element (on the host)."""
    recorded: Dict[str, torch.Tensor] = {}
    real = model.joint_forward
    calls = []

    def first_step_records(*args, **kwargs):
        Recomputed.terms = recorded if not calls else None
        calls.append(1)
        return real(*args, **kwargs)

    try:
        with mock.patch.object(model, "Tower", Recomputed), \
                mock.patch.object(model, "F", _Functional("functional")), \
                mock.patch.object(model, "joint_forward", first_step_records):
            out = train_steps.reference_steps(ctx, pool, **kw)
    finally:
        Recomputed.terms = None
        Recomputed.weights = {}
    out["terms"] = {k: v.cpu() for k, v in recorded.items()}
    return out
