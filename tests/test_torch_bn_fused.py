"""The bf16 train-mode conv -> batch norm -> ReLU as one autograd step
(``models/layers._Bf16ConvBNReLU``, the batch norm's passes in
``ops/batch_norm``) against the unfused chain it replaces, on the CPU,
where the kernels' plain versions run.

The unfused chain (:func:`_unfused`, a copy of ``_Bf16Conv`` ->
``SlimBatchNorm`` (train mode) -> ``.to(bf16)`` -> ``relu`` as they computed
the bf16 train step before it was fused) runs under autograd.  Both compute the
same roundings; they sum in other orders (the fused statistics take two
passes, ``SlimBatchNorm`` one ``var_mean`` without a group; the backward's
statistics term is one formula, not autograd's chain through ``rsqrt`` and
``var_mean``), so an f32 value may round to the other bf16 neighbour.
Measured over seeds 0-7 and the three :data:`CASES` (8 x 17 x 17 x 32 ->
48): outputs differ at 0-8.1e-5 of the elements, the conv's incoming
gradient at 4.1e-5-2.9e-4, a bf16 input's gradient at 0-9.5e-5 (an f32
input's, unrounded, at 0.7-2.1%); the input gradient by 0-2.1e-5 of its
norm and the weight gradient by 7e-9-3.0e-6 of its; the statistics by
5.8e-8-2.1e-7 (relative); ``beta``'s gradient not at all.  Each limit below
is about ten times its largest reading.  Dropping one bf16 rounding of the
backward's two paths moves most of the incoming gradient's elements.
"""

from __future__ import annotations

import copy
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tumblr_emotions_torch import get_preset  # noqa: E402
from tumblr_emotions_torch.models import build_model, layers  # noqa: E402
from tumblr_emotions_torch.ops import batch_norm as bn_ops  # noqa: E402

SEEDS = range(8)
OUT_SHARE = 8e-4        # outputs that differ (measured at most 8.1e-5)
GY_SHARE = 3e-3         # the conv's incoming gradient (2.9e-4)
GX_SHARE = 1e-3         # a bf16 input's gradient (9.5e-5)
GX_NORM = 2e-4          # the input gradient's difference over its norm (2.1e-5)
GW_NORM = 3e-5          # the weight gradient's (3.0e-6)
STATS_REL = 2e-6        # mean (of its largest) and variance (each) (2.1e-7)


def _case(seed, cin=32, cout=48, hw=17, n=8, kernel=(3, 3), strides=(1, 1),
          padding="SAME", x_dtype=torch.bfloat16):
    """A bf16 ConvBN in train mode whose moving averages take the batch's
    statistics whole (momentum 0), its input (a ReLU's output) and the
    gradient of its output."""
    rng = np.random.default_rng(seed)
    m = layers.ConvBN(cin, cout, kernel, strides, padding, dtype=torch.bfloat16).train()
    fan_in = cin * kernel[0] * kernel[1]
    with torch.no_grad():
        m.weights.copy_(torch.from_numpy(
            rng.normal(0, fan_in ** -0.5, m.weights.shape).astype(np.float32)))
        m.BatchNorm.beta.copy_(torch.from_numpy(rng.normal(0, 0.1, cout).astype(np.float32)))
    m.BatchNorm.momentum = 0.0
    x = torch.from_numpy(np.maximum(rng.normal(0, 1, (n, hw, hw, cin)), 0).astype(np.float32))
    out_hw = hw if padding == "SAME" else (hw - kernel[0]) // strides[0] + 1
    g = rng.normal(0, 1e-3, (n, out_hw, out_hw, cout)).astype(np.float32)
    return m, x.to(x_dtype), torch.from_numpy(g).to(torch.bfloat16)


def _bf16(t):
    return t.to(torch.bfloat16).float()


class _RoundGrad(torch.autograd.Function):
    """The identity; its backward rounds the gradient to bf16."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _bf16(g).to(g.dtype)


class _Conv(torch.autograd.Function):
    """The bf16 conv accumulated in f32; its backward rounds the incoming
    gradient to bf16 and returns the input gradient in ``x``'s dtype and the
    weight gradient in f32."""

    @staticmethod
    def forward(ctx, x, w, strides, pad):
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        ctx.save_for_backward(xb, wb)
        ctx.conf = (strides, pad, x.dtype)
        return layers.conv_f32_accumulate(xb, wb, strides, pad)

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        strides, pad, x_dtype = ctx.conf
        gx, gw = layers.conv_f32_backward(_bf16(g), xb, wb, strides, pad,
                                          ctx.needs_input_grad[0], ctx.needs_input_grad[1])
        return (None if gx is None else gx.to(x_dtype), gw, None, None)


def _unfused(m, x):
    """The unfused chain, kept here as it stood before the fused step and
    independent of the layers that now compute it: the conv, then the batch
    norm in train mode with both of its reads of the conv's output rounding
    their gradients, ``var_mean``'s statistics, the moving averages,
    ``x * inv + (beta - mean * inv)``, the rounding to bf16 and the ReLU, all
    under autograd.  Only the conv's f32 primitives are the layers' own."""
    y = _Conv.apply(x, m.weights, m.strides, m.pad)
    bn = m.BatchNorm
    ys, y = _RoundGrad.apply(y), _RoundGrad.apply(y)
    var, mean = torch.var_mean(ys, dim=(0, 1, 2), correction=0)
    with torch.no_grad():
        bn.moving_mean.copy_(bn.momentum * bn.moving_mean + (1.0 - bn.momentum) * mean)
        bn.moving_variance.copy_(bn.momentum * bn.moving_variance
                                 + (1.0 - bn.momentum) * var)
    inv = torch.rsqrt(var + bn.epsilon)
    return torch.relu((y * inv + (bn.beta - mean * inv)).to(torch.bfloat16))


def _run(m, x, g, fused):
    """Output, input, weight and beta gradients, the gradient the conv's
    backward was given, and the moving mean and variance after the step."""
    m = copy.deepcopy(m)
    given = []
    real = layers.conv_f32_backward

    def conv_backward(gy, *args):
        given.append(gy.clone())
        return real(gy, *args)

    x = x.clone().requires_grad_(True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, "conv_f32_backward", conv_backward)
        out = m(x) if fused else _unfused(m, x)
        out.backward(g)
    bn = m.BatchNorm
    return dict(out=out.detach(), gx=x.grad, gw=m.weights.grad, dbeta=bn.beta.grad,
                gy=given[0], mean=bn.moving_mean.clone(), var=bn.moving_variance.clone())


def _share(a, b):
    return (a != b).float().mean().item()


CASES = {
    "3x3": {},
    "stride2_valid": dict(kernel=(3, 3), strides=(2, 2), padding="VALID"),
    "1x7_f32_input": dict(kernel=(1, 7), x_dtype=torch.float32),   # the aux head's avg pool
}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", list(CASES))
def test_fused_step_is_the_unfused_chain_within_rounding_flips(case, seed):
    m, x, g = _case(seed, **CASES[case])
    got, want = _run(m, x, g, True), _run(m, x, g, False)
    assert got["out"].dtype == torch.bfloat16 and got["gx"].dtype == x.dtype
    assert got["gw"].dtype == torch.float32
    assert (got["mean"] - want["mean"]).abs().max() <= STATS_REL * want["mean"].abs().max()
    assert ((got["var"] - want["var"]).abs() <= STATS_REL * want["var"]).all()
    assert _share(got["out"], want["out"]) <= OUT_SHARE
    assert _share(got["gy"], want["gy"]) <= GY_SHARE
    assert torch.equal(got["gy"], got["gy"].to(torch.bfloat16).float())   # bf16 values
    assert (got["gx"] - want["gx"]).norm() <= GX_NORM * want["gx"].norm()
    if x.dtype == torch.bfloat16:
        assert _share(got["gx"], want["gx"]) <= GX_SHARE
    assert (got["gw"] - want["gw"]).norm() <= GW_NORM * want["gw"].norm()
    assert torch.equal(got["dbeta"], want["dbeta"])


@pytest.mark.parametrize("seed", SEEDS)
def test_normalisation_is_the_unfused_chains_bit_for_bit_given_its_statistics(seed):
    m, x, _ = _case(seed)
    y = _Conv.apply(x, m.weights, m.strides, m.pad).detach()
    with torch.no_grad():
        want = _unfused(m, x)
    var, mean = torch.var_mean(y, dim=(0, 1, 2), correction=0)
    inv = torch.rsqrt(var + m.BatchNorm.epsilon)
    got = bn_ops.normalize(bn_ops.as_rows(y), inv, m.BatchNorm.beta.detach() - mean * inv)
    assert torch.equal(got.view(want.shape), want)


def _without_rounding(path):
    def grad(g, x, inv, shift, mean, c1, c2):
        a = bn_ops._masked(g, x, inv, shift) * inv
        b = c1 + c2 * (x - mean)
        return bn_ops._bf16((a if path == "norm" else bn_ops._bf16(a))
                            + (b if path == "stats" else bn_ops._bf16(b)))
    return grad


@pytest.mark.parametrize("path", ["norm", "stats"])
def test_dropping_a_backward_rounding_is_caught(monkeypatch, path):
    """The limits see a missing rounding: without the bf16 rounding of the
    normalisation's or the statistics' path (seed 0: 13% and 1.8% of the
    conv's incoming gradient move) the share is over its limit."""
    m, x, g = _case(0)
    want = _run(m, x, g, False)
    monkeypatch.setattr(bn_ops, "grad", _without_rounding(path))
    assert _share(_run(m, x, g, True)["gy"], want["gy"]) > 5 * GY_SHARE


def test_gradient_rows_of_a_channel_slice_are_a_view():
    cat = torch.randn(2, 5, 5, 24).to(torch.bfloat16)
    part = cat[..., 8:16]
    rows = bn_ops.as_rows(part)
    assert rows.data_ptr() == part.data_ptr() and rows.stride() == (24, 1)
    assert torch.equal(rows, part.reshape(-1, 8))
    odd = torch.randn(2, 5, 5, 8).permute(0, 2, 1, 3)   # pixels out of row order: a copy
    assert torch.equal(bn_ops.as_rows(odd), odd.reshape(-1, 8))


def _tower(precision):
    cfg = get_preset("data_parallel")
    cfg = cfg.replace(image=cfg.image.replace(depth_multiplier=0.25, image_size=139),
                      train=cfg.train.replace(precision_mode=precision))
    return build_model(cfg.replace(model="image"), device="cpu")


@pytest.mark.parametrize("precision,train,calls", [("perf", True, 96), ("perf", False, 0),
                                                   ("parity", True, 0)])
def test_every_batch_normed_conv_of_the_bf16_tower_runs_fused_in_train_mode(
        monkeypatch, precision, train, calls):
    model = _tower(precision).train(train)
    seen = []
    real = layers._Bf16ConvBNReLU.forward

    def forward(ctx, *args):
        seen.append(1)
        return real(ctx, *args)

    monkeypatch.setattr(layers._Bf16ConvBNReLU, "forward", staticmethod(forward))
    with torch.no_grad():
        model(torch.rand(2, 139, 139, 3))
    assert len(seen) == calls
    assert sum(1 for mod in model.modules()
               if isinstance(mod, layers.ConvBN) and mod.BatchNorm is not None) == 96


def _defined_kernels():
    src = (ROOT / "tumblr_emotions_torch" / "ops" / "batch_norm.py").read_text()
    return src, [m.group(1) for m in re.finditer(r"^def (\w+)\(\w*_ptr", src, re.MULTILINE)]


def test_kernel_names_stay_out_of_the_pass_and_nccl_patterns():
    """Read as text, Triton not imported: every kernel is named
    ``bn_bf16_*`` and matches neither ``bn_pass_ms``' PyTorch passes nor
    ``allreduce_ms.dp``'s NCCL pattern (the trace's case-insensitive
    search), and no kernel adds floats atomically."""
    from benchmark.cell import HERE, load_module

    passes = load_module(HERE / "metrics" / "bn_pass_ms.train.py").PASSES
    nccl = load_module(HERE / "metrics" / "allreduce_ms.dp.py").NCCL
    src, kernels = _defined_kernels()
    assert sorted(kernels) == sorted(bn_ops.KERNELS)
    for name in kernels:
        assert name.startswith("bn_bf16_")
        assert not any(re.search(p, name, re.IGNORECASE) for p in passes + nccl), name
    assert "tl.atomic" not in src
