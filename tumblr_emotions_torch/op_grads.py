"""Each op of the train-mode tower, forward and backward, on the card
against the CPU.

    python -m tumblr_emotions_torch.op_grads

Runs every kind of op the Inception-v3 tower's train step takes (its
average pools, PyTorch's own padded average pool beside the port's, the
max pool, f32 convs of 576 and 2,048 terms, train-mode batch norm) on the
same seeded inputs and output gradients on the card and on the CPU, TF32
off, and prints one JSON line per op: max|card - cpu| / max|cpu| of the
output and of each input's gradient.  The train step's noise floor
(``chip_smoke.TRAIN_NOISE_EPS``) rests on the convs' rounding, and the
port's own SAME-pool backward (``models/layers._SameAvgPool``) on the line
for PyTorch's.  Needs a CUDA card; raises without one.
"""

from __future__ import annotations

import json

import torch
import torch.nn.functional as F

from tumblr_emotions_torch._device import card_line, full_f32, resolve_device
from tumblr_emotions_torch.models.layers import SlimBatchNorm, avg_pool, max_pool, to_nchw


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.cpu().double() - b.double()).abs().max() / b.double().abs().max()).item()


def compare(fn, shapes, dev, nonneg=False) -> dict:
    """``fn`` on seeded inputs of ``shapes`` on ``dev`` and on the CPU."""
    g = torch.Generator().manual_seed(0)
    xs = [torch.randn(*s, generator=g) for s in shapes]
    if nonneg:
        xs = [x.relu() for x in xs]
    out = {}
    for where in ("cpu", dev):
        ins = [x.to(where).requires_grad_(True) for x in xs]
        with full_f32():
            y = fn(*ins)
            dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(1)).to(where)
            grads = torch.autograd.grad(y, ins, dy)
        out[str(where)] = (y.detach().cpu(), [gi.cpu() for gi in grads])
    (y_dev, g_dev), (y_cpu, g_cpu) = out[str(dev)], out["cpu"]
    return {"forward": _rel(y_dev, y_cpu), "grads": [_rel(a, b) for a, b in zip(g_dev, g_cpu)]}


def _bn(x, beta):
    bn = SlimBatchNorm(x.shape[-1], device=x.device)
    bn.train()
    c = x.shape[-1]
    return torch.func.functional_call(bn, {"beta": beta,
                                           "moving_mean": torch.zeros(c, device=x.device),
                                           "moving_variance": torch.ones(c, device=x.device)},
                                      (x,))


def _conv(pad):
    def conv(x, w):
        return F.conv2d(x.permute(0, 3, 1, 2), w, padding=pad).permute(0, 2, 3, 1).contiguous()
    return conv


OPS = {
    # PyTorch's own padded pool on a channels-last view, as the tower fed it
    "torch avg_pool2d 3x3/1 SAME, count_include_pad=False": (
        lambda x: F.avg_pool2d(to_nchw(x), 3, 1, 1, count_include_pad=False),
        [(4, 17, 17, 64)], True),
    "port avg_pool 3x3/1 SAME (_SameAvgPool)": (
        lambda x: avg_pool(x, (3, 3), (1, 1)), [(4, 17, 17, 64)], True),
    "port avg_pool 5x5/3 VALID": (
        lambda x: avg_pool(x, (5, 5), (3, 3), padding="VALID"), [(4, 17, 17, 64)], True),
    "port avg_pool 8x8 VALID": (
        lambda x: avg_pool(x, (8, 8), (1, 1), padding="VALID"), [(4, 8, 8, 64)], True),
    "max_pool 3x3/2": (lambda x: max_pool(x, (3, 3), (2, 2)), [(4, 35, 35, 64)], False),
    "conv 3x3, 576 terms": (_conv(1), [(4, 17, 17, 64), (96, 64, 3, 3)], False),
    "conv 1x7, 448 terms": (_conv((0, 3)), [(4, 17, 17, 64), (96, 64, 1, 7)], False),
    "conv 1x1, 2048 terms": (_conv(0), [(4, 8, 8, 2048), (320, 2048, 1, 1)], False),
    "batch norm, train mode": (_bn, [(4, 8, 8, 64), (64,)], False),
}


def main() -> None:
    dev = resolve_device("cuda")
    card = card_line()
    for name, (fn, shapes, nonneg) in OPS.items():
        print(json.dumps({"op": name, "shapes": shapes, "card": card,
                          **compare(fn, shapes, dev, nonneg)}), flush=True)


if __name__ == "__main__":
    main()
