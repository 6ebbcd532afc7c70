"""Seeded weights of the joint model, made on the card in a few large calls.

He-scaled conv kernels (std sqrt(2/fan_in), sqrt(1/fan_in) for the heads
without ReLU), dense kernels N(0, 1/fan_in), embeddings, biases, betas and
BN moving means N(0, 0.1), moving variances U(0.5, 1.5): each BN-folded
ReLU conv then keeps its activations near unit scale through the
full-width tower, and batch-norm folding sees non-trivial statistics.
The same seed gives the same values on the same device.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from benchmark.reference.model import param_shapes


def _std(shape: Tuple[int, ...], kind: str) -> float:
    if kind in ("conv_relu", "conv_head"):
        fan_in = math.prod(shape[1:])
        return math.sqrt((2.0 if kind == "conv_relu" else 1.0) / fan_in)
    if kind == "dense":
        return math.sqrt(1.0 / shape[1])
    return 0.1


def make(seed: int, device, **sizes) -> Dict[str, torch.Tensor]:
    """{state key: float32 tensor on ``device``} for ``param_shapes(**sizes)``."""
    shapes = param_shapes(**sizes)
    g = torch.Generator(device=device).manual_seed(seed)
    normal = [(k, s, kind) for k, (s, kind) in shapes.items() if kind != "var"]
    var = [(k, s) for k, (s, kind) in shapes.items() if kind == "var"]
    counts = [math.prod(s) for _, s, _ in normal]
    z = torch.randn(sum(counts), generator=g, device=device)
    std = torch.tensor([_std(s, kind) for _, s, kind in normal], device=device)
    z.mul_(torch.repeat_interleave(std, torch.tensor(counts, device=device)))
    u = torch.rand(sum(math.prod(s) for _, s in var), generator=g, device=device).add_(0.5)
    out = {}
    for (k, s, _), part in zip(normal, z.split(counts)):
        out[k] = part.view(s)
    for (k, s), part in zip(var, u.split([math.prod(s) for _, s in var])):
        out[k] = part.view(s)
    return {k: out[k] for k in shapes}
