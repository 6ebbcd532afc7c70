"""How far two correct runs of a train step fall apart, and holding one run
to another within that.

A bf16 step cannot be compared bit for bit: two correct runs that sum in
another order (the JAX package's XLA program and the port, the card and
the CPU) round some bf16 values the other way, and train-mode batch norm
over a few images amplifies each such flip through the tower, so most of
the tower's gradient at initialisation is this noise.  A run is therefore
held to its reference within ``factor`` times its floor: the distance
between the run it compares (``base``) and the same step perturbed
(``floors``: the bf16 layers' products accumulated in float64
(:func:`float64_accumulation`), inputs or weights moved by ~1e-6).

Where the floor is near 1 a distance cannot tell a correct update from
none at all, so :func:`hold` also holds, one by one, the leaves whose
floor is under ``SIGNAL_FLOOR`` (the heads, biases and embeddings, where
the signal dominates), and reports whether the same check would refuse a
no-op and a sign-flipped update; a caller asserts both.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from tumblr_emotions_torch.models import layers

SIGNAL_FLOOR = 0.1


@contextlib.contextmanager
def float64_accumulation():
    """The bf16 layers' convs and matmuls, forward and backward, accumulated
    in float64 and rounded to f32 after: the port's step under another f32
    summation order (on the card as on the CPU)."""
    saved = layers.conv_f32_accumulate, layers.conv_f32_backward, layers.matmul_f32

    def nchw64(t):
        return layers.to_nchw(t).double().contiguous()

    def conv(x, w, strides=(1, 1), padding=(0, 0)):
        return layers.to_nhwc(torch.nn.functional.conv2d(
            nchw64(x), w.double(), stride=tuple(strides), padding=tuple(padding))).float()

    def conv_backward(g, xb, wb, strides, pad, need_x, need_w):
        gx, gw, _ = torch.ops.aten.convolution_backward(
            nchw64(g), nchw64(xb), wb.double(), None, strides, pad, (1, 1), False, (0, 0), 1,
            [need_x, need_w, False])
        return (None if gx is None else layers.to_nhwc(gx).float(),
                None if gw is None else gw.float())

    layers.conv_f32_accumulate = conv
    layers.conv_f32_backward = conv_backward
    layers.matmul_f32 = lambda a, b: (a.double() @ b.double()).float()
    try:
        yield
    finally:
        layers.conv_f32_accumulate, layers.conv_f32_backward, layers.matmul_f32 = saved


def _f64(v) -> np.ndarray:
    if torch.is_tensor(v):
        v = v.detach().cpu().double().numpy()
    return np.asarray(v, np.float64)


def distance(a: Dict, a0: Optional[Dict], b: Dict, b0: Optional[Dict],
             keys: Iterable[str]) -> float:
    """``||(a - a0) - (b - b0)|| / ||b - b0||`` over ``keys`` (dicts of
    tensors or arrays; ``a0``/``b0`` None: zero, for gradients): how far
    update a is from update b."""
    num = den = 0.0
    for k in keys:
        da = _f64(a[k]) - (0.0 if a0 is None else _f64(a0[k]))
        db = _f64(b[k]) - (0.0 if b0 is None else _f64(b0[k]))
        num += float(((da - db) ** 2).sum())
        den += float((db ** 2).sum())
    return (num / max(den, 1e-300)) ** 0.5


def hold(got: Dict, want: Dict, base: Dict, floors: List[Dict], before: Optional[Dict],
         keys: Iterable[str], factor: float, atol: float, leaf_atol: float) -> Dict:
    """Holds update ``got - before`` to ``want - before`` (``before`` None:
    gradients) over ``keys``: the whole within ``factor`` x the mean floor
    + ``atol``, and each leaf whose floor is under ``SIGNAL_FLOOR`` within
    ``factor`` x its floor + ``leaf_atol``; the floors are the distances of
    ``floors`` to ``base``.  Returns the readings, ``ok``, and whether the
    same check refuses a no-op (``refuses_noop``) and a sign-flipped
    (``refuses_flip``) update."""
    keys = list(keys)
    floor = float(np.mean([distance(f, before, base, before, keys) for f in floors]))
    leaf_floor = {k: float(np.mean([distance(f, before, base, before, [k]) for f in floors]))
                  for k in keys}
    signal = [k for k in keys if leaf_floor[k] < SIGNAL_FLOOR]

    def check(run):
        whole = distance(run, before, want, before, keys)
        leaves = {k: distance(run, before, want, before, [k]) for k in signal}
        bad = [k for k in signal if leaves[k] > factor * leaf_floor[k] + leaf_atol]
        return whole, leaves, whole <= factor * floor + atol and not bad, bad

    whole, leaves, ok, bad = check(got)
    zero = {k: 0.0 if before is None else _f64(before[k]) for k in keys}
    flip = {k: -_f64(got[k]) if before is None else 2 * _f64(before[k]) - _f64(got[k])
            for k in keys}
    return {"to_ref": whole, "floor": floor, "limit": factor * floor + atol, "ok": ok,
            "signal_leaves": {k: (leaves[k], leaf_floor[k], factor * leaf_floor[k] + leaf_atol)
                              for k in signal},
            "failed_leaves": bad, "refuses_noop": not check(zero)[2],
            "refuses_flip": not check(flip)[2]}
