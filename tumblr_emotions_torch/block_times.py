"""Time the bf16 engine's block conv and blocks, to compare two checkouts in one call.

    python -m tumblr_emotions_torch.block_times [--batch 64]
    cd <older checkout> && PYTHONPATH=. python <this repo>/tumblr_emotions_torch/block_times.py

On seeded full-width weights (``FusedInceptionV3(state).taps``) and seeded
ReLU'd inputs at B=64: each of the 17 convs of Mixed_5b and Mixed_6b, and
the blocks Mixed_5b/5c/5d/6b/6c/6e, each timed from Python between CUDA
events (``ms``) and in CUDA graphs (``graph_ms``, device time); the pool
branch of Mixed_5b, 5d and 6b in device time, as the pooled form, its 1x1
conv alone and the separate pool kernel, whichever the checkout has.  A conv
runs through ``ConvOp`` (packed once) where the checkout has it, else
through ``conv_same_bias_relu``; a block through ``fused_inception_a/_b``.
Uses only that public API, so it also runs against an older checkout of the
package.  Prints one JSON line per conv and block, then the sums and the
card's name and power limit.  Checks nothing: ``chip_smoke.py`` holds the
kernels against their plain versions.  Needs a card.
"""

from __future__ import annotations

import argparse
import functools
import json

import torch

from tumblr_emotions_torch._device import card_line
from tumblr_emotions_torch.models.inception_v3 import InceptionV3, init_state
from tumblr_emotions_torch.ops import fused_inception as fi
from tumblr_emotions_torch.ops.inference import FusedInceptionV3
from tumblr_emotions_torch.timing import cuda_ms, graph_ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("block_times: needs a CUDA card")
    torch.set_grad_enabled(False)
    dev = torch.device("cuda", torch.cuda.current_device())
    eng = FusedInceptionV3(init_state(InceptionV3(device="meta"), args.seed), device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def act(*shape):
        return torch.relu(torch.randn(*shape, generator=gen, device=dev)).to(torch.bfloat16)

    sums = {"conv_ms": 0.0, "conv_graph_ms": 0.0, "block_ms": 0.0, "block_graph_ms": 0.0}
    for scope, hw, branches in (("Mixed_5b", 35, fi.inception_a_branches(False)),
                                ("Mixed_6b", 17, fi.INCEPTION_B_BRANCHES)):
        for _, chain in branches:
            for name, kernel in chain:
                w, b = eng.taps[f"{scope}/{name}"]
                x = act(args.batch, hw, hw, w.shape[1])
                if hasattr(fi, "ConvOp"):
                    fn = functools.partial(fi.ConvOp([(w, b)], kernel), x)
                else:
                    fn = functools.partial(fi.conv_same_bias_relu, x, w, b, kernel)
                ms, g = cuda_ms(fn), graph_ms(fn)
                sums["conv_ms"] += ms
                sums["conv_graph_ms"] += g
                print(json.dumps({"conv": f"{scope}/{name}",
                                  "shape": [args.batch, hw, hw, *w.shape[1:]],
                                  "kernel": list(kernel), "ms": ms, "graph_ms": g}), flush=True)
    # The pool branch at Mixed_5b, 5d and 6b: the pooled form where the
    # checkout has it, the 1x1 conv alone, and the separate pool kernel
    # where the checkout has it (pool-then-conv is their sum).
    for scope, hw in (("Mixed_5b", 35), ("Mixed_5d", 35), ("Mixed_6b", 17)):
        w, b = eng.taps[f"{scope}/Branch_3/Conv2d_0b_1x1"]
        x = act(args.batch, hw, hw, w.shape[1])
        row = {"pool_branch": scope, "shape": [args.batch, hw, hw, *w.shape[1:]]}
        if hasattr(fi, "ConvOp"):
            conv, pooled = fi.ConvOp([(w, b)], (1, 1)), fi.ConvOp([(w, b)], (1, 1), pooled=True)
            row["pooled_graph_ms"] = graph_ms(lambda: pooled(x))
            row["conv_graph_ms"] = graph_ms(lambda: conv(x))
        else:
            row["conv_graph_ms"] = graph_ms(lambda: fi.conv_same_bias_relu(x, w, b, (1, 1)))
        if hasattr(fi, "avg_pool3_same"):
            row["pool_graph_ms"] = graph_ms(lambda: fi.avg_pool3_same(x))
        print(json.dumps(row), flush=True)
    for scope in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6b", "Mixed_6c", "Mixed_6e"):
        hw = 35 if scope.startswith("Mixed_5") else 17
        x = act(args.batch, hw, hw, eng.taps[f"{scope}/Branch_0/Conv2d_0a_1x1"][0].shape[1])
        if hw == 35:
            fn = functools.partial(fi.fused_inception_a, x, eng.taps, scope, scope == "Mixed_5c")
        else:
            fn = functools.partial(fi.fused_inception_b, x, eng.taps, scope)
        ms, g = cuda_ms(fn), graph_ms(fn)
        sums["block_ms"] += ms
        sums["block_graph_ms"] += g
        print(json.dumps({"block": scope, "ms": ms, "graph_ms": g}), flush=True)
    print(json.dumps({**sums, "card": card_line()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
