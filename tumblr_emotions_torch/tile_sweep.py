"""Time a conv kernel on every tile it has, at the served convs' shapes.

    python -m tumblr_emotions_torch.tile_sweep [--kernel int8|bf16] [--batch 64]

The data behind the tile rules' cost models (``ops/int8_conv.pick_tile``,
``ops/fused_inception.pick_tile``): for each shape (random operands, B=64,
full width; for ``int8`` one shift segment of ``conv_int8``, for ``bf16``
one launch of the block conv as the bf16 engine's blocks issue it), the
device time of one call on every tile of its copy width or form (CUDA
graphs of 20 calls between CUDA events), the rule's pick, and how far the
pick is from the fastest tile.  Each tile's output is checked against the
plain version first.  Prints one JSON line per shape, then a summary line.
Needs a card.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from tumblr_emotions_torch._device import card_line, resolve_device
from tumblr_emotions_torch.ops import fused_inception as fi
from tumblr_emotions_torch.ops import int8_conv as ic
from tumblr_emotions_torch.timing import graph_ms

# (site, H, W, Cin, Cout, kernel, SAME padding)
SHAPES = [
    ("Conv2d_1a s2d", 150, 150, 12, 32, (2, 2), False),
    ("Conv2d_2a", 149, 149, 32, 32, (3, 3), False),
    ("Conv2d_2b", 147, 147, 32, 64, (3, 3), True),
    ("Conv2d_3b", 73, 73, 64, 80, (1, 1), False),
    ("Conv2d_4a", 73, 73, 80, 192, (3, 3), False),
    ("Mixed_5b 3x3", 35, 35, 64, 96, (3, 3), True),
    ("Mixed_5b packed", 35, 35, 192, 208, (1, 1), False),
    ("Mixed_6b 1x7", 17, 17, 128, 128, (1, 7), True),
    ("Mixed_7b 1x3", 8, 8, 384, 384, (1, 3), True),
    ("Mixed_7c packed", 8, 8, 2048, 1344, (1, 1), False),
]

# The bf16 blocks' launches: (site, H, W, Cin, Cout, kernel, pooled)
BF16_SHAPES = [
    ("Mixed_5b packed", 35, 35, 192, 176, (1, 1), False),
    ("Mixed_5b 5x5", 35, 35, 48, 64, (5, 5), False),
    ("Mixed_5b 3x3 a", 35, 35, 64, 96, (3, 3), False),
    ("Mixed_5b 3x3 b", 35, 35, 96, 96, (3, 3), False),
    ("Mixed_5b pooled", 35, 35, 192, 32, (1, 1), True),
    ("Mixed_5d pooled", 35, 35, 288, 64, (1, 1), True),
    ("Mixed_6b packed", 17, 17, 768, 448, (1, 1), False),
    ("Mixed_6e packed", 17, 17, 768, 576, (1, 1), False),
    ("Mixed_6b 1x7", 17, 17, 128, 128, (1, 7), False),
    ("Mixed_6b 7x1", 17, 17, 128, 192, (7, 1), False),
    ("Mixed_6c 1x7", 17, 17, 160, 160, (1, 7), False),
    ("Mixed_6e 7x1", 17, 17, 192, 192, (7, 1), False),
    ("Mixed_6b pooled", 17, 17, 768, 192, (1, 1), True),
]


def _bf16_shapes(batch: int, gen, dev):
    """(site, shape, the rule's pick, {tile name: a call on that tile})."""
    for site, H, W, cin, cout, kernel, pooled in BF16_SHAPES:
        kh, kw = kernel
        x = torch.relu(torch.randn(batch, H, W, cin, generator=gen, device=dev)).to(torch.bfloat16)
        w = (torch.randn(kh * kw, cin, cout, generator=gen, device=dev)
             / (kh * kw * cin) ** 0.5).to(torch.bfloat16)
        op = fi.ConvOp([(w, torch.randn(cout, generator=gen, device=dev) * 0.1)], kernel, pooled)
        (want,) = fi.conv_segments_plain(x, op, [torch.empty(batch, H, W, cout, dtype=x.dtype,
                                                             device=dev)])
        pick = fi.pick_tile(batch * H * W, cout, kh * kw * cin, pooled, W if pooled else 0)
        calls = {}
        for bm, bn in fi.CONFIGS[pooled]:
            if fi._smem_bytes(bm, bn, pooled, W if pooled else 0) > fi._SMEM:
                continue           # the pooled form's halo does not fit
            tile = fi.TileConfig(bm, bn, pooled)
            (got,) = fi._run(op, x, None, tile)
            err = (got.float() - want.float()).abs().max() / want.float().abs().max()
            if err.item() > 2.0 ** -6:
                raise SystemExit(f"{site}: tile {tile.name} differs from the plain version")
            calls[tile.name] = lambda t=tile: fi._run(op, x, None, t)
        yield site, [batch, H, W, cin, cout, *kernel], pick.name, calls


def _int8_shapes(batch: int, gen, dev, rng):
    for site, H, W, cin, cout, kernel, same in SHAPES:
        x = torch.randint(-20, 60, (batch, H, W, cin), generator=gen, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-100, 100, (cout, *kernel, cin), generator=gen, device=dev,
                          dtype=torch.int8)
        epi = ic.Epilogue.build([("shift", cout, rng.randint(-3000, 6000, cout),
                                  rng.randint(8, 14, cout))], dev)
        pad = ic.conv_padding(kernel, (1, 1), "SAME" if same else "VALID")
        pick = ic.conv_config(x, w, (1, 1), pad)
        want = ic.conv_int8_plain(x, w, epi, (1, 1), pad)[0]
        calls = {}
        for bm, bn in ic.CONFIGS[pick.load_bytes]:
            tile = ic.TileConfig(pick.load_bytes, bm, bn)
            if not torch.equal(ic._launch(tile, x, w, epi, (1, 1), pad)[0], want):
                raise SystemExit(f"{site}: tile {tile.name} differs from the plain version")
            calls[tile.name] = lambda t=tile: ic._launch(t, x, w, epi, (1, 1), pad)
        yield site, [batch, H, W, cin, cout, *kernel], pick.name, calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("int8", "bf16"), default="int8")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    dev = resolve_device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rng = np.random.RandomState(args.seed)
    shapes = _bf16_shapes(args.batch, gen, dev) if args.kernel == "bf16" else \
        _int8_shapes(args.batch, gen, dev, rng)
    off = []
    for site, shape, pick, calls in shapes:
        times = {name: graph_ms(fn) for name, fn in calls.items()}
        best = min(times, key=times.get)
        off.append(times[pick] / times[best] - 1)
        print(json.dumps({"site": site, "shape": shape, "pick": pick, "pick_ms": times[pick],
                          "best": best, "best_ms": times[best], "ms": times}), flush=True)
    print(json.dumps({"kernel": args.kernel, "card": card_line(), "shapes": len(off),
                      "pick_is_fastest": sum(o == 0 for o in off),
                      "pick_over_fastest_max": max(off),
                      "pick_over_fastest_mean": sum(off) / len(off)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
