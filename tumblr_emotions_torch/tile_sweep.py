"""Time ``conv_int8`` on every tile it has, at the served int8 convs' shapes.

    python -m tumblr_emotions_torch.tile_sweep [--batch 64]

The data behind ``ops/int8_conv.pick_tile``'s cost model: for each shape
(random int8 operands, one shift segment, B=64, full width), the device
time of one call on every tile of its copy width (CUDA graphs of 20 calls
between CUDA events), the rule's pick, and how far the pick is from the
fastest tile.  Prints one JSON line per shape, then a summary line.  Needs
a card.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from tumblr_emotions_torch._device import card_line, resolve_device
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    dev = resolve_device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rng = np.random.RandomState(args.seed)
    off = []
    for site, H, W, cin, cout, kernel, same in SHAPES:
        x = torch.randint(-20, 60, (args.batch, H, W, cin), generator=gen, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-100, 100, (cout, *kernel, cin), generator=gen, device=dev,
                          dtype=torch.int8)
        epi = ic.Epilogue.build([("shift", cout, rng.randint(-3000, 6000, cout),
                                  rng.randint(8, 14, cout))], dev)
        pad = ic.conv_padding(kernel, (1, 1), "SAME" if same else "VALID")
        pick = ic.conv_config(x, w, (1, 1), pad)
        want = ic.conv_int8_plain(x, w, epi, (1, 1), pad)[0]
        times = {}
        for bm, bn in ic.CONFIGS[pick.load_bytes]:
            tile = ic.TileConfig(pick.load_bytes, bm, bn)
            if not torch.equal(ic._launch(tile, x, w, epi, (1, 1), pad)[0], want):
                raise SystemExit(f"{site}: tile {tile.name} differs from the plain version")
            times[tile.name] = graph_ms(lambda t=tile: ic._launch(t, x, w, epi, (1, 1), pad))
        best = min(times, key=times.get)
        off.append(times[pick.name] / times[best] - 1)
        print(json.dumps({"site": site, "shape": [args.batch, H, W, cin, cout, *kernel],
                          "pick": pick.name, "pick_ms": times[pick.name], "best": best,
                          "best_ms": times[best], "ms": times}), flush=True)
    print(json.dumps({"card": card_line(), "shapes": len(off),
                      "pick_is_fastest": sum(o == 0 for o in off),
                      "pick_over_fastest_max": max(off),
                      "pick_over_fastest_mean": sum(off) / len(off)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
