"""Host time of one conv call, at a conv too small to hold the host back.

    python -m tumblr_emotions_torch.launch_cost [--kernel int8|bf16] [--calls 2000] [--reps 5]

The engines are partly host-bound: each conv launch costs the wrapper's
Python, the ctypes call and the CUDA launch.  This times ``--calls``
back-to-back calls on a [1,8,8,64] input with a 1x1 conv to 64 channels,
outputs allocated per call, as most of the engines' convs: for ``int8``
``conv_int8`` with one shift segment, for ``bf16`` a ``ConvOp`` of the
block conv (its weights packed once, as a block plan holds them).  Host
clock around the loop and a final ``torch.cuda.synchronize()``; prints
the median over ``--reps`` loops in microseconds per call, with the card's
name and power limit.  ``int8`` uses only ``conv_int8`` and
``Epilogue.build``, so it also runs against an older checkout of the
package (``PYTHONPATH``).  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from tumblr_emotions_torch.ops import int8_conv as ic


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("int8", "bf16"), default="int8")
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("launch_cost: needs a CUDA card")
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.RandomState(0)
    if args.kernel == "int8":
        x = torch.from_numpy(rng.randint(-20, 60, (1, 8, 8, 64)).astype(np.int8)).to(dev)
        w = torch.from_numpy(rng.randint(-100, 100, (64, 1, 1, 64)).astype(np.int8)).to(dev)
        epi = ic.Epilogue.build([("shift", 64, rng.randint(0, 3000, 64),
                                  rng.randint(8, 14, 64))], dev)

        def call():
            return ic.conv_int8(x, w, epi)
    else:
        from tumblr_emotions_torch.ops import fused_inception as fi

        x = torch.from_numpy(rng.uniform(0, 1, (1, 8, 8, 64)).astype(np.float32)).to(
            dev, torch.bfloat16)
        w = torch.from_numpy(rng.normal(0, 0.1, (1, 64, 64)).astype(np.float32)).to(
            dev, torch.bfloat16)
        op = fi.ConvOp([(w, torch.zeros(64, device=dev))], (1, 1))

        def call():
            return op(x)
    for _ in range(100):
        call()
    torch.cuda.synchronize()
    us = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        for _ in range(args.calls):
            call()
        torch.cuda.synchronize()
        us.append((time.perf_counter() - t0) / args.calls * 1e6)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"kernel": args.kernel, "us_per_call_median": statistics.median(us),
                      "us_per_call": us, "calls": args.calls, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
