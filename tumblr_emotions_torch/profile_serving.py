"""Where the served program's time goes on the card: a torch.profiler trace.

    python -m tumblr_emotions_torch.profile_serving [--engine bf16|int8]
        [--batch 64] [--batches 3]

Builds seeded full-width weights (as chip_smoke.py does), warms up, then
profiles ``--batches`` served uint8 [B,347,347,3] batches.  ``--engine
bf16`` (default) profiles ``image_server(FusedInceptionV3(state,
use_kernels=...))`` for the kernel engine and the cuDNN engine; ``--engine
int8`` the default served program, ``QuantizedInceptionV3`` behind the
space-to-depth front, calibrated on one seeded batch.  Prints one JSON
line per engine: host wall
ms per batch, device busy ms per batch (sum of kernel times on the one
stream), the idle share (1 - busy/wall), and device time by kernel group.
Needs a CUDA card; raises without one.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import torch

from tumblr_emotions_torch._device import card_line
from tumblr_emotions_torch.models.inception_v3 import InceptionV3, init_state
from tumblr_emotions_torch.data.preprocessing import preprocess_for_eval
from tumblr_emotions_torch.ops.inference import FusedInceptionV3
from tumblr_emotions_torch.ops.quant import QuantizedInceptionV3
from tumblr_emotions_torch.ops.serving import image_server

# Kernel-name substrings -> group, first match wins.
GROUPS = [
    ("conv_int8", "int8 conv kernel (ours)"),
    ("maxpool_", "int8 max-pool kernel (ours)"),
    ("conv_bf16", "block conv kernel (ours)"),  # conv_bf16_wgmma<BM,BN,POOL>
    ("fprop", "cuDNN conv"),          # sm90_xmma_fprop_implicit_gemm_*
    ("conv", "cuDNN conv"),           # precomputed_convolve_sgemm, ...
    ("gemm", "matmul (resize, logits)"),
    ("pool", "torch pooling"),
    ("cat", "torch concat/copy"),
    ("copy", "torch concat/copy"),
    ("elementwise", "torch elementwise"),
    ("reduce", "torch reduction"),
    ("softmax", "torch reduction"),
]


def _group(name: str) -> str:
    low = name.lower()
    for key, group in GROUPS:
        if key in low:
            return group
    return "other"


def profile_engine(server, batches) -> dict:
    from torch.profiler import ProfilerActivity, profile

    for raw in batches:          # warm-up: cuDNN algorithm choice, allocator
        server(raw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for raw in batches:
            server(raw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_group, by_kernel = defaultdict(float), defaultdict(float)
    n_kernels = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        by_group[_group(e.name)] += us / 1e3
        by_kernel[e.name[:80]] += us / 1e3
        n_kernels += 1
    n = len(batches)
    busy = sum(by_group.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_ms_per_batch": wall_ms / n,
            "device_busy_ms_per_batch": busy / n if n_kernels else None,
            "idle_share": 1.0 - busy / wall_ms if n_kernels else None,
            "kernels_per_batch": n_kernels / n,
            "device_ms_per_batch_by_group": {k: v / n for k, v in
                                             sorted(by_group.items(), key=lambda kv: -kv[1])},
            "top_kernels_ms_per_batch": {k: v / n for k, v in top}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engine", choices=("bf16", "int8"), default="bf16")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    model = InceptionV3(device="meta")
    state = init_state(model, args.seed)
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    batches = [torch.randint(0, 256, (args.batch, 347, 347, 3), generator=g,
                             device="cuda", dtype=torch.uint8)
               for _ in range(args.batches)]
    card = card_line()
    if args.engine == "int8":
        calib = preprocess_for_eval(batches[0])
        engines = {"int8": QuantizedInceptionV3(state, calib, stem_s2d="pre")}
    else:
        engines = {"kernels": FusedInceptionV3(state, use_kernels=True),
                   "cudnn": FusedInceptionV3(state, use_kernels=False)}
    for name, engine in engines.items():
        print(json.dumps({"engine": name, "batch": args.batch, "card": card,
                          **profile_engine(image_server(engine), batches)}), flush=True)


if __name__ == "__main__":
    main()
