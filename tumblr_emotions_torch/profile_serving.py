"""Where the served program's time goes on the card: a torch.profiler trace.

    python -m tumblr_emotions_torch.profile_serving [--engine bf16|int8|joint|train]
        [--batch 64] [--batches 3]

Builds seeded full-width weights (as chip_smoke.py does), warms up, then
profiles ``--batches`` served uint8 [B,347,347,3] batches.  ``--engine
bf16`` (default) profiles ``image_server(FusedInceptionV3(state,
use_kernels=...))`` for the kernel engine and the cuDNN engine; ``--engine
int8`` the default served program, ``QuantizedInceptionV3`` behind the
space-to-depth front, calibrated on one seeded batch, and the same tower
behind the all-int8 uint8 front (``int8_uint8``); ``--engine joint``
that program and, in the same call, the joint_finetune program on the same
tower (``build_forward(engine="int8")`` with seeded [B,50] token batches),
so the difference is what the text branch and the fusion head add;
``--engine train`` a train step instead of a served batch:
``Trainer(joint_finetune, preprocess="train").train_step`` at full width on
seeded weights, batch 32 unless ``--batch`` says otherwise (the batch's
ids are seeded [B,50] ids, its labels seeded).  Prints
one JSON line per program: host wall ms per batch, device busy ms per batch
(sum of kernel times on the one stream), the idle share (1 - busy/wall),
the host's kernel and graph launch calls per batch, and device time by
kernel group.  Needs a CUDA card; raises without one.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import numpy as np
import torch

from tumblr_emotions_torch import get_preset
from tumblr_emotions_torch._device import card_line
from tumblr_emotions_torch.data.preprocessing import preprocess_for_eval
from tumblr_emotions_torch.data.vocab import synthetic_ids
from tumblr_emotions_torch.models import build_model, joint_model
from tumblr_emotions_torch.models.inception_v3 import InceptionV3, init_state
from tumblr_emotions_torch.ops.inference import FusedInceptionV3
from tumblr_emotions_torch.ops.quant import QuantizedInceptionV3
from tumblr_emotions_torch.ops.serving import build_forward, image_server

# Kernel-name substrings -> group, first match wins.
GROUPS = [
    ("conv_int8", "int8 conv kernel (ours)"),
    ("maxpool_", "int8 max-pool kernel (ours)"),
    ("conv_bf16", "block conv kernel (ours)"),  # conv_bf16_wgmma<BM,BN,POOL>
    ("dgrad", "cuDNN conv backward"),
    ("wgrad", "cuDNN conv backward"),
    ("fprop", "cuDNN conv"),          # sm90_xmma_fprop_implicit_gemm_*
    ("winograd", "cuDNN conv"),
    ("conv", "cuDNN conv"),           # precomputed_convolve_sgemm, ...
    ("gemm", "matmul (resize, logits, text heads)"),
    ("index", "torch gather (text lookup)"),   # before "elementwise": index_elementwise_kernel
    ("pool", "torch pooling"),
    ("cat", "torch concat/copy"),
    ("copy", "torch concat/copy"),
    ("elementwise", "torch elementwise"),
    ("reduce", "torch reduction"),
    ("softmax", "torch reduction"),
]


# The CUDA API calls (cuda* and cu*) that launch work, as the trace names them.
LAUNCH_CALLS = {"cudaLaunchKernel": "kernel", "cudaLaunchKernelExC": "kernel",
                "cuLaunchKernel": "kernel", "cuLaunchKernelEx": "kernel",
                "cudaGraphLaunch": "graph", "cuGraphLaunch": "graph"}


def _group(name: str) -> str:
    low = name.lower()
    for key, group in GROUPS:
        if key in low:
            return group
    return "other"


def profile_engine(serve, n: int) -> dict:
    """Profile ``serve(i)`` (serves batch i) over batches 0..n-1."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(n):           # warm-up: cuDNN algorithm choice, allocator
        serve(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            serve(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_group, by_kernel = defaultdict(float), defaultdict(float)
    n_kernels = 0
    host_launches = defaultdict(int)   # the host's launch calls the trace saw, by kind
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            if e.name in LAUNCH_CALLS:
                host_launches[LAUNCH_CALLS[e.name]] += 1
            continue
        us = e.time_range.elapsed_us()
        by_group[_group(e.name)] += us / 1e3
        by_kernel[e.name[:80]] += us / 1e3
        n_kernels += 1
    busy = sum(by_group.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_ms_per_batch": wall_ms / n,
            "device_busy_ms_per_batch": busy / n if n_kernels else None,
            "idle_share": 1.0 - busy / wall_ms if n_kernels else None,
            "kernels_per_batch": n_kernels / n,
            "host_launches_per_batch": {k: v / n for k, v in sorted(host_launches.items())},
            "device_ms_per_batch_by_group": {k: v / n for k, v in
                                             sorted(by_group.items(), key=lambda kv: -kv[1])},
            "top_kernels_ms_per_batch": {k: v / n for k, v in top}}


def profile_training(args) -> None:
    """Profile ``--batches`` train steps of joint_finetune at full width."""
    from tumblr_emotions_torch.train.trainer import Trainer

    cfg = get_preset("joint_finetune")
    batch = args.batch or cfg.train.batch_size
    trainer = Trainer(cfg, preprocess="train")
    state = trainer.init_state(joint_model.init_state(build_model(cfg, device="meta"),
                                                      args.seed))
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    rng = np.random.RandomState(args.seed + 1)
    batches = [{"image": torch.randint(0, 256, (batch, 347, 347, 3), generator=g,
                                       device="cuda", dtype=torch.uint8),
                "tokens": torch.from_numpy(synthetic_ids(rng, batch, cfg.text.max_len,
                                                         cfg.text.vocab_size)).cuda(),
                "label": torch.randint(0, cfg.image.num_classes, (batch,), generator=g,
                                       device="cuda")}
               for _ in range(args.batches)]

    def step(i):
        nonlocal state
        state, _ = trainer.train_step(state, batches[i], g)

    print(json.dumps({"engine": "train_joint", "batch": batch, "card": card_line(),
                      **profile_engine(step, len(batches))}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engine", choices=("bf16", "int8", "joint", "train"), default="bf16")
    ap.add_argument("--batch", type=int, default=None,
                    help="64 for a served program, the preset's 32 for train")
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.engine == "train":
        profile_training(args)
        return
    args.batch = args.batch or 64
    model = InceptionV3(device="meta")
    state = init_state(model, args.seed)
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    batches = [torch.randint(0, 256, (args.batch, 347, 347, 3), generator=g,
                             device="cuda", dtype=torch.uint8)
               for _ in range(args.batches)]
    card = card_line()
    if args.engine == "bf16":
        engines = {"kernels": FusedInceptionV3(state, use_kernels=True),
                   "cudnn": FusedInceptionV3(state, use_kernels=False)}
    else:
        calib = preprocess_for_eval(batches[0])
        engines = {"int8": QuantizedInceptionV3(state, calib, stem_s2d="pre")}
    servers = {name: (lambda i, srv=image_server(engine): srv(batches[i]))
               for name, engine in engines.items()}
    if args.engine == "int8":
        srv = image_server(QuantizedInceptionV3(state, calib), from_uint8=True)
        servers["int8_uint8"] = lambda i: srv(batches[i])
    if args.engine == "joint":
        cfg = get_preset("joint_finetune")
        joint = build_forward(cfg, joint_model.init_state(build_model(cfg, device="meta"),
                                                          args.seed),
                              engine="int8", calib_images=calib)
        rng = np.random.RandomState(args.seed + 1)
        tokens = [torch.from_numpy(synthetic_ids(rng, args.batch, cfg.text.max_len,
                                                 cfg.text.vocab_size)).cuda()
                  for _ in batches]
        servers["joint"] = lambda i: joint(batches[i], tokens[i])
    for name, serve in servers.items():
        print(json.dumps({"engine": name, "batch": args.batch, "card": card,
                          **profile_engine(serve, len(batches))}), flush=True)


if __name__ == "__main__":
    main()
