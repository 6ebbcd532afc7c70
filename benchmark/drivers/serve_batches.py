"""Closed-loop serving of full batches through the port's served program.

The program is ``ops/serving.build_forward`` of the configuration (the
joint model on the int8 engine behind the s2d front: one captured CUDA
graph per batch), calibrated at set-up on the configuration's calibration
images.  Each batch of the window is a pool batch of host numpy arrays
(uint8 images, int32 ids and lengths, as ``cli infer`` and the server's
batcher hand them), answered with its probabilities copied to the host
before the next is sent.  ``serve_posts_s`` is the posts answered over the
window's seconds.

After the window a sample of the answered batches, drawn from the seed and
holding the pool's longest caption, is compared with the float32
reference over the same images and captions (``compare.logit_gaps``).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import cell, compare, devtrace, traffic, weights
from benchmark.reference import model as ref_model
from benchmark.reference import preprocess as ref_pre


def build(ctx, cfg, state, calib):
    from tumblr_emotions_torch.ops.serving import build_forward

    s = ctx.config["serving"]
    return build_forward(cfg, state, engine=s["engine"], calib_images=calib, front=s["front"],
                         device=ctx.device)


def reference_probs(ctx, params, batch) -> np.ndarray:
    im, data = ctx.config["image"], ctx.config["data"]
    dev = ctx.device
    with ref_model.exact_f32(), torch.no_grad():
        x = ref_pre.eval_images(torch.from_numpy(batch["image"]).to(dev), im["image_size"],
                                data["eval_central_crop"])
        out = ref_model.joint_forward(params, x, torch.from_numpy(batch["tokens"]).to(dev),
                                      torch.from_numpy(batch["lengths"]).to(dev),
                                      depth_multiplier=im["depth_multiplier"],
                                      num_classes=im["num_classes"], eps=im["bn_epsilon"])
    return out["Predictions"].double().cpu().numpy()


def sample(ctx, pool, done: int):
    """The window batches to check: one holding the pool's longest caption,
    the rest drawn from the seed."""
    t = ctx.traffic
    want = max(1, min(done, t["check_posts"] // t["batch"]))
    longest = int(np.argmax([b["lengths"].max() for b in pool]))
    first = longest if longest < done else 0
    rng = np.random.default_rng(traffic.seed_of(ctx.seed, "sample"))
    rest = [int(i) for i in rng.permutation(done) if i != first][:want - 1]
    return [first] + sorted(rest)


def run(ctx) -> cell.Outcome:
    t = ctx.traffic
    dev = ctx.device
    cfg = cell.port_config(ctx.config)
    phases = {"start": time.perf_counter() - ctx.started}
    wseed = traffic.seed_of(ctx.seed, "weights")
    params = weights.make(wseed, dev, **cell.model_sizes(ctx.config))
    state = {k: v.cpu() for k, v in params.items()}   # build_forward takes a host state
    del params
    pool = traffic.pool(ctx.seed, t, dev)
    phases["weights_traffic"] = time.perf_counter() - ctx.started
    calib_u8 = traffic.images(ctx.seed, "calibration", t["calibration_images"], t["image_hw"],
                              dev, traffic.style(t))
    calib = ref_pre.eval_images(calib_u8, ctx.config["image"]["image_size"],
                                ctx.config["data"]["eval_central_crop"])
    del calib_u8
    runner = build(ctx, cfg, state, calib)
    del calib, state
    phases["build_calibrate"] = time.perf_counter() - ctx.started
    for i, b in enumerate(pool[:2]):   # the first call captures the graph, the second replays
        runner(b["image"], b["tokens"], b["lengths"]).cpu()
        phases[("capture", "replay")[i]] = time.perf_counter() - ctx.started
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - ctx.started

    seconds = min(ctx.seconds, t["trace_seconds"]) if ctx.trace else ctx.seconds
    answers = []
    with devtrace.traced(ctx.trace, dev.type == "cuda") as box:
        t0 = time.perf_counter()
        while True:
            b = pool[len(answers) % len(pool)]
            with devtrace.span("replay"):
                probs = runner(b["image"], b["tokens"], b["lengths"])
            with devtrace.span("answers"):
                answers.append(probs.cpu().numpy())
            if time.perf_counter() - t0 >= seconds:
                break
        t1 = time.perf_counter()
    done = len(answers)
    rows = t["batch"]
    memory = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    nodes = None
    if getattr(runner.program, "graphed", False):
        graphs = runner.program.kernel_nodes()
        nodes = sum(sum(g["kernels"].values()) for g in graphs) / max(1, len(graphs))
    del runner
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    failed = int(sum((~np.isfinite(a)).any(1).sum() for a in answers))
    params = weights.make(wseed, dev, **cell.model_sizes(ctx.config))
    picked = sample(ctx, pool, done)
    ref = {}
    got, want = [], []
    for i in picked:
        k = i % len(pool)
        if k not in ref:
            ref[k] = reference_probs(ctx, params, pool[k])
        got.append(answers[i])
        want.append(ref[k])
    gaps = compare.logit_gaps(np.concatenate(got), np.concatenate(want))
    limits = ctx.workload["limits"]
    checks = {k: (v, limits[k], f"{len(picked) * rows} posts of {done * rows}")
              for k, v in gaps.items()}
    reading = None
    if ctx.trace:
        reading = cell.Reading(box["trace"], done, rows,
                               {} if nodes is None else {"graph_nodes": nodes},
                               ctx.config, ctx.workload)
    return cell.Outcome({"serve_posts_s": done * rows / (t1 - t0), "setup_s": setup_s},
                        done * rows, failed, checks, memory, reading, phases)
