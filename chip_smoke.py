#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device   -- needs torch.cuda.is_available(); prints the card's name and
               power limit (nvidia-smi).
2. build    -- compiles csrc/inception_blocks.cu with nvcc (first use).
3. kernels  -- each hand-written kernel against its plain PyTorch version on
               the card, in bf16, at the full-width shapes the served path
               gives it (B=64): conv_same_bias_relu at every conv of Mixed_5b
               and Mixed_6b, avg_pool3_same at 35x35x288 and 17x17x768, the
               Inception-A block (Mixed_5b/5c/5d) and the Inception-B block
               (Mixed_6b/6c/6e).  Times by CUDA events.
4. e2e      -- the served program image_server(FusedInceptionV3(state,
               use_kernels=True)) on 3 uint8 [64,347,347,3] batches with
               seeded full-width weights; launch counts, probabilities, and
               logits/top-1 against the f32 slim tower (TF32 off); img/s of
               the kernel engine and of the cuDNN engine (use_kernels=False).
5. kernels  -- one JSON line listing every ported kernel.

The last line is {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import sys
import time

SEED = 0
DEVICE = "cuda"
DEPTH = 1.0                   # full width
BATCH = 64
N_BATCHES = 3
SRC_HW = 347                  # decoded image size; the 0.875 crop is real
H100_BF16_FLOPS = 989e12      # dense bf16 tensor-core peak, H100 SXM
H100_F32_FLOPS = 67e12        # f32 outside the tensor cores
H100_BYTES_S = 3.35e12        # HBM3

# Kernel vs plain version, bf16 on both sides; both accumulate in f32 and
# round once per conv, in another summation order, so an output may land
# one bf16 ulp (at most 2^-7 of its magnitude) apart; a block chains up to 5
# such roundings, where a flipped intermediate moves later outputs by far
# less than an ulp.  Tolerance on max|kernel - plain| / max|plain|:
KERNEL_TOL = 2.0 ** -6
# The bf16 served path against the f32 tower: bf16 is rounded after every
# conv (~0.4% each, ~20 convs deep), measured 0.8% of max|logit| at depth
# 0.5 on the CPU.  Tolerance on max|dlogit| / max|logit_f32|:
LOGIT_TOL = 0.05
# Top-1 must agree on every image whose f32 top-1 margin exceeds twice the
# logit tolerance (images with a smaller margin may legitimately flip), and
# on at least this share of all images:
TOP1_MIN_SHARE = 0.95

REPLACES = "tumblr_emotions_tpu/ops/fused_inception.py"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, peak: float = H100_BF16_FLOPS) -> dict:
    """Least time on an H100 SXM: the larger of the operations over the
    peak rate and the bytes (each input read once, each output written
    once) over the memory rate."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / H100_BYTES_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops_ms": t_ops, "bytes_ms": t_bytes}


def compare(name: str, got, want, tol: float) -> float:
    import torch

    got, want = got.float(), want.float()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite output")
    err = (got - want).abs().max().item()
    rel = err / max(want.abs().max().item(), 1e-30)
    if rel > tol:
        fail(f"{name}: max|err| {err} = {rel} of max|plain| > {tol}")
    return err


def check_launches(launches) -> None:
    """Per served batch: 3 Inception-A and 4 Inception-B blocks, whose
    7 and 10 convs and one pool each go through the kernels."""
    want = {"fused_inception_a": 3 * N_BATCHES, "fused_inception_b": 4 * N_BATCHES,
            "conv_same_bias_relu": (3 * 7 + 4 * 10) * N_BATCHES,
            "avg_pool3_same": 7 * N_BATCHES}
    if launches != want:
        fail(f"launch counts {launches} != {want}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    import numpy as np
    import torch.nn.functional as F

    from tumblr_emotions_torch._device import card_line, resolve_device
    from tumblr_emotions_torch.data.preprocessing import preprocess_for_eval
    from tumblr_emotions_torch.models.inception_v3 import InceptionV3, init_state
    from tumblr_emotions_torch.models.layers import to_nchw, to_nhwc
    from tumblr_emotions_torch.ops import _build
    from tumblr_emotions_torch.ops import fused_inception as fi
    from tumblr_emotions_torch.ops.inference import FusedInceptionV3
    from tumblr_emotions_torch.ops.serving import image_server

    torch.set_grad_enabled(False)
    dev = resolve_device(DEVICE)

    # ---- 1. device ----
    smi = card_line()
    print(smi, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count()})

    # ---- 2. build ----
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log = lib_path.with_suffix(".log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln] if log.exists() else []
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "library": lib_path.name, "ptxas": ptxas})

    # ---- seeded full-width weights (depth 1.0, 15 classes, aux head) ----
    model = InceptionV3(num_classes=15, depth_multiplier=DEPTH,
                        create_aux_logits=True, device=dev)
    state = init_state(model, SEED)
    model.load_state_dict(state)
    eng_k = FusedInceptionV3(state, dtype=torch.bfloat16, use_kernels=True, device=dev)
    eng_c = FusedInceptionV3(state, dtype=torch.bfloat16, use_kernels=False, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def act(*shape):
        return torch.relu(torch.randn(*shape, generator=gen, device=dev)).to(torch.bfloat16)

    rows = {}  # kernel name -> list of per-shape results

    def record(kernel, **r):
        rows.setdefault(kernel, []).append(r)
        emit({"phase": "kernel_check", "kernel": kernel, **r})

    # ---- 3a. conv_same_bias_relu at every conv of Mixed_5b and Mixed_6b ----
    for scope, hw, branches in (("Mixed_5b", 35, fi.inception_a_branches(False)),
                                ("Mixed_6b", 17, fi.INCEPTION_B_BRANCHES)):
        for _, chain in branches:
            for name, kernel in chain:
                w, b = eng_k.taps[f"{scope}/{name}"]
                _, cin, cout = w.shape
                x = act(BATCH, hw, hw, cin)
                got = fi.conv_same_bias_relu(x, w, b, kernel)
                want = fi.conv_same_bias_relu_plain(x, w, b, kernel)
                torch.cuda.synchronize()
                err = compare(f"conv {scope}/{name}", got, want, KERNEL_TOL)
                w_oihw = eng_c.w[f"{scope}/{name}"][0].to(
                    memory_format=torch.channels_last)
                x_nchw = to_nchw(x)
                pad = (kernel[0] // 2, kernel[1] // 2)
                b_bf16 = b.to(torch.bfloat16)
                m = BATCH * hw * hw
                flops = 2.0 * m * cout * cin * kernel[0] * kernel[1]
                nbytes = 2.0 * (m * cin + m * cout + w.numel()) + 4 * cout
                record("conv_same_bias_relu", shape=f"{scope}/{name} [{BATCH},{hw},{hw},{cin}]->{cout} k{kernel}",
                       max_abs_err=err, max_rel_err=err / want.float().abs().max().item(),
                       tol=KERNEL_TOL,
                       ms=cuda_ms(lambda: fi.conv_same_bias_relu(x, w, b, kernel)),
                       plain_ms=cuda_ms(lambda: fi.conv_same_bias_relu_plain(x, w, b, kernel)),
                       library_ms=cuda_ms(lambda: F.conv2d(x_nchw, w_oihw, b_bf16, padding=pad)),
                       **bound(flops, nbytes))

    # ---- 3b. avg_pool3_same ----
    for hw, c in ((35, 288), (17, 768)):
        x = act(BATCH, hw, hw, c)
        got, want = fi.avg_pool3_same(x), fi.avg_pool3_same_plain(x)
        torch.cuda.synchronize()
        err = compare(f"avg_pool3 {hw}x{hw}x{c}", got, want, KERNEL_TOL)
        n = BATCH * hw * hw * c
        x_nchw = to_nchw(x)
        record("avg_pool3_same", shape=f"[{BATCH},{hw},{hw},{c}]", max_abs_err=err,
               max_rel_err=err / want.float().abs().max().item(), tol=KERNEL_TOL,
               ms=cuda_ms(lambda: fi.avg_pool3_same(x)),
               plain_ms=cuda_ms(lambda: fi.avg_pool3_same_plain(x)),
               library_ms=cuda_ms(lambda: F.avg_pool2d(x_nchw, 3, 1, 1, count_include_pad=False)),
               **bound(9.0 * n, 4.0 * n, peak=H100_F32_FLOPS))

    # ---- 3c. the blocks (K2, K3) against their plain versions ----
    def block_cost(scope, branches, hw, cin):
        m = BATCH * hw * hw
        flops, wbytes, cout = 0.0, 0.0, 0
        for _, chain in branches:
            for name, _ in chain:
                w, _ = eng_k.taps[f"{scope}/{name}"]
                flops += 2.0 * m * w.numel()
                wbytes += 2.0 * w.numel() + 4.0 * w.shape[-1]   # bf16 taps, f32 bias
            cout += w.shape[-1]
        return bound(flops, 2.0 * m * (cin + cout) + wbytes)

    blocks = [("fused_inception_a", scope, 35, cin, fi.inception_a_branches(q),
               lambda x, s=scope, q=q: fi.fused_inception_a(x, eng_k.taps, s, q),
               lambda x, s=scope, q=q: fi.fused_inception_a_plain(x, eng_k.taps, s, q),
               lambda x, s=scope, q=q: eng_c._cudnn_block(x, s, fi.inception_a_branches(q)))
              for scope, q in (("Mixed_5b", False), ("Mixed_5c", True),
                               ("Mixed_5d", False))
              for cin in [eng_k.taps[f"{scope}/Branch_0/Conv2d_0a_1x1"][0].shape[1]]]
    blocks += [("fused_inception_b", scope, 17,
                eng_k.taps[f"{scope}/Branch_0/Conv2d_0a_1x1"][0].shape[1],
                fi.INCEPTION_B_BRANCHES,
                lambda x, s=scope: fi.fused_inception_b(x, eng_k.taps, s),
                lambda x, s=scope: fi.fused_inception_b_plain(x, eng_k.taps, s),
                lambda x, s=scope: eng_c._cudnn_block(x, s, fi.INCEPTION_B_BRANCHES))
               for scope in ("Mixed_6b", "Mixed_6c", "Mixed_6e")]
    for kname, scope, hw, cin, branches, kfn, pfn, lfn in blocks:
        x = act(BATCH, hw, hw, cin)
        got, want = kfn(x), pfn(x)
        torch.cuda.synchronize()
        err = compare(f"{kname} {scope}", got, want, KERNEL_TOL)
        record(kname, shape=f"{scope} [{BATCH},{hw},{hw},{cin}]->{got.shape[-1]}",
               max_abs_err=err, max_rel_err=err / want.float().abs().max().item(),
               tol=KERNEL_TOL, ms=cuda_ms(lambda: kfn(x)), plain_ms=cuda_ms(lambda: pfn(x)),
               library_ms=cuda_ms(lambda: lfn(x)), **block_cost(scope, branches, hw, cin))

    # ---- 4. end to end: the served kernel path ----
    rng = np.random.RandomState(SEED)

    def make_batch():
        # Per-image low-frequency colour patterns of random scale plus noise of
        # random strength, so the images differ in more than their noise.
        grids = rng.randint(2, 33, BATCH)
        imgs = []
        for g in grids:
            lo = torch.from_numpy(rng.uniform(0, 255, (1, 3, g, g)).astype(np.float32))
            im = F.interpolate(lo, size=(SRC_HW, SRC_HW), mode="bilinear",
                               align_corners=False)[0].permute(1, 2, 0)
            im = im + torch.from_numpy(rng.normal(0, rng.uniform(0, 40), im.shape)
                                       .astype(np.float32))
            imgs.append(im.clamp(0, 255).to(torch.uint8))
        return torch.stack(imgs).to(dev)

    batches = [make_batch() for _ in range(N_BATCHES)]
    server = image_server(eng_k, device=dev)
    fi.reset_launches()
    outs = [server(raw) for raw in batches]
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in
                (fi.fused_inception_a, fi.fused_inception_b, fi.conv_same_bias_relu,
                 fi.avg_pool3_same)}
    check_launches(launches)
    n_feat = eng_k.logits_w[0].shape[0]
    for probs, feature in outs:
        if probs.shape != (BATCH, 15) or feature.shape != (BATCH, n_feat):
            fail(f"output shapes {tuple(probs.shape)} {tuple(feature.shape)}")
        if not (torch.isfinite(probs).all() and torch.isfinite(feature).all()):
            fail("non-finite probabilities or features")
        if (probs.sum(-1) - 1).abs().max().item() > 1e-3:
            fail("probability rows do not sum to 1")

    dmax, agree, decided, decided_agree, lmax = 0.0, 0, 0, 0, 0.0
    for raw in batches:
        ref, _ = model(preprocess_for_eval(raw, dtype=torch.float32))
        got, _ = eng_k(preprocess_for_eval(raw, dtype=torch.bfloat16))
        lmax = max(lmax, ref.abs().max().item())
        dmax = max(dmax, (got - ref).abs().max().item())
        top2 = ref.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        same = got.argmax(-1) == ref.argmax(-1)
        sure = margin > 2 * LOGIT_TOL * ref.abs().max()
        agree += int(same.sum())
        decided += int(sure.sum())
        decided_agree += int((same & sure).sum())
    n_img = BATCH * N_BATCHES
    if dmax / lmax > LOGIT_TOL:
        fail(f"logits vs f32 tower: max|d| {dmax} = {dmax / lmax} of max|logit| > {LOGIT_TOL}")
    if decided_agree != decided:
        fail(f"top-1 differs on {decided - decided_agree} of {decided} images with a clear margin")
    if agree < TOP1_MIN_SHARE * n_img:
        fail(f"top-1 agrees on {agree} of {n_img} images, below {TOP1_MIN_SHARE}")

    def img_s(engine):
        srv = image_server(engine, device=dev)
        for raw in batches:
            srv(raw)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(3):
            for raw in batches:
                srv(raw)
        torch.cuda.synchronize()
        return 3 * n_img / (time.perf_counter() - t)

    emit({"phase": "e2e", "batch": BATCH, "batches": N_BATCHES, "src_hw": SRC_HW,
          "launches": launches, "logit_max_abs_diff": dmax, "logit_max_abs": lmax,
          "logit_rel_diff": dmax / lmax, "logit_tol": LOGIT_TOL,
          "top1_agree": agree / n_img, "top1_min_share": TOP1_MIN_SHARE,
          "top1_clear_margin_images": decided,
          "top1_clear_margin_agree": decided_agree,
          "img_s_kernels": img_s(eng_k), "img_s_cudnn": img_s(eng_c),
          "card": smi})

    # ---- 5. the kernels line ----
    src = "tumblr_emotions_torch/csrc/inception_blocks.cu"
    replaces = {"fused_inception_a": f"{REPLACES}:230", "fused_inception_b": f"{REPLACES}:283",
                "conv_same_bias_relu": f"{REPLACES}:127", "avg_pool3_same": f"{REPLACES}:147"}
    kernels = []
    for name in ("fused_inception_a", "fused_inception_b", "conv_same_bias_relu",
                 "avg_pool3_same"):
        rs = rows[name]
        t_ops, t_bytes = sum(r["ops_ms"] for r in rs), sum(r["bytes_ms"] for r in rs)
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": sum(r["ms"] for r in rs), "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(r["bound_ms"] for r in rs),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": sum(r["library_ms"] for r in rs)})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
