"""How far a perf (bf16) train step on the card falls from the CPU's, beside
the CPU's own floor, over several batches.

    python -m tumblr_emotions_torch.perf_noise [--seeds 8] [--out FILE]

The joint model of ``tests/test_torch_cuda.py``'s perf step (depth 0.25,
139 px, batch 4, dropout off, RMSProp with global-norm clipping).  For each
batch seed it prints one JSON line: the relative loss distance and the
gradient distance (``train/noise_floor.distance``) of

- ``card``: the card's step against the CPU's;
- ``card_cpu_images``: the card's step fed the CPU's distorted images (the
  model alone differs);
- ``f64_floor``: the CPU's step with the bf16 layers' products accumulated
  in float64 against the CPU's (another summation order);
- ``card64``: the card's and the CPU's steps both under float64
  accumulation (what is left when neither sums convs in f32);

and how many bf16 values of the distorted images differ between the card
and the CPU.  A last line gives the means.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import numpy as np
import torch


def _cfg():
    from tumblr_emotions_torch import get_preset

    cfg = get_preset("joint_finetune")
    return cfg.replace(
        image=cfg.image.replace(image_size=139, depth_multiplier=0.25, dropout_keep_prob=1.0),
        text=cfg.text.replace(vocab_size=300, embed_dim=32, max_len=12),
        train=cfg.train.replace(batch_size=4, grad_clip_norm=1.0, precision_mode="perf"))


def _batch(seed: int) -> Dict[str, np.ndarray]:
    from tumblr_emotions_torch.data.vocab import synthetic_ids

    rng = np.random.RandomState(seed)
    tokens = synthetic_ids(rng, 4, 12, 300)
    return {"tokens": tokens, "lengths": (tokens != 0).sum(-1).astype(np.int32),
            "label": rng.randint(0, 15, 4).astype(np.int32),
            "image": rng.randint(0, 256, (4, 160, 170, 3)).astype(np.uint8)}


def _step(cfg, state, batch, draws, where, images=None):
    """(loss, gradients on the CPU, distorted images on the CPU)."""
    from tumblr_emotions_torch.train.trainer import Trainer

    tr = Trainer(cfg, preprocess="train", device=where)
    ts = tr.init_state(state)
    inputs = tr.train_inputs(batch, None, draws.to(where))
    if images is not None:
        inputs = dict(inputs, image=images.to(where))
    loss, _, grads = tr.loss_and_grads(ts, inputs)
    return (float(loss), {k: g.detach().cpu() for k, g in grads.items()},
            inputs["image"].detach().cpu())


def main(argv=None) -> int:
    from tumblr_emotions_torch.data import preprocessing as pp
    from tumblr_emotions_torch.models import build_model, joint_model
    from tumblr_emotions_torch.train import noise_floor

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("perf_noise needs an NVIDIA card")
    torch.set_grad_enabled(False)
    cfg = _cfg()
    state = joint_model.init_state(build_model(cfg, device="meta"), 0)
    rows = []
    for seed in range(1, args.seeds + 1):
        batch = _batch(seed)
        draws = pp.draw_train(torch.Generator().manual_seed(seed), 4, (160, 170))
        l_cpu, g_cpu, im_cpu = _step(cfg, state, batch, draws, "cpu")
        l_card, g_card, im_card = _step(cfg, state, batch, draws, "cuda")
        l_ci, g_ci, _ = _step(cfg, state, batch, draws, "cuda", images=im_cpu)
        with noise_floor.float64_accumulation():
            l_f64, g_f64, _ = _step(cfg, state, batch, draws, "cpu")
            l_c64, g_c64, _ = _step(cfg, state, batch, draws, "cuda", images=im_cpu)
        keys = [k for k in g_cpu if bool(g_cpu[k].any())]

        def d(loss, grads, ref_loss=l_cpu, ref=g_cpu):
            return {"loss": abs(loss - ref_loss) / abs(ref_loss),
                    "grads": noise_floor.distance(grads, None, ref, None, keys)}

        row = {"seed": seed, "card": d(l_card, g_card), "card_cpu_images": d(l_ci, g_ci),
               "f64_floor": d(l_f64, g_f64), "card64": d(l_c64, g_c64, l_f64, g_f64),
               "image_bf16_values_differing": int(
                   (im_card.to(torch.bfloat16) != im_cpu.to(torch.bfloat16)).sum()),
               "image_values": im_cpu.numel()}
        rows.append(row)
        print(json.dumps(row), flush=True)
    mean = {k: {m: float(np.mean([r[k][m] for r in rows])) for m in ("loss", "grads")}
            for k in ("card", "card_cpu_images", "f64_floor", "card64")}
    print(json.dumps({"mean": mean, "seeds": len(rows),
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "mean": mean}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
