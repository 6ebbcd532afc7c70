"""The plain reference of the joint model's train step, in float32 PyTorch.

One step: the fast-mode train distortions (``preprocess.draw`` then
``preprocess.train_images``), the joint model in train mode (batch
statistics, dropout before ``PreLogits``), slim's loss (mean softmax
cross-entropy of the joint logits, ``aux_loss_weight`` times that of the
aux logits, and ``weight_decay * sum(w^2) / 2`` over conv and dense
kernels), its gradient by autograd, and RMSProp as TF-Slim's fine-tuning
sets it up through optax: ``nu = d*nu + (1-d)*g^2`` from zero, ``u = -lr *
g / sqrt(nu + eps)``, a momentum trace ``t = u + m*t``, ``p += t``.  Each
step's draws come from a generator on the batch's device seeded with that
step's seed.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from benchmark.reference import model, preprocess


def l2_keys(params) -> List[str]:
    return [k for k in params if k.rsplit(".", 1)[-1] in ("weights", "kernel")]


def trainable_keys(params) -> List[str]:
    return [k for k in params if k.rsplit(".", 1)[-1] not in ("moving_mean", "moving_variance")]


def loss(params, batch: Dict[str, torch.Tensor], generator: torch.Generator, hp,
         quant: Optional[model.Quant] = None, rows: slice = slice(None)) -> torch.Tensor:
    """The step's loss; ``rows`` limits the cross-entropy terms to some of
    the rows (a control's fault: the mean over part of the batch)."""
    image = batch["image"]
    d = preprocess.draw(generator, image.shape[0], tuple(image.shape[1:3]))
    x = preprocess.train_images(image, d, hp["image_size"])
    out = model.joint_forward(params, x, batch["tokens"], batch["lengths"], quant=quant,
                              depth_multiplier=hp["depth_multiplier"],
                              num_classes=hp["num_classes"], train=True,
                              keep_prob=hp["dropout_keep_prob"], eps=hp["bn_epsilon"],
                              generator=generator)
    label = batch["label"].long()[rows]
    total = F.cross_entropy(out["Logits"][rows], label) + \
        hp["aux_loss_weight"] * F.cross_entropy(out["AuxLogits"][rows], label)
    return total + hp["weight_decay"] * 0.5 * sum((params[k] ** 2).sum() for k in l2_keys(params))


def run_steps(params0: Dict[str, torch.Tensor], batches, seeds, hp,
              quant: Optional[model.Quant] = None, rows: slice = slice(None),
              tf32: bool = False) -> Dict:
    """``len(batches)`` steps from ``params0`` (left unchanged):
    ``{"loss": [per step], "grad_abs": {leaf: |step 1's gradient|},
    "change": {leaf: params after the last step - params0}}``, the leaves'
    tensors on the host."""
    keys = trainable_keys(params0)
    params = dict(params0)
    for k in keys:
        params[k] = params0[k].detach().clone().requires_grad_(True)
    nu = {k: torch.zeros_like(params[k]) for k in keys}
    trace = {k: torch.zeros_like(params[k]) for k in keys}
    losses, grad_abs = [], None
    with model.exact_f32(tf32):
        for batch, seed in zip(batches, seeds):
            gen = torch.Generator(device=batch["image"].device).manual_seed(int(seed))
            value = loss(params, batch, gen, hp, quant, rows)
            grads = torch.autograd.grad(value, [params[k] for k in keys], allow_unused=True)
            grads = [torch.zeros_like(params[k]) if g is None else g
                     for k, g in zip(keys, grads)]
            losses.append(float(value.detach()))
            if grad_abs is None:
                grad_abs = {k: g.detach().abs().cpu() for k, g in zip(keys, grads)}
            with torch.no_grad():
                for k, g in zip(keys, grads):
                    nu[k].mul_(hp["rmsprop_decay"]).add_((1.0 - hp["rmsprop_decay"]) * g * g)
                    u = -hp["learning_rate"] * g * torch.rsqrt(nu[k] + hp["rmsprop_epsilon"])
                    trace[k].mul_(hp["momentum"]).add_(u)
                    params[k].add_(trace[k])
            del grads, value
    change = {k: (params[k].detach() - params0[k]).cpu() for k in keys}
    return {"loss": losses, "grad_abs": grad_abs, "change": change}
