"""The optimizers of the JAX trainer, computed as optax computes them.

Counterpart of the optax transforms that
``tumblr_emotions_tpu/train/trainer.py:116-147`` composes, written out by
hand because ``torch.optim`` differs on the points that matter:

- RMSProp (``optax.rmsprop`` with ``eps_in_sqrt=True``): ``nu = d*nu +
  (1-d)*g^2`` from 0, ``u = g * rsqrt(nu + eps)`` (eps inside the square
  root; slim's eps is 1.0), ``u *= -lr(count)``, then the momentum trace
  ``t = u + m*t`` on the lr-scaled update (kept at momentum 0 too, as
  optax keeps it), ``p += t``.
  ``torch.optim.RMSprop`` puts eps outside the root and applies momentum
  before the learning rate.
- Adam (``optax.adam``): b1 0.9, b2 0.999, eps 1e-8 outside the root,
  both moments bias-corrected with ``t = count + 1``.
- SGD (``optax.sgd``): the momentum trace on the raw gradients, then
  ``-lr``; no trace when momentum is 0.
- The learning rate: ``optax.exponential_decay(staircase=True)``, ``lr *
  rate**floor(count / steps)`` with ``count`` the number of updates
  already applied, or constant.  Computed on the host in float32, as are
  Adam's bias corrections (:meth:`Optimizer.scalars`); the update reads
  them from a float32 tensor on the device (:meth:`Optimizer.apply`), so a
  captured step takes each update's values as an input, and divides by
  them as IEEE division (on the card PyTorch divides a tensor list by a
  Python scalar as a product with its reciprocal).  Adam's square root is
  correctly rounded on both devices (:func:`correctly_rounded_sqrt`), so
  its update on the card is the CPU's bit for bit; RMSProp's ``rsqrt`` is
  PyTorch's on each device.
- ``optax.clip_by_global_norm`` ahead of the optimizer, over the leaves it
  updates: with frozen scopes that is the trainable leaves only, as in the
  reference's ``multi_transform`` partition.

Only trainable leaves are given to :meth:`Optimizer.update`: frozen ones get
no state and no update.  The state is a dict: ``count`` (int, updates
applied) and per-leaf moments keyed by the parameter's state-dict key,
``nu`` and ``trace`` (RMSProp), ``mu`` and ``nu`` (Adam), ``trace`` (SGD
with momentum).  ``convert.opt_state_to_optax`` / ``opt_state_from_optax``
carry it to and from the optax state tree.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from tumblr_emotions_torch.config import TrainConfig

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
OPTIMIZERS = ("rmsprop", "adam", "sgd")


def learning_rate(t: TrainConfig, count: int) -> float:
    """The learning rate of update number ``count`` (0-based) as optax's
    schedule gives it, a float32 value."""
    lr = np.float32(t.learning_rate)
    if t.lr_decay_steps > 0 and count > 0:
        p = np.floor(np.float32(count) / np.float32(t.lr_decay_steps))
        lr = lr * np.power(np.float32(t.lr_decay_factor), p)
    return float(np.float32(lr))


class Optimizer:
    """The update rule ``TrainConfig`` names (``optimizer``, its
    hyper-parameters, ``grad_clip_norm``), on dicts of tensors."""

    def __init__(self, t: TrainConfig):
        if t.optimizer not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {t.optimizer!r}; expected one of {OPTIMIZERS}")
        self.t = t
        # optax.rmsprop keeps its trace even at momentum 0; optax.sgd has
        # one only for a non-zero momentum (the trainer passes ``momentum or
        # None``).
        self.moments = {"rmsprop": ("nu", "trace"),
                        "adam": ("mu", "nu"),
                        "sgd": ("trace",) if t.momentum else ()}[t.optimizer]

    def init(self, params: Dict[str, torch.Tensor]) -> Dict:
        """Zero moments for the leaves of ``params`` (the trainable ones)."""
        state: Dict = {"count": 0}
        for m in self.moments:
            state[m] = {k: torch.zeros_like(p) for k, p in params.items()}
        return state

    def scalars(self, count: int) -> np.ndarray:
        """The per-update host scalars of update number ``count``, in float32:
        ``[-lr, bc1, bc2]`` (Adam's bias corrections ``1 - b**(count+1)``; 1
        for the others), computed on the host as optax's float32 schedule
        gives them.  :meth:`apply` reads them from a tensor, so a captured
        step takes each update's values as an input instead of baking in the
        first's."""
        c = count + 1
        bc1 = np.float32(1) - np.float32(ADAM_B1) ** c if self.t.optimizer == "adam" else 1
        bc2 = np.float32(1) - np.float32(ADAM_B2) ** c if self.t.optimizer == "adam" else 1
        return np.asarray([-learning_rate(self.t, count), bc1, bc2], np.float32)

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
               state: Dict) -> Dict:
        """Apply one update to ``params`` in place from ``grads`` (same
        keys) and advance ``state`` in place; returns ``state``."""
        dev = next(iter(params.values())).device if params else torch.device("cpu")
        self.apply(params, grads, state, self.device_scalars(state["count"], dev))
        state["count"] += 1
        return state

    def device_scalars(self, count: int, device: torch.device) -> torch.Tensor:
        """:meth:`scalars` as a tensor on ``device`` (through pinned memory
        on the card, so the copy does not wait for the card's queue)."""
        host = torch.from_numpy(self.scalars(count))
        if device.type == "cuda":
            host = host.pin_memory()
        return host.to(device, non_blocking=True)

    @torch.no_grad()
    def apply(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
              state: Dict, scalars: torch.Tensor) -> None:
        """The update of :meth:`update` on the device, in place, with the
        per-update values ``scalars`` (:meth:`scalars`, a float32 tensor on
        ``params``' device); ``state["count"]`` is left to the caller."""
        t = self.t
        keys = list(params)
        p = [params[k] for k in keys]
        g = [grads[k] for k in keys]
        if t.grad_clip_norm > 0:
            g = _clip_by_global_norm(g, t.grad_clip_norm)
        neg_lr, bc1, bc2 = scalars.unbind()
        if t.optimizer == "rmsprop":
            d = t.rmsprop_decay
            nu = [state["nu"][k] for k in keys]
            g2 = torch._foreach_mul(g, g)
            torch._foreach_mul_(g2, 1.0 - d)
            torch._foreach_mul_(nu, d)
            torch._foreach_add_(nu, g2)                    # d*nu + (1-d)*g^2
            u = torch._foreach_add(nu, t.rmsprop_epsilon)
            torch._foreach_rsqrt_(u)
            torch._foreach_mul_(u, g)                      # g * rsqrt(nu + eps)
            torch._foreach_mul_(u, neg_lr)
            u = _trace(state, keys, u, t.momentum)         # u + m*t
        elif t.optimizer == "adam":
            mu = [state["mu"][k] for k in keys]
            nu = [state["nu"][k] for k in keys]
            g1 = torch._foreach_mul(g, 1.0 - ADAM_B1)
            torch._foreach_mul_(mu, ADAM_B1)
            torch._foreach_add_(mu, g1)
            g2 = torch._foreach_mul(g, g)
            torch._foreach_mul_(g2, 1.0 - ADAM_B2)
            torch._foreach_mul_(nu, ADAM_B2)
            torch._foreach_add_(nu, g2)
            den = correctly_rounded_sqrt(torch._foreach_div(nu, bc2))
            torch._foreach_add_(den, ADAM_EPS)             # sqrt(nu_hat) + eps
            u = torch._foreach_div(mu, bc1)                # mu_hat
            torch._foreach_div_(u, den)
            torch._foreach_mul_(u, neg_lr)
        else:  # sgd
            u = _trace(state, keys, g, t.momentum) if t.momentum else list(g)
            u = torch._foreach_mul(u, neg_lr)
        torch._foreach_add_(p, u)


def correctly_rounded_sqrt(ts: List[torch.Tensor]) -> List[torch.Tensor]:
    """The float32 square roots of ``ts``, correctly rounded, as the card's
    and the reference's (XLA's) are: PyTorch's vectorised float32 sqrt on
    the CPU is not always (it misses in a fraction of a percent of values,
    so Adam's update on the CPU and on the card differed); a float64 root
    rounded to float32 is (53 bits cover 2 x 24 + 2)."""
    roots = [t.double() for t in ts]
    torch._foreach_sqrt_(roots)
    return [t.float() for t in roots]


def _trace(state: Dict, keys: List[str], u: List[torch.Tensor], decay: float
           ) -> List[torch.Tensor]:
    """optax.trace: ``t = u + decay * t`` in place; returns the new traces."""
    tr = [state["trace"][k] for k in keys]
    torch._foreach_mul_(tr, decay)
    torch._foreach_add_(tr, u)
    return tr


def _clip_by_global_norm(g: List[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """optax.clip_by_global_norm: unchanged when the global norm is below
    ``max_norm``, else ``(g / norm) * max_norm``; decided on the device."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
    keep = norm < max_norm
    den = torch.where(keep, torch.ones_like(norm), norm)
    num = torch.where(keep, torch.ones_like(norm), torch.full_like(norm, max_norm))
    out = torch._foreach_div(g, den)
    torch._foreach_mul_(out, num)
    return out
