"""The comparisons that decide ``correct``: each returns numbers that are
held against the cell's limits (``limits`` in its workload file).

- serving: ``logit_gap``, the widest gap, over the sampled posts and the
  15 classes, between the program's and the reference's
  log-probabilities, each centred on its row's mean (the logits up to the
  softmax's constant); ``logit_gap.rel``, that widest gap over the median
  of the same gap between neighbouring posts' reference answers (each
  sampled post against the one before it).  How far two posts' answers
  lie apart follows the seed's weights, and so does the int8 engine's
  rounding; against that scale (on an H100, 15 seeds at batch 8 and 64)
  the int8 engine read 0.22-0.51 and answers given to the wrong posts
  2.5-6.1, where the widest gap alone read 0.07-0.22 and 0.69-3.4.
- training: ``loss_gap.step1``, the relative gap of the first step's
  loss; ``grad_gap`` and ``change_gap``, the worst leaf's gap between the
  program's and the reference's norm of the first gradient (the program's
  read from its RMSProp state after one step) and of the parameters'
  change over the first steps, each against the larger of the
  reference's norm of that leaf and of the median leaf;
  ``grad_gap.median``, the median leaf's gradient gap.  The change leaves
  out leaves whose reference gradient is under a thousandth of the median
  leaf's: they move by round-off alone.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np


def logit_gaps(p_prog: np.ndarray, p_ref: np.ndarray) -> Dict[str, float]:
    p_prog, p_ref = np.asarray(p_prog, np.float64), np.asarray(p_ref, np.float64)
    if p_prog.shape != p_ref.shape or not np.isfinite(p_prog).all():
        return {"logit_gap": float("inf"), "logit_gap.rel": float("inf")}
    lp, lr = np.log(np.clip(p_prog, 1e-30, None)), np.log(np.clip(p_ref, 1e-30, None))
    lp -= lp.mean(1, keepdims=True)
    lr -= lr.mean(1, keepdims=True)
    widest = float(np.abs(lp - lr).max())
    apart = float(np.median(np.abs(lr - np.roll(lr, 1, 0)).max(1)))
    return {"logit_gap": widest, "logit_gap.rel": widest / max(apart, 1e-30)}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keys: Iterable[str]
              ) -> Dict[str, float]:
    keys = list(keys)
    med = float(np.median([ref[k] for k in keys]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) if np.isfinite(prog[k])
            else float("inf") for k in keys}


def worst_and_median(prog, ref, keys) -> Tuple[Tuple[float, str], Tuple[float, str]]:
    gaps = leaf_gaps(prog, ref, keys)
    worst = max(gaps, key=gaps.get)
    return (gaps[worst], worst), (float(np.median(list(gaps.values()))),
                                  f"median of {len(gaps)} leaves")


def norms(leaves: Dict) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in leaves.items()}


def diff_norms(a: Dict, b: Dict) -> Dict[str, float]:
    return {k: float((a[k].double() - b[k].double()).norm()) for k in b}


def train_gaps(prog: Dict, ref: Dict) -> Dict[str, Tuple[float, str]]:
    a, b = prog["loss"][0], ref["loss"][0]
    loss = abs(a - b) / abs(b) if np.isfinite(a) else float("inf")
    g_ref, c_ref = norms(ref["grad_abs"]), norms(ref["change"])
    keys = list(g_ref)
    med = float(np.median([g_ref[k] for k in keys]))
    moved = [k for k in keys if g_ref[k] >= 1e-3 * med]
    grad = worst_and_median(norms(prog["grad_abs"]), g_ref, keys)
    change = worst_and_median(norms(prog["change"]), {k: c_ref[k] for k in moved}, moved)
    return {"loss_gap.step1": (loss, "step 1"), "grad_gap": grad[0],
            "grad_gap.median": grad[1], "change_gap": change[0]}
