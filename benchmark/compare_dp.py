"""The comparison that decides ``correct`` in a data-parallel training cell.

Against the float32 reference over the global batch (``reference_dp``):

- ``grad_gap``: the worst leaf's gap between the program's and the
  reference's norm of the first gradient, over the leaf's scale: the
  larger of its reference norm and the median leaf's norm, or, for an
  ill-conditioned leaf (:data:`ILL`), the norm of its terms' summed
  magnitudes (``reference_dp.terms``).  A conv layer's ``beta`` and
  ``weights`` receive sums over the global batch's positions whose terms
  nearly cancel, so the float32 sum is tens to a thousand times smaller
  than its terms, and a step in another precision, which rounds each term,
  moves the sum by that rounding times the terms: on the float32 scale
  alone (``compare.leaf_gaps``) the bf16 step's first convs and their
  ``beta`` read 0.2-0.7 where its median leaf reads 0.006;
- ``change_gap`` and ``change_gap.median``: the worst and the median leaf's
  gap of the parameters' change over the first steps, over the larger of
  the median leaf's change and the leaf's own, times its gradient's
  conditioning for an ill-conditioned leaf (its terms' scale over its
  reference norm): with RMSProp's epsilon of 1.0 the first steps' changes
  are the learning rate times sums of the gradients, cancellation
  included.  Leaves whose reference gradient is under a thousandth of the
  median leaf's are left out, as in ``compare.train_gaps``;
- ``head_gap.text`` and ``head_gap.aux``: element by element, the norm of
  the gap between the program's and the reference's first gradient
  magnitudes over the reference's norm, on two leaves that no train-mode
  batch norm follows: the word embedding (its gradient is the joint dense
  layer's input gradient, gathered by word) and the auxiliary head's last
  conv.  At initialisation train-mode batch norm answers a rounding
  anywhere in the tower by moving most leaves' gradients element by element
  as far as any other change would (0.79-0.84 over the whole gradient, for
  bf16 and fp8 alike), and their norms alike; these two leaves move with
  the precision of the operations that make them.

The first step's loss and the median leaf's gradient gap are not held: at
initialisation the loss is about log 15 whatever the step computes in, and
no control or fault moves either number far above the sound step's
(PERF.md).

And among the processes (``rank_gaps``): every process applies the same
all-reduced gradient and moves its batch norms to the same global
statistics, so each holds the same state.  ``rank_gap``: the largest
relative difference, over the state's leaves (parameters and batch norms'
moving statistics) and the processes, of the squared norm of the state's
change over the first steps from process 0's.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from benchmark import compare


# A leaf whose terms' summed magnitudes are above this many times its
# float32 norm is read on its terms' scale (187 of the cell's 199 leaves,
# PERF.md); below it the terms barely cancel and the float32 norm is the
# scale.
ILL = 10.0
# The leaves of ``head_gap``: (name, leaf).
HEAD = (("head_gap.text", "Text.WordEmbedding/embeddings"),
        ("head_gap.aux", "InceptionV3.AuxLogits/Conv2d_2b_1x1.weights"))


def conditioning(ref: Dict) -> Dict[str, float]:
    """Each leaf's terms' scale over its reference norm where that is above
    :data:`ILL`, else 1."""
    g = compare.norms(ref["grad_abs"])
    terms = compare.norms(ref.get("terms", {}))
    return {k: terms[k] / g[k] if g[k] > 0 and terms.get(k, 0.0) > ILL * g[k] else 1.0
            for k in g}


def scales(ref: Dict) -> Dict[str, float]:
    """Each leaf's gradient scale: the larger of its reference norm and the
    median leaf's norm, or its terms' summed magnitudes where the leaf is
    ill-conditioned."""
    g = compare.norms(ref["grad_abs"])
    med = float(np.median(list(g.values())))
    cond = conditioning(ref)
    return {k: max(g[k] * cond[k], med) for k in g}


def _gaps(prog: Dict[str, float], ref: Dict[str, float], scale: Dict[str, float],
          keys: Iterable[str]) -> Dict[str, float]:
    return {k: abs(prog[k] - ref[k]) / max(scale[k], 1e-30) if np.isfinite(prog[k])
            else float("inf") for k in keys}


def _worst(gaps: Dict[str, float]) -> Tuple[float, str]:
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def _median(gaps: Dict[str, float]) -> Tuple[float, str]:
    return float(np.median(list(gaps.values()))), f"median of {len(gaps)} leaves"


def head_gaps(prog: Dict, ref: Dict) -> Dict[str, Tuple[float, str]]:
    """``head_gap.*`` for the :data:`HEAD` leaves the model has."""
    out = {}
    for name, k in HEAD:
        if k in ref["grad_abs"]:
            a, b = prog["grad_abs"][k].double(), ref["grad_abs"][k].double()
            gap = float((a - b).norm() / b.norm()) if bool(torch.isfinite(a).all()) \
                else float("inf")
            out[name] = (gap, k)
    return out


def train_gaps(prog: Dict, ref: Dict) -> Dict[str, Tuple[float, str]]:
    g_ref, c_ref = compare.norms(ref["grad_abs"]), compare.norms(ref["change"])
    g_prog = compare.norms(prog["grad_abs"])
    keys = list(g_ref)
    cond = conditioning(ref)
    med = float(np.median([g_ref[k] for k in keys]))
    moved = [k for k in keys if g_ref[k] >= 1e-3 * med]
    c_med = float(np.median([c_ref[k] for k in moved]))
    sc = {k: max(c_ref[k] * cond[k], c_med) for k in moved}
    change = _gaps(compare.norms(prog["change"]), c_ref, sc, moved)
    return dict({"grad_gap": _worst(_gaps(g_prog, g_ref, scales(ref), keys)),
                 "change_gap": _worst(change), "change_gap.median": _median(change)},
                **head_gaps(prog, ref))


def change_digest(state: Dict, start: Dict) -> List[float]:
    """Per leaf of ``state`` (sorted keys): the squared norm of its change
    from ``start``, in float64."""
    return [float((state[k].detach().double() - start[k].double()).pow(2).sum())
            for k in sorted(state)]


def rank_gaps(digests: List[List[float]], keys: List[str]) -> Dict[str, Tuple[float, str]]:
    """``rank_gap`` from each process's ``change_digest`` (process 0's
    first) over the sorted ``keys``."""
    worst, where = 0.0, "every leaf equal"
    base = digests[0]
    for r, d in enumerate(digests[1:], 1):
        for k, a, b in zip(keys, d, base):
            gap = abs(a - b) / b if b > 0 else (float("inf") if a != b else 0.0)
            if gap > worst:
                worst, where = gap, f"{k} on process {r}"
    return {"rank_gap": (worst, where)}
