"""Streaming classification metrics: accuracy, per-class recall and
precision, the confusion matrix.

Port of ``tumblr_emotions_tpu/utils/metrics.py``.  Each batch gives a dict
of sufficient statistics (integer tensors on the batch's device) that adds
up across batches, so an evaluation keeps them on the card and reads them
back once at the end, whatever the number of batches.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch


def batch_stats(logits: torch.Tensor, labels: torch.Tensor, num_classes: int,
                weights: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """One batch's ``count``, ``correct`` and ``confusion`` ([C, C]: row the
    true class, column the prediction), int64 and exact.  ``weights``
    (0/1 per row) masks padding rows out of all three."""
    preds = logits.argmax(dim=-1)
    labels = labels.long()
    w = (torch.ones_like(labels) if weights is None
         else torch.as_tensor(weights, device=labels.device).long())
    confusion = torch.zeros(num_classes * num_classes, dtype=torch.long, device=labels.device)
    confusion.scatter_add_(0, labels * num_classes + preds, w)
    return {"count": w.sum(), "correct": ((preds == labels).long() * w).sum(),
            "confusion": confusion.view(num_classes, num_classes)}


def merge_stats(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    return {k: a[k] + b[k] for k in a}


def summarize(stats: Dict, class_names: Optional[Sequence[str]] = None) -> Dict:
    """Final metrics from merged statistics (tensors or arrays): top-1
    accuracy, per-class recall and precision, the confusion matrix."""
    confusion = np.asarray(torch.as_tensor(stats["confusion"]).cpu(), np.float64)
    count = float(stats["count"])
    correct = float(stats["correct"])
    true_tot = confusion.sum(axis=1)
    pred_tot = confusion.sum(axis=0)
    diag = np.diag(confusion)
    with np.errstate(divide="ignore", invalid="ignore"):
        recall = np.where(true_tot > 0, diag / true_tot, 0.0)
        precision = np.where(pred_tot > 0, diag / pred_tot, 0.0)
    out = {
        "accuracy": correct / max(count, 1.0),
        "count": int(count),
        "per_class_recall": recall,
        "per_class_precision": precision,
        "confusion": confusion,
    }
    if class_names is not None:
        out["per_class"] = {
            name: {"recall": float(recall[i]), "precision": float(precision[i]),
                   "support": int(true_tot[i])}
            for i, name in enumerate(class_names)
        }
    return out


def format_per_class(summary: Dict) -> str:
    """Human-readable per-emotion table."""
    lines = [f"accuracy: {summary['accuracy']:.4f}  (n={summary['count']})"]
    per = summary.get("per_class", {})
    if per:
        lines.append(f"{'emotion':<12} {'recall':>8} {'precision':>10} {'support':>8}")
        for name, m in per.items():
            lines.append(
                f"{name:<12} {m['recall']:>8.4f} {m['precision']:>10.4f} "
                f"{m['support']:>8d}")
    return "\n".join(lines)
