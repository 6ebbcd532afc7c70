"""Emotion-structure analysis: the paper's circumplex and the qualitative
examples.

The port's own copy of ``tumblr_emotions_tpu/analysis.py`` (host numpy; the
port imports nothing of the JAX package).  The paper's notebooks project
the trained model's 15-dim softmax outputs with PCA and recover a
valence/arousal "circumplex" structure of emotions.  Given the prediction
vectors over a split, this module PCAs the per-emotion means and reports
each emotion's coordinates in the first two components plus the explained
variance, and browses the most confident hits, misses and confusion pairs.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from tumblr_emotions_torch.config import EMOTIONS


def pca(x: np.ndarray, n_components: int = 2
        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Plain SVD PCA: returns (projected, components [k,D], explained_ratio)."""
    x = np.asarray(x, np.float64)
    mean = x.mean(axis=0)
    xc = x - mean
    u, s, vt = np.linalg.svd(xc, full_matrices=False)
    var = (s ** 2) / max(len(x) - 1, 1)
    ratio = var / var.sum()
    comps = vt[:n_components]
    return xc @ comps.T, comps, ratio[:n_components]


def circumplex(probs: np.ndarray, labels: np.ndarray,
               emotions: Sequence[str] = EMOTIONS,
               n_components: int = 2) -> Dict:
    """PCA of per-class mean prediction vectors -> circumplex coordinates.

    probs: [N, C] softmax outputs; labels: [N] true class ids.
    Returns {"coords": {emotion: [pc1, pc2]}, "explained_variance": [...]}.
    """
    probs = np.asarray(probs, np.float64)
    labels = np.asarray(labels)
    C = probs.shape[1]
    means = np.stack([
        probs[labels == c].mean(axis=0) if np.any(labels == c)
        else np.zeros(C) for c in range(C)])
    projected, comps, ratio = pca(means, n_components)
    return {
        "coords": {emotions[c]: projected[c].tolist() for c in range(C)},
        "components": comps.tolist(),
        "explained_variance": ratio.tolist(),
    }


def angular_order(coords: Dict[str, List[float]]) -> List[str]:
    """Emotions ordered by angle around the circumplex (paper-style view)."""
    def angle(xy):
        return float(np.arctan2(xy[1], xy[0]))

    return sorted(coords, key=lambda e: angle(coords[e]))


def format_circumplex(result: Dict) -> str:
    lines = [
        "PCA of per-emotion mean predictions "
        f"(explained variance: {', '.join(f'{r:.2f}' for r in result['explained_variance'])})",
        f"{'emotion':<12} {'pc1':>8} {'pc2':>8}",
    ]
    for e in angular_order(result["coords"]):
        x, y = result["coords"][e][:2]
        lines.append(f"{e:<12} {x:>8.4f} {y:>8.4f}")
    return "\n".join(lines)


def qualitative_examples(probs: np.ndarray, labels: np.ndarray,
                         emotions: Sequence[str] = EMOTIONS,
                         k: int = 5) -> Dict:
    """Per-emotion example browsing (the half of the paper's notebook
    analysis beyond the circumplex): for each emotion, the ``k`` most-confident CORRECT
    predictions and the ``k`` most-confident MISCLASSIFICATIONS (examples
    of that true emotion the model pushed elsewhere), plus the most
    frequent confusion pairs overall.

    ``probs`` [N, C] softmax outputs, ``labels`` [N] true ids.  Examples
    are referenced by their row index into the split's record order — the
    caller resolves indices to post ids/texts (``cli analyze`` does).
    """
    probs = np.asarray(probs, np.float64)
    labels = np.asarray(labels)
    preds = probs.argmax(axis=1)
    C = probs.shape[1]
    per_emotion: Dict[str, Dict] = {}
    for c in range(C):
        mine = np.nonzero(labels == c)[0]
        correct = mine[preds[mine] == c]
        wrong = mine[preds[mine] != c]
        c_order = correct[np.argsort(-probs[correct, c])][:k]
        w_order = wrong[np.argsort(-probs[wrong, preds[wrong]])][:k]
        per_emotion[emotions[c]] = {
            "count": int(mine.size),
            "accuracy": float((preds[mine] == c).mean()) if mine.size else 0.0,
            "correct": [{"index": int(i), "prob": float(probs[i, c])}
                        for i in c_order],
            "misclassified": [{"index": int(i),
                               "pred": emotions[int(preds[i])],
                               "prob": float(probs[i, preds[i]]),
                               "true_prob": float(probs[i, c])}
                              for i in w_order],
        }
    # Confusion pairs (true != pred), most frequent first, with the
    # highest-confidence exemplar indices for browsing.
    pairs: Dict[Tuple[int, int], List[int]] = {}
    for i in np.nonzero(preds != labels)[0]:
        pairs.setdefault((int(labels[i]), int(preds[i])), []).append(int(i))
    confusions = []
    for (t, p), idxs in sorted(pairs.items(), key=lambda kv: -len(kv[1])):
        idxs = sorted(idxs, key=lambda i: -probs[i, preds[i]])
        confusions.append({"true": emotions[t], "pred": emotions[p],
                           "count": len(idxs), "examples": idxs[:k]})
    return {"per_emotion": per_emotion, "confusions": confusions,
            "n": int(len(labels)),
            "accuracy": float((preds == labels).mean()) if len(labels)
            else 0.0}


def format_examples(result: Dict, lookup=None, max_confusions: int = 10
                    ) -> str:
    """Human-readable qualitative report.  ``lookup(index) -> str`` resolves
    a row index to a display string (post id / text snippet); defaults to
    the bare index."""
    show = lookup or (lambda i: f"#{i}")
    lines = [f"qualitative examples over {result['n']} posts "
             f"(overall accuracy {result['accuracy']:.3f})", ""]
    for emotion, block in result["per_emotion"].items():
        lines.append(f"== {emotion} (n={block['count']}, "
                     f"acc {block['accuracy']:.3f}) ==")
        for ex in block["correct"]:
            lines.append(f"  hit  p={ex['prob']:.3f}  {show(ex['index'])}")
        for ex in block["misclassified"]:
            lines.append(f"  miss p={ex['prob']:.3f} -> {ex['pred']:<10} "
                         f"{show(ex['index'])}")
        lines.append("")
    lines.append("top confusion pairs (true -> predicted):")
    for c in result["confusions"][:max_confusions]:
        lines.append(f"  {c['true']:<10} -> {c['pred']:<10} x{c['count']}")
    return "\n".join(lines)


def write_examples_report(result: Dict, path: str, lookup=None,
                          title: str = "Qualitative emotion analysis"
                          ) -> str:
    """Markdown report next to the circumplex plot: per-emotion top-k
    confident hits/misses with resolved post text, and a confusion-pair
    browser.  ``lookup(index) -> str`` as in :func:`format_examples`."""
    show = lookup or (lambda i: f"#{i}")
    md = [f"# {title}", "",
          f"{result['n']} posts; overall accuracy "
          f"{result['accuracy']:.3f}.", ""]
    for emotion, block in result["per_emotion"].items():
        md.append(f"## {emotion} — n={block['count']}, "
                  f"accuracy {block['accuracy']:.3f}")
        if block["correct"]:
            md.append("\nMost-confident correct predictions:\n")
            md += [f"- `p={ex['prob']:.3f}` {show(ex['index'])}"
                   for ex in block["correct"]]
        if block["misclassified"]:
            md.append("\nMost-confident misclassifications:\n")
            md += [f"- `p={ex['prob']:.3f}` predicted **{ex['pred']}** "
                   f"(true-class p={ex['true_prob']:.3f}) "
                   f"{show(ex['index'])}"
                   for ex in block["misclassified"]]
        md.append("")
    md.append("## Confusion pairs\n")
    md.append("| true | predicted | count | examples |")
    md.append("|---|---|---|---|")
    for c in result["confusions"]:
        exs = "; ".join(show(i) for i in c["examples"][:3])
        md.append(f"| {c['true']} | {c['pred']} | {c['count']} | {exs} |")
    md.append("")
    with open(path, "w") as f:
        f.write("\n".join(md))
    return path


def plot_circumplex(result: Dict, path: str) -> str:
    """Render the circumplex as a labeled scatter (the reference notebooks'
    figure).  One neutral mark hue; identity rides the direct text labels
    (15 categorical colors would be unreadable); recessive axes.

    Requires matplotlib, an optional extra (not a dependency of the
    port): without it this raises ``RuntimeError``.
    """
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "plot_circumplex needs matplotlib (pip install matplotlib)"
        ) from e

    coords = result["coords"]
    ratio = result["explained_variance"]
    xs = np.array([coords[e][0] for e in coords])
    ys = np.array([coords[e][1] for e in coords])

    fig, ax = plt.subplots(figsize=(7, 7), dpi=150)
    ax.axhline(0, color="#d4d4d4", lw=1, zorder=0)
    ax.axvline(0, color="#d4d4d4", lw=1, zorder=0)
    # Unit-ish circle guide at the median radius (circumplex reading aid).
    r = float(np.median(np.hypot(xs, ys)))
    ax.add_patch(plt.Circle((0, 0), r, fill=False, color="#e5e5e5",
                            lw=1, zorder=0))
    ax.scatter(xs, ys, s=48, color="#3b5bd9", zorder=2)
    for e in coords:
        x, y = coords[e][:2]
        off = 0.02 * max(np.abs(xs).max(), np.abs(ys).max(), 1e-9)
        ax.annotate(e, (x, y), xytext=(x + off, y + off), fontsize=10,
                    color="#1f1f1f", zorder=3)
    ax.set_xlabel(f"PC1 ({ratio[0]:.0%} var)", color="#525252")
    ax.set_ylabel(f"PC2 ({ratio[1]:.0%} var)", color="#525252")
    ax.set_title("Emotion circumplex (PCA of per-emotion mean predictions)",
                 fontsize=11)
    ax.set_aspect("equal")
    ax.margins(0.14)  # keep edge labels inside the axes
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    for s in ("left", "bottom"):
        ax.spines[s].set_color("#a3a3a3")
    ax.tick_params(colors="#525252", labelsize=8)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path
