"""The one traffic generator: a cell's pool of batches from its traffic
parameters (``benchmark/workloads/<cell>.json``, key ``traffic``) and the
run's seed.

- ``images``: uint8 [B, H, W, 3], drawn on the card: each a random
  ``grid`` x ``grid`` colour field resized bilinearly to H x W, plus
  Gaussian pixel noise of ``noise`` levels (``image_style``, by default
  ``IMAGE_STYLE``).  Uniform noise images all look
  alike to the network (its global pool averages them to one feature), so
  every post would get about the same answer and an answer given to the
  wrong post could not be told from a right one.
- ``captions``: ``max_len`` ids per post, a length per post and pad (0)
  past it.  The lengths are the same multiset for every seed (the
  quantiles of a log-normal with the given median and sigma, rounded into
  [1, max_len]), in an order the seed draws, so no seed changes the work;
  the ids are Zipf(``zipf_s``) over the vocabulary's ranks, skipping the
  reserved ids (pad, out-of-vocabulary).
- ``labels``: uniform over ``num_classes``.

Every array is handed to the program on the host (numpy), as ``cli infer``
and the server's batcher hand them.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

IMAGE_STYLE = {"grid": 2, "noise": 16.0}
STREAMS = {"images": 1, "captions": 2, "labels": 3, "weights": 4, "steps": 5, "sample": 6,
           "calibration": 7}


def seed_of(seed: int, stream: str, index: int = 0) -> int:
    """A 63-bit seed for one stream of the run, from the run's seed."""
    ss = np.random.SeedSequence([int(seed) & (2**64 - 1), STREAMS[stream], index])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def style(p: Dict) -> Dict:
    """The traffic's ``image_style``: ``IMAGE_STYLE`` unless it says otherwise."""
    return p.get("image_style", IMAGE_STYLE)


def images(seed: int, stream: str, n: int, hw, device, style: Dict) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed_of(seed, stream))
    out = torch.empty((n, hw[0], hw[1], 3), dtype=torch.uint8, device=device)
    for i in range(0, n, 64):
        k = min(64, n - i)
        low = 255.0 * torch.rand((k, 3, style["grid"], style["grid"]), generator=g,
                                 device=device)
        x = F.interpolate(low, size=tuple(hw), mode="bilinear", align_corners=False)
        x += style["noise"] * torch.randn(x.shape, generator=g, device=device)
        out[i:i + k] = x.clamp_(0, 255).round_().to(torch.uint8).permute(0, 2, 3, 1)
    return out


def caption_lengths(n: int, median: float, sigma: float, max_len: int) -> np.ndarray:
    """The same ``n`` lengths for every seed: log-normal quantiles."""
    z = np.array([statistics.NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.clip(np.round(median * np.exp(sigma * z)), 1, max_len).astype(np.int32)


def captions(seed: int, n: int, p: Dict) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed_of(seed, "captions"))
    max_len, vocab, reserved = p["max_len"], p["vocab_size"], p["reserved_ids"]
    lengths = rng.permutation(caption_lengths(n, p["median_len"], p["sigma"], max_len))
    ranks = np.arange(1, vocab - reserved + 1, dtype=np.float64)
    cdf = np.cumsum(ranks ** -p["zipf_s"])
    ids = np.searchsorted(cdf / cdf[-1], rng.random((n, max_len))) + reserved
    ids[np.arange(max_len)[None, :] >= lengths[:, None]] = 0
    return {"tokens": ids.astype(np.int32), "lengths": lengths}


def pool(seed: int, p: Dict, device) -> List[Dict[str, np.ndarray]]:
    """``p["pool_batches"]`` distinct batches of ``p["batch"]`` posts."""
    b, k = p["batch"], p["pool_batches"]
    img = images(seed, "images", b * k, p["image_hw"], device, style(p)).cpu().numpy()
    cap = captions(seed, b * k, p["captions"])
    out = []
    for i in range(k):
        rows = slice(i * b, (i + 1) * b)
        batch = {"image": img[rows], "tokens": cap["tokens"][rows],
                 "lengths": cap["lengths"][rows]}
        if "num_classes" in p:
            rng = np.random.default_rng(seed_of(seed, "labels", i))
            batch["label"] = rng.integers(0, p["num_classes"], b).astype(np.int64)
        out.append(batch)
    return out
