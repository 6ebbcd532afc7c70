"""The plain reference of TF-Slim's ``inception_preprocessing``, in PyTorch.

- eval: uint8 -> [0, 1] -> ``tf.image.central_crop(0.875)`` -> TF1's
  legacy ``resize_bilinear`` (``align_corners=False``, no half-pixel
  centres: source ``o * in / out``) -> ``x * 2 - 1``;
- train (slim's fast mode): ``sample_distorted_bounding_box`` with the whole
  image as the box (``min_object_covered`` 0.1, aspect ratio [0.75, 1.333],
  area [0.05, 1], 100 attempts), the crop resized bilinearly, a random
  horizontal flip, brightness (delta in [-32/255, 32/255)) and saturation
  (factor in [0.5, 1.5)) in a random order, clipped to [0, 1], ``* 2 - 1``.

The train distortions draw from a ``torch.Generator`` in a fixed order of
calls (the crop's aspect ratios, heights and two offsets as [N, 100]
uniforms, then the flip, the brightness, the saturation and the order as
[N] uniforms), so a generator seeded alike on the same device draws the
same distortions.  The resizes are computed in float64 and returned in
float32.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

ATTEMPTS = 100


def central_crop(h: int, w: int, fraction: float) -> Tuple[int, int, int, int]:
    """``tf.image.central_crop``'s offsets and sizes."""
    oh, ow = int((h - h * fraction) / 2.0), int((w - w * fraction) / 2.0)
    return oh, ow, h - 2 * oh, w - 2 * ow


def tf1_matrix(out_size: int, in_size: int) -> np.ndarray:
    """[out, in] weights of TF1's legacy bilinear resize (its source grid
    in float32, as TF's kernel computes it)."""
    m = np.zeros((out_size, in_size), np.float64)
    scale = np.float32(in_size) / np.float32(out_size)
    for o in range(out_size):
        src = min(float(np.float32(o) * scale), in_size - 1)
        lo = int(np.floor(src))
        hi = min(lo + 1, in_size - 1)
        m[o, lo] += 1.0 - (src - lo)
        m[o, hi] += src - lo
    return m


def eval_images(u8: torch.Tensor, size: int = 299, fraction: float = 0.875) -> torch.Tensor:
    """uint8 [N,H,W,3] -> [N,size,size,3] float32 in [-1, 1]."""
    n, h, w, _ = u8.shape
    oh, ow, ch, cw = central_crop(h, w, fraction)
    x = u8[:, oh:oh + ch, ow:ow + cw].double() / 255.0
    rh = torch.from_numpy(tf1_matrix(size, ch)).to(u8.device)
    rw = torch.from_numpy(tf1_matrix(size, cw)).to(u8.device)
    x = torch.einsum("oh,nhwc->nowc", rh, x)
    x = torch.einsum("pw,nowc->nopc", rw, x)
    return (x * 2.0 - 1.0).float()


def draw(generator: torch.Generator, n: int, hw: Tuple[int, int]) -> Dict[str, torch.Tensor]:
    """One batch's distortions: the crop window (``oy``, ``ox``, ``ch``,
    ``cw``), ``flip``, brightness ``delta``, saturation ``factor`` and
    ``bright_first``, each [N], on the generator's device."""
    dev = generator.device
    h, w = hw
    area = float(h * w)
    lo_area, hi_area = 0.05 * area, 1.0 * area

    def u():
        return torch.rand((n, ATTEMPTS), generator=generator, device=dev)

    def below(v, span):   # integer uniform in [0, span)
        return torch.minimum((v * span).floor().long(), span - 1)

    ar = 0.75 + (1.333 - 0.75) * u()

    def width(height):   # TF rounds the width half to even
        return torch.round(height.float() * ar).long()

    # the height is uniform over the integers whose width keeps the area in range
    ch = torch.round(torch.sqrt(lo_area / ar)).long()
    hi_h = torch.round(torch.sqrt(hi_area / ar)).long()
    fit = torch.floor((w + 0.5 - 1e-7) / ar).long()
    fit = torch.where(width(fit) > w, fit - 1, fit)
    hi_h = torch.where(width(hi_h) > w, fit, hi_h).clamp_max(h)
    ch = torch.minimum(ch, hi_h)
    ch = ch + below(u(), (hi_h - ch + 1).clamp_min(1))
    cw = width(ch)
    small = (cw * ch).float() < lo_area
    ch = torch.where(small, ch + 1, ch)
    cw = torch.where(small, width(ch), cw)
    big = (cw * ch).float() > hi_area
    ch = torch.where(big, ch - 1, ch)
    cw = torch.where(big, width(ch), cw)
    a = (cw * ch).float()
    ok = (a >= lo_area) & (a <= hi_area) & (cw <= w) & (ch <= h) & (cw > 0) & (ch > 0) \
        & (a / area >= 0.1)
    # TF draws the offset uniform over [0, H - h): the last row only when h == H
    oy = torch.where(ch < h, below(u(), (h - ch).clamp_min(1)), 0)
    ox = torch.where(cw < w, below(u(), (w - cw).clamp_min(1)), 0)
    first = ok.long().argmax(1, keepdim=True)
    found = ok.any(1)

    def pick(v, whole):
        return torch.where(found, v.gather(1, first)[:, 0], whole)

    out = {"oy": pick(oy, 0), "ox": pick(ox, 0), "ch": pick(ch.clamp(1, h), h),
           "cw": pick(cw.clamp(1, w), w)}
    out["flip"] = torch.rand(n, generator=generator, device=dev) < 0.5
    out["delta"] = -32.0 / 255.0 + (64.0 / 255.0) * torch.rand(n, generator=generator,
                                                               device=dev)
    out["factor"] = 0.5 + 1.0 * torch.rand(n, generator=generator, device=dev)
    out["bright_first"] = torch.rand(n, generator=generator, device=dev) < 0.5
    return out


def _crop_matrix(out_size: int, off: torch.Tensor, size: torch.Tensor, in_size: int
                 ) -> torch.Tensor:
    """[N, out, in] bilinear weights of each image's crop resized to
    ``out_size`` (TF1's grid: source ``o * size / out`` within the crop)."""
    scale = size.float() / torch.full((), float(out_size), device=off.device)
    o = torch.arange(out_size, dtype=torch.float32, device=off.device)
    src = torch.minimum((o[None] * scale[:, None]).clamp_min(0), size.float()[:, None] - 1)
    src = (src + off.float()[:, None]).double()
    i = torch.arange(in_size, dtype=torch.float64, device=off.device)
    return (1.0 - (i[None, None] - src[:, :, None]).abs()).clamp_min(0.0)


def rgb_to_hsv(x):
    r, g, b = x.unbind(-1)
    mx, mn = x.amax(-1), x.amin(-1)
    c = mx - mn
    safe = torch.where(c > 0, c, torch.ones_like(c))
    h = torch.where(mx == r, torch.remainder((g - b) / safe, 6.0),
                    torch.where(mx == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0)) / 6.0
    h = torch.where(c > 0, h, torch.zeros_like(h))
    s = torch.where(mx > 0, c / torch.where(mx > 0, mx, torch.ones_like(mx)),
                    torch.zeros_like(mx))
    return h, s, mx


def hsv_to_rgb(h, s, v):
    c = s * v
    hp = torch.remainder(h, 1.0) * 6.0
    x = c * (1.0 - (torch.remainder(hp, 2.0) - 1.0).abs())
    z = torch.zeros_like(c)
    sector = hp.long() % 6
    table = [(c, x, z), (x, c, z), (z, c, x), (z, x, c), (x, z, c), (c, z, x)]
    rgb = [torch.zeros_like(c) for _ in range(3)]
    for k, trio in enumerate(table):
        for ch in range(3):
            rgb[ch] = torch.where(sector == k, trio[ch], rgb[ch])
    m = v - c
    return torch.stack([rgb[0] + m, rgb[1] + m, rgb[2] + m], -1)


def saturate(x, factor):
    """``tf.image.adjust_saturation`` of images in [0, 1]: HSV saturation
    scaled by ``factor`` [N,1,1] and clipped to [0, 1]."""
    h, s, v = rgb_to_hsv(x.clamp(0.0, 1.0))
    return hsv_to_rgb(h, (s * factor).clamp(0.0, 1.0), v)


def train_images(u8: torch.Tensor, d: Dict[str, torch.Tensor], size: int = 299) -> torch.Tensor:
    """uint8 [N,H,W,3] and its draws -> [N,size,size,3] float32 in [-1, 1]."""
    n, h, w, _ = u8.shape
    my = _crop_matrix(size, d["oy"], d["ch"], h)
    mx = _crop_matrix(size, d["ox"], d["cw"], w)
    mx = torch.where(d["flip"][:, None, None], mx.flip(1), mx)
    x = torch.einsum("noh,nhwc->nowc", my, u8.double() / 255.0)
    x = torch.einsum("npw,nowc->nopc", mx, x).float()
    delta = d["delta"][:, None, None, None]
    factor = d["factor"][:, None, None]
    a = saturate(x + delta, factor)
    b = saturate(x, factor) + delta
    x = torch.where(d["bright_first"][:, None, None, None], a, b)
    return x.clamp(0.0, 1.0) * 2.0 - 1.0
