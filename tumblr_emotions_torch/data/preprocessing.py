"""Image preprocessing with TF/slim ``inception_preprocessing`` semantics,
in PyTorch (port of ``tumblr_emotions_tpu/data/preprocessing.py``):

    eval:  uint8 -> [0, 1] -> central_crop(0.875) -> resize_bilinear(299,
           299, align_corners=False, half_pixel_centers=False) -> x*2 - 1
    train: distorted bounding-box crop -> bilinear resize -> random
           horizontal flip -> brightness and saturation in a random order
           -> x*2 - 1 (slim's fast mode, the one the trainer runs); full
           mode picks the resize per image among bilinear, nearest,
           bicubic and area, and chains brightness, saturation, hue and
           contrast in one of four orders

The resizes are two separable 1-D interpolations, each a dense [out, in]
matrix product (per image for the train crop).  In float32 they run in
full f32 on the card (no TF32), as the reference's ``Precision.HIGHEST``.
``preprocess_for_eval_s2d`` emits the 2x2 space-to-depth layout of the int8
engine's stem straight from the two resize products.

The train distortions are split into their random draws
(:func:`draw_train`, from a ``torch.Generator``) and a pure
:func:`apply_train` of those draws: random streams cannot match across
frameworks, so the tests feed the JAX package's draws to ``apply_train``.  Slim's
full mode (``fast_mode=False``) is reached by no trainer entry point, in
either package.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from tumblr_emotions_torch._device import full_f32


def _interp_matrix(out_size: int, in_size: int, method: str) -> np.ndarray:
    """Dense [out_size, in_size] bilinear interpolation matrix (f32).

    method: "tf1"        — legacy TF1 resize_bilinear: src = dst * in/out
            "half_pixel" — TF2 semantics: src = (dst+0.5)*in/out - 0.5
    """
    m = np.zeros((out_size, in_size), np.float32)
    if in_size == out_size:
        np.fill_diagonal(m, 1.0)
        return m
    # The source grid is computed in float32 as TF's kernels do; a float64
    # grid drifts by ~2e-5 against TF.
    scale = np.float32(in_size) / np.float32(out_size)
    for o in range(out_size):
        if method == "tf1":
            src = float(np.float32(o) * scale)
        elif method == "half_pixel":
            src = float((np.float32(o) + np.float32(0.5)) * scale - np.float32(0.5))
        else:
            raise ValueError(f"unknown resize method {method!r}")
        src = min(max(src, 0.0), in_size - 1)
        lo = int(np.floor(src))
        hi = min(lo + 1, in_size - 1)
        frac = src - lo
        m[o, lo] += 1.0 - frac
        m[o, hi] += frac
    return m


@functools.lru_cache(maxsize=64)
def _interp_matrix_cached(out_size: int, in_size: int, method: str) -> np.ndarray:
    m = _interp_matrix(out_size, in_size, method)
    m.flags.writeable = False
    return m


@functools.lru_cache(maxsize=64)
def _interp_tensor(out_size: int, in_size: int, method: str, dtype: torch.dtype,
                   device: torch.device, s2d: bool = False) -> torch.Tensor:
    """The interpolation matrix as a tensor on ``device``, uploaded once (an
    upload from pageable memory per batch would make the host wait for the
    card); ``s2d``: zero-padded to an even row count and reshaped to
    [out/2, 2, in]."""
    m = _interp_matrix_cached(out_size, in_size, method)
    if s2d:
        m = np.pad(m, ((0, -out_size % 2), (0, 0))).reshape(-1, 2, in_size)
    return torch.tensor(m, dtype=dtype, device=device)


def resize_bilinear(images: torch.Tensor, out_h: int, out_w: int,
                    method: str = "tf1",
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Batched NHWC bilinear resize as two matrix products."""
    n, h, w, c = images.shape
    dev = images.device
    rh = _interp_tensor(out_h, h, method, dtype, dev)
    rw = _interp_tensor(out_w, w, method, dtype, dev)
    x = images.to(dtype)
    with full_f32():
        x = torch.einsum("oh,nhwc->nowc", rh, x)
        return torch.einsum("pw,nowc->nopc", rw, x)


def central_crop_sizes(h: int, w: int, fraction: float) -> Tuple[int, int, int, int]:
    """tf.image.central_crop offsets and sizes (its integer arithmetic)."""
    off_h = int((h - h * fraction) / 2.0)
    off_w = int((w - w * fraction) / 2.0)
    return off_h, off_w, h - 2 * off_h, w - 2 * off_w


def preprocess_for_eval(images: torch.Tensor, height: int = 299, width: int = 299,
                        central_fraction: float = 0.875,
                        resize_method: str = "tf1",
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """slim preprocess_for_eval on an NHWC batch.

    images: [N, H, W, C] uint8 (0..255) or float already in [0, 1].
    Returns [N, height, width, C] in [-1, 1], in ``dtype``.
    """
    n, h, w, c = images.shape
    x = images.to(dtype)
    if not images.is_floating_point():
        x = _true_div(x, 255.0)  # tf.image.convert_image_dtype
    if central_fraction and central_fraction < 1.0:
        oh, ow, ch, cw = central_crop_sizes(h, w, central_fraction)
        x = x[:, oh:oh + ch, ow:ow + cw, :]
    x = resize_bilinear(x, height, width, method=resize_method, dtype=dtype)
    return x * 2.0 - 1.0


def space_to_depth_2x2(x: torch.Tensor) -> torch.Tensor:
    """[B,H,W,C] -> [B,ceil(H/2),ceil(W/2),4C]; odd H/W zero-pad at the end.

    A kxk stride-2 conv over [H,W,C] equals a ceil(k/2) x ceil(k/2)
    stride-1 conv over this layout with the kernel rearranged by
    ``ops.quant._s2d_kernel`` (the padded row/col only meets zero kernel
    taps).  Merged channel order is (dy, dx, c).
    """
    b, h, w, c = x.shape
    ph, pw = -h % 2, -w % 2
    if ph or pw:
        x = torch.nn.functional.pad(x, (0, 0, 0, pw, 0, ph))
    x = x.reshape(b, (h + ph) // 2, 2, (w + pw) // 2, 2, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h + ph) // 2, (w + pw) // 2, 4 * c)


def preprocess_for_eval_s2d(images: torch.Tensor, height: int = 299, width: int = 299,
                            central_fraction: float = 0.875,
                            resize_method: str = "tf1",
                            dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``preprocess_for_eval`` emitting the 2x2 space-to-depth layout directly.

    Returns [N, ceil(height/2), ceil(width/2), 4C] such that
    ``space_to_depth_2x2(preprocess_for_eval(images))`` holds (channel
    order (dy, dx, c)) on every real lane: the row and column interpolation
    matrices are reshaped to [out/2, 2, in], so the two resize products
    emit the (dy, dx) parity planes as separate dims and the merge to 4C is
    a reshape.  Same arithmetic in another contraction order, so bf16/f32
    results can differ from the non-s2d path by about one ulp.  For an odd
    height/width the padded parity plane holds -1 (the ``x*2 - 1`` of a
    zero row), where ``space_to_depth_2x2`` pads 0: it is inert, since the
    s2d kernel's padded taps are zero.
    """
    n, h, w, c = images.shape
    x = images.to(dtype)
    if not images.is_floating_point():
        x = _true_div(x, 255.0)
    if central_fraction and central_fraction < 1.0:
        oh, ow, ch, cw = central_crop_sizes(h, w, central_fraction)
        x = x[:, oh:oh + ch, ow:ow + cw, :]
        h, w = ch, cw
    ph, pw = -height % 2, -width % 2
    rh3 = _interp_tensor(height, h, resize_method, dtype, images.device, s2d=True)
    rw3 = _interp_tensor(width, w, resize_method, dtype, images.device, s2d=True)
    with full_f32():
        y = torch.einsum("idh,nhwc->nidwc", rh3, x)
        z = torch.einsum("jew,nidwc->nijdec", rw3, y)
    z = z.reshape(n, (height + ph) // 2, (width + pw) // 2, 4 * c)
    return z * 2.0 - 1.0


# ---------------------------------------------------------------------------
# Training-time distortions (slim preprocess_for_train).
# ---------------------------------------------------------------------------

CROP_ATTEMPTS = 100


def distorted_bounding_box_crop(generator: torch.Generator, n: int, image_hw: Tuple[int, int],
                                min_object_covered: float = 0.1,
                                aspect_ratio_range: Tuple[float, float] = (0.75, 1.333),
                                area_range: Tuple[float, float] = (0.05, 1.0),
                                max_attempts: int = CROP_ATTEMPTS, device=None):
    """Crop windows for ``n`` images of ``image_hw`` with
    ``tf.image.sample_distorted_bounding_box`` semantics (slim passes the
    whole image as the box), as the JAX package's sampler draws them:

    - the aspect ratio uniform over the range, in f32;
    - the crop height uniform over the integer band whose round-half-even
      width keeps the area inside ``area_range``, then the +-1-row
      corrections for rounding drift;
    - with the whole image as the box, ``min_object_covered`` asks
      ``crop_area / image_area >= 0.1``, so smaller crops are rejected;
    - offsets ``Uniform(H - h)``, so a crop never starts on the last
      admissible row unless it spans the image (TF's quirk);
    - the first of ``max_attempts`` attempts that satisfies every
      constraint wins, else the whole image.

    All attempts of all images are drawn at once, on ``device``.  Returns
    int64 ``(offset_y, offset_x, crop_h, crop_w)``, each ``[n]``."""
    h, w = image_hw
    area = float(h * w)
    min_area, max_area = area_range[0] * area, area_range[1] * area
    shape = (n, max_attempts)

    def uniform():
        return torch.rand(shape, generator=generator, device=device)

    def randint(span):  # integers uniform in [0, span), span >= 1
        return torch.minimum((uniform() * span).floor().long(), span - 1)

    lo_ar, hi_ar = aspect_ratio_range
    ar = lo_ar + (hi_ar - lo_ar) * uniform()

    def rw(height):  # round-half-even width, like TF's lrintf
        return torch.round(height.float() * ar).long()

    ch = torch.round(torch.sqrt(min_area / ar)).long()
    max_h = torch.round(torch.sqrt(max_area / ar)).long()
    # Shrink max_h until its rounded width fits inside the image.
    alt = torch.floor((w + 0.5 - 1e-7) / ar).long()
    alt = torch.where(rw(alt) > w, alt - 1, alt)
    max_h = torch.where(rw(max_h) > w, alt, max_h).clamp_max(h)
    ch = torch.minimum(ch, max_h)
    ch = ch + randint((max_h - ch + 1).clamp_min(1))
    cw = rw(ch)
    # +-1-row area corrections, then the validity test (TF's order).
    low = (cw * ch).float() < min_area
    ch = torch.where(low, ch + 1, ch)
    cw = torch.where(low, rw(ch), cw)
    high = (cw * ch).float() > max_area
    ch = torch.where(high, ch - 1, ch)
    cw = torch.where(high, rw(ch), cw)
    crop_area = (cw * ch).float()
    ok = ((crop_area >= min_area) & (crop_area <= max_area) & (cw <= w) & (ch <= h)
          & (cw > 0) & (ch > 0) & (crop_area / area >= min_object_covered))
    oy = torch.where(ch < h, randint((h - ch).clamp_min(1)), 0)
    ox = torch.where(cw < w, randint((w - cw).clamp_min(1)), 0)
    # The first attempt that is ok (argmax of a bool picks the first True),
    # else the whole image.
    first = ok.long().argmax(dim=1, keepdim=True)
    found = ok.any(dim=1)

    def pick(v, fallback):
        return torch.where(found, v.gather(1, first)[:, 0], fallback)

    return (pick(oy, 0), pick(ox, 0), pick(ch.clamp(1, h), h), pick(cw.clamp(1, w), w))


FULL_RESIZES = ("nearest", "bicubic", "area")   # full mode's cases after the configured one


@dataclasses.dataclass
class TrainDraws:
    """The random draws of one batch's train distortions, each ``[N]``: the
    crop window (``oy``, ``ox``, ``ch``, ``cw``), the horizontal flip, the
    brightness ``delta``, the saturation ``factor`` and the fast mode's
    colour order (``order``: brightness first).  Full mode adds the resize
    case (``resize``: 0 the configured method, then ``FULL_RESIZES``), the
    ``hue`` delta, the ``contrast`` factor and the colour chain (``chain``,
    one of four orders); they are None for a fast-mode batch."""

    oy: torch.Tensor
    ox: torch.Tensor
    ch: torch.Tensor
    cw: torch.Tensor
    flip: torch.Tensor
    delta: torch.Tensor
    factor: torch.Tensor
    order: torch.Tensor
    resize: Optional[torch.Tensor] = None
    hue: Optional[torch.Tensor] = None
    contrast: Optional[torch.Tensor] = None
    chain: Optional[torch.Tensor] = None

    def _map(self, fn) -> "TrainDraws":
        return TrainDraws(**{f.name: None if getattr(self, f.name) is None
                             else fn(getattr(self, f.name)) for f in dataclasses.fields(self)})

    def to(self, device) -> "TrainDraws":
        return self._map(lambda t: t.to(device))

    def rows(self, rows: slice) -> "TrainDraws":
        """The draws of ``rows`` of the batch (a process's rows of the
        global batch under data parallelism)."""
        return self._map(lambda t: t[rows])


def draw_train(generator: torch.Generator, n: int, image_hw: Tuple[int, int],
               device=None, fast_mode: bool = True) -> TrainDraws:
    """Draw one batch's distortions from ``generator`` (on ``device``): the
    crop as :func:`distorted_bounding_box_crop`, a fair coin for the flip
    and the order, the brightness delta uniform in [-32/255, 32/255) and
    the saturation factor uniform in [0.5, 1.5); for full mode then the
    resize case and the chain uniform over 4, the hue delta uniform in
    [-0.2, 0.2) and the contrast factor in [0.5, 1.5)."""
    oy, ox, ch, cw = distorted_bounding_box_crop(generator, n, image_hw, device=device)

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=generator, device=device)

    def four():
        return torch.randint(0, 4, (n,), generator=generator, device=device)

    flip = torch.rand(n, generator=generator, device=device) < 0.5
    delta = uniform(-32.0 / 255.0, 32.0 / 255.0)
    factor = uniform(0.5, 1.5)
    order = torch.rand(n, generator=generator, device=device) < 0.5
    d = TrainDraws(oy, ox, ch, cw, flip, delta, factor, order)
    if not fast_mode:
        d.resize, d.hue, d.contrast, d.chain = four(), uniform(-0.2, 0.2), uniform(0.5, 1.5), \
            four()
    return d


def _true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded as IEEE division, as the reference divides: on the
    card PyTorch divides by a Python scalar as a product with its
    reciprocal, which moves a quotient by an ulp and, under a floor, moves
    a nearest or bicubic tap by a whole pixel."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _crop_resize_matrix(out_size: int, off: torch.Tensor, size: torch.Tensor,
                        in_size: int, method: str) -> torch.Tensor:
    """Dense [N, out_size, in_size] matrices of a per-image crop (``off``,
    ``size``: [N]) and resize, in the reference's f32 arithmetic
    (``_crop_resize_matrix``):

    - ``tf1`` (``src = o * scale``), ``half_pixel`` and its alias
      ``bilinear``: the weight at input column ``i`` is
      ``relu(1 - |i - src(o)|)``;
    - ``nearest``: TF1's ``min(floor(o * scale), size - 1)``;
    - ``bicubic``: TF1's Keys kernel (A = -0.75) over the 4 taps around
      ``floor(o * scale)``, each clamped into the crop;
    - ``area``: the overlap of input cell ``i`` with ``[o, o+1) * scale``,
      over ``scale``."""
    dev = off.device
    scale = _true_div(size.float(), out_size)                       # [N]
    o = torch.arange(out_size, dtype=torch.float32, device=dev)
    i = torch.arange(in_size, dtype=torch.float32, device=dev)
    offf = off.float()
    if method in ("tf1", "half_pixel", "bilinear"):
        if method == "half_pixel":
            src = (o[None, :] + 0.5) * scale[:, None] - 0.5
        else:
            src = o[None, :] * scale[:, None]
        src = torch.minimum(src.clamp_min(0.0), size.float()[:, None] - 1.0)
        src = src + offf[:, None]                                   # [N, out]
        return (1.0 - (i[None, None, :] - src[:, :, None]).abs()).clamp_min(0.0)
    if method == "nearest":
        idx = torch.minimum(torch.floor(o[None, :] * scale[:, None]),
                            size.float()[:, None] - 1)
        idx = idx + offf[:, None]
        return (i[None, None, :] == idx[:, :, None]).float()
    if method == "bicubic":
        a = -0.75
        src = o[None, :] * scale[:, None]                           # [N, out]
        p = torch.floor(src)
        t = src - p

        def edge(s):
            return ((a * s - 5.0 * a) * s + 8.0 * a) * s - 4.0 * a

        def center(s):
            return ((a + 2.0) * s - (a + 3.0)) * s * s + 1.0

        wts = [edge(1.0 + t), center(t), center(1.0 - t), edge(2.0 - t)]
        hi = size.float()[:, None] - 1.0
        m = torch.zeros(off.shape[0], out_size, in_size, device=dev)
        for k in range(4):
            tap = torch.minimum((p + (k - 1)).clamp_min(0.0), hi) + offf[:, None]
            m = m + wts[k][:, :, None] * (i[None, None, :] == tap[:, :, None]).float()
        return m
    if method == "area":
        start = o[None, :] * scale[:, None]                         # [N, out]
        end = (o[None, :] + 1.0) * scale[:, None]
        i_rel = i[None, None, :] - offf[:, None, None]              # [N, 1, in]
        overlap = (torch.minimum(i_rel + 1.0, end[:, :, None])
                   - torch.maximum(i_rel, start[:, :, None]))
        return overlap.clamp_min(0.0) / scale[:, None, None]
    raise ValueError(f"unknown resize method {method!r}")


def _resize_matrices(d: TrainDraws, height: int, width: int, h: int, w: int,
                     method: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The row and column matrices of each image: ``method``'s, or in full
    mode (``d.resize`` set) the per-image case's, picked among the
    matrices (not among resized outputs)."""
    if d.resize is None:
        return (_crop_resize_matrix(height, d.oy, d.ch, h, method),
                _crop_resize_matrix(width, d.ox, d.cw, w, method))
    cases = (method,) + FULL_RESIZES
    pick = d.resize[:, None, None]
    my = torch.zeros(d.oy.shape[0], height, h, device=d.oy.device)
    mx = torch.zeros(d.oy.shape[0], width, w, device=d.oy.device)
    for k, m in enumerate(cases):
        my = torch.where(pick == k, _crop_resize_matrix(height, d.oy, d.ch, h, m), my)
        mx = torch.where(pick == k, _crop_resize_matrix(width, d.ox, d.cw, w, m), mx)
    return my, mx


def _crop_resize_batch(images: torch.Tensor, d: TrainDraws, height: int, width: int,
                       method: str, in_scale: float = 1.0) -> torch.Tensor:
    """Batched crop and resize as two matrix products, [N,H,W,C] ->
    [N,height,width,C] f32: the flip reverses the rows of the width matrix
    (a permutation, so equal to flipping afterwards), and ``in_scale``
    (1/255 for uint8) is folded into the row matrix."""
    n, h, w, c = images.shape
    my, mx = _resize_matrices(d, height, width, h, w, method)
    mx = torch.where(d.flip[:, None, None], mx.flip(1), mx)
    if in_scale != 1.0:
        my = my * in_scale
    with full_f32():
        x = torch.einsum("noh,nhwc->nowc", my, images.float())
        return torch.einsum("npw,nowc->nopc", mx, x)


def _saturate(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """``tf.image.adjust_saturation`` elementwise: scaling HSV saturation by
    ``factor`` keeps the value (the max) and the hue, so each channel moves
    toward the max by the chroma ratio ``min(factor, max/chroma)`` (the min
    is the s <= 1 clip)."""
    im = img.clamp(0.0, 1.0)
    mx = im.amax(dim=-1, keepdim=True)
    d = mx - im.amin(dim=-1, keepdim=True)
    ratio = torch.minimum(factor, mx / torch.where(d > 0, d, torch.ones_like(d)))
    return torch.where(d > 0, mx - ratio * (mx - im), im)


def _distort_color_fast_batch(x: torch.Tensor, d: TrainDraws) -> torch.Tensor:
    """slim's fast-mode colour distortion per image: brightness then
    saturation where ``order``, else saturation then brightness."""
    delta, factor = d.delta[:, None, None, None], d.factor[:, None, None, None]
    a = _saturate(x + delta, factor)
    b = _saturate(x, factor) + delta
    return torch.where(d.order[:, None, None, None], a, b)


def _floor_mod(x: torch.Tensor, y: float) -> torch.Tensor:
    """``jnp.remainder`` for a positive float ``y``: C's ``fmod`` (exact),
    moved into [0, y) (``torch.remainder`` rounds ``x - floor(x/y)*y``)."""
    m = torch.fmod(x, y)
    return torch.where((m != 0) & (m < 0), m + y, m)


def rgb_to_hsv(img: torch.Tensor) -> torch.Tensor:
    """RGB [..., 3] in [0,1] -> HSV, matching tf.image.rgb_to_hsv, in the
    reference's operation order."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    mx = img.amax(dim=-1)
    mn = img.amin(dim=-1)
    d = mx - mn
    safe_d = torch.where(d > 0, d, torch.ones_like(d))
    h_r = _floor_mod((g - b) / safe_d, 6.0)
    h_g = (b - r) / safe_d + 2.0
    h_b = (r - g) / safe_d + 4.0
    h = _true_div(torch.where(mx == r, h_r, torch.where(mx == g, h_g, h_b)), 6.0)
    h = torch.where(d > 0, h, torch.zeros_like(h))
    s = torch.where(mx > 0, d / torch.where(mx > 0, mx, torch.ones_like(mx)),
                    torch.zeros_like(mx))
    return torch.stack([h, s, mx], dim=-1)


def hsv_to_rgb(img: torch.Tensor) -> torch.Tensor:
    """HSV [..., 3] -> RGB, matching tf.image.hsv_to_rgb: the sector
    ``int(h * 6) % 6`` of each pixel picks its channels, as the reference
    selects them."""
    h, s, v = img[..., 0], img[..., 1], img[..., 2]
    c = s * v
    m = v - c
    dh = _floor_mod(h, 1.0) * 6.0
    x = c * (1.0 - (_floor_mod(dh, 2.0) - 1.0).abs())
    idx = dh.to(torch.int32) % 6
    z = torch.zeros_like(c)

    def select(values, default):   # sector 5 is the default
        out = default
        for k in reversed(range(5)):
            out = torch.where(idx == k, values[k], out)
        return out

    r = select([c, x, z, z, x], c)
    g = select([x, c, c, x, z], z)
    b = select([z, z, x, c, c], x)
    return torch.stack([r + m, g + m, b + m], dim=-1)


def _hue_rotate(img: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """tf.image.adjust_hue with a per-image [N,1,1] delta, elementwise."""
    hsv = rgb_to_hsv(img.clamp(0.0, 1.0))
    h = _floor_mod(hsv[..., 0] + delta, 1.0)
    return hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))


def _contrast(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    mean = img.mean(dim=(-3, -2), keepdim=True)
    return mean + (img - mean) * factor


def _distort_color_full_batch(x: torch.Tensor, d: TrainDraws) -> torch.Tensor:
    """slim's full-mode colour distortion per image: brightness,
    saturation, hue and contrast in the order ``d.chain`` picks (all four
    chains computed elementwise, then selected, as the reference does)."""
    delta, sat_f = d.delta[:, None, None, None], d.factor[:, None, None, None]
    hue_d, con_f = d.hue[:, None, None], d.contrast[:, None, None, None]

    def bright(im):
        return im + delta

    def sat(im):
        return _saturate(im, sat_f)

    def hue(im):
        return _hue_rotate(im, hue_d)

    def con(im):
        return _contrast(im, con_f)

    chains = [con(hue(sat(bright(x)))),
              hue(con(bright(sat(x)))),
              bright(sat(con(hue(x)))),
              sat(bright(con(hue(x))))]
    case = d.chain[:, None, None, None]
    out = chains[3]
    for k in reversed(range(3)):
        out = torch.where(case == k, chains[k], out)
    return out


def _adjust_saturation(img: torch.Tensor, factor) -> torch.Tensor:
    """tf.image.adjust_saturation by the exact HSV scaling."""
    hsv = rgb_to_hsv(img.clamp(0.0, 1.0))
    s = (hsv[..., 1] * factor).clamp(0.0, 1.0)
    return hsv_to_rgb(torch.stack([hsv[..., 0], s, hsv[..., 2]], dim=-1))


def _adjust_hue(img: torch.Tensor, delta) -> torch.Tensor:
    """tf.image.adjust_hue by the exact HSV rotation."""
    hsv = rgb_to_hsv(img.clamp(0.0, 1.0))
    h = _floor_mod(hsv[..., 0] + delta, 1.0)
    return hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))


def _adjust_contrast(img: torch.Tensor, factor) -> torch.Tensor:
    mean = img.mean(dim=(0, 1), keepdim=True)
    return mean + (img - mean) * factor


def distort_color(img: torch.Tensor, delta, saturation, hue, contrast, order: int,
                  fast_mode: bool = True) -> torch.Tensor:
    """slim ``distort_color`` of one [H,W,3] image with its draws given:
    brightness ``delta``, ``saturation`` factor, ``hue`` delta and
    ``contrast`` factor, in ordering ``order`` (one of 2 in fast mode, of 4
    in full mode), each adjustment as TF computes it."""
    def bright(im):
        return im + delta

    def sat(im):
        return _adjust_saturation(im, saturation)

    def hue_(im):
        return _adjust_hue(im, hue)

    def con(im):
        return _adjust_contrast(im, contrast)

    if fast_mode:
        chains = [lambda im: sat(bright(im)), lambda im: bright(sat(im))]
    else:
        chains = [lambda im: con(hue_(sat(bright(im)))),
                  lambda im: hue_(con(bright(sat(im)))),
                  lambda im: bright(sat(con(hue_(im)))),
                  lambda im: sat(bright(con(hue_(im))))]
    return chains[int(order)](img)


def apply_train(images: torch.Tensor, draws: TrainDraws, height: int = 299,
                width: int = 299, resize_method: str = "tf1",
                fast_mode: bool = True) -> torch.Tensor:
    """The train distortions of ``draws`` on an NHWC batch (uint8, or float
    in [0, 1]) -> [N, height, width, C] f32 in [-1, 1]: the reference's
    ``preprocess_for_train`` with its draws given; ``fast_mode=False``
    takes full-mode draws (``draw_train(fast_mode=False)``)."""
    if not fast_mode and draws.resize is None:
        raise ValueError("full mode needs full-mode draws (draw_train(fast_mode=False))")
    if fast_mode:
        draws = dataclasses.replace(draws, resize=None)
    in_scale = 1.0 if images.is_floating_point() else 1.0 / 255.0
    x = _crop_resize_batch(images, draws, height, width, resize_method, in_scale)
    x = _distort_color_fast_batch(x, draws) if fast_mode else \
        _distort_color_full_batch(x, draws)
    return x.clamp(0.0, 1.0) * 2.0 - 1.0


def preprocess_for_train(generator: torch.Generator, images: torch.Tensor,
                         height: int = 299, width: int = 299, resize_method: str = "tf1",
                         fast_mode: bool = True) -> torch.Tensor:
    """slim ``preprocess_for_train`` over a batch on its device, drawing
    from ``generator`` (on that device): distorted crop, resize (per image
    among four methods in full mode), random flip, colour distortion,
    scale to [-1, 1], in f32."""
    n, h, w, _ = images.shape
    draws = draw_train(generator, n, (h, w), device=images.device, fast_mode=fast_mode)
    return apply_train(images, draws, height, width, resize_method, fast_mode=fast_mode)
