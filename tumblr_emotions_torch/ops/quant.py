"""int8 post-training-quantized Inception-v3 serving engine, in PyTorch.

Port of ``tumblr_emotions_tpu/ops/quant.py``, the program the JAX package
serves by default.  Every conv is quantized:

- **Weights**: per-output-channel symmetric int8 over the BN-folded kernels
  (``w_q[..., c] = round(w[..., c] / s_w[c])``, ``s_w[c] = max|w[..., c]|/127``).
- **Activations**: per-tensor symmetric int8 with static scales from a
  one-shot calibration pass (max |activation| at every conv site over a
  calibration batch), so the requantization fuses into the conv epilogue.
- **Epilogue** (``epilogue="shift"``, the served default): weight scales are
  constrained per channel so the requant is ``clamp((acc + b_i) >> k, 0,
  127)``; a conv whose channels would need 0 <= k <= 24 violated falls back
  to the f32 epilogue ``clip(acc * m + bq, 0, 127)``.

The tower topology is written once (``_tower``) against an abstract op set
and interpreted twice: ``_CalibOps`` (calibration, once at construction)
and ``_Int8Ops`` (the served forward).  The numpy functions behind the
constants (``_channel_quantize``, ``quantize_weights``, ``_s2d_kernel``,
``_Int8Ops._weights``) are copies of the reference's numpy, so their
results are bit-equal to it.

On the card the convs are ``ops.int8_conv.conv_int8`` (one launch per conv,
a packed 1x1 included, its epilogue chosen per branch) and the max pools
``ops.int8_pool.maxpool3x3s2_int8``.  Tensors flow as ``(int8 tensor,
scale)`` pairs.  Each branch's last op writes straight into its channel
slice of the block's output buffer, so a concat of int8 branches (which
share one scale, as the reference asserts) allocates nothing.  The pool
branch's ``pool_act`` (either ``pool_mode``) and the last block's dequantized
bf16 outputs are PyTorch ops, as the reference leaves them to XLA.

The uint8 front (``preprocess_for_eval_int8``, ``forward_from_uint8``) is
central crop, centring to int8 and the TF1 resize as two s8 x s8 -> s32
GEMMs (``torch._int_mm`` on the card, as the reference leaves them to XLA's
einsum; an exact float64 product on the CPU), with the requantisation and
the engine's input quantisation as PyTorch ops.

Calibration computes in f32 on bf16-rounded operands with TF32 off, which is
what the reference's ``preferred_element_type=f32`` does up to summation
order: the scales are close to the reference's, not bit-equal.
"""

from __future__ import annotations

import copy
import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tumblr_emotions_torch._device import full_f32, resolve_device
from tumblr_emotions_torch.data.preprocessing import (
    _interp_matrix_cached, central_crop_sizes, space_to_depth_2x2)
from tumblr_emotions_torch.models.layers import linear_f64, max_pool, to_nchw, to_nhwc
from tumblr_emotions_torch.ops.fused_inception import fold_batchnorm
from tumblr_emotions_torch.ops.int8_conv import (
    Epilogue, conv_int8, conv_int8_plain, conv_padding)
from tumblr_emotions_torch.ops.int8_pool import maxpool3x3s2_int8, maxpool3x3s2_int8_plain

_INT8_MIN, _INT8_MAX = -127.0, 127.0

# Sentinel for ``out_key``: requantize to the conv's own scope key.  An
# explicit ``None`` means "dequantize to bf16" (final block).
_SELF = "_SELF"

Folded = Dict[str, Tuple[np.ndarray, np.ndarray]]


def _channel_quantize(w: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-output-channel symmetric int8: (w_q, s_w) with
    s_w[c] = max|w[..., c]|/127 (zero channels get scale 1)."""
    w = np.asarray(w, np.float32)
    s_w = np.max(np.abs(w), axis=(0, 1, 2)) / 127.0
    s_w = np.where(s_w == 0.0, 1.0, s_w).astype(np.float32)
    w_q = np.clip(np.round(w / s_w), _INT8_MIN, _INT8_MAX).astype(np.int8)
    return w_q, s_w


def quantize_weights(folded: Folded
                     ) -> Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Per-output-channel symmetric int8 quantization of folded conv kernels.

    Returns {scope: (w_q int8 [kh,kw,Cin,Cout], s_w f32 [Cout], b f32 [Cout])}.
    """
    out = {}
    for scope, (w, b) in folded.items():
        w_q, s_w = _channel_quantize(w)
        out[scope] = (w_q, s_w, np.asarray(b, np.float32))
    return out


def _s2d_kernel(w: np.ndarray) -> np.ndarray:
    """Rearrange a [kh,kw,C,O] stride-2 kernel for the space-to-depth
    input layout: [ceil(kh/2), ceil(kw/2), 4C, O], channel order
    (dy, dx, c), padded taps zero.  Applied to the already-quantized int8
    kernel so the transform is bit-exact (zeros are exactly
    representable)."""
    kh, kw, c, o = w.shape
    ph, pw = -kh % 2, -kw % 2
    wp = np.zeros((kh + ph, kw + pw, c, o), w.dtype)
    wp[:kh, :kw] = w
    w2 = wp.reshape((kh + ph) // 2, 2, (kw + pw) // 2, 2, c, o)
    w2 = w2.transpose(0, 2, 1, 3, 4, 5)
    return w2.reshape((kh + ph) // 2, (kw + pw) // 2, 4 * c, o)


def fold_hwio(state: Dict[str, torch.Tensor]) -> Folded:
    """BN-folded weights of a port state dict in the reference's layout:
    {scope: (w [kh,kw,Cin,Cout] f32, b [Cout] f32)} as numpy (bit-equal to
    the JAX package's ``fold_batchnorm``)."""
    return {s: (w.permute(2, 3, 1, 0).numpy(), b.numpy())
            for s, (w, b) in fold_batchnorm(state).items()}


@functools.lru_cache(maxsize=32)
def _in_image_taps(H: int, W: int, device: torch.device) -> torch.Tensor:
    """[1,H,W,1] f32 count of the in-image taps of a 3x3 SAME window."""
    ones = F.pad(torch.ones(H, W, device=device), (1, 1, 1, 1))
    n = sum(ones[dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3))
    return n[None, :, :, None]


def _window_sum_3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME window sum of NHWC: the nine taps summed in window
    order over a zero border."""
    B, H, W, C = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    s = xp[:, 0:H, 0:W] + xp[:, 0:H, 1:W + 1]
    for dy, dx in [(0, 2), (1, 0), (1, 1), (1, 2), (2, 0), (2, 1), (2, 2)]:
        s = s + xp[:, dy:dy + H, dx:dx + W]
    return s


def _avgpool_3x3_same(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME average pool of NHWC f32, count_include_pad=False:
    the window sum divided by the in-image count."""
    return _window_sum_3x3(x) / _in_image_taps(x.shape[1], x.shape[2], x.device)


def _float_tensor(a, device) -> torch.Tensor:
    """A float32 tensor on ``device`` from a tensor or an array."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a, np.float32))
    return a.to(device, torch.float32)


def _channels(t) -> int:
    return (t[0] if isinstance(t, tuple) else t).shape[-1]


class _CalibOps:
    """Calibration interpretation: bf16 operands, f32 accumulation (TF32
    off), recording per-site activation ranges.

    ``quantile=None`` records the exact max |activation|; a quantile like
    0.9995 records that quantile of |activation| over a strided subsample
    instead (outliers then saturate in the epilogue's clamp).
    """

    def __init__(self, folded: Folded, device, quantile=None):
        self.folded = folded
        self.device = device
        self.quantile = quantile
        self.maxima: Dict[str, torch.Tensor] = {}

    def _record(self, key: str, t: torch.Tensor) -> None:
        a = t.float().abs()
        if self.quantile is None:
            m = a.max()
        else:
            flat = a.reshape(-1)
            m = torch.quantile(flat[:: max(1, flat.numel() // 1_000_000)], self.quantile)
        self.maxima[key] = torch.maximum(self.maxima[key], m) if key in self.maxima else m

    def _w(self, scopes: Sequence[str]) -> Tuple[torch.Tensor, torch.Tensor]:
        w = np.concatenate([self.folded[s][0] for s in scopes], axis=-1)
        b = np.concatenate([self.folded[s][1] for s in scopes])
        w = torch.from_numpy(w).to(self.device, torch.bfloat16).float()
        return w.permute(3, 2, 0, 1), torch.from_numpy(b).to(self.device)

    def _conv_f32(self, t, scopes, strides=(1, 1), padding="VALID"):
        w, b = self._w(scopes)
        pad = conv_padding(tuple(w.shape[2:]), strides, padding)
        with full_f32():
            y = F.conv2d(to_nchw(t.to(torch.bfloat16).float()), w, stride=strides,
                         padding=pad)
        return to_nhwc(y) + b

    def block_out(self, t, out_key, widths, reduce=False):
        return [None] * len(widths)

    def stem_in(self, x):
        x = x.to(torch.bfloat16)
        self._record("input", x)
        return x

    def conv(self, t, scope, out_key=_SELF, strides=(1, 1), padding="VALID", dst=None):
        y = torch.relu(self._conv_f32(t, [scope], strides, padding))
        key = scope if out_key is _SELF else out_key
        if key is not None:
            self._record(key, y)
        return y.to(torch.bfloat16)

    def packed(self, t, scopes: Sequence[str], out_keys=None, dsts=None):
        y = self._conv_f32(t, scopes, padding="SAME")
        return list(torch.split(y, [self.folded[s][0].shape[-1] for s in scopes], dim=-1))

    def act(self, pre, out_key):
        y = torch.relu(pre)
        if out_key is not None:
            self._record(out_key, y)
        return y.to(torch.bfloat16)

    def pool_act(self, pre, out_key, dst=None):
        if out_key is not None:
            # Signed pre-pool range, for the reference's pool_mode="int8".
            self._record(f"{out_key}:poolpre", pre)
        y = torch.relu(_avgpool_3x3_same(pre))
        if out_key is not None:
            self._record(out_key, y)
        return y.to(torch.bfloat16)

    def maxpool(self, t, out_key=None, dst=None):
        y = max_pool(t, (3, 3), (2, 2))
        if out_key is not None:
            self._record(out_key, y)
        return y

    def concat(self, ts, out_key=None):
        y = torch.cat(ts, dim=-1)
        if out_key is not None:
            self._record(out_key, y)
        return y

    def finish(self, t):
        return t.float()


def _join_adjacent(ts: Sequence[torch.Tensor]) -> Optional[torch.Tensor]:
    """One view over channel slices that lie side by side in one buffer, in
    order; None if they do not."""
    first = ts[0]
    off = first.storage_offset()
    for t in ts:
        if (t.dtype != first.dtype or t.shape[:-1] != first.shape[:-1]
                or t.stride() != first.stride() or t.storage_offset() != off
                or t.untyped_storage().data_ptr() != first.untyped_storage().data_ptr()):
            return None
        off += t.shape[-1]
    c = sum(t.shape[-1] for t in ts)
    if first.stride(-1) != 1 or c > first.stride(2):
        return None
    return first.as_strided((*first.shape[:-1], c), first.stride())


class _Int8Ops:
    """int8 interpretation: tensors flow as (q int8, scale float).

    ``epilogue="f32"``: per-channel ideal weight scales, requant in f32.
    ``epilogue="shift"``: weight scales constrained per channel so that m is
    a power of two and the requant is integer; a conv that cannot keep
    0 <= k <= 24 on every channel falls back to f32.  ``epilogue_kinds``
    records the kind each conv site got.  Per-site weights and epilogue
    constants are built once and kept on the device.  ``use_kernels=False``
    runs the plain versions of the kernels (on any device).
    """

    def __init__(self, folded: Folded, scales: Dict[str, float], device,
                 epilogue: str = "f32", stem_s2d=False, pool_mode: str = "f32",
                 use_kernels: bool = True):
        self.folded = folded
        self.scales = scales
        self.device = device
        self.epilogue = epilogue
        self.stem_s2d = stem_s2d
        self.pool_mode = pool_mode
        self._conv = conv_int8 if use_kernels else conv_int8_plain
        self._pool = maxpool3x3s2_int8 if use_kernels else maxpool3x3s2_int8_plain
        self.epilogue_kinds: Dict[str, str] = {}
        self._sites: Dict[tuple, tuple] = {}
        self._consts: Dict[tuple, torch.Tensor] = {}

    def _dev(self, key, make) -> torch.Tensor:
        """A float32 constant on the device, uploaded once: an upload from
        pageable memory in the forward would make the host wait for the
        device."""
        if key not in self._consts:
            self._consts[key] = torch.from_numpy(
                np.asarray(make(), np.float32)).to(self.device)
        return self._consts[key]

    def _quantize(self, y_f32, out_key):
        s = self.scales[out_key]
        r = self._dev(("1/s", out_key), lambda: np.float32(1.0 / s))
        q = torch.clamp(torch.round(y_f32 * r), _INT8_MIN, _INT8_MAX)
        return q.to(torch.int8), s

    def stem_in(self, x):
        if isinstance(x, tuple):  # already quantized
            return x
        return self._quantize(x.float(), "input")

    def _weights(self, scope, s_x, out_key):
        """(w_q int8, epilogue constants) for one conv site (numpy)."""
        w, b = self.folded[scope]
        w = np.asarray(w, np.float32)
        w_q, s_w = _channel_quantize(w)
        if out_key is None:
            self.epilogue_kinds[scope] = "dequant"
            return w_q, ("dequant", s_x * s_w, np.asarray(b, np.float32))
        s_out = self.scales[out_key]
        m = s_x * s_w / s_out
        k = np.floor(-np.log2(np.maximum(m, 1e-30))).astype(np.int32)
        # Shift mode needs 0 <= k <= 24: k < 0 would be a left shift
        # (m > 1), and large k risks overflowing the int32 bias term
        # (b_i ~ (b/s_out + 0.5) * 2^k).  Out-of-range channels fall the
        # whole conv back to the f32 epilogue.
        if self.epilogue == "shift" and np.all((k >= 0) & (k <= 24)):
            s_w2 = np.exp2(-k.astype(np.float64)) * s_out / s_x
            w_q = np.clip(np.round(w / s_w2), _INT8_MIN, _INT8_MAX
                          ).astype(np.int8)
            b_i = np.round((np.asarray(b, np.float64) / s_out + 0.5)
                           * np.exp2(k.astype(np.float64)))
            if np.all(np.abs(b_i) < 2**31):
                self.epilogue_kinds[scope] = "shift"
                return w_q, ("shift", b_i.astype(np.int32), k)
        w_q = np.clip(np.round(w / s_w), _INT8_MIN, _INT8_MAX).astype(np.int8)
        self.epilogue_kinds[scope] = "f32"
        return w_q, ("f32", (s_x * s_w / s_out).astype(np.float32),
                     (np.asarray(b, np.float32) / s_out + 0.5)
                     .astype(np.float32))

    def _site(self, scopes: Sequence[str], s_x, out_keys, s2d=False):
        """Cached (w [Cout,kh,kw,Cin] int8 on the device, Epilogue, consts)
        of one conv launch."""
        key = (tuple(scopes), s_x, tuple(out_keys), s2d)
        if key not in self._sites:
            w_parts, consts = [], []
            for scope, out_key in zip(scopes, out_keys):
                if out_key == "pool":
                    w, b = self.folded[scope]
                    w_q, s_w = _channel_quantize(w)
                    consts.append(("pre", (s_x * s_w).astype(np.float32),
                                   np.asarray(b, np.float32)))
                else:
                    w_q, const = self._weights(scope, s_x, out_key)
                    consts.append(const)
                w_parts.append(w_q)
            w_q = np.concatenate(w_parts, axis=-1)
            if s2d:
                w_q = _s2d_kernel(w_q)
            w_dev = torch.from_numpy(np.ascontiguousarray(w_q.transpose(3, 0, 1, 2)))
            epi = Epilogue.build(
                [(c[0], w.shape[-1], *((None, None) if c[0] == "pre" else c[1:]))
                 for w, c in zip(w_parts, consts)], self.device)
            self._sites[key] = (w_dev.to(self.device), epi, consts)
        return self._sites[key]

    def _wrap(self, y, const, out_key):
        if const[0] == "pre":
            return ("pre", y, const[1], const[2])
        if const[0] == "dequant":
            return y
        return y, self.scales[out_key]

    def block_out(self, t, out_key, widths, reduce=False):
        """The block's output buffer, as one channel slice per branch."""
        B, H, W, _ = t[0].shape
        if reduce:
            H, W = (H - 3) // 2 + 1, (W - 3) // 2 + 1
        dtype = torch.int8 if out_key is not None else torch.bfloat16
        buf = torch.empty(B, H, W, sum(widths), dtype=dtype, device=t[0].device)
        offs = np.cumsum([0] + list(widths))
        return [buf[..., a:b] for a, b in zip(offs[:-1], offs[1:])]

    def conv(self, t, scope, out_key=_SELF, strides=(1, 1), padding="VALID", dst=None):
        q, s_x = t
        out_key = scope if out_key is _SELF else out_key
        w, epi, consts = self._site([scope], s_x, [out_key])
        pad = conv_padding(tuple(w.shape[1:3]), strides, padding)
        (y,) = self._conv(q, w, epi, strides, pad, [dst])
        return self._wrap(y, consts[0], out_key)

    def conv_s2d(self, t, scope, out_key=_SELF, dst=None):
        """Stride-2 VALID conv as a stride-1 conv over the 2x2 space-to-depth
        layout (bit-exact vs ``conv``: the int8 kernel is rearranged after
        quantization).  ``stem_s2d="pre"``: the input arrives in that layout
        (``preprocess_for_eval_s2d``)."""
        q, s_x = t
        out_key = scope if out_key is _SELF else out_key
        w, epi, consts = self._site([scope], s_x, [out_key], s2d=True)
        if self.stem_s2d != "pre":
            q = space_to_depth_2x2(q)
        (y,) = self._conv(q, w, epi, (1, 1), (0, 0), [dst])
        return self._wrap(y, consts[0], out_key)

    def packed(self, t, scopes: Sequence[str], out_keys=None, dsts=None):
        """One wide 1x1 conv for the parallel branch openers; ``out_keys[i]``
        is slice i's requant target ("pool" = keep the int32 pre-activation
        for pool_act; None = dequantize); ``dsts[i]`` its destination."""
        q, s_x = t
        if out_keys is None:
            out_keys = ["pool"] * len(scopes)
        w, epi, consts = self._site(scopes, s_x, out_keys)
        ys = self._conv(q, w, epi, (1, 1), (0, 0), dsts)
        return [self._wrap(y, c, k) for y, c, k in zip(ys, consts, out_keys)]

    def _pre_affine(self, m, b, out_key):
        """Device constants (m', b') of ``pre * m' + b'``: the dequant of a
        pre-activation, or its requant to ``out_key``'s scale (+0.5 so that
        the truncating cast rounds).  Keyed by the identity of m and b,
        which live as long as the site cache that holds them."""
        if out_key is None:
            return (self._dev(("m", id(m)), lambda: m), self._dev(("b", id(b)), lambda: b))
        s_out = self.scales[out_key]
        return (self._dev(("m", id(m), out_key), lambda: m / s_out),
                self._dev(("b", id(b), out_key), lambda: b / s_out + 0.5))

    def act(self, pre, out_key):
        if not (isinstance(pre, tuple) and len(pre) == 4 and pre[0] == "pre"):
            return pre  # packed() already applied the epilogue
        _, y, m, b = pre
        mm, bb = self._pre_affine(m, b, out_key)
        yf = y.float() * mm + bb
        if out_key is not None:
            return torch.clamp(yf, 0.0, _INT8_MAX).to(torch.int8), self.scales[out_key]
        return torch.clamp_min(yf, 0.0).to(torch.bfloat16)

    def pool_act(self, pre, out_key, dst=None):
        _, y, m, b = pre
        s_q = self.scales.get(f"{out_key}:poolpre") if out_key is not None else None
        if out_key is not None and self.pool_mode == "int8" and s_q is not None:
            # Requantize the pre-activation to signed int8 at its own
            # calibrated scale, sum each 3x3 window in int32, then rescale
            # to the block's scale with the count_include_pad=False divisor
            # folded in, in the reference's order of f32 operations.
            s_out = self.scales[out_key]
            mq = self._dev(("m", id(m), "poolpre", s_q), lambda: m / s_q)
            bq = self._dev(("b", id(b), "poolpre", s_q), lambda: b / s_q)
            yq = torch.clamp(torch.round(y.float() * mq + bq), _INT8_MIN, _INT8_MAX)
            ssum = _window_sum_3x3(yq.to(torch.int32))
            r = self._dev(("pool_rescale", s_q, s_out), lambda: np.float32(s_q / s_out))
            yf = ssum.float() * (r / _in_image_taps(y.shape[1], y.shape[2], y.device)) + 0.5
            yq = torch.clamp(yf, 0.0, _INT8_MAX).to(torch.int8)
            return (yq if dst is None else dst.copy_(yq)), s_out
        # Pool the pre-activation: 1x1 conv + bias commutes with the
        # count_include_pad=False average; +0.5 is window-invariant.
        mm, bb = self._pre_affine(m, b, out_key)
        yf = _avgpool_3x3_same(y.float() * mm + bb)
        if out_key is not None:
            yq = torch.clamp(yf, 0.0, _INT8_MAX).to(torch.int8)
            return (yq if dst is None else dst.copy_(yq)), self.scales[out_key]
        yf = torch.clamp_min(yf, 0.0).to(torch.bfloat16)
        return yf if dst is None else dst.copy_(yf)

    def maxpool(self, t, out_key=None, dst=None):
        q, s = t
        if out_key is not None and self.scales[out_key] != s:
            s_out = self.scales[out_key]
            # Values are post-relu (>= 0): trunc(x + 0.5) rounds.
            return self._pool(q, s / s_out, dst), s_out
        return self._pool(q, None, dst), s

    def concat(self, ts, out_key=None):
        scale = None
        if all(isinstance(t, tuple) for t in ts):
            scale = ts[0][1]
            if any(t[1] != scale for t in ts):
                raise ValueError("concat branches must share a requant scale")
            ts = [t[0] for t in ts]
        joined = _join_adjacent(ts)  # branches written into one buffer: no copy
        if joined is None:
            joined = torch.cat(ts, dim=-1)
        return joined if scale is None else (joined, scale)

    def finish(self, t):
        if isinstance(t, tuple):
            return t[0].float() * t[1]
        return t.float()


def _tower(ops, x, stop_at: Optional[str] = None):
    """Inception-v3 inference topology over an abstract op set, as the
    reference's ``_tower``.  Each block first takes its output buffer
    (``ops.block_out``) and each branch's last op writes its slice.
    ``stop_at`` returns the tensor after the named stage."""
    def cout(scope):
        return ops.folded[scope][0].shape[-1]

    t = ops.stem_in(x)
    if getattr(ops, "stem_s2d", False):
        t = ops.conv_s2d(t, "Conv2d_1a_3x3")
    else:
        t = ops.conv(t, "Conv2d_1a_3x3", strides=(2, 2))
    t = ops.conv(t, "Conv2d_2a_3x3")
    t = ops.conv(t, "Conv2d_2b_3x3", padding="SAME")
    t = ops.maxpool(t)
    t = ops.conv(t, "Conv2d_3b_1x1")
    t = ops.conv(t, "Conv2d_4a_3x3")
    t = ops.maxpool(t)
    if stop_at == "stem":
        return t

    def inception_a(t, scope, quirky):
        b1n = ("Conv2d_0b_1x1", "Conv_1_0c_5x5") if quirky else \
            ("Conv2d_0a_1x1", "Conv2d_0b_5x5")
        out = f"{scope}/out"
        heads = [f"{scope}/Branch_0/Conv2d_0a_1x1", f"{scope}/Branch_1/{b1n[0]}",
                 f"{scope}/Branch_2/Conv2d_0a_1x1", f"{scope}/Branch_3/Conv2d_0b_1x1"]
        o = ops.block_out(t, out, [cout(heads[0]), cout(f"{scope}/Branch_1/{b1n[1]}"),
                                   cout(f"{scope}/Branch_2/Conv2d_0c_3x3"), cout(heads[3])])
        p0, p1, p2, p3 = ops.packed(
            t, heads, out_keys=[out, f"{scope}/b1", f"{scope}/b2", "pool"],
            dsts=[o[0], None, None, None])
        b0 = ops.act(p0, out)
        b1 = ops.conv(ops.act(p1, f"{scope}/b1"),
                      f"{scope}/Branch_1/{b1n[1]}", out_key=out,
                      padding="SAME", dst=o[1])
        b2 = ops.conv(ops.act(p2, f"{scope}/b2"),
                      f"{scope}/Branch_2/Conv2d_0b_3x3", padding="SAME")
        b2 = ops.conv(b2, f"{scope}/Branch_2/Conv2d_0c_3x3", out_key=out,
                      padding="SAME", dst=o[2])
        b3 = ops.pool_act(p3, out, dst=o[3])
        return ops.concat([b0, b1, b2, b3], out)

    t = inception_a(t, "Mixed_5b", False)
    t = inception_a(t, "Mixed_5c", True)
    t = inception_a(t, "Mixed_5d", False)
    if stop_at == "Mixed_5d":
        return t

    # Mixed_6a reduction
    out = "Mixed_6a/out"
    o = ops.block_out(t, out, [cout("Mixed_6a/Branch_0/Conv2d_1a_1x1"),
                               cout("Mixed_6a/Branch_1/Conv2d_1a_1x1"), _channels(t)],
                      reduce=True)
    b0 = ops.conv(t, "Mixed_6a/Branch_0/Conv2d_1a_1x1", out_key=out,
                  strides=(2, 2), dst=o[0])
    b1 = ops.conv(t, "Mixed_6a/Branch_1/Conv2d_0a_1x1", padding="SAME")
    b1 = ops.conv(b1, "Mixed_6a/Branch_1/Conv2d_0b_3x3", padding="SAME")
    b1 = ops.conv(b1, "Mixed_6a/Branch_1/Conv2d_1a_1x1", out_key=out,
                  strides=(2, 2), dst=o[1])
    b2 = ops.maxpool(t, out_key=out, dst=o[2])
    t = ops.concat([b0, b1, b2], out)
    if stop_at == "Mixed_6a":
        return t

    def inception_b(t, scope):
        out = f"{scope}/out"
        heads = [f"{scope}/Branch_{i}/Conv2d_0{'b' if i == 3 else 'a'}_1x1"
                 for i in range(4)]
        o = ops.block_out(t, out, [cout(heads[0]), cout(f"{scope}/Branch_1/Conv2d_0c_7x1"),
                                   cout(f"{scope}/Branch_2/Conv2d_0e_1x7"), cout(heads[3])])
        p0, p1, p2, p3 = ops.packed(
            t, heads, out_keys=[out, f"{scope}/b1", f"{scope}/b2", "pool"],
            dsts=[o[0], None, None, None])
        b0 = ops.act(p0, out)
        b1 = ops.act(p1, f"{scope}/b1")
        b1 = ops.conv(b1, f"{scope}/Branch_1/Conv2d_0b_1x7", padding="SAME")
        b1 = ops.conv(b1, f"{scope}/Branch_1/Conv2d_0c_7x1", out_key=out,
                      padding="SAME", dst=o[1])
        b2 = ops.act(p2, f"{scope}/b2")
        b2 = ops.conv(b2, f"{scope}/Branch_2/Conv2d_0b_7x1", padding="SAME")
        b2 = ops.conv(b2, f"{scope}/Branch_2/Conv2d_0c_1x7", padding="SAME")
        b2 = ops.conv(b2, f"{scope}/Branch_2/Conv2d_0d_7x1", padding="SAME")
        b2 = ops.conv(b2, f"{scope}/Branch_2/Conv2d_0e_1x7", out_key=out,
                      padding="SAME", dst=o[2])
        b3 = ops.pool_act(p3, out, dst=o[3])
        return ops.concat([b0, b1, b2, b3], out)

    for scope in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
        t = inception_b(t, scope)
    if stop_at == "Mixed_6e":
        return t

    # Mixed_7a reduction
    out = "Mixed_7a/out"
    o = ops.block_out(t, out, [cout("Mixed_7a/Branch_0/Conv2d_1a_3x3"),
                               cout("Mixed_7a/Branch_1/Conv2d_1a_3x3"), _channels(t)],
                      reduce=True)
    p0, p1 = ops.packed(t, ["Mixed_7a/Branch_0/Conv2d_0a_1x1",
                            "Mixed_7a/Branch_1/Conv2d_0a_1x1"],
                        out_keys=["Mixed_7a/b0", "Mixed_7a/b1"])
    b0 = ops.conv(ops.act(p0, "Mixed_7a/b0"),
                  "Mixed_7a/Branch_0/Conv2d_1a_3x3", out_key=out,
                  strides=(2, 2), dst=o[0])
    b1 = ops.act(p1, "Mixed_7a/b1")
    b1 = ops.conv(b1, "Mixed_7a/Branch_1/Conv2d_0b_1x7", padding="SAME")
    b1 = ops.conv(b1, "Mixed_7a/Branch_1/Conv2d_0c_7x1", padding="SAME")
    b1 = ops.conv(b1, "Mixed_7a/Branch_1/Conv2d_1a_3x3", out_key=out,
                  strides=(2, 2), dst=o[1])
    b2 = ops.maxpool(t, out_key=out, dst=o[2])
    t = ops.concat([b0, b1, b2], out)
    if stop_at == "Mixed_7a":
        return t

    def inception_c(t, scope, quirky_7c, last):
        out = None if last else f"{scope}/out"
        n31 = "Conv2d_0c_3x1" if quirky_7c else "Conv2d_0b_3x1"
        heads = [f"{scope}/Branch_{i}/Conv2d_0{'b' if i == 3 else 'a'}_1x1"
                 for i in range(4)]
        o = ops.block_out(t, out, [cout(heads[0]),
                                   cout(f"{scope}/Branch_1/Conv2d_0b_1x3"),
                                   cout(f"{scope}/Branch_1/{n31}"),
                                   cout(f"{scope}/Branch_2/Conv2d_0c_1x3"),
                                   cout(f"{scope}/Branch_2/Conv2d_0d_3x1"), cout(heads[3])])
        p0, p1, p2, p3 = ops.packed(
            t, heads, out_keys=[out, f"{scope}/b1", f"{scope}/b2", "pool"],
            dsts=[o[0], None, None, None])
        b0 = ops.act(p0, out)
        b1 = ops.act(p1, f"{scope}/b1")
        b1 = ops.concat([
            ops.conv(b1, f"{scope}/Branch_1/Conv2d_0b_1x3", out_key=out,
                     padding="SAME", dst=o[1]),
            ops.conv(b1, f"{scope}/Branch_1/{n31}", out_key=out,
                     padding="SAME", dst=o[2])])
        b2 = ops.act(p2, f"{scope}/b2")
        b2 = ops.conv(b2, f"{scope}/Branch_2/Conv2d_0b_3x3", padding="SAME")
        b2 = ops.concat([
            ops.conv(b2, f"{scope}/Branch_2/Conv2d_0c_1x3", out_key=out,
                     padding="SAME", dst=o[3]),
            ops.conv(b2, f"{scope}/Branch_2/Conv2d_0d_3x1", out_key=out,
                     padding="SAME", dst=o[4])])
        b3 = ops.pool_act(p3, out, dst=o[5])
        return ops.concat([b0, b1, b2, b3], out)

    t = inception_c(t, "Mixed_7b", False, last=False)
    t = inception_c(t, "Mixed_7c", True, last=True)
    return ops.finish(t)


def _quantized_interp_matrix(out_size: int, in_size: int) -> np.ndarray:
    """TF1 bilinear interpolation matrix quantized to int8 with exact row
    sums of 127, so the resize is an s8 x s8 -> s32 matmul whose output
    divides by exactly 127 per stage (no per-row scale vector)."""
    m = _interp_matrix_cached(out_size, in_size, "tf1")
    q = np.round(m * 127.0)
    # Each row has <= 2 taps summing to 1.0; force the quantized sum to 127
    # by adjusting the largest tap (error <= half a step).
    for o in range(q.shape[0]):
        idx = np.nonzero(q[o])[0]
        if idx.size == 0:  # degenerate (frac rounded to zero on both taps)
            q[o, np.argmax(m[o])] = 127.0
            idx = np.nonzero(q[o])[0]
        q[o, idx[np.argmax(q[o, idx])]] += 127.0 - q[o].sum()
    if not (q.sum(axis=1) == 127.0).all():
        raise ArithmeticError(f"quantized {out_size}x{in_size} resize rows do not sum to 127")
    return q.astype(np.int8)


@functools.lru_cache(maxsize=16)
def _resize_operand(out_size: int, in_size: int, device: torch.device) -> torch.Tensor:
    """:func:`_quantized_interp_matrix` as the [N, K] int8 operand of a
    resize GEMM on ``device``, uploaded once: [out, in] zero-padded to
    multiples of 8 both ways (``torch._int_mm`` wants K and N so; the zero
    rows and taps add nothing to the sums)."""
    q = _quantized_interp_matrix(out_size, in_size)
    return torch.from_numpy(np.pad(q, ((0, -out_size % 8), (0, -in_size % 8)))).to(device)


def _int8_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 (row-major) @ b [K, N] int8 -> [M, N] int32, exact:
    ``torch._int_mm`` on the card (it raises for a shape it refuses), a
    float64 product cast to int32 on the CPU (|sum| < 2^53)."""
    if a.device.type == "cpu":
        return (a.double() @ b.double()).to(torch.int32)
    return torch._int_mm(a, b)


# The uint8 front's f32 constants are Python floats holding f32 values, so
# every backend's cast of them to f32 is exact and gives the f32 value the
# reference's weak-typed Python floats become.
_INV127 = float(np.float32(1.0 / 127.0))


def _resize_rows_int8(crop_u8: torch.Tensor, height: int) -> torch.Tensor:
    """Centre a cropped uint8 batch [n,h,w,c] into int8 and resize its rows
    to ``height``, requantized to int8 (value / 127, rounded half to even,
    clipped to [-127, 127]): the [n, height, c, Kw] int8 operand of the
    column GEMM, w innermost and zero-padded to Kw, a multiple of 8.  Each
    elementwise step writes the layout the next GEMM reads, so no transposed
    copy of the image is made."""
    n, h, w, c = crop_u8.shape
    dev = crop_u8.device
    x = torch.empty(n, w, c, h + (-h % 8), dtype=torch.int8, device=dev)
    x[..., h:].zero_()
    # u8 - 128 in int8 is u8 with its top bit flipped.
    torch.bitwise_xor(crop_u8.permute(0, 2, 3, 1), 128, out=x[..., :h].view(torch.uint8))
    y = _int8_gemm(x.view(n * w * c, -1), _resize_operand(height, h, dev).t())
    t = torch.round(y.view(n, w, c, -1)[..., :height] * _INV127).clamp_(_INT8_MIN, _INT8_MAX)
    yq = torch.empty(n, height, c, w + (-w % 8), dtype=torch.int8, device=dev)
    yq[..., w:].zero_()
    yq[..., :w].copy_(t.permute(0, 3, 2, 1))
    return yq


def preprocess_for_eval_int8(images_u8: torch.Tensor, input_scale: float,
                             height: int = 299, width: int = 299,
                             central_fraction: float = 0.875) -> torch.Tensor:
    """int8-domain slim eval preprocessing for the quantized engine.

    uint8 [N,H,W,C] -> central crop -> TF1 bilinear resize as two s8 GEMMs
    -> requantize into the engine's calibrated input scale -> int8
    [N, height, width, C].  The [0,255] -> [-1,1] normalization and the
    input quantization fold into one affine over the final int32 resize
    output, ``round(z * a + b)`` with ``a = 2/(127*255*input_scale)`` and
    ``b = (2*128/255 - 1)/input_scale`` (a multiply, then an add, each
    rounded to f32).  TF1 resize only, as in the reference.
    """
    if images_u8.dtype != torch.uint8 or images_u8.ndim != 4:
        raise ValueError(f"expected a uint8 [N,H,W,C] batch, got {images_u8.dtype} "
                         f"{tuple(images_u8.shape)}")
    n, h, w, c = images_u8.shape
    if central_fraction and central_fraction < 1.0:
        oh, ow, ch, cw = central_crop_sizes(h, w, central_fraction)
        images_u8 = images_u8[:, oh:oh + ch, ow:ow + cw]
    cw = images_u8.shape[2]
    dev = images_u8.device
    yq = _resize_rows_int8(images_u8, height)
    z = _int8_gemm(yq.view(n * height * c, -1), _resize_operand(width, cw, dev).t())
    z = z.view(n, height, c, -1)[..., :width]
    a = float(np.float32(2.0 / (127.0 * 255.0 * input_scale)))
    b = float(np.float32((2.0 * 128.0 / 255.0 - 1.0) / input_scale))
    t = (z * a).add_(b).round_().clamp_(_INT8_MIN, _INT8_MAX)
    q = torch.empty(n, height, width, c, dtype=torch.int8, device=dev)
    q.permute(0, 1, 3, 2).copy_(t)
    return q


class QuantizedInceptionV3:
    """int8-serving Inception-v3 over BN-folded, per-channel-quantized weights.

    state: the port's state dict (image tower at the root).
    calibration_images: preprocessed [N, H, W, 3] float batch (output of
        ``preprocess_for_eval``), run once here to fix the static scales.
    epilogue: "shift" (served) or "f32".
    calibration_quantile: None (exact max) or a quantile like 0.9995.
    stem_s2d: False (stride-2 stem on the normal layout), True (relayout on
        the device, then the 2x2 s2d conv) or "pre" (the caller feeds the
        s2d layout, ``preprocess_for_eval_s2d``; the served front).
    pool_mode: "f32" (the pool branch averages its f32 pre-activation) or
        "int8" (requantized to int8 at its own calibrated scale, summed in
        int32, rescaled to the block's scale).
    use_kernels: False runs the kernels' plain versions (the oracle on the
        card).  The dequantized outputs of the last block are bf16.
    """

    def __init__(self, state: Dict[str, torch.Tensor], calibration_images,
                 epilogue: str = "shift", calibration_quantile=None, stem_s2d=False,
                 pool_mode: str = "f32", use_kernels: bool = True, device="cuda"):
        self.device = resolve_device(device)
        if epilogue not in ("shift", "f32") or pool_mode not in ("f32", "int8"):
            raise ValueError(f"epilogue={epilogue!r}, pool_mode={pool_mode!r}; expected "
                             "shift|f32 and f32|int8")
        self.folded = fold_hwio(state)
        self.epilogue = epilogue
        self.stem_s2d = stem_s2d
        self.pool_mode = pool_mode
        self.use_kernels = use_kernels
        self.logits_w: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        if "Logits/Conv2d_1c_1x1" in self.folded:
            w, b = self.folded["Logits/Conv2d_1c_1x1"]
            self.logits_w = (torch.from_numpy(np.ascontiguousarray(w[0, 0])).to(self.device),
                             torch.from_numpy(b).to(self.device))
        calib = _CalibOps(self.folded, self.device, quantile=calibration_quantile)
        x = _float_tensor(calibration_images, self.device)
        with torch.inference_mode():
            _tower(calib, x)
        self.scales = {k: max(float(v), 1e-6) / 127.0 for k, v in calib.maxima.items()}
        self._ops: Optional[_Int8Ops] = None
        self.last_epilogue_kinds: Dict[str, str] = {}

    def to(self, device) -> "QuantizedInceptionV3":
        """This engine on ``device``: the same folded weights and calibrated
        scales (shared, not calibrated again), its device weights, constants
        and kernel plans made there at first use (the reference replicates
        one engine's weights over its mesh)."""
        dev = resolve_device(device)
        if dev == self.device:
            return self
        out = copy.copy(self)
        out.device = dev
        if self.logits_w is not None:
            out.logits_w = tuple(t.to(dev) for t in self.logits_w)
        out._ops = None
        out.last_epilogue_kinds = {}
        return out

    def int8_ops(self) -> _Int8Ops:
        """The op set for the current ``scales`` (rebuilt if they were replaced)."""
        if self._ops is None or self._ops.scales is not self.scales:
            self._ops = _Int8Ops(self.folded, self.scales, self.device,
                                 epilogue=self.epilogue, stem_s2d=self.stem_s2d,
                                 pool_mode=self.pool_mode, use_kernels=self.use_kernels)
        return self._ops

    @torch.inference_mode()
    def forward_from_uint8(self, raw_u8, height: int = 299, width: int = 299,
                           central_fraction: float = 0.875
                           ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        """Decoded uint8 [B,H,W,3] -> int8 eval preprocess -> tower: central
        crop, int8-GEMM TF1 resize, normalization and input quantization in
        one affine, so no float image is made.  The preprocess knobs must
        match the model's eval config (TF1 resize only)."""
        s_in = self.scales["input"]
        q = preprocess_for_eval_int8(torch.as_tensor(raw_u8, device=self.device), s_in,
                                     height=height, width=width,
                                     central_fraction=central_fraction)
        return self((q, s_in))

    @torch.inference_mode()
    def __call__(self, x) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        """Preprocessed [B, 299, 299, 3] (or [B,150,150,12] with
        stem_s2d="pre") float, or an ``(int8, scale)`` pair -> (logits [B, C]
        or None, feature [B, 2048]), f32."""
        dev = (x[0] if isinstance(x, tuple) else x).device
        if dev != self.device:
            raise ValueError(f"input on {dev}, engine on {self.device}")
        ops = self.int8_ops()
        net = _tower(ops, x)
        self.last_epilogue_kinds = dict(ops.epilogue_kinds)
        # Global average pool over min(8, spatial), as slim does.
        kh, kw = min(8, net.shape[1]), min(8, net.shape[2])
        if (net.shape[1], net.shape[2]) == (kh, kw):
            feature = net.mean(dim=(1, 2))
        else:
            feature = to_nhwc(F.avg_pool2d(to_nchw(net), (kh, kw), 1)).squeeze(2).squeeze(1)
        logits = None
        if self.logits_w is not None:
            w, b = self.logits_w
            logits = linear_f64(feature, w.t(), b)   # rows independent of the batch
        return logits, feature


def quantization_delta(state: Dict[str, torch.Tensor], images,
                       calibration_images=None, device="cuda",
                       **engine_kwargs) -> Dict[str, float]:
    """Accuracy-delta harness: int8 engine vs the bf16 engine.

    Returns top-1 agreement rate and max/mean |prob delta| over ``images``
    (preprocessed, normal layout; relayouted for an engine built with
    ``stem_s2d="pre"``), and, for the shift epilogue, the share of conv
    sites that kept it and the count that fell back to f32.  The reference
    is ``FusedInceptionV3`` in bf16 with the block kernels (the JAX package
    uses its XLA blocks, which compute the same function).
    """
    from tumblr_emotions_torch.ops.inference import FusedInceptionV3

    dev = resolve_device(device)
    images = _float_tensor(images, dev)
    ref = FusedInceptionV3(state, dtype=torch.bfloat16, use_kernels=True, device=dev)
    qeng = QuantizedInceptionV3(state, calibration_images if calibration_images is not None
                                else images, device=dev, **engine_kwargs)
    q_in = space_to_depth_2x2(images) if qeng.stem_s2d == "pre" else images
    ref_logits, _ = ref(images)
    q_logits, _ = qeng(q_in)
    p_ref = torch.softmax(ref_logits.float(), dim=-1)
    p_q = torch.softmax(q_logits.float(), dim=-1)
    agree = float((ref_logits.argmax(-1) == q_logits.argmax(-1)).float().mean())
    delta = (p_ref - p_q).abs()
    kinds = list(qeng.last_epilogue_kinds.values())
    out = {"top1_agreement": agree,
           "max_prob_delta": float(delta.max()),
           "mean_prob_delta": float(delta.mean())}
    if kinds and qeng.epilogue == "shift":
        out["shift_epilogue_rate"] = round(kinds.count("shift") / max(len(kinds), 1), 4)
        out["f32_fallback_convs"] = kinds.count("f32")
    return out
