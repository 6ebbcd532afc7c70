"""int8 convolution for Hopper: the port of the TPU's int8 Pallas conv (K1),
widened to every conv of the int8 serving engine.

Replaces ``tumblr_emotions_tpu/ops/pallas_conv.py::valid_conv3x3_int8_shift``
(a VALID 3x3 stride-1 int8 conv as nine tap-shifted per-image MXU matmuls in
int32, with the integer shift epilogue fused) and, beyond it, the convs that
``tumblr_emotions_tpu/ops/quant.py`` leaves to XLA (``_conv_raw`` followed by
``_Int8Ops._apply_epilogue``).  PyTorch has no int8 convolution on CUDA, so
the engine runs on the card only through this kernel.

``conv_int8`` (``csrc/int8_conv.cu``) is one implicit GEMM on the int8
tensor cores for every conv form the engine issues (1x1 single and packed,
3x3 SAME/VALID, 5x5, 1x3/3x1/1x7/7x1 SAME, 3x3 stride 2, the 2x2
space-to-depth stem, the 3x3/2 stem on Cin 3).  Its epilogue is chosen per
output-channel segment (:class:`Epilogue`), so a packed 1x1 conv is one
launch whose slices end in different kinds and different tensors:

- ``shift``: ``clamp((acc + b_i) >> k, 0, 127)`` -> int8 (pure integer);
- ``f32``: ``clip(float(acc) * m + bq, 0, 127)`` -> int8 by truncation;
- ``dequant``: ``max(float(acc) * m + b, 0)`` -> bf16;
- ``pre``: the int32 accumulator, for the pool branch's ``pool_act``.

Each output may be a channel slice of a larger NHWC tensor (a pixel
stride), so a block's branches write straight into its concat buffer.

The plain version computes the conv in float64 (exact: |acc| <= 127^2 *
4032 < 2^53) cast to int32, then the same epilogue in PyTorch ops, each
float step one rounded multiply and one rounded add as in the kernel.  A
wrapper takes it only for a tensor on the CPU; for a CUDA tensor it
launches the kernel or raises.  ``conv_int8.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tumblr_emotions_torch.models.layers import to_nchw, to_nhwc
from tumblr_emotions_torch.ops import _build
from tumblr_emotions_torch.ops.fused_inception import _pixel_stride

KINDS = ("shift", "f32", "dequant", "pre")
OUT_DTYPE = {"shift": torch.int8, "f32": torch.int8, "dequant": torch.bfloat16,
             "pre": torch.int32}
MAX_SEGMENTS = 4  # csrc/int8_conv.cu MAX_SEGS


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """Per-output-channel epilogue of one conv: segment kinds and widths, and
    the constants over all Cout channels (zero where a kind does not read
    them): ``bias_i``/``shift`` int32 for ``shift``, ``mul``/``add`` f32 for
    ``f32`` (m, bq) and ``dequant`` (m, b)."""

    kinds: Tuple[str, ...]
    widths: Tuple[int, ...]
    bias_i: torch.Tensor
    shift: torch.Tensor
    mul: torch.Tensor
    add: torch.Tensor

    def __post_init__(self):
        n = sum(self.widths)
        if len(self.kinds) != len(self.widths) or any(k not in KINDS for k in self.kinds):
            raise ValueError(f"epilogue kinds {self.kinds} / widths {self.widths}")
        for name, dt in (("bias_i", torch.int32), ("shift", torch.int32),
                         ("mul", torch.float32), ("add", torch.float32)):
            t = getattr(self, name)
            if t.dtype != dt or t.shape != (n,) or not t.is_contiguous() \
                    or t.device != self.bias_i.device:
                raise ValueError(f"epilogue {name}: {t.dtype} {tuple(t.shape)} on {t.device}, "
                                 f"expected contiguous {dt} ({n},) beside bias_i")
        # The kernel's segment table, built once (ctypes arrays).
        k = len(self.kinds)
        object.__setattr__(self, "c_ends", (ctypes.c_int * k)(*np.cumsum(self.widths).tolist()))
        object.__setattr__(self, "c_kinds", (ctypes.c_int * k)(*[KINDS.index(x) for x in self.kinds]))

    @staticmethod
    def build(segments: Sequence[tuple], device) -> "Epilogue":
        """``segments``: one tuple per segment, ``(kind, width, a, b)`` with
        numpy arrays a, b of that width: (b_i, k) for shift, (m, bq) for
        f32, (m, b) for dequant, ignored (None) for pre."""
        kinds, widths = [], []
        bi, sh, mu, ad = [], [], [], []
        for kind, n, a, b in segments:
            if kind not in KINDS:
                raise ValueError(f"unknown epilogue kind {kind!r}; expected {KINDS}")
            kinds.append(kind)
            widths.append(int(n))
            zi, zf = np.zeros(n, np.int32), np.zeros(n, np.float32)
            bi.append(np.asarray(a, np.int32) if kind == "shift" else zi)
            sh.append(np.asarray(b, np.int32) if kind == "shift" else zi)
            mu.append(np.asarray(a, np.float32) if kind in ("f32", "dequant") else zf)
            ad.append(np.asarray(b, np.float32) if kind in ("f32", "dequant") else zf)

        def dev(parts):
            return torch.from_numpy(np.ascontiguousarray(np.concatenate(parts))).to(device)

        return Epilogue(tuple(kinds), tuple(widths), dev(bi), dev(sh), dev(mu), dev(ad))


def conv_padding(kernel: Tuple[int, int], strides: Tuple[int, int], padding: str
                 ) -> Tuple[int, int]:
    """(pad_h, pad_w) of XLA's ``padding`` for the convs the engine issues:
    VALID, or SAME at stride 1 with an odd kernel (symmetric k // 2)."""
    kh, kw = kernel
    if padding == "VALID":
        return 0, 0
    if padding == "SAME" and tuple(strides) == (1, 1) and kh % 2 and kw % 2:
        return kh // 2, kw // 2
    raise ValueError(f"padding {padding!r} with kernel {kernel}, strides {strides} "
                     "is not a form the int8 engine issues")


def _out_hw(x: torch.Tensor, w: torch.Tensor, strides, pad) -> Tuple[int, int]:
    _, H, W, _ = x.shape
    _, kh, kw, _ = w.shape
    return (H + 2 * pad[0] - kh) // strides[0] + 1, (W + 2 * pad[1] - kw) // strides[1] + 1


def apply_epilogue_plain(acc: torch.Tensor, epi: Epilogue,
                         outs: Optional[Sequence[Optional[torch.Tensor]]] = None
                         ) -> List[torch.Tensor]:
    """Plain epilogue of an int32 NHWC accumulator, one tensor per segment
    (copied into ``outs[i]`` where given)."""
    res, off = [], 0
    for i, (kind, n) in enumerate(zip(epi.kinds, epi.widths)):
        a = acc[..., off:off + n]
        sl = slice(off, off + n)
        if kind == "shift":
            y = torch.bitwise_right_shift(a + epi.bias_i[sl], epi.shift[sl])
            y = y.clamp(0, 127).to(torch.int8)
        elif kind == "f32":
            y = (a.float() * epi.mul[sl] + epi.add[sl]).clamp(0.0, 127.0).to(torch.int8)
        elif kind == "dequant":
            y = (a.float() * epi.mul[sl] + epi.add[sl]).clamp_min(0.0).to(torch.bfloat16)
        else:
            y = a.contiguous()
        dst = outs[i] if outs is not None else None
        res.append(y if dst is None else dst.copy_(y))
        off += n
    return res


def conv_int8_plain(x: torch.Tensor, w: torch.Tensor, epi: Epilogue,
                    strides: Tuple[int, int] = (1, 1), pad: Tuple[int, int] = (0, 0),
                    outs: Optional[Sequence[Optional[torch.Tensor]]] = None
                    ) -> List[torch.Tensor]:
    """Plain version of :func:`conv_int8`: float64 conv (exact), cast to
    int32, then :func:`apply_epilogue_plain`."""
    acc = F.conv2d(to_nchw(x).double(), w.permute(0, 3, 1, 2).double(),
                   stride=tuple(strides), padding=tuple(pad))
    return apply_epilogue_plain(to_nhwc(acc).to(torch.int32), epi, outs)


def conv_int8(x: torch.Tensor, w: torch.Tensor, epi: Epilogue,
              strides: Tuple[int, int] = (1, 1), pad: Tuple[int, int] = (0, 0),
              outs: Optional[Sequence[Optional[torch.Tensor]]] = None
              ) -> List[torch.Tensor]:
    """int8 conv + per-segment epilogue: one tensor per segment of ``epi``.

    x: [B,H,W,Cin] int8 NHWC; may be a channel slice of a larger tensor.
    w: [Cout,kh,kw,Cin] int8, contiguous.  ``pad``: zero padding (top and
    bottom, left and right).  outs: optional destination per segment
    ([B,Ho,Wo,width] of the kind's dtype, channels contiguous; a channel
    slice qualifies); None entries are allocated.
    """
    B, H, W, cin = x.shape
    cout, kh, kw, cin_w = w.shape
    if cin_w != cin or sum(epi.widths) != cout:
        raise ValueError(f"conv_int8: x {tuple(x.shape)}, w {tuple(w.shape)} and "
                         f"epilogue widths {epi.widths} do not fit")
    if len(epi.kinds) > MAX_SEGMENTS:
        raise ValueError(f"conv_int8: at most {MAX_SEGMENTS} segments, got {len(epi.kinds)}")
    Ho, Wo = _out_hw(x, w, strides, pad)
    if Ho < 1 or Wo < 1:
        raise ValueError(f"conv_int8: empty output for x {tuple(x.shape)}, kernel "
                         f"{(kh, kw)}, strides {strides}, pad {pad}")
    outs = list(outs) if outs is not None else [None] * len(epi.kinds)
    for dst, kind, n in zip(outs, epi.kinds, epi.widths):
        if dst is not None and (tuple(dst.shape) != (B, Ho, Wo, n) or dst.dtype != OUT_DTYPE[kind]):
            raise ValueError(f"conv_int8: {kind} output {tuple(dst.shape)} {dst.dtype}, "
                             f"expected {(B, Ho, Wo, n)} {OUT_DTYPE[kind]}")
    if x.device.type == "cpu":
        return conv_int8_plain(x, w, epi, strides, pad, outs)
    dev = x.device
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise ValueError(f"conv_int8: x is {x.dtype}, w {w.dtype}; the kernel takes torch.int8")
    if w.device != dev or epi.bias_i.device != dev or any(
            o is not None and o.device != dev for o in outs):
        raise ValueError(f"conv_int8: w, the epilogue and the outputs must be on {dev}")
    if not w.is_contiguous():
        raise ValueError("conv_int8: w must be contiguous")
    outs = [torch.empty(B, Ho, Wo, n, dtype=OUT_DTYPE[kind], device=dev)
            if dst is None else dst for dst, kind, n in zip(outs, epi.kinds, epi.widths)]
    n = len(outs)
    args = (x.data_ptr(), _pixel_stride(x, "x"), w.data_ptr(), B, H, W, cin, Ho, Wo, cout,
            kh, kw, int(strides[0]), int(strides[1]), int(pad[0]), int(pad[1]),
            epi.bias_i.data_ptr(), epi.shift.data_ptr(), epi.mul.data_ptr(),
            epi.add.data_ptr(), n, epi.c_ends, epi.c_kinds,
            (ctypes.c_longlong * n)(*[_pixel_stride(o, f"output {i}") for i, o in enumerate(outs)]),
            (ctypes.c_void_p * n)(*[o.data_ptr() for o in outs]),
            torch.cuda.current_stream(dev).cuda_stream)
    lib = _build.library("int8_conv")
    if dev.index == torch.cuda.current_device():
        err = lib.conv_int8(*args)
    else:
        with torch.cuda.device(dev):
            err = lib.conv_int8(*args)
    _build.check(err, "conv_int8", "int8_conv")
    conv_int8.launches += 1
    return outs


conv_int8.launches = 0


def valid_conv3x3_int8_shift(x, w_q, b_i32, k_i32) -> torch.Tensor:
    """VALID stride-1 int8 conv with the fused integer shift epilogue, with
    the signature and meaning of the TPU kernel's public function.

    x: [B,H,W,Cin] int8; w_q: [3,3,Cin,Cout] int8 (HWIO); b_i32/k_i32:
    [Cout] int32 (bias-with-rounding and per-channel right shift, as
    ``ops.quant._Int8Ops._weights`` builds them in "shift" mode).  Returns
    [B,H-2,W-2,Cout] int8 ``clamp((conv + b_i) >> k, 0, 127)``.
    """
    x = torch.as_tensor(x)
    w = torch.as_tensor(w_q).to(x.device).permute(3, 0, 1, 2).contiguous()
    epi = Epilogue.build([("shift", w.shape[0], np.asarray(b_i32), np.asarray(k_i32))],
                         x.device)
    return conv_int8(x, w, epi)[0]


def reset_launches() -> None:
    conv_int8.launches = 0
