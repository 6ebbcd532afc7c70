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
space-to-depth stem, the 3x3/2 stem on Cin 3): ``wgmma`` fed by a 3-slot
shared-memory ring (``cp.async`` for the gathered pixels, TMA for the
weights), persistent blocks, an epilogue stored by bulk copies, on a tile
that :func:`pick_tile` chooses per conv from a fixed set (:data:`CONFIGS`).
Inputs whose channels or strides are not multiples of 4 bytes (the Cin 3
stem of the float front) take the older ``mma.sync`` kernel with byte
loads instead, by that fixed rule and never as a recovery;
``conv_int8.byte_launches`` counts those launches apart.
The epilogue is chosen per output-channel segment (:class:`Epilogue`), so
a packed 1x1 conv is one launch whose slices end in different kinds and
different tensors:

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
launches the kernel or raises.  ``conv_int8.launches`` counts launches
(run, not recorded into a CUDA graph).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
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

# The tiles csrc/int8_conv.cu instantiates (WGMMA_CONFIGS), per copy width:
# BM output pixels (one warpgroup per 64) by BN output channels (a width
# that wgmma m64nNk32 takes for .s8).
SMS = 132                 # streaming multiprocessors of an H100 SXM
TILE_BM = (64, 128)
TILE_BN = (32, 64, 96, 128, 192, 256)
CONFIGS = {16: tuple((bm, bn) for bm in TILE_BM for bn in TILE_BN if bm * bn < 128 * 256),
           4: tuple((bm, bn) for bm in TILE_BM for bn in (32, 64))}
_BK = 128                 # csrc/int8_conv.cu BK
_SMEM, _REGS = 232_448, 65_536   # per SM: shared-memory bytes a block may use, registers


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """The kernel and tile of one conv: ``load_bytes`` 16 or 4 is the
    wgmma kernel with copies of that width on a ``bm`` x ``bn`` tile; 1 is
    the byte-load ``mma.sync`` kernel (64 x 64)."""

    load_bytes: int
    bm: int
    bn: int

    @property
    def name(self) -> str:
        if self.load_bytes == 1:
            return "bytes 64x64"
        return f"wgmma {self.bm}x{self.bn} cp.async{self.load_bytes}"

    def tiles(self, m: int, cout: int) -> int:
        """Output tiles of a conv with ``m`` pixels and ``cout`` channels."""
        return -(-m // self.bm) * -(-cout // self.bn)


def _smem_bytes(bm: int, bn: int) -> int:
    """Shared memory of one block (csrc/int8_conv.cu wgmma_smem_bytes): a
    3-step ring, the output tile (at most 4 bytes an element), the channel
    constants and column descriptors, the segment and part tables, the
    ring's barriers and 1024 bytes of alignment slack."""
    return 3 * (bm + bn) * _BK + bm * bn * 4 + 64 + 32 * bn + 128 + 256 + 64 + 1024


def _tile_cost(m: int, cout: int, k: int, bm: int, bn: int) -> float:
    """Relative time of one conv on a bm x bn tile, in SM clocks, from a
    model fitted to the kernel's times on an H100 at ten served shapes and
    every tile (``python -m tumblr_emotions_torch.tile_sweep`` measures
    them; on the final kernel the pick was the fastest tile at six shapes
    and within 9% of it at the others).  A tile costs its shared-memory fill (bm + bn
    bytes per K byte at 24 bytes a clock per SM), its output (6 bytes a
    clock), its MMAs (4,096 MACs a clock) and 800 clocks per K step; blocks
    resident together on an SM overlap a third of that with each other."""
    k32 = -(-k // 32) * 32
    steps = -(-k // _BK)
    per_tile = (k32 * (bm + bn) / 24 + bm * min(bn, cout) / 6 + bm * bn * k32 / 4096
                + 800 * steps)
    threads = 2 * bm
    regs = 8 * -(-(bn // 2 + 48) // 8)
    occ = max(1, min(_SMEM // _smem_bytes(bm, bn), _REGS // (threads * regs), 2048 // threads))
    waves = -(-(-(-m // bm) * -(-cout // bn)) // (SMS * occ))
    return waves * occ * per_tile / (1 + 0.35 * (min(occ, 4) - 1))


@functools.lru_cache(maxsize=None)
def pick_tile(m: int, cout: int, k: int, load_bytes: int) -> TileConfig:
    """The tile of a conv with ``m`` output pixels, ``cout`` channels and
    ``k`` = kh*kw*Cin: among the tiles that cut the output into at least
    one tile per SM (or, where none does, into the most tiles), the one of
    least :func:`_tile_cost`, the larger on a tie.  ``load_bytes`` 1 (the
    byte-load kernel) has one tile."""
    if load_bytes == 1:
        return TileConfig(1, 64, 64)
    cands = [TileConfig(load_bytes, bm, bn) for bm, bn in CONFIGS[load_bytes]]
    tiles = {c: c.tiles(m, cout) for c in cands}
    pool = [c for c in cands if tiles[c] >= SMS] or \
        [c for c in cands if tiles[c] == max(tiles.values())]
    return min(pool, key=lambda c: (_tile_cost(m, cout, k, c.bm, c.bn), -c.bm * c.bn))


def _nhwc_stride(x: torch.Tensor) -> Optional[int]:
    """The pixel stride of ``x`` where its channels are contiguous within
    NHWC pixels (a channel slice qualifies), else None: the wrapper then
    copies it (the float front's stem input is a permuted view)."""
    B, H, W, C = x.shape
    s = x.stride()
    if s[3] == 1 and s[2] >= C and s[1] == W * s[2] and s[0] == H * s[1]:
        return s[2]
    return None


def _copy_width(cin: int, x_stride: int, x_ptr: int, w_ptr: int) -> int:
    for a in (16, 4):
        if cin % a == 0 and x_stride % a == 0 and x_ptr % a == 0 and w_ptr % a == 0:
            return a
    return 1


def load_bytes(x: torch.Tensor, w: torch.Tensor) -> int:
    """Copy width of a conv's input: 16 bytes where Cin, the input pixel
    stride and both pointers are multiples of 16, else 4 where they are
    multiples of 4, else 1 (the byte-load kernel).  An input that must be
    copied counts as its copy: contiguous and aligned."""
    cin = x.shape[-1]
    xs = _nhwc_stride(x)
    if xs is None:
        return _copy_width(cin, cin, 0, w.data_ptr())
    return _copy_width(cin, xs, x.data_ptr(), w.data_ptr())


def conv_config(x: torch.Tensor, w: torch.Tensor, strides=(1, 1), pad=(0, 0)) -> TileConfig:
    """The kernel and tile :func:`conv_int8` launches for these operands."""
    B = x.shape[0]
    cout, kh, kw, cin = w.shape
    ho, wo = _out_hw(x, w, strides, pad)
    return pick_tile(B * ho * wo, cout, kh * kw * cin, load_bytes(x, w))


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
        # The kernel's segment table, built once (ctypes arrays), and the
        # plans of the operand geometries this epilogue's conv has seen.
        k = len(self.kinds)
        object.__setattr__(self, "c_ends", (ctypes.c_int * k)(*np.cumsum(self.widths).tolist()))
        object.__setattr__(self, "c_kinds", (ctypes.c_int * k)(*[KINDS.index(x) for x in self.kinds]))
        object.__setattr__(self, "plans", {})

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


@dataclasses.dataclass(frozen=True)
class _Plan:
    """What :func:`conv_int8` decides once per operand geometry: the kernel
    and tile, the outputs' shapes, the input's pixel stride (of its copy
    where ``copy``), and the C call's geometry arguments."""

    cfg: TileConfig
    out_shapes: Tuple[Tuple[int, int, int, int], ...]
    x_stride: int
    copy: bool
    geom: Tuple[int, ...]


def _plan(x: torch.Tensor, w: torch.Tensor, epi: Epilogue, strides, pad,
          cfg: Optional[TileConfig] = None) -> _Plan:
    """Check the operands' shapes and decide the launch (:func:`conv_config`'s
    tile, or ``cfg`` where it is one the kernel has for these operands)."""
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
    xs = _nhwc_stride(x)
    auto = pick_tile(B * Ho * Wo, cout, kh * kw * cin, load_bytes(x, w))
    if cfg is None:
        cfg = auto
    elif not ((cfg.bm, cfg.bn) == (64, 64) if cfg.load_bytes == 1 else (
            (cfg.bm, cfg.bn) in CONFIGS.get(cfg.load_bytes, ()) and
            cfg.load_bytes <= auto.load_bytes)):
        raise ValueError(f"conv_int8: tile {cfg} is not one the kernel has for these "
                         f"operands (copy width {auto.load_bytes})")
    return _Plan(cfg, tuple((B, Ho, Wo, n) for n in epi.widths),
                 cin if xs is None else xs, xs is None,
                 (B, H, W, cin, Ho, Wo, cout, kh, kw, int(strides[0]), int(strides[1]),
                  int(pad[0]), int(pad[1])))


def conv_int8(x: torch.Tensor, w: torch.Tensor, epi: Epilogue,
              strides: Tuple[int, int] = (1, 1), pad: Tuple[int, int] = (0, 0),
              outs: Optional[Sequence[Optional[torch.Tensor]]] = None) -> List[torch.Tensor]:
    """int8 conv + per-segment epilogue: one tensor per segment of ``epi``.

    x: [B,H,W,Cin] int8 NHWC; may be a channel slice of a larger tensor.
    w: [Cout,kh,kw,Cin] int8, contiguous.  ``pad``: zero padding (top and
    bottom, left and right).  outs: optional destination per segment
    ([B,Ho,Wo,width] of the kind's dtype, channels contiguous; a channel
    slice qualifies); None entries are allocated.  The shape checks and the
    tile are decided once per operand geometry and kept on ``epi``, which
    an engine builds once per conv site.
    """
    key = (x.shape, x.stride(), x.data_ptr() & 15, w.shape, w.data_ptr() & 15, *strides, *pad)
    plan = epi.plans.get(key)
    if plan is None:
        plan = epi.plans[key] = _plan(x, w, epi, strides, pad)
    return _run(plan, x, w, epi, strides, pad, outs)


def _launch(cfg: TileConfig, x: torch.Tensor, w: torch.Tensor, epi: Epilogue,
            strides=(1, 1), pad=(0, 0), outs=None) -> List[torch.Tensor]:
    """:func:`conv_int8` on a given kernel and tile (the card tests and
    ``tile_sweep`` run every one); raises ValueError for a tile the kernel
    does not have for these operands."""
    return _run(_plan(x, w, epi, strides, pad, cfg), x, w, epi, strides, pad, outs)


def _run(plan: _Plan, x, w, epi: Epilogue, strides, pad, outs) -> List[torch.Tensor]:
    if outs is None:
        outs = [None] * len(plan.out_shapes)
    else:
        outs = list(outs)
        for dst, kind, shape in zip(outs, epi.kinds, plan.out_shapes):
            if dst is not None and (dst.shape != shape or dst.dtype != OUT_DTYPE[kind]):
                raise ValueError(f"conv_int8: {kind} output {tuple(dst.shape)} {dst.dtype}, "
                                 f"expected {shape} {OUT_DTYPE[kind]}")
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
    outs = [torch.empty(shape, dtype=OUT_DTYPE[kind], device=dev) if dst is None else dst
            for dst, kind, shape in zip(outs, epi.kinds, plan.out_shapes)]
    if plan.copy:
        x = x.contiguous()
    cfg, n = plan.cfg, len(outs)
    args = (x.data_ptr(), plan.x_stride, w.data_ptr(), *plan.geom,
            epi.bias_i.data_ptr(), epi.shift.data_ptr(), epi.mul.data_ptr(),
            epi.add.data_ptr(), n, epi.c_ends, epi.c_kinds,
            (ctypes.c_longlong * n)(*[_pixel_stride(o, f"output {i}") for i, o in enumerate(outs)]),
            (ctypes.c_void_p * n)(*[o.data_ptr() for o in outs]),
            cfg.load_bytes, cfg.bm, cfg.bn, dev.index, _build.raw_stream(dev))
    lib = _build.library("int8_conv")
    if dev.index == torch.cuda.current_device():
        err = lib.conv_int8(*args)
    else:
        with torch.cuda.device(dev):
            err = lib.conv_int8(*args)
    _build.check(err, "conv_int8", "int8_conv")
    if _build.launched(dev):
        conv_int8.launches += 1
        if cfg.load_bytes == 1:
            conv_int8.byte_launches += 1
    return outs


conv_int8.launches = 0
conv_int8.byte_launches = 0


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
    conv_int8.byte_launches = 0
