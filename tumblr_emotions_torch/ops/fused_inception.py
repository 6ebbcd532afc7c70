"""Fused Inception-A/B blocks for Hopper: ports of the TPU Pallas blocks.

Replaces ``tumblr_emotions_tpu/ops/fused_inception.py::fused_inception_a``
(Mixed_5b/5c/5d, 35x35) and ``::fused_inception_b`` (Mixed_6b..6e, 17x17).
On the TPU each block is one Pallas program per image that keeps the whole
plane in VMEM and computes every SAME conv as masked row-shifted matmuls.
An H100 block has 227 KB of shared memory, less than one plane (35x35x288
bf16 is 0.7 MB), so the port runs each block as a fixed plan of launches
of one kernel (:class:`BlockPlan`):

1. the three 1x1 convs over the block input (Branch_0 and the openings of
   Branch_1 and Branch_2) as one conv over their concatenated weights
   (Cout 176 in Inception-A, 448-576 in Inception-B), whose output
   segments go to Branch_0's slice of the block output and to the two
   branch intermediates;
2. each later conv of Branch_1 and Branch_2, the last one into its slice
   of the block output (so there is no concat);
3. the pool branch as the pooled form: the 1x1 conv whose input is the
   3x3 SAME average of the block input (``count_include_pad=False``),
   computed inside the kernel, so the pooled plane never goes to memory.

That is 5 launches per Inception-A block and 8 per Inception-B block.  On
the CPU the same plan runs with the plain per-launch function.

The kernel, ``conv_bf16_wgmma`` (``csrc/inception_blocks.cu``), is a
stride-1 SAME conv as an implicit GEMM (M = B*H*W pixels, N = Cout, K =
kh*kw*Cin) on ``wgmma`` bf16 tensor cores with an f32 accumulator, fed by
a 3-slot shared-memory ring (``cp.async`` for the gathered pixels, TMA for
the weights), in persistent blocks, + bias, ReLU, rounded once to bf16 and
stored by bulk copies into each segment's tensor; the tile is chosen per
conv by :func:`pick_tile` from a fixed set (:data:`CONFIGS`).  The weights
are held K-major ([Cout, kh*kw*Cin], each channel's K run contiguous), as
``wgmma`` reads them, packed once per engine (:class:`ConvOp`).

What bounds a block on an H100 (989 TFLOP/s bf16, 3.35 TB/s): per image,
Mixed_5b does 0.62 GFLOP against 1.10 MB of block input and output (570
FLOP per byte), Mixed_6b 0.75 GFLOP against 0.89 MB (840 FLOP per byte);
both are above the 295 FLOP per byte at which the tensor cores, not
memory, are the limit.  Intermediates go through device memory (mostly
L2), where the TPU kept them in VMEM.

Each kernel form has a plain PyTorch version beside it (f32 math, rounded
to the working type after every conv, where the kernel rounds).  A
wrapper takes the plain version only for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises.  ``conv_same_bias_relu.launches``
counts the kernel's launches (``.pooled_launches`` those of the pooled
form); ``fused_inception_a/_b.launches`` the blocks run on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tumblr_emotions_torch._device import full_f32
from tumblr_emotions_torch.models.inception_v3 import inception_a_names
from tumblr_emotions_torch.models.layers import to_nchw, to_nhwc
from tumblr_emotions_torch.ops import _build

Taps = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


# ---------------------------------------------------------------------------
# Batch-norm folding (inference)
# ---------------------------------------------------------------------------

def fold_batchnorm(state: Dict[str, torch.Tensor], eps: float = 0.001
                   ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Fold slim BN (scale=False) into the conv weights of a port state dict.

    Returns {conv_scope: (w_folded [Cout,Cin,kh,kw] f32, b_folded [Cout] f32)}
    on the CPU.  y = (x*w - mean) * inv + beta == x @ (w*inv) + (beta - mean*inv).
    Convs without BN (the Logits/AuxLogits heads) pass through with their biases.
    The arithmetic is numpy float32, as in the JAX package, so the folded
    weights are bit-equal to its own.
    """
    f32 = {k: v.detach().cpu().numpy().astype(np.float32) for k, v in state.items()}
    out: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
    for key, w in f32.items():
        if not key.endswith(".weights"):
            continue
        scope = key[: -len(".weights")]
        mean = f32.get(f"{scope}.BatchNorm.moving_mean")
        if mean is not None:
            var = f32[f"{scope}.BatchNorm.moving_variance"]
            inv = 1.0 / np.sqrt(var + eps)
            gamma = f32.get(f"{scope}.BatchNorm.gamma")
            if gamma is not None:
                inv = inv * gamma
            w, b = w * inv[:, None, None, None], f32[f"{scope}.BatchNorm.beta"] - mean * inv
        else:
            b = f32.get(f"{scope}.biases", np.zeros(w.shape[0], np.float32))
        out[scope] = (torch.from_numpy(w), torch.from_numpy(b))
    return out


def _taps(w: torch.Tensor) -> torch.Tensor:
    """[Cout,Cin,kh,kw] -> [kh*kw, Cin, Cout] tap stack (contiguous)."""
    co, ci, kh, kw = w.shape
    return w.permute(2, 3, 1, 0).reshape(kh * kw, ci, co).contiguous()


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def conv_same_bias_relu_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                              kernel: Tuple[int, int], out: torch.Tensor = None
                              ) -> torch.Tensor:
    """Plain version: f32 SAME conv of NHWC ``x`` with tap stack ``w``
    [kh*kw, Cin, Cout], + bias, ReLU, rounded to ``x.dtype`` (copied into
    ``out`` if given)."""
    kh, kw = kernel
    w4 = w.float().reshape(kh, kw, w.shape[1], w.shape[2]).permute(3, 2, 0, 1)
    with full_f32():
        y = F.conv2d(to_nchw(x.float()), w4, padding=(kh // 2, kw // 2))
    y = torch.relu(to_nhwc(y) + bias.float()).to(x.dtype)
    return y if out is None else out.copy_(y)


def avg_pool3_same_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version: 3x3 stride-1 SAME average pool, count_include_pad=False,
    in f32, rounded to ``x.dtype``."""
    y = F.avg_pool2d(to_nchw(x.float()), 3, 1, padding=1, count_include_pad=False)
    return to_nhwc(y).to(x.dtype)


def conv_segments_plain(x: torch.Tensor, op: "ConvOp",
                        outs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Plain version of one launch of ``op``: relu(SAME conv of ``x`` (or
    of its 3x3 average, ``op.pooled``) + bias) in f32, rounded to
    ``x.dtype``, each segment copied into its tensor of ``outs``."""
    kh, kw = op.kernel
    if op.pooled:
        x = avg_pool3_same_plain(x)
    w4 = op.w.float().reshape(op.cout, kh, kw, op.cin).permute(0, 3, 1, 2)
    with full_f32():
        y = F.conv2d(to_nchw(x.float()), w4, padding=(kh // 2, kw // 2))
    y = torch.relu(to_nhwc(y) + op.bias.float()).to(x.dtype)
    for o, part in zip(outs, torch.split(y, op.widths, dim=-1)):
        o.copy_(part)
    return list(outs)


def _pixel_stride(t: torch.Tensor, what: str) -> int:
    """Stride between pixels of an NHWC tensor whose channels are contiguous
    (a channel slice of a larger NHWC tensor qualifies)."""
    B, H, W, C = t.shape
    s = t.stride()
    if not (s[3] == 1 and s[2] >= C and s[1] == W * s[2] and s[0] == H * s[1]):
        raise ValueError(f"{what}: NHWC layout with contiguous channels "
                         f"expected, got shape {tuple(t.shape)} strides {s}")
    return s[2]


# ---------------------------------------------------------------------------
# The kernel's tiles
# ---------------------------------------------------------------------------

# The tiles csrc/inception_blocks.cu instantiates (BF16_CONFIGS): BM output
# pixels (one warpgroup per 64) by BN output channels, per form (pooled or
# not).  The BN cover every Cout of the blocks' convs and the packed widths
# (176; 448 = 2 x 224, 512 = 2 x 256, 576 = 3 x 192); the pooled form's
# Couts are 32, 64 and 192.
SMS = 132                 # streaming multiprocessors of an H100 SXM
TILE_BM = (64, 128)
TILE_BN = (32, 48, 64, 96, 128, 160, 176, 192, 224, 256)
POOLED_BN = (32, 64, 192)
CONFIGS = {False: tuple((bm, bn) for bm in TILE_BM for bn in TILE_BN),
           True: tuple((bm, bn) for bm in TILE_BM for bn in POOLED_BN)}
MAX_SEGMENTS = 4          # csrc/inception_blocks.cu MAX_SEGS
_BK = 64                  # K elements per ring stage (csrc/inception_blocks.cu BK)
_SMEM, _REGS = 232_448, 65_536   # per SM: shared-memory bytes a block may use, registers


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """The tile of one launch: ``bm`` pixels by ``bn`` channels, of the
    pooled form or not."""

    bm: int
    bn: int
    pooled: bool = False

    @property
    def name(self) -> str:
        return f"wgmma {self.bm}x{self.bn}" + (" pooled" if self.pooled else "")

    def tiles(self, m: int, cout: int) -> int:
        """Output tiles of a conv with ``m`` pixels and ``cout`` channels."""
        return -(-m // self.bm) * -(-cout // self.bn)


def _smem_bytes(bm: int, bn: int, pooled: bool = False, width: int = 0) -> int:
    """Shared memory of one block (csrc/inception_blocks.cu smem_bytes and
    halo_bytes): a 3-step ring of 128-byte rows (one A stage in the pooled
    form, with a 3-step ring of its halo, bm + 2 * width + 2 pixels a
    stage), the bf16 output tile, the bias, the column groups, the part
    table, the ring's barriers and alignment slack."""
    halo = 3 * (bm + 2 * width + 2) * 128 if pooled else 0
    return ((1 if pooled else 3) * bm * 128 + 3 * bn * 128 + bm * bn * 2 + 4 * bn + bn + 256
            + 8 * 3 + 1024 + 128 + halo)


def _tile_cost(m: int, cout: int, k: int, bm: int, bn: int, pooled: bool, width: int) -> float:
    """Relative time of one launch on a bm x bn tile, in SM clocks: the
    int8 kernel's model (``int8_conv._tile_cost``) refitted to this
    kernel's times on an H100 at its served shapes (``python -m
    tumblr_emotions_torch.tile_sweep --kernel bf16``; at 13 served shapes
    the pick was within 12% of the fastest tile, 4% on average).  A tile costs its
    shared-memory fill ((bm + bn) * 2 bytes per K element at 8 bytes a
    clock per SM; the pooled form fills its halo, bm + 2 * width + 2
    pixels, and averages nine of them per A element at 64 bytes a clock),
    its output (2 bytes a clock), its MMAs (2,048 bf16 MACs a clock) and
    200 clocks per K step; blocks resident together on an SM overlap a
    sixth of that with each other."""
    k16 = -(-k // 16) * 16
    steps = -(-k // _BK)
    rows = bm + 2 * width + 2 if pooled else bm
    per_tile = (k16 * (rows + bn) * 2 / 8 + (9 * bm * k16 * 2 / 64 if pooled else 0)
                + bm * min(bn, cout) * 2 / 2 + bm * bn * k16 / 2048 + 200 * steps)
    threads = 2 * bm
    regs = 8 * -(-(bn // 2 + 48) // 8)
    occ = max(1, min(_SMEM // _smem_bytes(bm, bn, pooled, width), _REGS // (threads * regs),
                     2048 // threads))
    waves = -(-(-(-m // bm) * -(-cout // bn)) // (SMS * occ))
    return waves * occ * per_tile / (1 + 0.2 * (min(occ, 4) - 1))


@functools.lru_cache(maxsize=None)
def pick_tile(m: int, cout: int, k: int, pooled: bool = False, width: int = 0) -> TileConfig:
    """The tile of a launch with ``m`` output pixels, ``cout`` channels and
    ``k`` = kh*kw*Cin (the pooled form: over images ``width`` pixels wide):
    among the tiles of its form whose shared memory fits and that cut the
    output into at least one tile per SM (or, where none does, into the
    most tiles), the one of least :func:`_tile_cost`, the larger on a tie."""
    cands = [TileConfig(bm, bn, pooled) for bm, bn in CONFIGS[pooled]
             if _smem_bytes(bm, bn, pooled, width) <= _SMEM]
    if not cands:
        raise ValueError(f"conv_same_bias_relu: no tile of the pooled form fits images "
                         f"{width} pixels wide")
    tiles = {c: c.tiles(m, cout) for c in cands}
    pool = [c for c in cands if tiles[c] >= SMS] or \
        [c for c in cands if tiles[c] == max(tiles.values())]
    return min(pool, key=lambda c: (_tile_cost(m, cout, k, c.bm, c.bn, pooled, width),
                                    -c.bm * c.bn))


# ---------------------------------------------------------------------------
# One launch: ConvOp
# ---------------------------------------------------------------------------

class ConvOp:
    """The weights of one launch of the block conv, packed once.

    ``parts``: one (tap stack [kh*kw, Cin, Cout_i], bias [Cout_i] f32) per
    output segment, all over the same input; ``pooled``: the input is the
    3x3 SAME average of the given tensor (1x1 kernels only).  Holds the
    K-major weights ``w`` [sum Cout_i, kh*kw*Cin] (in the tap stacks'
    dtype and device), the f32 ``bias``, the segment ``widths`` and, per
    operand geometry seen, the launch decided for it (``plans``).
    """

    def __init__(self, parts: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                 kernel: Tuple[int, int], pooled: bool = False):
        kh, kw = kernel
        cins = {t.shape[1] for t, _ in parts}
        if len(cins) != 1 or any(t.shape[0] != kh * kw for t, _ in parts) \
                or kh % 2 == 0 or kw % 2 == 0 or (pooled and (kh, kw) != (1, 1)):
            raise ValueError(f"ConvOp: kernel {kernel} (pooled={pooled}) and tap stacks "
                             f"{[tuple(t.shape) for t, _ in parts]} do not fit")
        if len(parts) > MAX_SEGMENTS:
            raise ValueError(f"ConvOp: at most {MAX_SEGMENTS} segments, got {len(parts)}")
        self.kernel, self.pooled, self.cin = (kh, kw), pooled, cins.pop()
        self.widths = tuple(int(t.shape[2]) for t, _ in parts)
        self.cout = sum(self.widths)
        self.w = torch.cat([t.permute(2, 0, 1).reshape(t.shape[2], -1) for t, _ in parts])
        self.bias = torch.cat([b.float() for _, b in parts])
        self.c_ends = (ctypes.c_int * len(parts))(*np.cumsum(self.widths).tolist())
        self.plans: Dict[tuple, "_Plan"] = {}

    def __call__(self, x: torch.Tensor, outs: Optional[Sequence[Optional[torch.Tensor]]] = None
                 ) -> List[torch.Tensor]:
        """One launch over NHWC ``x`` (a channel slice qualifies): one
        [B,H,W,width] tensor per segment, written into ``outs[i]`` where
        given (a channel slice qualifies), else allocated."""
        return _run(self, x, outs)


@dataclasses.dataclass(frozen=True)
class _Plan:
    """What a launch decides once per operand geometry: the tile, the
    input's pixel stride and the outputs' (a ctypes array)."""

    cfg: TileConfig
    x_stride: int
    c_strides: object


def _plan(op: ConvOp, x: torch.Tensor, outs: Sequence[torch.Tensor],
          cfg: Optional[TileConfig] = None) -> _Plan:
    """Check the operands of a launch on the card and decide its tile
    (:func:`pick_tile`'s, or ``cfg`` where it is one the kernel has)."""
    name = "conv_same_bias_relu"
    dev = x.device
    for what, t, dt in [("x", x, torch.bfloat16), ("w", op.w, torch.bfloat16),
                        ("bias", op.bias, torch.float32)] + \
            [(f"output {i}", o, torch.bfloat16) for i, o in enumerate(outs)]:
        if t.device != dev:
            raise ValueError(f"{name}: {what} on {t.device}, expected {dev}")
        if t.dtype != dt:
            raise ValueError(f"{name}: {what} is {t.dtype}, the kernel takes {dt}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} is not 16-byte aligned")
    strides = [_pixel_stride(o, f"output {i}") for i, o in enumerate(outs)]
    xs = _pixel_stride(x, "x")
    if op.cin % 8 or xs % 8 or any(w % 8 for w in op.widths) or any(s % 8 for s in strides):
        raise ValueError(f"{name}: the kernel takes Cin, segment widths and pixel strides "
                         f"that are multiples of 8, got {op.cin}, {op.widths}, {xs}, {strides}")
    B, H, W, _ = x.shape
    width = W if op.pooled else 0
    if cfg is None:
        cfg = pick_tile(B * H * W, op.cout, op.kernel[0] * op.kernel[1] * op.cin, op.pooled,
                        width)
    elif cfg.pooled != op.pooled or (cfg.bm, cfg.bn) not in CONFIGS[op.pooled] or \
            _smem_bytes(cfg.bm, cfg.bn, cfg.pooled, width) > _SMEM:
        raise ValueError(f"{name}: tile {cfg} is not one the kernel has for this form")
    return _Plan(cfg, xs, (ctypes.c_longlong * len(strides))(*strides))


def _run(op: ConvOp, x: torch.Tensor, outs=None, cfg: Optional[TileConfig] = None
         ) -> List[torch.Tensor]:
    """:meth:`ConvOp.__call__`, on a given tile where ``cfg`` is given (the
    card tests and the tile sweep run every one)."""
    B, H, W, cin = x.shape
    if cin != op.cin:
        raise ValueError(f"conv_same_bias_relu: x {tuple(x.shape)} has not the weights' "
                         f"{op.cin} channels")
    outs = list(outs) if outs is not None else [None] * len(op.widths)
    for i, (o, n) in enumerate(zip(outs, op.widths)):
        if o is None:
            outs[i] = torch.empty(B, H, W, n, dtype=x.dtype, device=x.device)
        elif tuple(o.shape) != (B, H, W, n):
            raise ValueError(f"conv_same_bias_relu: output {i} {tuple(o.shape)} != "
                             f"{(B, H, W, n)}")
    if x.device.type == "cpu":
        return conv_segments_plain(x, op, outs)
    if cfg is None:
        key = (x.shape, x.stride(), x.data_ptr() % 16,
               tuple((o.stride(), o.data_ptr() % 16) for o in outs))
        plan = op.plans.get(key)
        if plan is None:
            plan = op.plans[key] = _plan(op, x, outs)
    else:
        plan = _plan(op, x, outs, cfg)
    _launch(op, plan.cfg, x.data_ptr(), plan.x_stride, B, H, W, plan.c_strides,
            [o.data_ptr() for o in outs], x.device)
    return outs


def _launch(op: ConvOp, cfg: TileConfig, x_ptr: int, x_stride: int, B: int, H: int, W: int,
            c_strides, out_ptrs: Sequence[int], dev: torch.device) -> None:
    n = len(out_ptrs)
    args = (x_ptr, x_stride, op.w.data_ptr(), op.bias.data_ptr(), B, H, W, op.cin, op.cout,
            op.kernel[0], op.kernel[1], int(op.pooled), n, op.c_ends, c_strides,
            (ctypes.c_void_p * n)(*out_ptrs), cfg.bm, cfg.bn, dev.index, _build.raw_stream(dev))
    lib = _build.library("inception_blocks")
    if dev.index == torch.cuda.current_device():
        err = lib.conv_bf16(*args)
    else:
        with torch.cuda.device(dev):
            err = lib.conv_bf16(*args)
    _build.check(err, "conv_same_bias_relu", "inception_blocks")
    if _build.launched(dev):
        conv_same_bias_relu.launches += 1
        if op.pooled:
            conv_same_bias_relu.pooled_launches += 1


def conv_same_bias_relu(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                        kernel: Tuple[int, int], out: torch.Tensor = None) -> torch.Tensor:
    """relu(SAME_conv(x, w) + bias) -> bf16, for stride 1 and an odd kernel.

    x: [B,H,W,Cin] NHWC; may be a channel slice of a larger NHWC tensor.
    w: [kh*kw, Cin, Cout] tap stack (``_taps``).  bias: [Cout] f32.
    out: optional [B,H,W,Cout] destination, e.g. a channel slice of a
    block's output; allocated if None.  On the card the kernel takes bf16
    with Cin, Cout and the pixel strides multiples of 8.  Packs the weights
    on every call: a caller that repeats a conv keeps a :class:`ConvOp`.
    """
    return ConvOp([(w, bias)], kernel)(x, [out])[0]


conv_same_bias_relu.launches = 0
conv_same_bias_relu.pooled_launches = 0


# ---------------------------------------------------------------------------
# The blocks
# ---------------------------------------------------------------------------

# A block is four branches; each is (starts with the 3x3 avg pool?, its
# chain of (conv name, kernel)).  The last conv of a branch writes its
# channel slice of the output.
Branches = Sequence[Tuple[bool, List[Tuple[str, Tuple[int, int]]]]]


def inception_a_branches(quirky_5c: bool) -> Branches:
    n1 = inception_a_names(quirky_5c)
    return [
        (False, [("Branch_0/Conv2d_0a_1x1", (1, 1))]),
        (False, [(f"Branch_1/{n1[0]}", (1, 1)), (f"Branch_1/{n1[1]}", (5, 5))]),
        (False, [("Branch_2/Conv2d_0a_1x1", (1, 1)),
                 ("Branch_2/Conv2d_0b_3x3", (3, 3)),
                 ("Branch_2/Conv2d_0c_3x3", (3, 3))]),
        (True, [("Branch_3/Conv2d_0b_1x1", (1, 1))]),
    ]


INCEPTION_B_BRANCHES: Branches = [
    (False, [("Branch_0/Conv2d_0a_1x1", (1, 1))]),
    (False, [("Branch_1/Conv2d_0a_1x1", (1, 1)),
             ("Branch_1/Conv2d_0b_1x7", (1, 7)),
             ("Branch_1/Conv2d_0c_7x1", (7, 1))]),
    (False, [("Branch_2/Conv2d_0a_1x1", (1, 1)),
             ("Branch_2/Conv2d_0b_7x1", (7, 1)),
             ("Branch_2/Conv2d_0c_1x7", (1, 7)),
             ("Branch_2/Conv2d_0d_7x1", (7, 1)),
             ("Branch_2/Conv2d_0e_1x7", (1, 7))]),
    (True, [("Branch_3/Conv2d_0b_1x1", (1, 1))]),
]

# Where a launch reads and writes: None is the block input; ("out", c) the
# block output from channel c; ("tmp", i) the block's i-th intermediate.
Place = Tuple[str, int]


@dataclasses.dataclass(frozen=True)
class Launch:
    """One launch of a block plan: ``op`` over ``src`` (None: the block
    input, else an intermediate's index) into one place per segment."""

    op: ConvOp
    src: Optional[int]
    dsts: Tuple[Place, ...]


class BlockPlan:
    """The fixed launch plan of one Inception-A/B block, its weights packed
    once: the 1x1 convs over the block input in one launch (pooled
    branches excepted), then each later conv of each branch, then each
    pooled branch's pooled 1x1.  ``launches``, ``tmp_widths`` (the
    channels of each intermediate) and ``cout`` (the block output's)."""

    def __init__(self, taps: Taps, scope: str, branches: Branches):
        def conv(name):
            return taps[f"{scope}/{name}"]

        couts = [conv(chain[-1][0])[0].shape[-1] for _, chain in branches]
        offs = np.concatenate([[0], np.cumsum(couts)]).astype(int).tolist()
        self.cout, self.tmp_widths = offs[-1], []

        def place(branch: int, last: bool, width: int) -> Place:
            if last:
                return ("out", offs[branch])
            self.tmp_widths.append(width)
            return ("tmp", len(self.tmp_widths) - 1)

        heads = [(i, chain) for i, (pooled, chain) in enumerate(branches) if not pooled]
        if any(chain[0][1] != (1, 1) for _, chain in heads):
            raise ValueError(f"{scope}: a branch opens with a conv that is not 1x1")
        first = [place(i, len(chain) == 1, conv(chain[0][0])[0].shape[-1]) for i, chain in heads]
        self.launches = [Launch(ConvOp([conv(chain[0][0]) for _, chain in heads], (1, 1)),
                                None, tuple(first))]
        for (i, chain), at in zip(heads, first):
            for j, (name, kernel) in enumerate(chain[1:], 1):
                dst = place(i, j == len(chain) - 1, conv(name)[0].shape[-1])
                self.launches.append(Launch(ConvOp([conv(name)], kernel), at[1], (dst,)))
                at = dst
        for i, (pooled, chain) in enumerate(branches):
            if pooled:
                if len(chain) != 1 or chain[0][1] != (1, 1):
                    raise ValueError(f"{scope}: the pool branch is not one 1x1 conv")
                self.launches.append(Launch(ConvOp([conv(chain[0][0])], (1, 1), pooled=True),
                                            None, (place(i, True, couts[i]),)))
        self._geoms: Dict[tuple, list] = {}

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """The block over NHWC ``x``: the plain per-launch function on the
        CPU, the kernel on the card."""
        B, H, W, _ = x.shape
        out = torch.empty(B, H, W, self.cout, dtype=x.dtype, device=x.device)
        m = B * H * W
        tmp_offs = np.concatenate([[0], np.cumsum(self.tmp_widths)]).astype(int).tolist()
        tmp = torch.empty(m * tmp_offs[-1], dtype=x.dtype, device=x.device)
        if x.device.type == "cpu":
            for L in self.launches:
                src, dsts = self._views(L, x, out, tmp, tmp_offs)
                conv_segments_plain(src, L.op, dsts)
            return out
        key = (x.shape, x.stride(), x.data_ptr() % 16)
        geom = self._geoms.get(key)
        if geom is None:
            geom = self._geoms[key] = self._plan(x, out, tmp, tmp_offs)
        ptr = {"out": out.data_ptr(), "tmp": tmp.data_ptr()}
        for L, (cfg, x_off, x_stride, c_strides, offs) in zip(self.launches, geom):
            x_ptr = x.data_ptr() if x_off is None else ptr["tmp"] + 2 * x_off
            _launch(L.op, cfg, x_ptr, x_stride, B, H, W, c_strides,
                    [ptr[kind] + 2 * off for kind, off in offs], x.device)
        return out

    def _views(self, L: Launch, x, out, tmp, tmp_offs):
        """The input and output tensors of launch ``L``: views of the block
        input, output and intermediates."""
        B, H, W, _ = x.shape
        m = B * H * W

        def view(place: Place, width: int) -> torch.Tensor:
            kind, i = place
            if kind == "out":
                return out[..., i:i + width]
            return tmp[m * tmp_offs[i]:m * tmp_offs[i + 1]].view(B, H, W, width)

        src = x if L.src is None else view(("tmp", L.src), self.tmp_widths[L.src])
        return src, [view(p, w) for p, w in zip(L.dsts, L.op.widths)]

    def _plan(self, x, out, tmp, tmp_offs) -> list:
        """Per launch, decided once per input geometry: (tile, the input's
        element offset in the intermediates or None, its pixel stride, the
        outputs' pixel strides, each output's (buffer, element offset)).
        The shape and layout checks run on views of this call's buffers."""
        m = x.shape[0] * x.shape[1] * x.shape[2]
        geom = []
        for L in self.launches:
            plan = _plan(L.op, *self._views(L, x, out, tmp, tmp_offs))
            offs = [("out", i) if kind == "out" else ("tmp", m * tmp_offs[i])
                    for kind, i in L.dsts]
            geom.append((plan.cfg, None if L.src is None else m * tmp_offs[L.src],
                         plan.x_stride, plan.c_strides, offs))
        return geom


# Block plans, built once per (taps, scope): keyed by the identity of the
# tap stacks they packed.  An entry goes when any of those tensors is freed,
# so an id is never reused while its entry lives, and a dropped engine's
# plans go with it.
_PLANS: Dict[tuple, BlockPlan] = {}


def block_plan(taps: Taps, scope: str, branches: Branches) -> BlockPlan:
    """The cached :class:`BlockPlan` of ``scope`` over these tap stacks."""
    stacks = [taps[f"{scope}/{n}"][0] for _, chain in branches for n, _ in chain]
    key = (scope, tuple(id(t) for t in stacks))
    plan = _PLANS.get(key)
    if plan is None:
        plan = _PLANS[key] = BlockPlan(taps, scope, branches)
        for t in stacks:
            weakref.finalize(t, _PLANS.pop, key, None)
    return plan


def _run_block_plain(x: torch.Tensor, taps: Taps, scope: str, branches: Branches
                     ) -> torch.Tensor:
    """Each conv of each branch on its own, in the Pallas order, in plain
    PyTorch: independent of the launch plan."""
    B, H, W, _ = x.shape
    couts = [taps[f"{scope}/{chain[-1][0]}"][0].shape[-1] for _, chain in branches]
    out = torch.empty(B, H, W, sum(couts), dtype=x.dtype, device=x.device)
    off = 0
    for (pooled, chain), cout in zip(branches, couts):
        h = avg_pool3_same_plain(x) if pooled else x
        for i, (name, kernel) in enumerate(chain):
            w, b = taps[f"{scope}/{name}"]
            dst = out[..., off:off + cout] if i == len(chain) - 1 else None
            h = conv_same_bias_relu_plain(h, w, b, kernel, out=dst)
        off += cout
    return out


def fused_inception_a_plain(x: torch.Tensor, taps: Taps, scope: str,
                            quirky_5c: bool = False) -> torch.Tensor:
    """Plain version of ``fused_inception_a``, on any device: conv by conv,
    not through the launch plan."""
    return _run_block_plain(x, taps, scope, inception_a_branches(quirky_5c))


def fused_inception_b_plain(x: torch.Tensor, taps: Taps, scope: str) -> torch.Tensor:
    """Plain version of ``fused_inception_b``, on any device."""
    return _run_block_plain(x, taps, scope, INCEPTION_B_BRANCHES)


def fused_inception_a(x: torch.Tensor, taps: Taps, scope: str,
                      quirky_5c: bool = False) -> torch.Tensor:
    """Inception-A: x [B,H,W,Cin] -> [B,H,W,Cout], BN-folded.

    ``taps``: {conv_scope: (tap stack [kh*kw,Cin,Cout], bias f32)} on x's
    device, e.g. ``FusedInceptionV3.taps``; ``scope`` e.g. "Mixed_5b";
    ``quirky_5c`` selects slim's Mixed_5c names.  Runs the scope's
    :class:`BlockPlan` (5 launches), built on first use.
    """
    out = block_plan(taps, scope, inception_a_branches(quirky_5c))(x)
    if x.device.type != "cpu" and _build.launched(x.device):
        fused_inception_a.launches += 1
    return out


fused_inception_a.launches = 0


def fused_inception_b(x: torch.Tensor, taps: Taps, scope: str) -> torch.Tensor:
    """Inception-B (factorized 7x7): x [B,H,W,Cin] -> [B,H,W,Cout] (8 launches)."""
    out = block_plan(taps, scope, INCEPTION_B_BRANCHES)(x)
    if x.device.type != "cpu" and _build.launched(x.device):
        fused_inception_b.launches += 1
    return out


fused_inception_b.launches = 0


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in (conv_same_bias_relu, fused_inception_a, fused_inception_b):
        fn.launches = 0
    conv_same_bias_relu.pooled_launches = 0
