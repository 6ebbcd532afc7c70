"""Train-mode batch norm of the bf16 model in Triton: statistics, the
normalisation with its ReLU, and their backward, over an NHWC conv output
viewed as ``[R = N*H*W, C]`` rows.

Replaces no TPU kernel: on the TPU XLA fuses these passes into the convs'
neighbours.  It was added because, launched op by op as PyTorch kernels
(``models/layers.SlimBatchNorm`` in bf16 train mode), the passes took 70% of
the data-parallel bf16 step on an H100: about 170 bytes moved an element of
the 96 batch-normed conv outputs.  The work is memory-bound (a few
operations a byte), so the kernels move fewer bytes: about 30 an element,
the f32 conv output read four times and written never, the bf16 output and
gradient once each, and the f32-held input gradient the conv's backward
takes written once.

The kernels (:data:`KERNELS`; every name starts with ``bn_bf16_``):

- ``bn_bf16_sums``: per-channel f32 sums of ``x`` (or of ``(x - mean)^2``)
  over the rows of each program's row range, written to scratch; no float
  atomics, so every run sums in one order;
- ``bn_bf16_finish``: the scratch's partial sums added in a fixed order;
- ``bn_bf16_normalize``: ``relu(bf16(x * inv + shift))``, bf16 out;
- ``bn_bf16_grad_sums``: with the ReLU's mask recomputed from
  ``bf16(x * inv + shift) > 0``, the sums of the masked gradient ``g_m``
  and of ``g_m * (x - mean)``, to scratch as ``bn_bf16_sums``;
- ``bn_bf16_grad``: ``bf16(bf16(g_m * inv) + bf16(c1 + c2 * (x - mean)))``
  held in f32: the normalisation's path and the statistics' path each
  rounded to bf16, then their sum, as the reference's perf step rounds.

Each product and sum whose bits the output keeps is one PTX ``mul.rn.f32``
or ``add.rn.f32`` (``sub.rn.f32``): rounded on its own, as PyTorch's
kernels round each operation, never contracted into an FMA, and with
subnormals kept (libdevice's ``mul_rn`` flushes them under Triton's FTZ
setting).  The sums may contract; their order is fixed by the launch.

Block sizes come from a table keyed on ``C`` and ``R``
(:func:`_blocks`): ``BLOCK_C`` the largest power of two up to 128 that
divides ``C``, so no channel is masked, ``BLOCK_R`` rows to 16,384 elements a
statistics tile and 8,192 an elementwise one, and a statistics program's row
range sized so that about ``_PROGRAMS`` programs cover the tensor: long runs
of rows a program, few partial sums.  Chosen on an H100 over the tower's 96
conv outputs at 128 rows (``PERF.md``): these kernels then take 13.0 ms,
70-88% of each one's bytes at 3.35 TB/s, against 12.9-19.6 ms over the 23
other tables tried (tiles of 2,048 to 32,768 elements, 132 to 4,096
statistics programs, 2 to 16 warps).  Triton compiles a variant for each ``BLOCK_C`` (16 to 128 in
the tower) at its first launch.

Every wrapper takes its plain version, which repeats the kernel's arithmetic
operation by operation in PyTorch, for a tensor on the CPU; for a CUDA
tensor it launches the kernel.  Triton is imported at the first launch
(:func:`_triton`), so the module imports without it.  ``<wrapper>.launches``
counts launches run (not those recorded into a CUDA graph).  The caller,
``models/layers._Bf16ConvBNReLU``, keeps the per-channel arithmetic
(``rsqrt``, the moving averages, the backward's coefficients) in PyTorch,
and the all-reduces of the per-channel sums over a process group.
"""

from __future__ import annotations

import functools
import os
from pathlib import Path
from typing import Optional, Tuple

import torch

from tumblr_emotions_torch.ops import _build

KERNELS = ("bn_bf16_sums", "bn_bf16_finish", "bn_bf16_normalize", "bn_bf16_grad_sums",
           "bn_bf16_grad")
_SUM_TILE, _SUM_WARPS = 16384, 8  # a statistics kernel's tile (elements) and warps
_TILE, _WARPS = 8192, 8           # an elementwise kernel's
_PROGRAMS = 256                   # statistics programs a tensor is cut into, about 2 an SM
_FINISH_P, _FINISH_W = 32, 64     # a finishing program's tile: partial sums x columns
_CACHE = Path(__file__).resolve().parents[2] / "build" / "triton"


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


# ---------------------------------------------------------------------------
# The layouts
# ---------------------------------------------------------------------------

def as_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` (``[..., C]``) as ``[R, C]`` rows with contiguous channels: a
    view where one exists (a channel slice of a wider NHWC tensor, such as a
    block's concatenated gradient, keeps its pixel stride), else a copy."""
    C = t.shape[-1]
    if t.is_contiguous():
        return t.view(-1, C)
    if t.dim() == 4 and t.stride(3) == 1:
        B, H, W, _ = t.shape
        s = t.stride()
        if s[2] >= C and s[1] == W * s[2] and s[0] == H * s[1]:
            return t.as_strided((B * H * W, C), (s[2], 1))
    return t.contiguous().view(-1, C)


def _blocks(R: int, C: int, tile: int = _TILE) -> Tuple[int, int, int]:
    """(BLOCK_R, BLOCK_C, rows a statistics program sums) for tiles of
    ``tile`` elements."""
    block_c = min(128, C & -C)
    block_r = tile // block_c
    tiles = -(-R // block_r)
    per_program = max(1, -(-tiles * (C // block_c) // _PROGRAMS))
    return block_r, block_c, per_program * block_r


def _check(name: str, x: torch.Tensor, *vectors: torch.Tensor) -> None:
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous float32 [R, C] rows, got "
                         f"{x.dtype} {tuple(x.shape)} strides {x.stride()}")
    for v in vectors:
        if v.dtype != torch.float32 or tuple(v.shape) != (x.shape[1],) or v.device != x.device \
                or not v.is_contiguous():
            raise ValueError(f"{name}: per-channel vectors must be contiguous float32 "
                             f"[{x.shape[1]}] on {x.device}, got {v.dtype} {tuple(v.shape)} "
                             f"on {v.device}")


def _check_grad(name: str, g: torch.Tensor, x: torch.Tensor) -> None:
    if g.dtype != torch.bfloat16 or tuple(g.shape) != tuple(x.shape) or g.stride(1) != 1 \
            or g.device != x.device:
        raise ValueError(f"{name}: g must be bfloat16 rows like x {tuple(x.shape)} with "
                         f"contiguous channels, got {g.dtype} {tuple(g.shape)} strides "
                         f"{g.stride()} on {g.device}")


# ---------------------------------------------------------------------------
# The plain versions
# ---------------------------------------------------------------------------

def sums_plain(x: torch.Tensor, mean: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`sums`."""
    return (x if mean is None else (x - mean) ** 2).sum(0)


def normalize_plain(x: torch.Tensor, inv: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`normalize`."""
    return torch.relu((x * inv + shift).to(torch.bfloat16))


def _masked(g, x, inv, shift):
    return torch.where((x * inv + shift).to(torch.bfloat16) > 0, g.float(), 0.0)


def grad_sums_plain(g: torch.Tensor, x: torch.Tensor, inv: torch.Tensor, shift: torch.Tensor,
                    mean: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`grad_sums`."""
    gm = _masked(g, x, inv, shift)
    return torch.cat([gm.sum(0), (gm * (x - mean)).sum(0)])


def grad_plain(g: torch.Tensor, x: torch.Tensor, inv: torch.Tensor, shift: torch.Tensor,
               mean: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`grad`."""
    gm = _masked(g, x, inv, shift)
    return _bf16(_bf16(gm * inv) + _bf16(c1 + c2 * (x - mean)))


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------

def finish_plain(part: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`_finish`."""
    return part.sum(0)


def _finish(part: torch.Tensor) -> torch.Tensor:
    """The f32 ``[P, W]`` partial sums added over ``P`` in a fixed order."""
    if part.device.type == "cpu":
        return finish_plain(part)
    _triton()
    P, W = part.shape
    out = torch.empty(W, dtype=torch.float32, device=part.device)
    bn_bf16_finish[(-(-W // _FINISH_W),)](part, out, P, W, BLOCK_P=_FINISH_P,
                                          BLOCK_W=_FINISH_W, num_warps=4)
    _count(_finish, part.device)
    return out


_finish.launches = 0


def sums(x: torch.Tensor, mean: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-channel f32 sums over the rows of ``x`` (f32 ``[R, C]``), of
    ``(x - mean)^2`` when ``mean`` is given: two launches, the partial sums
    of each program's row range and their fixed-order sum."""
    if x.device.type == "cpu":
        return sums_plain(x, mean)
    _check("sums", x, *(() if mean is None else (mean,)))
    _triton()
    R, C = x.shape
    block_r, block_c, per_program = _blocks(R, C, _SUM_TILE)
    P = -(-R // per_program)
    part = torch.empty(P, C, dtype=torch.float32, device=x.device)
    bn_bf16_sums[(P, C // block_c)](x, x if mean is None else mean, part, R, C, per_program,
                                    CENTERED=mean is not None, BLOCK_R=block_r,
                                    BLOCK_C=block_c, num_warps=_SUM_WARPS)
    _count(sums, x.device)
    return _finish(part)


sums.launches = 0


def normalize(x: torch.Tensor, inv: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """``relu(bf16(x * inv + shift))`` of f32 ``[R, C]`` rows with the
    per-channel ``inv`` and ``shift``: bf16 ``[R, C]``, the product and the
    sum each rounded to f32."""
    if x.device.type == "cpu":
        return normalize_plain(x, inv, shift)
    _check("normalize", x, inv, shift)
    _triton()
    R, C = x.shape
    block_r, block_c, _ = _blocks(R, C)
    out = torch.empty(R, C, dtype=torch.bfloat16, device=x.device)
    bn_bf16_normalize[(-(-R // block_r), C // block_c)](x, inv, shift, out, R, C,
                                                        BLOCK_R=block_r, BLOCK_C=block_c,
                                                        num_warps=_WARPS)
    _count(normalize, x.device)
    return out


normalize.launches = 0


def grad_sums(g: torch.Tensor, x: torch.Tensor, inv: torch.Tensor, shift: torch.Tensor,
              mean: torch.Tensor) -> torch.Tensor:
    """``[Σ g_m, Σ g_m (x - mean)]`` per channel (f32 ``[2C]``), where
    ``g_m`` is the bf16 gradient ``g`` of :func:`normalize`'s output
    (``[R, C]`` rows with contiguous channels, any pixel stride) where that
    output is above 0, else 0."""
    if x.device.type == "cpu":
        return grad_sums_plain(g, x, inv, shift, mean)
    _check("grad_sums", x, inv, shift, mean)
    _check_grad("grad_sums", g, x)
    _triton()
    R, C = x.shape
    block_r, block_c, per_program = _blocks(R, C, _SUM_TILE)
    P = -(-R // per_program)
    part = torch.empty(P, 2 * C, dtype=torch.float32, device=x.device)
    bn_bf16_grad_sums[(P, C // block_c)](g, x, inv, shift, mean, part, R, C, g.stride(0),
                                         per_program, BLOCK_R=block_r, BLOCK_C=block_c,
                                         num_warps=_SUM_WARPS)
    _count(grad_sums, x.device)
    return _finish(part)


grad_sums.launches = 0


def grad(g: torch.Tensor, x: torch.Tensor, inv: torch.Tensor, shift: torch.Tensor,
         mean: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """The gradient of the normalisation's input, ``bf16(bf16(g_m * inv) +
    bf16(c1 + c2 * (x - mean)))`` held in f32 ``[R, C]`` (``g_m`` as in
    :func:`grad_sums`; ``c1``, ``c2`` the statistics' per-channel
    coefficients), each operation rounded to f32."""
    if x.device.type == "cpu":
        return grad_plain(g, x, inv, shift, mean, c1, c2)
    _check("grad", x, inv, shift, mean, c1, c2)
    _check_grad("grad", g, x)
    _triton()
    R, C = x.shape
    block_r, block_c, _ = _blocks(R, C)
    out = torch.empty(R, C, dtype=torch.float32, device=x.device)
    bn_bf16_grad[(-(-R // block_r), C // block_c)](g, x, inv, shift, mean, c1, c2, out, R, C,
                                                   g.stride(0), BLOCK_R=block_r,
                                                   BLOCK_C=block_c, num_warps=_WARPS)
    _count(grad, x.device)
    return out


grad.launches = 0


def _count(wrapper, dev: torch.device) -> None:
    if _build.launched(dev):
        wrapper.launches += 1


# ---------------------------------------------------------------------------
# The kernels, jitted at the first launch (:func:`_triton`)
# ---------------------------------------------------------------------------

tl = None   # triton.language, bound by _triton()


@functools.lru_cache(maxsize=None)
def _triton():
    """Import Triton, with its cache inside the checkout's ``build/`` unless
    ``TRITON_CACHE_DIR`` says otherwise, and jit this module's device
    functions and kernels in place."""
    global tl
    os.environ.setdefault("TRITON_CACHE_DIR", str(_CACHE))
    import triton
    import triton.language as language

    tl = language
    g = globals()
    for name in ("_mul_rn", "_add_rn", "_sub_rn", "_channel") + KERNELS:
        g[name] = triton.jit(g[name])
    return triton


def _mul_rn(a, b):
    return tl.inline_asm_elementwise("mul.rn.f32 $0, $1, $2;", "=f,f,f", [a, b],
                                     dtype=tl.float32, is_pure=True, pack=1)


def _add_rn(a, b):
    return tl.inline_asm_elementwise("add.rn.f32 $0, $1, $2;", "=f,f,f", [a, b],
                                     dtype=tl.float32, is_pure=True, pack=1)


def _sub_rn(a, b):
    return tl.inline_asm_elementwise("sub.rn.f32 $0, $1, $2;", "=f,f,f", [a, b],
                                     dtype=tl.float32, is_pure=True, pack=1)


def _channel(ptr, cols, BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
    return tl.broadcast_to(tl.load(ptr + cols)[None, :], (BLOCK_R, BLOCK_C))


def bn_bf16_sums(x_ptr, mean_ptr, part_ptr, R, C, per_program, CENTERED: tl.constexpr,
                 BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
    pid_r = tl.program_id(0)
    cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
    acc = tl.zeros((BLOCK_R, BLOCK_C), dtype=tl.float32)
    if CENTERED:
        mean = tl.load(mean_ptr + cols)[None, :]
    for i in range(0, per_program, BLOCK_R):
        rows = pid_r * per_program + i + tl.arange(0, BLOCK_R)
        keep = (rows < R)[:, None]
        x = tl.load(x_ptr + rows.to(tl.int64)[:, None] * C + cols[None, :], mask=keep, other=0.0)
        if CENTERED:
            d = tl.where(keep, x - mean, 0.0)
            x = d * d
        acc += x
    tl.store(part_ptr + pid_r * C + cols, tl.sum(acc, axis=0))


def bn_bf16_finish(part_ptr, out_ptr, P, W, BLOCK_P: tl.constexpr, BLOCK_W: tl.constexpr):
    cols = tl.program_id(0) * BLOCK_W + tl.arange(0, BLOCK_W)
    acc = tl.zeros((BLOCK_P, BLOCK_W), dtype=tl.float32)
    for p0 in range(0, P, BLOCK_P):
        p = p0 + tl.arange(0, BLOCK_P)
        keep = (p < P)[:, None] & (cols < W)[None, :]
        acc += tl.load(part_ptr + p[:, None] * W + cols[None, :], mask=keep, other=0.0)
    tl.store(out_ptr + cols, tl.sum(acc, axis=0), mask=cols < W)


def bn_bf16_normalize(x_ptr, inv_ptr, shift_ptr, out_ptr, R, C, BLOCK_R: tl.constexpr,
                      BLOCK_C: tl.constexpr):
    rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
    cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
    keep = (rows < R)[:, None]
    at = rows.to(tl.int64)[:, None] * C + cols[None, :]
    x = tl.load(x_ptr + at, mask=keep, other=0.0)
    inv = _channel(inv_ptr, cols, BLOCK_R, BLOCK_C)
    shift = _channel(shift_ptr, cols, BLOCK_R, BLOCK_C)
    z = _add_rn(_mul_rn(x, inv), shift).to(tl.bfloat16)
    tl.store(out_ptr + at, tl.where(z > 0, z, 0.0).to(tl.bfloat16), mask=keep)


def bn_bf16_grad_sums(g_ptr, x_ptr, inv_ptr, shift_ptr, mean_ptr, part_ptr, R, C, g_stride,
                      per_program, BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
    pid_r = tl.program_id(0)
    cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
    inv = _channel(inv_ptr, cols, BLOCK_R, BLOCK_C)
    shift = _channel(shift_ptr, cols, BLOCK_R, BLOCK_C)
    mean = tl.load(mean_ptr + cols)[None, :]
    s1 = tl.zeros((BLOCK_R, BLOCK_C), dtype=tl.float32)
    s2 = tl.zeros((BLOCK_R, BLOCK_C), dtype=tl.float32)
    for i in range(0, per_program, BLOCK_R):
        rows = (pid_r * per_program + i + tl.arange(0, BLOCK_R)).to(tl.int64)
        keep = (rows < R)[:, None]
        x = tl.load(x_ptr + rows[:, None] * C + cols[None, :], mask=keep, other=0.0)
        g = tl.load(g_ptr + rows[:, None] * g_stride + cols[None, :], mask=keep, other=0.0)
        z = _add_rn(_mul_rn(x, inv), shift).to(tl.bfloat16)
        gm = tl.where(z > 0, g.to(tl.float32), 0.0)
        s1 += gm
        s2 += gm * (x - mean)
    out = part_ptr + pid_r * 2 * C + cols
    tl.store(out, tl.sum(s1, axis=0))
    tl.store(out + C, tl.sum(s2, axis=0))


def bn_bf16_grad(g_ptr, x_ptr, inv_ptr, shift_ptr, mean_ptr, c1_ptr, c2_ptr, out_ptr, R, C,
                 g_stride, BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
    rows = (tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)).to(tl.int64)
    cols = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
    keep = (rows < R)[:, None]
    at = rows[:, None] * C + cols[None, :]
    x = tl.load(x_ptr + at, mask=keep, other=0.0)
    g = tl.load(g_ptr + rows[:, None] * g_stride + cols[None, :], mask=keep, other=0.0)
    inv = _channel(inv_ptr, cols, BLOCK_R, BLOCK_C)
    shift = _channel(shift_ptr, cols, BLOCK_R, BLOCK_C)
    mean = _channel(mean_ptr, cols, BLOCK_R, BLOCK_C)
    c1 = _channel(c1_ptr, cols, BLOCK_R, BLOCK_C)
    c2 = _channel(c2_ptr, cols, BLOCK_R, BLOCK_C)
    z = _add_rn(_mul_rn(x, inv), shift).to(tl.bfloat16)
    gm = tl.where(z > 0, g.to(tl.float32), 0.0)
    a = _mul_rn(gm, inv).to(tl.bfloat16).to(tl.float32)
    b = _add_rn(c1, _mul_rn(c2, _sub_rn(x, mean))).to(tl.bfloat16).to(tl.float32)
    tl.store(out_ptr + at, _add_rn(a, b).to(tl.bfloat16).to(tl.float32), mask=keep)
