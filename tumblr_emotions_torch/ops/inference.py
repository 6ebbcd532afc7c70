"""Fused inference engine: the serving-path Inception-v3 forward, in PyTorch.

Port of ``tumblr_emotions_tpu/ops/inference.py``.  Assembles the tower from
BN-folded weights.  The stem, the Mixed_6a/7a reductions and the
Inception-C blocks are plain ``F.conv2d`` (cuDNN on the card) in the working
dtype with an f32 bias and ReLU, as the JAX package leaves them to XLA.  The
repeated constant-size stages (3x Inception-A at 35x35, 4x Inception-B at
17x17) run either as the hand-written block kernels
(``ops/fused_inception.py``, ``use_kernels=True``: 5 and 8 launches of one
conv kernel per block, the 1x1s over the block input packed into one and
the pool fused into its 1x1) or as the same cuDNN
convs with packed 1x1 branches (``use_kernels=False``, the ablation).  The
1x1 branches over a block input are always packed into one conv, the JAX
package's default (``pack_branches=True``); its unpacked variant has no
caller here.

Rounding: as the JAX package (``preferred_element_type=float32``), every
conv accumulates in f32, adds the f32 bias and rounds to the working dtype
once.  The cuDNN convs are ``models.layers.conv_f32_accumulate``: f32 on
the bf16-valued activations and weights, TF32 allowed on the card, which
is exact for bf16 values (``tests/test_torch_cuda.py`` holds these convs
to one rounding on the card).  The block kernels round
once, as the TPU kernels do.

The TPU knob ``images_per_block`` (images stacked per Pallas grid step to
fill the MXU) is not carried over: the CUDA kernels tile over all pixels of
the batch.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from tumblr_emotions_torch._device import full_f32, resolve_device
from tumblr_emotions_torch.models.layers import (conv_f32_accumulate, linear_f64, to_nchw,
                                                 to_nhwc)
from tumblr_emotions_torch.ops.fused_inception import (
    INCEPTION_B_BRANCHES, _taps, block_plan, fold_batchnorm, fused_inception_a,
    fused_inception_b, inception_a_branches)

_A_SCOPES = ("Mixed_5b", "Mixed_5c", "Mixed_5d")
_B_SCOPES = ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e")


class FusedInceptionV3:
    """Inference-only Inception-v3 over BN-folded weights.

    state: the port's state dict (``InceptionV3.state_dict()`` or
    ``convert.to_state`` of the JAX package's variables), image tower at
    the root.  Weights are folded, cast and moved to ``device`` once here.
    """

    def __init__(self, state: Dict[str, torch.Tensor], dtype=torch.bfloat16,
                 use_kernels: bool = True, device="cuda"):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.use_kernels = use_kernels
        self._state = state
        folded = fold_batchnorm(state)
        dev = self.device
        # The cuDNN convs' weights: rounded to dtype, held in f32 (see Rounding).
        self.w = {s: (w.to(dtype).to(dev, torch.float32), b.to(dev))
                  for s, (w, b) in folded.items()}
        # The block kernels take tap stacks [kh*kw, Cin, Cout]; each block's
        # launch plan packs them once, here.
        self.taps = {s: (_taps(w).to(dev, dtype), b.to(dev))
                     for s, (w, b) in folded.items()
                     if s.split("/")[0] in _A_SCOPES + _B_SCOPES} \
            if use_kernels else {}
        self.block_plans = {
            scope: block_plan(self.taps, scope, inception_a_branches(scope == "Mixed_5c")
                              if scope in _A_SCOPES else INCEPTION_B_BRANCHES)
            for scope in _A_SCOPES + _B_SCOPES} if use_kernels else {}
        self.logits_w: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        if "Logits/Conv2d_1c_1x1" in folded:
            w, b = folded["Logits/Conv2d_1c_1x1"]
            self.logits_w = (w[:, :, 0, 0].t().contiguous().to(dev), b.to(dev))
        self._packs: Dict[Tuple[str, ...], Tuple[torch.Tensor, torch.Tensor]] = {}

    def to(self, device) -> "FusedInceptionV3":
        """This engine on ``device``, folded from the same state."""
        dev = resolve_device(device)
        if dev == self.device:
            return self
        return FusedInceptionV3(self._state, self.dtype, self.use_kernels, dev)

    # ---- building blocks ----

    def _conv(self, x, scope, strides=(1, 1), padding="VALID", relu=True):
        w, b = self.w[scope]
        pad = (w.shape[2] // 2, w.shape[3] // 2) if padding == "SAME" else (0, 0)
        y = conv_f32_accumulate(x, w, strides, pad) + b
        return (torch.relu(y) if relu else y).to(self.dtype)

    def _packed_conv1x1(self, x, scopes: Sequence[str]):
        """N parallel 1x1 branches over the SAME input as ONE conv.

        Concatenating the folded kernels along Cout is exact and turns them
        into one wide GEMM with one read of the input.  Returns the
        per-branch PRE-activation slices (f32, bias added, no ReLU): the
        avg-pool branch needs pool-then-ReLU (a 1x1 conv + bias commutes
        with count_include_pad=False average pooling, ReLU does not).
        """
        key = tuple(scopes)
        if key not in self._packs:
            self._packs[key] = (torch.cat([self.w[s][0] for s in scopes]),
                                torch.cat([self.w[s][1] for s in scopes]))
        w, b = self._packs[key]
        y = conv_f32_accumulate(x, w) + b
        return torch.split(y, [self.w[s][0].shape[0] for s in scopes], dim=-1)

    def _relu(self, y):
        return torch.relu(y).to(self.dtype)

    def _pool_branch(self, pre):
        """avg-pool (3x3 SAME) then ReLU a pre-activation 1x1 branch."""
        p = F.avg_pool2d(to_nchw(pre), 3, 1, padding=1, count_include_pad=False)
        return self._relu(to_nhwc(p))

    @staticmethod
    def _max_pool(x):
        return to_nhwc(F.max_pool2d(to_nchw(x), 3, 2))

    # ---- the tower ----

    @torch.inference_mode()
    def __call__(self, x: torch.Tensor):
        """Preprocessed NHWC [B, 299, 299, 3] -> (logits [B, C] or None,
        pre-logits feature [B, 2048]), both f32."""
        if x.device != self.device:
            raise ValueError(f"input on {x.device}, engine on {self.device}")
        with full_f32():
            return self._forward(x.to(self.dtype))

    def _forward(self, x):
        conv = self._conv
        net = conv(x, "Conv2d_1a_3x3", strides=(2, 2))
        net = conv(net, "Conv2d_2a_3x3")
        net = conv(net, "Conv2d_2b_3x3", padding="SAME")
        net = self._max_pool(net)
        net = conv(net, "Conv2d_3b_1x1")
        net = conv(net, "Conv2d_4a_3x3")
        net = self._max_pool(net)

        for scope in _A_SCOPES:
            quirky = scope == "Mixed_5c"
            if self.use_kernels:
                net = fused_inception_a(net, self.taps, scope, quirky_5c=quirky)
            else:
                net = self._cudnn_block(net, scope, inception_a_branches(quirky))

        # Mixed_6a reduction
        b0 = conv(net, "Mixed_6a/Branch_0/Conv2d_1a_1x1", strides=(2, 2))
        b1 = conv(net, "Mixed_6a/Branch_1/Conv2d_0a_1x1", padding="SAME")
        b1 = conv(b1, "Mixed_6a/Branch_1/Conv2d_0b_3x3", padding="SAME")
        b1 = conv(b1, "Mixed_6a/Branch_1/Conv2d_1a_1x1", strides=(2, 2))
        net = torch.cat([b0, b1, self._max_pool(net)], dim=-1)

        for scope in _B_SCOPES:
            if self.use_kernels:
                net = fused_inception_b(net, self.taps, scope)
            else:
                net = self._cudnn_block(net, scope, INCEPTION_B_BRANCHES)

        # Mixed_7a reduction
        s7 = "Mixed_7a"
        p0, p1 = self._packed_conv1x1(net, [f"{s7}/Branch_0/Conv2d_0a_1x1",
                                            f"{s7}/Branch_1/Conv2d_0a_1x1"])
        b0, b1 = self._relu(p0), self._relu(p1)
        b0 = conv(b0, f"{s7}/Branch_0/Conv2d_1a_3x3", strides=(2, 2))
        b1 = conv(b1, f"{s7}/Branch_1/Conv2d_0b_1x7", padding="SAME")
        b1 = conv(b1, f"{s7}/Branch_1/Conv2d_0c_7x1", padding="SAME")
        b1 = conv(b1, f"{s7}/Branch_1/Conv2d_1a_3x3", strides=(2, 2))
        net = torch.cat([b0, b1, self._max_pool(net)], dim=-1)

        net = self._inception_c(net, "Mixed_7b", False)
        net = self._inception_c(net, "Mixed_7c", True)

        kh, kw = min(8, net.shape[1]), min(8, net.shape[2])
        if (net.shape[1], net.shape[2]) == (kh, kw):
            feature = net.float().mean(dim=(1, 2))
        else:
            feature = to_nhwc(F.avg_pool2d(to_nchw(net), (kh, kw), 1))
            feature = feature.squeeze(2).squeeze(1).float()
        logits = None
        if self.logits_w is not None:
            w, b = self.logits_w
            logits = linear_f64(feature, w.t(), b)   # rows independent of the batch
        return logits, feature

    # ---- cuDNN blocks (use_kernels=False; also the A/B ablation baseline) ----

    def _first_convs(self, net, scope, branches):
        """The first 1x1 conv of each branch over the block input, packed
        into one conv (the pool branch pools its pre-activation, then ReLU):
        returns the four branch heads."""
        pre = self._packed_conv1x1(net, [f"{scope}/{chain[0][0]}" for _, chain in branches])
        return [self._pool_branch(p) if pooled else self._relu(p)
                for (pooled, _), p in zip(branches, pre)]

    def _cudnn_block(self, net, scope, branches):
        """Inception-A/B on cuDNN: the port of ``_xla_inception_a/_b``."""
        heads = self._first_convs(net, scope, branches)
        outs = []
        for (_, chain), h in zip(branches, heads):
            for name, _ in chain[1:]:
                h = self._conv(h, f"{scope}/{name}", padding="SAME")
            outs.append(h)
        return torch.cat(outs, dim=-1)

    def _inception_c(self, net, scope, quirky_7c):
        conv = self._conv
        n31 = "Conv2d_0c_3x1" if quirky_7c else "Conv2d_0b_3x1"
        branches = [(False, [("Branch_0/Conv2d_0a_1x1", (1, 1))]),
                    (False, [("Branch_1/Conv2d_0a_1x1", (1, 1))]),
                    (False, [("Branch_2/Conv2d_0a_1x1", (1, 1))]),
                    (True, [("Branch_3/Conv2d_0b_1x1", (1, 1))])]
        b0, b1, b2, b3 = self._first_convs(net, scope, branches)
        b1 = torch.cat([conv(b1, f"{scope}/Branch_1/Conv2d_0b_1x3", padding="SAME"),
                        conv(b1, f"{scope}/Branch_1/{n31}", padding="SAME")], dim=-1)
        b2 = conv(b2, f"{scope}/Branch_2/Conv2d_0b_3x3", padding="SAME")
        b2 = torch.cat([conv(b2, f"{scope}/Branch_2/Conv2d_0c_1x3", padding="SAME"),
                        conv(b2, f"{scope}/Branch_2/Conv2d_0d_3x1", padding="SAME")],
                       dim=-1)
        return torch.cat([b0, b1, b2, b3], dim=-1)
