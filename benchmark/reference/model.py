"""The plain reference of the joint Deep Sentiment model, in float32 PyTorch.

Written from the published description, not from the program:

- the image tower is Inception-v3 as TF-Slim's ``nets/inception_v3.py``
  builds it (Szegedy et al., arXiv:1512.00567): every conv is a conv without
  bias, batch norm without scale (epsilon 0.001) and ReLU; SAME padding is
  TF's (for the stride-1 odd kernels of this tower, ``k // 2`` on both
  sides); the average pools count only the taps inside the image; slim's
  scope names, quirks included, are the parameter names;
- the text branch is the mean of the caption's word embeddings over its
  length (Hu & Flaxman, KDD 2018, arXiv:1805.10205);
- the joint head is one dense layer over the image feature (``PreLogits``,
  2,048 at depth 1) concatenated with the text feature, softmaxed.

Parameters are a dict of tensors keyed by the names the program's state
dict uses (``InceptionV3.<scope>.weights`` OIHW, ``.BatchNorm.beta`` ...,
``Text.WordEmbedding/embeddings``, ``JointLogits.kernel`` [out, in]).
Everything runs in float32 with TF32 off, on whatever device the inputs
are on.  On the meta device the same code records each conv's shapes
(:func:`layer_table`), from which the benchmark counts its work.

``Quant`` puts a lower precision in place of float32 for the controls:
per-tensor int4 activations with per-channel weights over the
BN-folded eval kernels (a served engine), or fp8 training (e4m3 operands
of every conv and dense layer, e5m2 gradients, scaled per tensor).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

TOWER = "InceptionV3."
EMBEDDINGS = "Text.WordEmbedding/embeddings"


@contextlib.contextmanager
def exact_f32(tf32: bool = False):
    """float32 convolutions and matmuls without TF32 (with it, for the
    control of a float32 configuration, when ``tf32``)."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


@dataclasses.dataclass
class Conv:
    """One conv layer as a pass met it: its name, shapes and kind."""

    name: str
    cin: int
    cout: int
    kernel: Tuple[int, int]
    stride: int
    in_hw: Tuple[int, int]
    out_hw: Tuple[int, int]
    head: bool          # bias, no batch norm, no ReLU

    def macs(self) -> int:
        """Multiply-adds for one image."""
        return self.out_hw[0] * self.out_hw[1] * self.cout * self.cin * \
            self.kernel[0] * self.kernel[1]


class _Fp8(torch.autograd.Function):
    """An operand rounded to fp8 e4m3 and its gradient to e5m2, each scaled
    per tensor by its largest magnitude (the usual fp8 training recipe)."""

    @staticmethod
    def forward(ctx, x):
        return _fp8_round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _fp8_round(g, torch.float8_e5m2, 57344.0)


def _fp8_round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class Quant:
    """A lower precision for the control.  ``kind``: ``"int4"`` (symmetric;
    activations per tensor at the scale a calibration pass
    recorded, weights per output channel over the BN-folded kernels, the
    gradient passed straight through) or ``"fp8"`` (every conv's and dense
    layer's input and kernel in e4m3 and the input's gradient in e5m2, each
    scaled per tensor)."""

    def __init__(self, kind: str):
        if kind not in ("int4", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind
        self.qmax = 7.0
        self.amax: Dict[str, torch.Tensor] = {}
        self.calibrating = kind != "fp8"

    def _fake(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        q = torch.clamp(torch.round(x / scale), -self.qmax, self.qmax) * scale
        return x + (q - x).detach()

    def act(self, name: str, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "fp8":
            return _Fp8.apply(x)
        if self.calibrating:
            m = x.detach().abs().amax()
            self.amax[name] = torch.maximum(self.amax[name], m) if name in self.amax else m
            return x
        return self._fake(x, self.amax[name].clamp_min(1e-6) / self.qmax)

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        if self.kind == "fp8":
            return w + (_fp8_round(w.detach(), torch.float8_e4m3fn, 448.0) - w).detach()
        if self.calibrating:
            return w
        s = w.detach().abs().amax(dim=tuple(range(1, w.ndim)), keepdim=True)
        return self._fake(w, torch.where(s > 0, s, torch.ones_like(s)) / self.qmax)


def _same(k: Tuple[int, int], stride: int) -> Tuple[int, int]:
    if stride != 1 or k[0] % 2 == 0 or k[1] % 2 == 0:
        raise ValueError(f"SAME padding of kernel {k} at stride {stride} is not in this tower")
    return k[0] // 2, k[1] // 2


class Tower:
    """One pass of the slim tower over ``params`` (NCHW inside).  With
    ``params=None`` the weights are made on the meta device as the pass
    meets each layer, and ``table`` records every conv."""

    def __init__(self, params: Optional[Dict[str, torch.Tensor]], prefix: str = TOWER,
                 depth_multiplier: float = 1.0, min_depth: int = 16, num_classes: int = 15,
                 train: bool = False, keep_prob: float = 0.8, eps: float = 0.001,
                 quant: Optional[Quant] = None, generator: Optional[torch.Generator] = None):
        self.params, self.prefix = params, prefix
        self.mult, self.min_depth, self.num_classes = depth_multiplier, min_depth, num_classes
        self.train, self.keep_prob, self.eps = train, keep_prob, eps
        self.quant, self.generator = quant, generator
        self.table: List[Conv] = []

    def d(self, c: int) -> int:
        return max(int(c * self.mult), self.min_depth)

    def _p(self, key: str, shape) -> torch.Tensor:
        if self.params is None:
            return torch.zeros(shape, device="meta")
        return self.params[self.prefix + key]

    def conv(self, x, scope, cout, k, stride=1, padding="SAME", head=False):
        k = (k, k) if isinstance(k, int) else tuple(k)
        cin = x.shape[1]
        w = self._p(f"{scope}.weights", (cout, cin, *k))
        pad = _same(k, stride) if padding == "SAME" else (0, 0)
        q = self.quant
        if head:
            bias = self._p(f"{scope}.biases", (cout,))
            shift = None
        elif not self.train:
            # eval batch norm folded into the kernel: x*inv + (beta - mean*inv)
            var = self._p(f"{scope}.BatchNorm.moving_variance", (cout,))
            mean = self._p(f"{scope}.BatchNorm.moving_mean", (cout,))
            inv = torch.rsqrt(var + self.eps)
            w = w * inv[:, None, None, None]
            bias = None
            shift = self._p(f"{scope}.BatchNorm.beta", (cout,)) - mean * inv
        else:
            bias = shift = None
        if q is not None:
            x, w = q.act(self.prefix + scope, x), q.weight(w)
        y = F.conv2d(x, w, bias, stride=stride, padding=pad)
        self.table.append(Conv(self.prefix + scope, cin, cout, k, stride,
                               tuple(x.shape[2:]), tuple(y.shape[2:]), head))
        if head:
            return y
        if self.train:
            var, mean = torch.var_mean(y, dim=(0, 2, 3), correction=0)
            y = (y - mean[:, None, None]) * torch.rsqrt(var + self.eps)[:, None, None] + \
                self._p(f"{scope}.BatchNorm.beta", (cout,))[:, None, None]
        else:
            y = y + shift[:, None, None]
        return torch.relu(y)

    @staticmethod
    def avg_same(x: torch.Tensor) -> torch.Tensor:
        """3x3 stride-1 SAME average over the in-image taps (window sums of
        shifted slices, so autograd's backward is the plain adjoint)."""
        H, W = x.shape[2:]
        xp = F.pad(x, (1, 1, 1, 1))
        ones = F.pad(torch.ones(H, W, dtype=x.dtype, device=x.device), (1, 1, 1, 1))
        s = sum(xp[:, :, i:i + H, j:j + W] for i in range(3) for j in range(3))
        n = sum(ones[i:i + H, j:j + W] for i in range(3) for j in range(3))
        return s / n

    @staticmethod
    def maxpool(x):
        return F.max_pool2d(x, 3, 2)

    def block_a(self, x, scope, pool_features, quirky):
        c, d = self.conv, self.d
        n1 = ("Conv2d_0b_1x1", "Conv_1_0c_5x5") if quirky else ("Conv2d_0a_1x1", "Conv2d_0b_5x5")
        b0 = c(x, f"{scope}/Branch_0/Conv2d_0a_1x1", d(64), 1)
        b1 = c(c(x, f"{scope}/Branch_1/{n1[0]}", d(48), 1), f"{scope}/Branch_1/{n1[1]}", d(64), 5)
        b2 = c(x, f"{scope}/Branch_2/Conv2d_0a_1x1", d(64), 1)
        b2 = c(b2, f"{scope}/Branch_2/Conv2d_0b_3x3", d(96), 3)
        b2 = c(b2, f"{scope}/Branch_2/Conv2d_0c_3x3", d(96), 3)
        b3 = c(self.avg_same(x), f"{scope}/Branch_3/Conv2d_0b_1x1", d(pool_features), 1)
        return torch.cat([b0, b1, b2, b3], 1)

    def block_b(self, x, scope, c7):
        c, d = self.conv, self.d
        b0 = c(x, f"{scope}/Branch_0/Conv2d_0a_1x1", d(192), 1)
        b1 = c(x, f"{scope}/Branch_1/Conv2d_0a_1x1", d(c7), 1)
        b1 = c(b1, f"{scope}/Branch_1/Conv2d_0b_1x7", d(c7), (1, 7))
        b1 = c(b1, f"{scope}/Branch_1/Conv2d_0c_7x1", d(192), (7, 1))
        b2 = c(x, f"{scope}/Branch_2/Conv2d_0a_1x1", d(c7), 1)
        b2 = c(b2, f"{scope}/Branch_2/Conv2d_0b_7x1", d(c7), (7, 1))
        b2 = c(b2, f"{scope}/Branch_2/Conv2d_0c_1x7", d(c7), (1, 7))
        b2 = c(b2, f"{scope}/Branch_2/Conv2d_0d_7x1", d(c7), (7, 1))
        b2 = c(b2, f"{scope}/Branch_2/Conv2d_0e_1x7", d(192), (1, 7))
        b3 = c(self.avg_same(x), f"{scope}/Branch_3/Conv2d_0b_1x1", d(192), 1)
        return torch.cat([b0, b1, b2, b3], 1)

    def block_c(self, x, scope, quirky):
        c, d = self.conv, self.d
        n31 = "Conv2d_0c_3x1" if quirky else "Conv2d_0b_3x1"
        b0 = c(x, f"{scope}/Branch_0/Conv2d_0a_1x1", d(320), 1)
        b1 = c(x, f"{scope}/Branch_1/Conv2d_0a_1x1", d(384), 1)
        b1 = torch.cat([c(b1, f"{scope}/Branch_1/Conv2d_0b_1x3", d(384), (1, 3)),
                        c(b1, f"{scope}/Branch_1/{n31}", d(384), (3, 1))], 1)
        b2 = c(x, f"{scope}/Branch_2/Conv2d_0a_1x1", d(448), 1)
        b2 = c(b2, f"{scope}/Branch_2/Conv2d_0b_3x3", d(384), 3)
        b2 = torch.cat([c(b2, f"{scope}/Branch_2/Conv2d_0c_1x3", d(384), (1, 3)),
                        c(b2, f"{scope}/Branch_2/Conv2d_0d_3x1", d(384), (3, 1))], 1)
        b3 = c(self.avg_same(x), f"{scope}/Branch_3/Conv2d_0b_1x1", d(192), 1)
        return torch.cat([b0, b1, b2, b3], 1)

    def __call__(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Preprocessed NHWC images in [-1, 1] -> {"PreLogits" [N, F]
        (after dropout in train mode), "Logits" [N, C], "AuxLogits" [N, C]}."""
        c, d = self.conv, self.d
        x = images.permute(0, 3, 1, 2)
        x = c(x, "Conv2d_1a_3x3", d(32), 3, 2, "VALID")
        x = c(x, "Conv2d_2a_3x3", d(32), 3, 1, "VALID")
        x = c(x, "Conv2d_2b_3x3", d(64), 3)
        x = self.maxpool(x)
        x = c(x, "Conv2d_3b_1x1", d(80), 1, 1, "VALID")
        x = c(x, "Conv2d_4a_3x3", d(192), 3, 1, "VALID")
        x = self.maxpool(x)
        x = self.block_a(x, "Mixed_5b", 32, False)
        x = self.block_a(x, "Mixed_5c", 64, True)
        x = self.block_a(x, "Mixed_5d", 64, False)
        b0 = c(x, "Mixed_6a/Branch_0/Conv2d_1a_1x1", d(384), 3, 2, "VALID")
        b1 = c(x, "Mixed_6a/Branch_1/Conv2d_0a_1x1", d(64), 1)
        b1 = c(b1, "Mixed_6a/Branch_1/Conv2d_0b_3x3", d(96), 3)
        b1 = c(b1, "Mixed_6a/Branch_1/Conv2d_1a_1x1", d(96), 3, 2, "VALID")
        x = torch.cat([b0, b1, self.maxpool(x)], 1)
        for scope, c7 in (("Mixed_6b", 128), ("Mixed_6c", 160), ("Mixed_6d", 160),
                          ("Mixed_6e", 192)):
            x = self.block_b(x, scope, c7)
        out = {}
        if self.num_classes:
            a = F.avg_pool2d(x, 5, 3)
            a = c(a, "AuxLogits/Conv2d_1b_1x1", d(128), 1)
            k = min(5, a.shape[2])
            a = c(a, f"AuxLogits/Conv2d_2a_{k}x{k}", d(768), k, 1, "VALID")
            a = c(a, "AuxLogits/Conv2d_2b_1x1", self.num_classes, 1, head=True)
            out["AuxLogits"] = a.flatten(1)
        b0 = c(c(x, "Mixed_7a/Branch_0/Conv2d_0a_1x1", d(192), 1),
               "Mixed_7a/Branch_0/Conv2d_1a_3x3", d(320), 3, 2, "VALID")
        b1 = c(x, "Mixed_7a/Branch_1/Conv2d_0a_1x1", d(192), 1)
        b1 = c(b1, "Mixed_7a/Branch_1/Conv2d_0b_1x7", d(192), (1, 7))
        b1 = c(b1, "Mixed_7a/Branch_1/Conv2d_0c_7x1", d(192), (7, 1))
        b1 = c(b1, "Mixed_7a/Branch_1/Conv2d_1a_3x3", d(192), 3, 2, "VALID")
        x = torch.cat([b0, b1, self.maxpool(x)], 1)
        x = self.block_c(x, "Mixed_7b", False)
        x = self.block_c(x, "Mixed_7c", True)
        # global average pool over min(8, spatial), as slim pools
        k = (min(8, x.shape[2]), min(8, x.shape[3]))
        x = F.avg_pool2d(x, k, 1)
        if self.train and self.keep_prob < 1.0:
            # flax's dropout draws rand < keep_prob over the NHWC [N,1,1,F]
            u = torch.rand((x.shape[0], 1, 1, x.shape[1]), generator=self.generator,
                           device=x.device).permute(0, 3, 1, 2)
            x = torch.where(u < self.keep_prob, x / self.keep_prob, torch.zeros_like(x))
        out["PreLogits"] = x.flatten(1)
        if self.num_classes:
            out["Logits"] = c(x, "Logits/Conv2d_1c_1x1", self.num_classes, 1,
                              head=True).flatten(1)
        return out


def text_feature(params, tokens: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """The mean of the caption's embeddings over its first ``lengths`` ids
    (a length of 0 gives zeros)."""
    emb = F.embedding(tokens.long(), params[EMBEDDINGS])
    keep = torch.arange(tokens.shape[1], device=tokens.device)[None, :] < lengths[:, None]
    total = (emb * keep[..., None]).sum(1)
    return total / lengths.clamp_min(1)[:, None].float()


def joint_forward(params, images, tokens, lengths, quant: Optional[Quant] = None,
                  **tower) -> Dict[str, torch.Tensor]:
    """The joint model: {"Logits" (joint), "AuxLogits", "Predictions"}, plus
    the tower's own unused ``Logits`` as ``TowerLogits``."""
    t = Tower(params, quant=quant, **tower)
    out = t(images)
    fused = torch.cat([out["PreLogits"], text_feature(params, tokens, lengths)], 1)
    k = params["JointLogits.kernel"]
    if quant is not None and quant.kind == "fp8":
        fused, k = quant.act("JointLogits", fused), quant.weight(k)
    logits = fused @ k.t() + params["JointLogits.bias"]
    res = {"Logits": logits, "Predictions": torch.softmax(logits, -1),
           "TowerLogits": out.get("Logits")}
    if "AuxLogits" in out:
        res["AuxLogits"] = out["AuxLogits"]
    return res


def layer_table(image_size: int = 299, depth_multiplier: float = 1.0,
                num_classes: int = 15, train: bool = False) -> List[Conv]:
    """Every conv of the tower for one image, in the order a pass meets
    them, from a pass on the meta device."""
    t = Tower(None, depth_multiplier=depth_multiplier, num_classes=num_classes, train=train)
    t(torch.zeros(1, image_size, image_size, 3, device="meta"))
    return t.table


def param_shapes(image_size: int = 299, depth_multiplier: float = 1.0,
                 num_classes: int = 15, vocab_size: int = 50_000, embed_dim: int = 200
                 ) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """{state key: (shape, kind)} of the joint model, kind one of
    ``conv_relu``, ``conv_head``, ``bias``, ``beta``, ``mean``, ``var``,
    ``embedding``, ``dense``."""
    out: Dict[str, Tuple[Tuple[int, ...], str]] = {}
    feat = 0
    for conv in layer_table(image_size, depth_multiplier, num_classes):
        out[f"{conv.name}.weights"] = ((conv.cout, conv.cin, *conv.kernel),
                                       "conv_head" if conv.head else "conv_relu")
        if conv.head:
            out[f"{conv.name}.biases"] = ((conv.cout,), "bias")
        else:
            for leaf, kind in (("beta", "beta"), ("moving_mean", "mean"),
                               ("moving_variance", "var")):
                out[f"{conv.name}.BatchNorm.{leaf}"] = ((conv.cout,), kind)
        if conv.name == TOWER + "Logits/Conv2d_1c_1x1":
            feat = conv.cin
    out[EMBEDDINGS] = ((vocab_size, embed_dim), "embedding")
    out["JointLogits.kernel"] = ((num_classes, feat + embed_dim), "dense")
    out["JointLogits.bias"] = ((num_classes,), "bias")
    return out
