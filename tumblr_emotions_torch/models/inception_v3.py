"""Inception-v3 with TF-Slim semantics and variable naming, in PyTorch.

Port of ``tumblr_emotions_tpu/models/inception_v3.py``: the f32 slim-exact
tower that the served ``"parity"`` engine runs, that the bf16 engine is
held against on the card, and that the trainer trains (``model.train()``:
batch-statistics batch norm and dropout before ``PreLogits``).  Module
names are the slim scopes verbatim, quirks included (``Mixed_5c/Branch_1/Conv_1_0c_5x5``, the
``Conv2d_1a_1x1`` name on Mixed_6a's 3x3 stride-2 conv, Mixed_7b's doubled
``Conv2d_0b_*`` scopes), so ``state_dict()`` keys are the JAX package's
variable paths (see ``convert.py``).  Activations are NHWC at the module's
edges, as in the JAX package.  ``dtype=torch.bfloat16`` builds the
JAX package's bf16 (``precision_mode="perf"``) model: the input is cast to
bf16 and every layer follows ``models/layers.py``'s bf16 rules, so the
average pools (the Inception-A/B/C pool branches, the aux head's pool and
the global pool, hence ``PreLogits``) are f32.  The bf16 model trains as
the reference's perf step does, on f32 master weights (``models/layers.py``
says which roundings its backward keeps).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from tumblr_emotions_torch._device import full_f32, resolve_device
from tumblr_emotions_torch.models.layers import (
    ConvBN, Dropout, avg_pool, max_pool, train_logits)


def inception_a_names(quirky_5c: bool) -> Tuple[str, str]:
    """Branch_1's (1x1, 5x5) names; slim's Mixed_5c uses other scopes."""
    return (("Conv2d_0b_1x1", "Conv_1_0c_5x5") if quirky_5c
            else ("Conv2d_0a_1x1", "Conv2d_0b_5x5"))


def _aux_kernel(image_size: int) -> int:
    """Spatial size of the aux head's input, capped at 5 (slim's
    ``min(5, spatial)``): 5 at the canonical 299 input."""
    s = (image_size - 3) // 2 + 1       # Conv2d_1a_3x3, stride 2
    s = s - 2                           # Conv2d_2a_3x3
    s = (s - 3) // 2 + 1 - 2            # MaxPool_3a, Conv2d_4a_3x3
    s = (s - 3) // 2 + 1                # MaxPool_5a -> the 35x35 stage
    s = (s - 3) // 2 + 1                # Mixed_6a -> the 17x17 stage
    return min(5, (s - 5) // 3 + 1)     # 5x5/3 VALID avg pool


class InceptionV3(nn.Module):
    """Inception-v3 classifier tower.

    ``forward`` returns ``(logits, end_points)`` like slim's
    ``inception_v3``: every Mixed block, ``AuxLogits`` (if built),
    ``PreLogits`` ([N,1,1,C]), ``Logits`` and ``Predictions``.
    ``image_size`` fixes the aux head's kernel, as the input shape does in
    the JAX package.  Built in eval mode; ``train()`` switches batch norm
    to batch statistics (``bn_momentum`` for the moving averages) and turns
    on the ``Logits/Dropout_1b`` dropout (``dropout_keep_prob``).
    """

    def __init__(self, num_classes: int = 15, depth_multiplier: float = 1.0,
                 min_depth: int = 16, create_aux_logits: bool = True,
                 bn_epsilon: float = 0.001, bn_scale: bool = False,
                 bn_momentum: float = 0.9997, dropout_keep_prob: float = 0.8,
                 image_size: int = 299, dtype=torch.float32, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        self.num_classes = num_classes
        self.depth_multiplier = depth_multiplier
        self.min_depth = min_depth
        self.image_size = image_size
        self.aux = create_aux_logits and num_classes > 0
        d = self._depth

        def conv(name, cin, cout, kernel, strides=(1, 1), padding="VALID", **kw):
            self.add_module(name, ConvBN(cin, cout, kernel, strides, padding,
                                         bn_epsilon=bn_epsilon, bn_scale=bn_scale,
                                         bn_momentum=bn_momentum, dtype=dtype, device=dev,
                                         **kw))
            return cout

        def sconv(name, cin, cout, kernel):
            return conv(name, cin, cout, kernel, padding="SAME")

        c = conv("Conv2d_1a_3x3", 3, d(32), (3, 3), (2, 2))
        c = conv("Conv2d_2a_3x3", c, d(32), (3, 3))
        c = sconv("Conv2d_2b_3x3", c, d(64), (3, 3))
        c = conv("Conv2d_3b_1x1", c, d(80), (1, 1))
        c = conv("Conv2d_4a_3x3", c, d(192), (3, 3))

        for scope, pool_features in (("Mixed_5b", 32), ("Mixed_5c", 64),
                                     ("Mixed_5d", 64)):
            n1 = inception_a_names(scope == "Mixed_5c")
            sconv(f"{scope}/Branch_0/Conv2d_0a_1x1", c, d(64), (1, 1))
            sconv(f"{scope}/Branch_1/{n1[0]}", c, d(48), (1, 1))
            sconv(f"{scope}/Branch_1/{n1[1]}", d(48), d(64), (5, 5))
            sconv(f"{scope}/Branch_2/Conv2d_0a_1x1", c, d(64), (1, 1))
            sconv(f"{scope}/Branch_2/Conv2d_0b_3x3", d(64), d(96), (3, 3))
            sconv(f"{scope}/Branch_2/Conv2d_0c_3x3", d(96), d(96), (3, 3))
            sconv(f"{scope}/Branch_3/Conv2d_0b_1x1", c, d(pool_features), (1, 1))
            c = d(64) + d(64) + d(96) + d(pool_features)

        scope = "Mixed_6a"
        conv(f"{scope}/Branch_0/Conv2d_1a_1x1", c, d(384), (3, 3), (2, 2))
        sconv(f"{scope}/Branch_1/Conv2d_0a_1x1", c, d(64), (1, 1))
        sconv(f"{scope}/Branch_1/Conv2d_0b_3x3", d(64), d(96), (3, 3))
        conv(f"{scope}/Branch_1/Conv2d_1a_1x1", d(96), d(96), (3, 3), (2, 2))
        c = d(384) + d(96) + c

        for scope, c7 in (("Mixed_6b", 128), ("Mixed_6c", 160),
                          ("Mixed_6d", 160), ("Mixed_6e", 192)):
            sconv(f"{scope}/Branch_0/Conv2d_0a_1x1", c, d(192), (1, 1))
            sconv(f"{scope}/Branch_1/Conv2d_0a_1x1", c, d(c7), (1, 1))
            sconv(f"{scope}/Branch_1/Conv2d_0b_1x7", d(c7), d(c7), (1, 7))
            sconv(f"{scope}/Branch_1/Conv2d_0c_7x1", d(c7), d(192), (7, 1))
            sconv(f"{scope}/Branch_2/Conv2d_0a_1x1", c, d(c7), (1, 1))
            sconv(f"{scope}/Branch_2/Conv2d_0b_7x1", d(c7), d(c7), (7, 1))
            sconv(f"{scope}/Branch_2/Conv2d_0c_1x7", d(c7), d(c7), (1, 7))
            sconv(f"{scope}/Branch_2/Conv2d_0d_7x1", d(c7), d(c7), (7, 1))
            sconv(f"{scope}/Branch_2/Conv2d_0e_1x7", d(c7), d(192), (1, 7))
            sconv(f"{scope}/Branch_3/Conv2d_0b_1x1", c, d(192), (1, 1))
            c = 4 * d(192)

        if self.aux:
            k = _aux_kernel(image_size)
            self.aux_conv2a = f"AuxLogits/Conv2d_2a_{k}x{k}"
            sconv("AuxLogits/Conv2d_1b_1x1", c, d(128), (1, 1))
            conv(self.aux_conv2a, d(128), d(768), (k, k))
            conv("AuxLogits/Conv2d_2b_1x1", d(768), num_classes, (1, 1),
                 padding="SAME", use_bn=False, use_bias=True, relu=False)

        scope = "Mixed_7a"
        sconv(f"{scope}/Branch_0/Conv2d_0a_1x1", c, d(192), (1, 1))
        conv(f"{scope}/Branch_0/Conv2d_1a_3x3", d(192), d(320), (3, 3), (2, 2))
        sconv(f"{scope}/Branch_1/Conv2d_0a_1x1", c, d(192), (1, 1))
        sconv(f"{scope}/Branch_1/Conv2d_0b_1x7", d(192), d(192), (1, 7))
        sconv(f"{scope}/Branch_1/Conv2d_0c_7x1", d(192), d(192), (7, 1))
        conv(f"{scope}/Branch_1/Conv2d_1a_3x3", d(192), d(192), (3, 3), (2, 2))
        c = d(320) + d(192) + c

        for scope, quirky_7c in (("Mixed_7b", False), ("Mixed_7c", True)):
            n31 = "Conv2d_0c_3x1" if quirky_7c else "Conv2d_0b_3x1"
            sconv(f"{scope}/Branch_0/Conv2d_0a_1x1", c, d(320), (1, 1))
            sconv(f"{scope}/Branch_1/Conv2d_0a_1x1", c, d(384), (1, 1))
            sconv(f"{scope}/Branch_1/Conv2d_0b_1x3", d(384), d(384), (1, 3))
            sconv(f"{scope}/Branch_1/{n31}", d(384), d(384), (3, 1))
            sconv(f"{scope}/Branch_2/Conv2d_0a_1x1", c, d(448), (1, 1))
            sconv(f"{scope}/Branch_2/Conv2d_0b_3x3", d(448), d(384), (3, 3))
            sconv(f"{scope}/Branch_2/Conv2d_0c_1x3", d(384), d(384), (1, 3))
            sconv(f"{scope}/Branch_2/Conv2d_0d_3x1", d(384), d(384), (3, 1))
            sconv(f"{scope}/Branch_3/Conv2d_0b_1x1", c, d(192), (1, 1))
            c = d(320) + 2 * d(384) + 2 * d(384) + d(192)
        self.num_features = c           # PreLogits width (2048 at depth 1)
        self.add_module("Logits/Dropout_1b", Dropout(dropout_keep_prob))

        if num_classes > 0:
            conv("Logits/Conv2d_1c_1x1", c, num_classes, (1, 1), padding="SAME",
                 use_bn=False, use_bias=True, relu=False)
        self.eval()

    def _depth(self, d: int) -> int:
        return max(int(d * self.depth_multiplier), self.min_depth)

    def _c(self, name: str) -> ConvBN:
        return self._modules[name]

    def forward(self, x: torch.Tensor, generator=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Preprocessed NHWC f32 images -> (logits, end_points), computed in
        the model's dtype (the probabilities in f32).  In train mode the
        dropout draws from ``generator``."""
        if x.ndim != 4:
            raise ValueError(f"expected NHWC input, got shape {tuple(x.shape)}")
        with full_f32():
            return self._forward(x.to(self.dtype), generator)

    def _forward(self, x, generator=None):
        c = self._c
        ep: Dict[str, torch.Tensor] = {}

        def add(name, net):
            ep[name] = net
            return net

        net = add("Conv2d_1a_3x3", c("Conv2d_1a_3x3")(x))
        net = add("Conv2d_2a_3x3", c("Conv2d_2a_3x3")(net))
        net = add("Conv2d_2b_3x3", c("Conv2d_2b_3x3")(net))
        net = add("MaxPool_3a_3x3", max_pool(net, (3, 3), (2, 2)))
        net = add("Conv2d_3b_1x1", c("Conv2d_3b_1x1")(net))
        net = add("Conv2d_4a_3x3", c("Conv2d_4a_3x3")(net))
        net = add("MaxPool_5a_3x3", max_pool(net, (3, 3), (2, 2)))

        for scope in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
            n1 = inception_a_names(scope == "Mixed_5c")
            b0 = c(f"{scope}/Branch_0/Conv2d_0a_1x1")(net)
            b1 = c(f"{scope}/Branch_1/{n1[0]}")(net)
            b1 = c(f"{scope}/Branch_1/{n1[1]}")(b1)
            b2 = c(f"{scope}/Branch_2/Conv2d_0a_1x1")(net)
            b2 = c(f"{scope}/Branch_2/Conv2d_0b_3x3")(b2)
            b2 = c(f"{scope}/Branch_2/Conv2d_0c_3x3")(b2)
            b3 = c(f"{scope}/Branch_3/Conv2d_0b_1x1")(
                avg_pool(net, (3, 3), (1, 1)))
            net = add(scope, torch.cat([b0, b1, b2, b3], dim=-1))

        scope = "Mixed_6a"
        b0 = c(f"{scope}/Branch_0/Conv2d_1a_1x1")(net)
        b1 = c(f"{scope}/Branch_1/Conv2d_0a_1x1")(net)
        b1 = c(f"{scope}/Branch_1/Conv2d_0b_3x3")(b1)
        b1 = c(f"{scope}/Branch_1/Conv2d_1a_1x1")(b1)
        b2 = max_pool(net, (3, 3), (2, 2))
        net = add(scope, torch.cat([b0, b1, b2], dim=-1))

        for scope in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            b0 = c(f"{scope}/Branch_0/Conv2d_0a_1x1")(net)
            b1 = c(f"{scope}/Branch_1/Conv2d_0a_1x1")(net)
            b1 = c(f"{scope}/Branch_1/Conv2d_0b_1x7")(b1)
            b1 = c(f"{scope}/Branch_1/Conv2d_0c_7x1")(b1)
            b2 = c(f"{scope}/Branch_2/Conv2d_0a_1x1")(net)
            for name in ("0b_7x1", "0c_1x7", "0d_7x1", "0e_1x7"):
                b2 = c(f"{scope}/Branch_2/Conv2d_{name}")(b2)
            b3 = c(f"{scope}/Branch_3/Conv2d_0b_1x1")(
                avg_pool(net, (3, 3), (1, 1)))
            net = add(scope, torch.cat([b0, b1, b2, b3], dim=-1))

        if self.aux:
            aux = avg_pool(net, (5, 5), (3, 3), padding="VALID")
            aux = c("AuxLogits/Conv2d_1b_1x1")(aux)
            k = min(5, aux.shape[1])
            if f"AuxLogits/Conv2d_2a_{k}x{k}" != self.aux_conv2a:
                raise ValueError(
                    f"input {tuple(x.shape)} needs a {k}x{k} aux conv; this "
                    f"model was built for image_size={self.image_size}")
            aux = c(self.aux_conv2a)(aux)
            aux = train_logits(c("AuxLogits/Conv2d_2b_1x1").unrounded(aux), self)
            ep["AuxLogits"] = aux.squeeze(2).squeeze(1)

        scope = "Mixed_7a"
        b0 = c(f"{scope}/Branch_0/Conv2d_0a_1x1")(net)
        b0 = c(f"{scope}/Branch_0/Conv2d_1a_3x3")(b0)
        b1 = c(f"{scope}/Branch_1/Conv2d_0a_1x1")(net)
        b1 = c(f"{scope}/Branch_1/Conv2d_0b_1x7")(b1)
        b1 = c(f"{scope}/Branch_1/Conv2d_0c_7x1")(b1)
        b1 = c(f"{scope}/Branch_1/Conv2d_1a_3x3")(b1)
        b2 = max_pool(net, (3, 3), (2, 2))
        net = add(scope, torch.cat([b0, b1, b2], dim=-1))

        for scope, quirky_7c in (("Mixed_7b", False), ("Mixed_7c", True)):
            n31 = "Conv2d_0c_3x1" if quirky_7c else "Conv2d_0b_3x1"
            b0 = c(f"{scope}/Branch_0/Conv2d_0a_1x1")(net)
            b1 = c(f"{scope}/Branch_1/Conv2d_0a_1x1")(net)
            b1 = torch.cat([c(f"{scope}/Branch_1/Conv2d_0b_1x3")(b1),
                            c(f"{scope}/Branch_1/{n31}")(b1)], dim=-1)
            b2 = c(f"{scope}/Branch_2/Conv2d_0a_1x1")(net)
            b2 = c(f"{scope}/Branch_2/Conv2d_0b_3x3")(b2)
            b2 = torch.cat([c(f"{scope}/Branch_2/Conv2d_0c_1x3")(b2),
                            c(f"{scope}/Branch_2/Conv2d_0d_3x1")(b2)], dim=-1)
            b3 = c(f"{scope}/Branch_3/Conv2d_0b_1x1")(
                avg_pool(net, (3, 3), (1, 1)))
            net = add(scope, torch.cat([b0, b1, b2, b3], dim=-1))

        # Global average pool with kernel min(8, spatial), as slim does.
        kh, kw = min(8, net.shape[1]), min(8, net.shape[2])
        net = avg_pool(net, (kh, kw), (1, 1), padding="VALID")
        net = self._modules["Logits/Dropout_1b"](net, generator)
        ep["PreLogits"] = net
        if self.num_classes == 0:
            return net, ep
        pre = c("Logits/Conv2d_1c_1x1").unrounded(net).squeeze(2).squeeze(1)
        logits = train_logits(pre, self)
        ep["Logits"] = logits
        ep["Predictions"] = torch.softmax(pre, dim=-1)
        return logits, ep


def init_state(model: InceptionV3, seed: int) -> Dict[str, torch.Tensor]:
    """Seeded random weights with slim's shapes and names, made with numpy.

    He-scaled conv weights (std sqrt(2/fan_in); sqrt(1/fan_in) for the
    linear heads), small random BN means and betas (std 0.1) and variances
    in [0.5, 1.5]: each BN-folded ReLU conv then keeps its activations at
    unit scale, so they stay O(1) through the full-width tower instead of
    growing layer by layer as slim's stddev-0.1 init does, and BN folding
    is exercised with non-trivial statistics.
    """
    rng = np.random.RandomState(seed)
    state: Dict[str, torch.Tensor] = {}
    for key, t in model.state_dict().items():
        shape = tuple(t.shape)
        leaf = key.rsplit(".", 1)[1]
        if leaf == "weights":
            fan_in = int(np.prod(shape[1:]))
            relu = model._c(key.rsplit(".", 1)[0]).relu
            a = rng.normal(0.0, np.sqrt((2.0 if relu else 1.0) / fan_in), shape)
        elif leaf in ("moving_variance", "gamma"):
            a = rng.uniform(0.5, 1.5, shape)
        else:  # beta, moving_mean, head biases
            a = rng.normal(0.0, 0.1, shape)
        state[key] = torch.from_numpy(a.astype(np.float32))
    return state
