"""Joint "Deep Sentiment" model: Inception pool feature ∥ text feature.

Port of ``tumblr_emotions_tpu/models/joint_model.py``: the Inception-v3
PreLogits feature (2048-d at depth 1) is concatenated with the
text representation, an optional ReLU Dense (``JointHidden``) follows, and
``JointLogits`` gives the 15-way emotion logits, softmaxed in f32.  The
image tower sits under ``InceptionV3`` and the text branch under ``Text``,
as in the JAX package's tree.

:meth:`DeepSentimentModel.fuse` is the serving split: the image tower runs
in a fused engine (``ops/quant.py``, ``ops/inference.py``) and this half
carries the text lookup and the joint softmax; :meth:`forward` runs the
slim tower (the ``parity`` engine), in f32 or, with ``dtype=torch.bfloat16``,
as the JAX package's bf16 (perf) model, whose ``PreLogits`` is f32.  In
train mode (f32 or bf16) the tower's batch norm uses batch statistics and its
dropout acts before ``PreLogits``, so the fused image feature is the
dropped-out one; the tower's own ``Logits`` head is still computed, and
unused.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from tumblr_emotions_torch._device import full_f32, resolve_device
from tumblr_emotions_torch.models import inception_v3, text_model
from tumblr_emotions_torch.models.layers import Dense, train_logits


class DeepSentimentModel(nn.Module):
    """Concat fusion of the image and text branches -> joint emotion logits."""

    def __init__(self, vocab_size: int, embed_dim: int, num_classes: int = 15,
                 aggregator: str = "mean", rnn_hidden: int = 256, pad_id: int = 0,
                 fusion_hidden: int = 0, create_aux_logits: bool = True,
                 depth_multiplier: float = 1.0, min_depth: int = 16,
                 bn_epsilon: float = 0.001, bn_scale: bool = False,
                 bn_momentum: float = 0.9997, dropout_keep_prob: float = 0.8,
                 image_size: int = 299, dtype=torch.float32, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        self.InceptionV3 = inception_v3.InceptionV3(
            num_classes=num_classes, depth_multiplier=depth_multiplier,
            min_depth=min_depth, create_aux_logits=create_aux_logits,
            bn_epsilon=bn_epsilon, bn_scale=bn_scale, bn_momentum=bn_momentum,
            dropout_keep_prob=dropout_keep_prob, image_size=image_size, dtype=dtype,
            device=dev)
        self.Text = text_model.TextEmotionModel(
            vocab_size, embed_dim, num_classes=0, aggregator=aggregator,
            rnn_hidden=rnn_hidden, pad_id=pad_id, dtype=dtype, device=dev)
        fused = self.InceptionV3.num_features + self.Text.feature_dim
        # (the fusion head's kernel gradient is left unrounded in bf16, as
        # the reference's perf step leaves it: models/layers.py)
        self.JointHidden = Dense(fused, fusion_hidden, dtype=dtype, device=dev,
                                 round_weight_grad=False) if fusion_hidden > 0 else None
        self.JointLogits = Dense(fusion_hidden or fused, num_classes, dtype=dtype, device=dev,
                                 round_weight_grad=False)
        self.eval()

    def fuse(self, image_feature: torch.Tensor, token_ids, lengths=None,
             exact: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Text branch + fusion head over a precomputed image feature [B, F]
        -> (logits, end_points: ImageFeature, TextFeature, Fused,
        JointHidden, Logits, Predictions).  ``exact``: the head's products
        summed in float64 (``layers.linear_f64``), as the served program
        sums them."""
        txt = self.Text.represent(token_ids, lengths)
        fused = torch.cat([image_feature, txt.to(image_feature.dtype)], dim=-1)
        end_points = {"ImageFeature": image_feature, "TextFeature": txt, "Fused": fused}
        with full_f32():
            if self.JointHidden is not None:
                fused = torch.relu(self.JointHidden(fused, exact))
                end_points["JointHidden"] = fused
            pre = self.JointLogits.unrounded(fused, exact)
        logits = train_logits(pre, self)
        end_points["Logits"] = logits
        end_points["Predictions"] = torch.softmax(pre, dim=-1)
        return logits, end_points

    def forward(self, images: torch.Tensor, token_ids, lengths=None, generator=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Preprocessed NHWC f32 images and [B, T] ids -> (logits,
        end_points), with the image tower's ``AuxLogits``.  In train mode
        the tower's dropout draws from ``generator``."""
        _, img = self.InceptionV3(images, generator=generator)
        logits, end_points = self.fuse(img["PreLogits"].squeeze(2).squeeze(1),
                                       token_ids, lengths)
        if "AuxLogits" in img:
            end_points["AuxLogits"] = img["AuxLogits"]
        return logits, end_points


TOWER = "InceptionV3."   # the image tower's prefix in a joint state


def tower_state(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The image tower's state (keys without ``InceptionV3.``) of a joint
    state, as the tower's engines take it."""
    return {k[len(TOWER):]: v for k, v in state.items() if k.startswith(TOWER)}


def init_state(model: DeepSentimentModel, seed: int) -> Dict[str, torch.Tensor]:
    """Seeded random weights with the joint model's shapes and names: the
    tower as ``inception_v3.init_state(seed)``, the text branch and the
    heads as ``text_model.dense_init`` from ``seed + 1``."""
    state = {TOWER + k: v for k, v in inception_v3.init_state(model.InceptionV3, seed).items()}
    rest = {k: tuple(t.shape) for k, t in model.state_dict().items() if not k.startswith(TOWER)}
    state.update(text_model.dense_init(rest, np.random.RandomState(seed + 1)))
    return state
