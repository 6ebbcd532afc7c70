import torch

from tumblr_emotions_torch.models.inception_v3 import InceptionV3, init_state  # noqa: F401
from tumblr_emotions_torch.models.joint_model import DeepSentimentModel  # noqa: F401
from tumblr_emotions_torch.models.text_model import TextEmotionModel  # noqa: F401


def build_model(cfg, device="cuda"):
    """The model ``cfg`` describes, in eval mode, with zero weights to load a
    state into: the model half of the JAX trainer's ``build_model``
    (``tumblr_emotions_tpu/train/trainer.py:54``), in f32 or, when
    ``cfg.train.precision_mode == "perf"``, in bf16 (the reference's perf
    model; see ``models/layers.py``), with the config's batch-norm decay and
    dropout for train mode."""
    im, tx = cfg.image, cfg.text
    if cfg.train.precision_mode not in ("parity", "perf"):
        raise ValueError(f"unknown precision_mode {cfg.train.precision_mode!r}; "
                         "expected parity|perf")
    dtype = torch.bfloat16 if cfg.train.precision_mode == "perf" else torch.float32
    tower = dict(depth_multiplier=im.depth_multiplier, min_depth=im.min_depth,
                 create_aux_logits=im.create_aux_logits, bn_epsilon=im.bn_epsilon,
                 bn_scale=im.bn_scale, bn_momentum=im.bn_momentum,
                 dropout_keep_prob=im.dropout_keep_prob, image_size=im.image_size,
                 dtype=dtype)
    text = dict(num_classes=im.num_classes, aggregator=tx.aggregator,
                rnn_hidden=tx.rnn_hidden, pad_id=tx.pad_id)
    if cfg.model == "image":
        return InceptionV3(num_classes=im.num_classes, **tower, device=device)
    if cfg.model == "text":
        return TextEmotionModel(tx.vocab_size, tx.embed_dim, hidden_dim=tx.hidden_dim, **text,
                                dtype=dtype, device=device)
    if cfg.model == "joint":
        return DeepSentimentModel(tx.vocab_size, tx.embed_dim, **text, **tower, device=device)
    raise ValueError(f"unknown model type {cfg.model!r}; expected image|text|joint")
