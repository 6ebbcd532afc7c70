"""Config dataclasses for the PyTorch port: the image, text and joint models
and their eval data.

A copy of the parts of ``tumblr_emotions_tpu/config.py`` that the port
reads (it imports nothing of the JAX package): the model and data configs,
``TrainConfig`` (the trainer's settings; ``precision_mode`` picks the f32
``"parity"`` or the bf16 ``"perf"`` model), ``MeshConfig`` (the data axis:
one process per card, ``parallel/mesh.py``) and the reference's five
presets.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# The 15 Tumblr emotion hashtag labels, in the reference's (alphabetical) order.
EMOTIONS: Tuple[str, ...] = (
    "amazed",
    "angry",
    "annoyed",
    "ashamed",
    "bored",
    "calm",
    "disgusted",
    "excited",
    "happy",
    "love",
    "optimistic",
    "pensive",
    "sad",
    "scared",
    "surprised",
)
NUM_CLASSES = len(EMOTIONS)


class _Replaceable:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class TextConfig(_Replaceable):
    """Text branch: vocab lookup -> embedding matrix -> aggregate -> head."""

    vocab_size: int = 50_000
    embed_dim: int = 200          # GloVe-style dims
    max_len: int = 50             # Tumblr captions are short
    aggregator: str = "mean"      # "mean" | "sum" | "rnn"
    rnn_hidden: int = 256
    pad_id: int = 0
    oov_id: int = 1
    finetune_embeddings: bool = True
    hidden_dim: int = 0           # optional hidden dense layer; 0 = logits direct


@dataclasses.dataclass(frozen=True)
class ImageConfig(_Replaceable):
    """Image branch: TF-Slim-semantics Inception-v3."""

    image_size: int = 299
    num_classes: int = NUM_CLASSES
    depth_multiplier: float = 1.0
    min_depth: int = 16
    dropout_keep_prob: float = 0.8
    create_aux_logits: bool = True
    aux_loss_weight: float = 0.4
    # slim inception_v3_arg_scope: BN scale=False, decay=0.9997, epsilon=0.001.
    bn_epsilon: float = 0.001
    bn_momentum: float = 0.9997
    bn_scale: bool = False


@dataclasses.dataclass(frozen=True)
class DataConfig(_Replaceable):
    data_dir: str = ""
    split_name: str = "train"
    records_pattern: str = ""
    labels_file: str = ""
    vocab_file: str = ""
    embeddings_file: str = ""
    shuffle_buffer: int = 4096
    num_workers: int = 8
    prefetch_batches: int = 2
    decode_backend: str = "auto"
    eval_central_crop: float = 0.875
    resize_method: str = "tf1"    # "tf1" legacy bilinear (parity) | "half_pixel"


@dataclasses.dataclass(frozen=True)
class MeshConfig(_Replaceable):
    """The processes of a data-parallel run (``parallel/mesh.py``): the
    ``data`` axis is the process group, one card per process; ``model``
    (tensor parallelism) is the reference's field, and ``create_mesh``
    refuses any value but 1."""

    data: int = -1                # -1 = every process of the group
    model: int = 1


@dataclasses.dataclass(frozen=True)
class TrainConfig(_Replaceable):
    batch_size: int = 32
    eval_batch_size: int = 64
    learning_rate: float = 1e-3
    lr_decay_steps: int = 0       # 0 = constant lr
    lr_decay_factor: float = 0.94
    optimizer: str = "rmsprop"    # slim fine-tune default; "adam"|"sgd"|"rmsprop"
    rmsprop_decay: float = 0.9
    rmsprop_epsilon: float = 1.0
    momentum: float = 0.9
    weight_decay: float = 4e-5    # slim inception arg_scope default
    grad_clip_norm: float = 0.0   # 0 = off
    num_steps: int = 1000
    log_every: int = 50
    checkpoint_every: int = 500
    checkpoint_dir: str = "/tmp/tumblr_emotions_ckpt"
    keep_checkpoints: int = 3
    log_dir: str = ""                # TensorBoard event files
    profile_start_step: int = 0      # 0 = no profiler trace
    profile_num_steps: int = 3
    seed: int = 0
    # "parity" = f32 everywhere (1e-4 logit budget); "perf" = bf16 compute.
    precision_mode: str = "parity"
    trainable_scopes: str = ""    # e.g. "Logits,AuxLogits" = new-head-only phase
    warmstart_checkpoint: str = ""   # slim .ckpt or checkpoint dir to restore from
    warmstart_exclude: Tuple[str, ...] = ("Logits", "AuxLogits")


@dataclasses.dataclass(frozen=True)
class Config(_Replaceable):
    name: str = "default"
    model: str = "joint"          # "text" | "image" | "joint"
    text: TextConfig = TextConfig()
    image: ImageConfig = ImageConfig()
    data: DataConfig = DataConfig()
    mesh: MeshConfig = MeshConfig()
    train: TrainConfig = TrainConfig()


PRESETS = {
    # Text-only: embedding + dense softmax.
    "text_only": Config(
        name="text_only", model="text",
        train=TrainConfig(batch_size=64, optimizer="adam", learning_rate=1e-3,
                          weight_decay=0.0, num_steps=2000)),
    # Image-only: frozen Inception backbone + linear emotion head.
    "image_frozen": Config(
        name="image_frozen", model="image",
        train=TrainConfig(batch_size=32, optimizer="rmsprop",
                          trainable_scopes="Logits,AuxLogits",
                          warmstart_checkpoint="", num_steps=5000)),
    # Joint image+text concat fusion (the paper's multimodal model).
    "joint_finetune": Config(
        name="joint_finetune", model="joint",
        train=TrainConfig(batch_size=32, optimizer="rmsprop", learning_rate=1e-4,
                          num_steps=20000)),
    # Fused inference path: preprocess + forward of the image model, bf16
    # perf mode.
    "fused_inference": Config(
        name="fused_inference", model="image",
        train=TrainConfig(batch_size=256, precision_mode="perf")),
    # Full-corpus data-parallel training: bf16 compute on f32 masters, the
    # batch split over every process of the group.
    "data_parallel": Config(
        name="data_parallel", model="joint", mesh=MeshConfig(data=-1),
        train=TrainConfig(batch_size=1024, precision_mode="perf", num_steps=100_000)),
}


def get_preset(name: str) -> Config:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(
            f"unknown preset {name!r}; available: {sorted(PRESETS)}") from None
