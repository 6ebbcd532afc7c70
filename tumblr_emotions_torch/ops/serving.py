"""Serving: uint8 image batches -> emotion probabilities on one card.

Port of the one-device form of ``tumblr_emotions_tpu/ops/serving.py``:
``image_server`` is ``data_parallel_server`` on a single device (preprocess
-> engine -> softmax), and ``build_forward`` builds the served program for
an image model with the ``"bf16"`` BN-folded engine or the ``"parity"`` f32
tower.  The int8 engine, the joint server and multi-card serving come with
later slices.

The hand-written-kernel program is
``image_server(FusedInceptionV3(state, use_kernels=True))``, the program
the JAX package's ``bench.py`` measures as its ``pallas`` engine.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from tumblr_emotions_torch._device import resolve_device
from tumblr_emotions_torch.data.preprocessing import preprocess_for_eval
from tumblr_emotions_torch.models.inception_v3 import InceptionV3
from tumblr_emotions_torch.ops.inference import FusedInceptionV3


def _checked(logits, feature):
    if logits is None:
        raise ValueError(
            "engine has no Logits head (state lacks Logits/Conv2d_1c_1x1); "
            "build the server from a classifier, or call the engine directly "
            "for features")
    return torch.softmax(logits.float(), dim=-1), feature


def _uint8_batch(images, dev: torch.device) -> torch.Tensor:
    raw = torch.as_tensor(images)
    if raw.dtype != torch.uint8 or raw.ndim != 4 or raw.shape[-1] != 3:
        raise ValueError(f"expected a uint8 [B,H,W,3] batch, got "
                         f"{raw.dtype} {tuple(raw.shape)}")
    return raw.to(dev)


def image_server(engine: FusedInceptionV3, device="cuda",
                 preprocess_dtype=torch.bfloat16, image_size: int = 299,
                 central_fraction: float = 0.875, resize_method: str = "tf1"
                 ) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """[B, H, W, 3] uint8 (tensor or numpy) -> (probs [B, C] f32,
    feature [B, 2048] f32), computed on ``device``.

    The preprocess knobs must match the model's eval config
    (``build_forward`` threads them from ``cfg``).
    """
    dev = resolve_device(device)
    if engine.device != dev:
        raise ValueError(f"engine on {engine.device}, server on {dev}")

    @torch.inference_mode()
    def serve(images):
        x = preprocess_for_eval(_uint8_batch(images, dev), image_size, image_size,
                                central_fraction=central_fraction,
                                resize_method=resize_method,
                                dtype=preprocess_dtype)
        return _checked(*engine(x))

    return serve


def build_forward(cfg, state: Dict[str, torch.Tensor], engine: str = "bf16",
                  device="cuda") -> Callable:
    """``runner(image_u8, tokens=None, lengths=None) -> probs [B, C]`` for an
    image model described by ``cfg`` and its port state dict.

    ``engine``: ``"bf16"`` (BN-folded, cuDNN blocks, as the JAX package's
    ``build_forward`` builds it) or ``"parity"`` (the f32 slim tower, TF32
    off).  The int8 engine and the text/joint models are not ported yet.
    """
    if cfg.model != "image":
        raise NotImplementedError(
            f"model {cfg.model!r} is not ported yet; only 'image' is")
    dev = resolve_device(device)
    size = cfg.image.image_size
    pp = dict(central_fraction=cfg.data.eval_central_crop,
              resize_method=cfg.data.resize_method)
    if engine == "parity":
        im = cfg.image
        model = InceptionV3(num_classes=im.num_classes,
                            depth_multiplier=im.depth_multiplier,
                            min_depth=im.min_depth,
                            create_aux_logits=im.create_aux_logits,
                            bn_epsilon=im.bn_epsilon, bn_scale=im.bn_scale,
                            image_size=size, device=dev)
        model.load_state_dict(state)

        @torch.inference_mode()
        def runner(image, tokens=None, lengths=None):
            x = preprocess_for_eval(_uint8_batch(image, dev), size, size,
                                    dtype=torch.float32, **pp)
            return model(x)[1]["Predictions"]

        return runner
    if engine == "bf16":
        eng = FusedInceptionV3(state, dtype=torch.bfloat16, use_kernels=False,
                               device=dev)
        server = image_server(eng, device=dev, image_size=size, **pp)
        return lambda image, tokens=None, lengths=None: server(image)[0]
    raise ValueError(f"unknown engine {engine!r}; expected bf16|parity "
                     "(int8 is not ported yet)")
