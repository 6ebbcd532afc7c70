"""Serving: uint8 image batches -> emotion probabilities on one card.

Port of the one-device form of ``tumblr_emotions_tpu/ops/serving.py``:
``image_server`` is ``data_parallel_server`` on a single device (preprocess
-> engine -> softmax), and ``build_forward`` builds the served program for
an image model: the ``"int8"`` engine (the default, as in the reference:
``QuantizedInceptionV3`` with the shift epilogue behind the space-to-depth
front), the ``"bf16"`` BN-folded engine or the ``"parity"`` f32 tower.  The
uint8 front, the joint server and multi-card serving come with later
slices.

The default served program is ``image_server(QuantizedInceptionV3(state,
calib, stem_s2d="pre"))``, the program the JAX package's ``bench.py``
measures; its convs and max pools run as hand-written kernels
(``ops/int8_conv.py``, ``ops/int8_pool.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from tumblr_emotions_torch._device import resolve_device
from tumblr_emotions_torch.data.preprocessing import (
    preprocess_for_eval, preprocess_for_eval_s2d)
from tumblr_emotions_torch.models.inception_v3 import InceptionV3
from tumblr_emotions_torch.ops.inference import FusedInceptionV3
from tumblr_emotions_torch.ops.quant import QuantizedInceptionV3


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


def image_server(engine, device="cuda",
                 preprocess_dtype=torch.bfloat16, image_size: int = 299,
                 central_fraction: float = 0.875, resize_method: str = "tf1"
                 ) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """[B, H, W, 3] uint8 (tensor or numpy) -> (probs [B, C] f32,
    feature [B, 2048] f32), computed on ``device``.

    ``engine`` maps preprocessed images to (logits, feature):
    ``FusedInceptionV3`` or ``QuantizedInceptionV3``; an engine built with
    ``stem_s2d="pre"`` is fed the space-to-depth layout
    (``preprocess_for_eval_s2d``).  The preprocess knobs must match the
    model's eval config (``build_forward`` threads them from ``cfg``).
    """
    dev = resolve_device(device)
    if engine.device != dev:
        raise ValueError(f"engine on {engine.device}, server on {dev}")

    pre = (preprocess_for_eval_s2d if getattr(engine, "stem_s2d", False) == "pre"
           else preprocess_for_eval)

    @torch.inference_mode()
    def serve(images):
        x = pre(_uint8_batch(images, dev), image_size, image_size,
                central_fraction=central_fraction, resize_method=resize_method,
                dtype=preprocess_dtype)
        return _checked(*engine(x))

    return serve


def build_forward(cfg, state: Dict[str, torch.Tensor], engine: str = "int8",
                  device="cuda", calib_images=None, front: str = "s2d") -> Callable:
    """``runner(image_u8, tokens=None, lengths=None) -> probs [B, C]`` for an
    image model described by ``cfg`` and its port state dict.

    ``engine``: ``"int8"`` (quantized, shift epilogue; the default, as in
    the JAX package), ``"bf16"`` (BN-folded, cuDNN blocks, as the JAX
    package's ``build_forward`` builds it) or ``"parity"`` (the f32 slim
    tower, TF32 off).  ``calib_images`` (preprocessed f32 [N,H,W,3])
    calibrates the int8 engine's activation scales.  ``front`` picks the
    int8 engine's preprocess: ``"s2d"`` (default: the resize emits the 2x2
    space-to-depth layout and the stem runs as the stride-1 K=12 conv) or
    ``"float"`` (normal layout, stride-2 stem).  The ``"uint8"`` front and
    the text/joint models are not ported yet.  The int8 and bf16 runners
    carry their engine as ``runner.engine``.
    """
    if front not in ("s2d", "uint8", "float"):
        raise ValueError(f"unknown front {front!r}; expected s2d|uint8|float")
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
    if engine == "int8":
        # The reference's uint8 front implements the TF1 resize only and
        # falls back to the float front for any other resize.
        if front == "uint8" and cfg.data.resize_method == "tf1":
            raise NotImplementedError(
                "front='uint8' (preprocess_for_eval_int8, int8 resize GEMMs) is "
                "not ported yet; use front='s2d' or 'float'")
        if calib_images is None:
            raise ValueError("int8 serving needs calib_images (a "
                             "preprocessed f32 calibration batch)")
        eng = QuantizedInceptionV3(state, calib_images, epilogue="shift",
                                   stem_s2d="pre" if front == "s2d" else False,
                                   device=dev)
    elif engine == "bf16":
        eng = FusedInceptionV3(state, dtype=torch.bfloat16, use_kernels=False,
                               device=dev)
    else:
        raise ValueError(f"unknown engine {engine!r}; expected int8|bf16|parity")
    server = image_server(eng, device=dev, image_size=size, **pp)

    def runner(image, tokens=None, lengths=None):
        return server(image)[0]

    runner.engine = eng  # the engine behind the runner (its scales, epilogue kinds)
    return runner
