"""Serving: uint8 image batches (and post text) -> emotion probabilities on
one card.

Port of the one-device form of ``tumblr_emotions_tpu/ops/serving.py``:

- ``image_server`` is ``data_parallel_server`` on a single device
  (preprocess -> engine -> softmax); ``from_uint8=True`` serves the int8
  engine's all-int8 front (``QuantizedInceptionV3.forward_from_uint8``).
- ``joint_server`` is ``joint_data_parallel_server`` on a single device:
  the engine's image feature feeds ``DeepSentimentModel.fuse`` (text
  lookup, aggregator, concat fusion, joint softmax).
- ``build_forward`` builds the served program of an image, text or joint
  model: the ``"int8"`` engine (the default, as in the reference:
  ``QuantizedInceptionV3`` with the shift epilogue behind the front
  ``front`` picks), the ``"bf16"`` BN-folded engine or the ``"parity"``
  engine, the slim model in the config's precision mode (f32, or bf16 for
  ``cfg.train.precision_mode == "perf"``); a text model always runs that
  model.

The default served program is ``image_server(QuantizedInceptionV3(state,
calib, stem_s2d="pre"))``, the program the JAX package's ``bench.py``
measures; its convs and max pools run as hand-written kernels
(``ops/int8_conv.py``, ``ops/int8_pool.py``).  Every served program (the
preprocess, the engine, the text branch and the softmax) runs through
``utils.compile_opts.capture``, as the reference's runs through
``tpu_jit``: on the card, one CUDA graph per input signature, its inputs
copied into static buffers, so a batch is one launch.  Multi-card serving
comes with a later slice.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from tumblr_emotions_torch._device import resolve_device
from tumblr_emotions_torch.data.preprocessing import (
    preprocess_for_eval, preprocess_for_eval_s2d)
from tumblr_emotions_torch.models import build_model
from tumblr_emotions_torch.models.joint_model import tower_state
from tumblr_emotions_torch.ops.inference import FusedInceptionV3
from tumblr_emotions_torch.ops.quant import QuantizedInceptionV3
from tumblr_emotions_torch.utils.compile_opts import capture


def _checked(logits, feature):
    if logits is None:
        raise ValueError(
            "engine has no Logits head (state lacks Logits/Conv2d_1c_1x1); "
            "build the server from a classifier, or call the engine directly "
            "for features")
    return torch.softmax(logits.float(), dim=-1), feature


def _uint8_batch(images):
    """``images`` (a tensor or numpy array, where it lies: the captured
    program copies it to the card) after checking it is a uint8 [B,H,W,3]
    batch."""
    raw = images if isinstance(images, (torch.Tensor, np.ndarray)) else np.asarray(images)
    u8 = torch.uint8 if isinstance(raw, torch.Tensor) else np.uint8
    if raw.dtype != u8 or raw.ndim != 4 or raw.shape[-1] != 3:
        raise ValueError(f"expected a uint8 [B,H,W,3] batch, got "
                         f"{raw.dtype} {tuple(raw.shape)}")
    return raw


def _front(engine, dev: torch.device, from_uint8: bool, preprocess_dtype,
           image_size: int, central_fraction: float, resize_method: str
           ) -> Callable[[torch.Tensor], Tuple]:
    """uint8 batch on ``dev`` -> the engine's (logits, feature), through
    the preprocess the engine takes (the reference's ``_forward``)."""
    if engine.device != dev:
        raise ValueError(f"engine on {engine.device}, server on {dev}")
    pre_s2d = getattr(engine, "stem_s2d", False) == "pre"
    if from_uint8:
        if not hasattr(engine, "forward_from_uint8"):
            raise ValueError(
                f"{type(engine).__name__} has no forward_from_uint8; from_uint8 "
                "serving needs the int8 engine (ops.quant.QuantizedInceptionV3)")
        if resize_method != "tf1":
            raise ValueError(
                "the int8-GEMM preprocess implements the TF1 resize only; "
                f"resize_method={resize_method!r} needs from_uint8=False")
        if pre_s2d:
            raise ValueError(
                'from_uint8 serving feeds the normal [H,W,3] layout; an engine built '
                'with stem_s2d="pre" expects the space-to-depth layout (use '
                'from_uint8=False)')
        return lambda raw: engine.forward_from_uint8(
            raw, height=image_size, width=image_size, central_fraction=central_fraction)
    pre = preprocess_for_eval_s2d if pre_s2d else preprocess_for_eval
    return lambda raw: engine(pre(raw, image_size, image_size,
                                  central_fraction=central_fraction,
                                  resize_method=resize_method, dtype=preprocess_dtype))


def image_server(engine, device="cuda", preprocess_dtype=torch.bfloat16,
                 from_uint8: bool = False, image_size: int = 299,
                 central_fraction: float = 0.875, resize_method: str = "tf1"
                 ) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """[B, H, W, 3] uint8 (tensor or numpy) -> (probs [B, C] f32,
    feature [B, 2048] f32), computed on ``device``.

    ``engine`` maps preprocessed images to (logits, feature):
    ``FusedInceptionV3`` or ``QuantizedInceptionV3``; an engine built with
    ``stem_s2d="pre"`` is fed the space-to-depth layout
    (``preprocess_for_eval_s2d``).  ``from_uint8=True`` serves the int8
    engine's all-int8 front (TF1 resize only; not with ``stem_s2d="pre"``).
    The preprocess knobs must match the model's eval config
    (``build_forward`` threads them from ``cfg``).  The program runs through
    ``capture`` (``serve.program``).
    """
    dev = resolve_device(device)
    front = _front(engine, dev, from_uint8, preprocess_dtype, image_size,
                   central_fraction, resize_method)
    program = capture(lambda raw: _checked(*front(raw)), device=dev)

    def serve(images):
        return program(_uint8_batch(images))

    serve.program = program
    return serve


def joint_server(engine, model, device="cuda", preprocess_dtype=torch.bfloat16,
                 from_uint8: bool = False, image_size: int = 299,
                 central_fraction: float = 0.875, resize_method: str = "tf1"
                 ) -> Callable[..., torch.Tensor]:
    """The served joint Deep Sentiment program: (raw_u8 [B,H,W,3], tokens
    [B,T], lengths [B] or None) -> probs [B, C] f32, on ``device``.

    The image tower runs in ``engine`` (int8 or bf16, fronts as for
    :func:`image_server`); its feature, in f32, feeds ``model.fuse`` (a
    ``DeepSentimentModel`` on ``device``), which carries the text lookup, the
    aggregator and the fusion head.  ``lengths=None`` counts the non-pad ids.
    The whole program runs through ``capture`` (``serve.program``).
    """
    dev = resolve_device(device)
    front = _front(engine, dev, from_uint8, preprocess_dtype, image_size,
                   central_fraction, resize_method)

    def body(raw, tokens, lengths):
        _, feature = front(raw)
        return model.fuse(feature.float(), tokens, lengths)[1]["Predictions"]

    program = capture(body, device=dev)

    def serve(images, tokens, lengths=None):
        return program(_uint8_batch(images), tokens, lengths)

    serve.program = program
    return serve


def build_forward(cfg, state: Dict[str, torch.Tensor], engine: str = "int8",
                  device="cuda", calib_images=None, front: str = "s2d") -> Callable:
    """``runner(image_u8, tokens=None, lengths=None) -> probs [B, C]`` for the
    model ``cfg`` describes (image / text / joint) and its port state dict
    (the joint state holds the tower under ``InceptionV3.``).  Unused inputs
    may be None; ``lengths=None`` counts the non-pad ids.

    ``engine``: ``"int8"`` (quantized, shift epilogues; the default, as in
    the JAX package), ``"bf16"`` (BN-folded, cuDNN blocks, as the JAX
    package's ``build_forward`` builds it) or ``"parity"`` (the slim model
    ``models.build_model`` builds: f32 with TF32 off, or the bf16 model when
    ``cfg.train.precision_mode == "perf"``); a text model always runs that
    model.  Every runner carries its device as ``runner.device``.  ``calib_images``
    (preprocessed f32 [N,H,W,3]) calibrates the int8 engine's activation
    scales.  ``front`` picks the int8 engine's preprocess: ``"s2d"``
    (default: the resize emits the 2x2 space-to-depth layout and the stem
    runs as the stride-1 K=12 conv), ``"uint8"`` (the all-int8 front: int8
    resize GEMMs, no float image; TF1 resize only, any other resize falls
    back to the float front, as in the reference) or ``"float"`` (normal
    layout, stride-2 stem).  The int8 and bf16 runners carry their engine
    as ``runner.engine``.  Every runner serves its program through
    ``utils.compile_opts.capture`` (one CUDA graph per input signature on
    the card, unless ``TET_TORCH_COMPILER_OPTIONS`` turns it off), as
    ``runner.program`` (its eager program is ``runner.program.fn``); inputs may be
    tensors anywhere or numpy arrays.  A parity or text runner carries its
    slim model as ``runner.model``.
    """
    if front not in ("s2d", "uint8", "float"):
        raise ValueError(f"unknown front {front!r}; expected s2d|uint8|float")
    if cfg.model not in ("image", "text", "joint"):
        raise ValueError(f"unknown model type {cfg.model!r}; expected image|text|joint")
    dev = resolve_device(device)
    size = cfg.image.image_size
    pp = dict(central_fraction=cfg.data.eval_central_crop,
              resize_method=cfg.data.resize_method)
    if cfg.model == "text" or engine == "parity":
        model = build_model(cfg, device=dev)
        model.load_state_dict(state)

        def body(image, tokens, lengths):
            args = [] if cfg.model == "text" else [preprocess_for_eval(
                image, size, size, dtype=torch.float32, **pp)]
            if cfg.model != "image":
                args += [tokens, lengths]
            return model(*args)[1]["Predictions"]

        program = capture(body, device=dev)

        def runner(image=None, tokens=None, lengths=None):
            if cfg.model == "text":
                image = None
            elif image is not None:
                image = _uint8_batch(image)
            if cfg.model == "image":
                tokens = lengths = None
            return program(image, tokens, lengths)

        runner.device = dev
        runner.program = program
        runner.model = model
        return runner

    tower = state if cfg.model == "image" else tower_state(state)
    if engine == "int8":
        if calib_images is None:
            raise ValueError("int8 serving needs calib_images (a "
                             "preprocessed f32 calibration batch)")
        # The all-int8 uint8 front implements the TF1 resize only; another
        # resize falls back to the float front feeding the same int8 tower.
        from_uint8 = front == "uint8" and cfg.data.resize_method == "tf1"
        eng = QuantizedInceptionV3(tower, calib_images, epilogue="shift",
                                   stem_s2d="pre" if front == "s2d" else False,
                                   device=dev)
    elif engine == "bf16":
        eng = FusedInceptionV3(tower, dtype=torch.bfloat16, use_kernels=False,
                               device=dev)
        from_uint8 = False
    else:
        raise ValueError(f"unknown engine {engine!r}; expected int8|bf16|parity")

    if cfg.model == "joint":
        model = build_model(cfg, device=dev)
        model.load_state_dict(state)
        runner = joint_server(eng, model, device=dev, from_uint8=from_uint8,
                              image_size=size, **pp)
    else:
        img_server = image_server(eng, device=dev, from_uint8=from_uint8,
                                  image_size=size, **pp)

        def runner(image, tokens=None, lengths=None):
            return img_server(image)[0]

        runner.program = img_server.program
    runner.engine = eng  # the engine behind the runner (its scales, epilogue kinds)
    runner.device = dev
    return runner
