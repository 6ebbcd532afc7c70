"""Serving: uint8 image batches (and post text) -> emotion probabilities, on
one card or split over several.

Port of ``tumblr_emotions_tpu/ops/serving.py``:

- ``image_server`` is ``data_parallel_server`` on a single device
  (preprocess -> engine -> softmax); ``from_uint8=True`` serves the int8
  engine's all-int8 front (``QuantizedInceptionV3.forward_from_uint8``).
- ``joint_server`` is ``joint_data_parallel_server`` on a single device:
  the engine's image feature feeds ``DeepSentimentModel.fuse`` (text
  lookup, aggregator, concat fusion, joint softmax).
- ``data_parallel_server`` and ``joint_data_parallel_server`` serve one
  batch over a list of devices, as the reference's over its mesh's data
  axis (``P("data")``): the engine is built once (one int8 calibration, its
  scales shared) and copied to every device, each with its own captured
  program; a batch's rows are split into equal parts in device order, every
  device's part is launched before any is waited on, and the answers are
  concatenated on the first device.  A batch that does not divide over the
  devices is a ``ValueError``, as the reference's sharding refuses it.
- ``build_forward`` builds the served program of an image, text or joint
  model over ``devices``: the ``"int8"`` engine (the default, as in the
  reference: ``QuantizedInceptionV3`` with the shift epilogue behind the
  front ``front`` picks), the ``"bf16"`` BN-folded engine or the
  ``"parity"`` engine, the slim model in the config's precision mode (f32,
  or bf16 for ``cfg.train.precision_mode == "perf"``), on the first device
  only; a text model always runs that model.

The default served program is ``image_server(QuantizedInceptionV3(state,
calib, stem_s2d="pre"))``, the program the JAX package's ``bench.py``
measures; its convs and max pools run as hand-written kernels
(``ops/int8_conv.py``, ``ops/int8_pool.py``).  Every served program (the
preprocess, the engine, the text branch and the softmax) runs through
``utils.compile_opts.capture``, as the reference's runs through
``tpu_jit``: on the card, one CUDA graph per input signature, its inputs
copied into static buffers, so a batch is one launch per device.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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


def _on(dev: torch.device):
    """``dev`` as the current device (kernels launch on its streams)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


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
        with _on(dev):
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
    aggregator and the fusion head (summed in float64, ``exact=True``, so a
    row's answer does not depend on the batch's size).  ``lengths=None`` counts the non-pad ids.
    The whole program runs through ``capture`` (``serve.program``).
    """
    dev = resolve_device(device)
    front = _front(engine, dev, from_uint8, preprocess_dtype, image_size,
                   central_fraction, resize_method)

    def body(raw, tokens, lengths):
        _, feature = front(raw)
        return model.fuse(feature.float(), tokens, lengths, exact=True)[1]["Predictions"]

    program = capture(body, device=dev)

    def serve(images, tokens, lengths=None):
        with _on(dev):
            return program(_uint8_batch(images), tokens, lengths)

    serve.program = program
    return serve


def _device_list(devices) -> List[torch.device]:
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("serving needs at least one device")
    return devs


def _gather(parts: Sequence, dev: torch.device):
    """The per-device answers (tensors, or tuples of them) concatenated
    along the rows on ``dev``."""
    if isinstance(parts[0], tuple):
        return tuple(_gather([p[k] for p in parts], dev) for k in range(len(parts[0])))
    return torch.cat([p.to(dev) for p in parts])


def _data_parallel(servers: Sequence[Callable], devs: Sequence[torch.device]) -> Callable:
    """``serve(*inputs)``: each input's rows (inputs of None stay None) split
    into ``len(devs)`` equal parts in device order, part ``i`` served by
    ``servers[i]`` on ``devs[i]``; every part is launched before any is
    waited on, and the answers are concatenated on ``devs[0]``.  A numpy
    input is split into views: each device's program copies its own rows
    in.  One device serves the batch as it is.  ``serve.programs`` are the
    servers' captured programs, ``serve.program`` the first."""
    def serve(*inputs):
        rows = next(int(a.shape[0]) for a in inputs if a is not None)
        n = len(servers)
        if rows % n:
            raise ValueError(f"a batch of {rows} rows does not split over {n} devices: "
                             f"serve batches of a multiple of {n}")
        part = rows // n
        outs = []
        for i, (srv, dev) in enumerate(zip(servers, devs)):
            with _on(dev):
                outs.append(srv(*[None if a is None else a[i * part:(i + 1) * part]
                                  for a in inputs]))
        with _on(devs[0]):
            return _gather(outs, devs[0])

    if len(servers) == 1:
        serve = servers[0]
    serve.programs = [s.program for s in servers]
    serve.program = servers[0].program
    return serve


def data_parallel_server(engine, devices: Sequence, preprocess_dtype=torch.bfloat16,
                         from_uint8: bool = False, image_size: int = 299,
                         central_fraction: float = 0.875, resize_method: str = "tf1"
                         ) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """:func:`image_server` over ``devices`` (a list of devices, or of names):
    [B, H, W, 3] uint8 -> (probs [B, C] f32, feature [B, 2048] f32) on the
    first device, B a multiple of ``len(devices)``.  ``engine`` is built
    once and copied to each device (``engine.to``); ``serve.programs`` are
    the per-device captured programs (``serve.program`` the first)."""
    devs = _device_list(devices)
    servers = [image_server(engine.to(d), device=d, preprocess_dtype=preprocess_dtype,
                            from_uint8=from_uint8, image_size=image_size,
                            central_fraction=central_fraction, resize_method=resize_method)
               for d in devs]
    return _data_parallel(servers, devs)


def _model_on(model, dev: torch.device):
    """``model`` (an ``nn.Module``) on ``dev``: itself there, else a copy."""
    here = next(model.parameters()).device
    return model if here == dev else copy.deepcopy(model).to(dev)


def joint_data_parallel_server(engine, model, devices: Sequence,
                               preprocess_dtype=torch.bfloat16, from_uint8: bool = False,
                               image_size: int = 299, central_fraction: float = 0.875,
                               resize_method: str = "tf1") -> Callable[..., torch.Tensor]:
    """:func:`joint_server` over ``devices``: (raw_u8 [B,H,W,3], tokens
    [B,T], lengths [B] or None) -> probs [B, C] f32 on the first device,
    B a multiple of ``len(devices)``; the engine and the joint model
    (its text branch and fusion head) copied to each device."""
    devs = _device_list(devices)
    servers = [joint_server(engine.to(d), _model_on(model, d), device=d,
                            preprocess_dtype=preprocess_dtype, from_uint8=from_uint8,
                            image_size=image_size, central_fraction=central_fraction,
                            resize_method=resize_method) for d in devs]
    return _data_parallel(servers, devs)


def build_forward(cfg, state: Dict[str, torch.Tensor], engine: str = "int8",
                  device="cuda", calib_images=None, front: str = "s2d",
                  devices: Optional[Sequence] = None) -> Callable:
    """``runner(image_u8, tokens=None, lengths=None) -> probs [B, C]`` for the
    model ``cfg`` describes (image / text / joint) and its port state dict
    (the joint state holds the tower under ``InceptionV3.``).  Unused inputs
    may be None; ``lengths=None`` counts the non-pad ids.

    ``engine``: ``"int8"`` (quantized, shift epilogues; the default, as in
    the JAX package), ``"bf16"`` (BN-folded, cuDNN blocks, as the JAX
    package's ``build_forward`` builds it) or ``"parity"`` (the slim model
    ``models.build_model`` builds: f32 with TF32 off, or the bf16 model when
    ``cfg.train.precision_mode == "perf"``); a text model always runs that
    model.  ``devices`` (default ``[device]``): the int8 and bf16 engines
    serve each batch split over them (:func:`data_parallel_server`; B a
    multiple of their number); the parity engine and a text model run on
    the first, as in the reference.  Every runner carries its first device
    as ``runner.device`` and all of them as ``runner.devices``.  ``calib_images``
    (preprocessed f32 [N,H,W,3]) calibrates the int8 engine's activation
    scales.  ``front`` picks the int8 engine's preprocess: ``"s2d"``
    (default: the resize emits the 2x2 space-to-depth layout and the stem
    runs as the stride-1 K=12 conv), ``"uint8"`` (the all-int8 front: int8
    resize GEMMs, no float image; TF1 resize only, any other resize falls
    back to the float front, as in the reference) or ``"float"`` (normal
    layout, stride-2 stem).  The int8 and bf16 runners carry their engine
    as ``runner.engine`` (the first device's).  Every runner serves its
    program through ``utils.compile_opts.capture`` (one CUDA graph per input
    signature on the card, unless ``TET_TORCH_COMPILER_OPTIONS`` turns it
    off), as ``runner.program`` (its eager program is ``runner.program.fn``),
    one per device as ``runner.programs``; inputs may be tensors anywhere or
    numpy arrays.  A parity or text runner carries its
    slim model as ``runner.model``.
    """
    if front not in ("s2d", "uint8", "float"):
        raise ValueError(f"unknown front {front!r}; expected s2d|uint8|float")
    if cfg.model not in ("image", "text", "joint"):
        raise ValueError(f"unknown model type {cfg.model!r}; expected image|text|joint")
    devs = _device_list([device] if devices is None else devices)
    dev = devs[0]
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

        runner.device, runner.devices = dev, [dev]
        runner.program, runner.programs = program, [program]
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
        server = joint_data_parallel_server(eng, model, devs, from_uint8=from_uint8,
                                            image_size=size, **pp)

        def runner(image, tokens, lengths=None):
            return server(image, tokens, lengths)
    else:
        server = data_parallel_server(eng, devs, from_uint8=from_uint8, image_size=size,
                                      **pp)

        def runner(image, tokens=None, lengths=None):
            return server(image)[0]

    runner.program, runner.programs = server.program, server.programs
    runner.engine = eng  # the engine behind the runner (its scales, epilogue kinds)
    runner.device, runner.devices = dev, devs
    return runner
