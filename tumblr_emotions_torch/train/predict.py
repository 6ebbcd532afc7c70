"""Single-post predict: one image and/or caption -> the 15-way emotion
distribution.

Port of ``tumblr_emotions_tpu/train/predict.py``.  The JPEG is decoded at
its full resolution on the host (the port's own decoder, bit for bit
libjpeg's), the exact eval preprocessing (central crop at native
resolution, then the TF1 bilinear resize to the model's size) runs on the
device, then the slim model ``models.build_model(cfg)`` builds, in the
config's precision mode (f32, or bf16 for ``precision_mode="perf"``):
the parity path, batch 1: the program ``ops.serving.build_forward(
engine="parity")`` serves, run eagerly.  Each post's image keeps its own
decoded size, so a CUDA graph per shape (the served runners' capture) would
rarely be replayed, and ``cli predict`` calls it once.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from tumblr_emotions_torch._device import resolve_device
from tumblr_emotions_torch.config import EMOTIONS, Config
from tumblr_emotions_torch.data import jpeg as jpeg_lib
from tumblr_emotions_torch.data.vocab import Vocabulary
from tumblr_emotions_torch.ops.serving import build_forward
from tumblr_emotions_torch.utils.compile_opts import capture


class Predictor:
    """Batch-1 emotion predictor over a joint, image or text model.

    ``state`` is the port's state dict of the model ``cfg`` describes (as
    ``build_forward`` takes it).  Runs on ``device`` (default ``"cuda"``,
    which raises without a card)."""

    def __init__(self, cfg: Config, state: Dict[str, torch.Tensor],
                 vocab: Optional[Vocabulary] = None,
                 emotions: Sequence[str] = EMOTIONS, device="cuda"):
        self.cfg = cfg
        self.vocab = vocab
        self.emotions = list(emotions)
        self.device = resolve_device(device)
        self.runner = build_forward(cfg, state, engine="parity", device=self.device)
        self.model = self.runner.model
        self.program = capture(self.runner.program.fn, options={"cuda_graph": "false"},
                               device=self.device)

    def predict(self, image_bytes: Optional[bytes] = None,
                text: Optional[str] = None) -> Dict[str, float]:
        """One post -> {emotion: probability}, sorted descending."""
        cfg = self.cfg
        raw = ids = lengths = None
        if cfg.model in ("image", "joint"):
            if image_bytes is None:
                raise ValueError(f"model {cfg.model!r} needs an image")
            raw = jpeg_lib.decode(image_bytes)[None]
        if cfg.model in ("text", "joint"):
            if text is None:
                raise ValueError(f"model {cfg.model!r} needs text")
            if self.vocab is None:
                raise ValueError("predictor needs a vocabulary for text")
            ids, length = self.vocab.encode(text, cfg.text.max_len)
            ids, lengths = ids[None], np.array([length], np.int32)
        probs = self.program(raw, ids, lengths)[0].float().cpu().numpy()
        order = np.argsort(-probs)
        return {self.emotions[i]: float(probs[i]) for i in order}
