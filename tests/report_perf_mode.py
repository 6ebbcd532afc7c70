"""Print how far the port's perf-mode (bf16) parity programs are from the
JAX package's, on the CPU, at the inputs of tests/test_torch_serving.py.

    python tests/report_perf_mode.py

Lines: the image model (``fused_inference``, depth 0.25, 139 px, seed-7
weights, uint8 ``[4,160,200,3]`` from seed 8) in perf mode against the
JAX program in perf mode; the port's f32 model against the same (the
fault before the repair); the port's bf16 model with its convs summed in
float64 against itself (the floor that f32 summation order sets); the
joint model in perf mode; the text models (mean, sum, rnn) in perf mode.
Each is the largest absolute difference in probability.
"""

import os
import sys
import types

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from tumblr_emotions_tpu import config as jconfig  # noqa: E402
from tumblr_emotions_tpu.ops import serving as jserving  # noqa: E402
from tumblr_emotions_tpu.train.trainer import build_model as jax_build_model  # noqa: E402
from tumblr_emotions_torch import config as tconfig  # noqa: E402
from tumblr_emotions_torch import convert  # noqa: E402
from tumblr_emotions_torch.data.vocab import synthetic_ids  # noqa: E402
from tumblr_emotions_torch.models import (build_model, inception_v3, joint_model,  # noqa: E402
                                          layers, text_model)
from tumblr_emotions_torch.ops.serving import build_forward  # noqa: E402

IMAGE = 139


def configs(preset, model=None, **text):
    out = []
    for mod in (jconfig, tconfig):
        c = mod.get_preset(preset)
        c = c.replace(image=c.image.replace(image_size=IMAGE, depth_multiplier=0.25),
                      text=c.text.replace(**text),
                      train=c.train.replace(precision_mode="perf"))
        out.append(c.replace(model=model or c.model))
    return out


def jax_probs(jcfg, state, image, tok):
    model, forward = jax_build_model(jcfg)
    run = jserving.build_forward(jcfg, types.SimpleNamespace(forward=forward, model=model),
                                 convert.to_variables(state), None, engine="parity")
    return np.asarray(run(None if image is None else jnp.asarray(image),
                          None if tok is None else jnp.asarray(tok), None))


def port_probs(cfg, state, image, tok, mode="perf"):
    cfg = cfg.replace(train=cfg.train.replace(precision_mode=mode))
    return build_forward(cfg, state, engine="parity", device="cpu")(image, tok).numpy()


def main():
    torch.set_num_threads(4)
    raw = np.random.RandomState(8).randint(0, 256, (4, 160, 200, 3), dtype=np.uint8)
    jcfg, cfg = configs("fused_inference")
    state = inception_v3.init_state(build_model(cfg, device="meta"), 7)
    want = jax_probs(jcfg, state, raw, None)
    perf = port_probs(cfg, state, raw, None)
    print(f"image, perf vs JAX perf: {np.abs(perf - want).max():.3g}")
    print(f"image, port f32 vs JAX perf: "
          f"{np.abs(port_probs(cfg, state, raw, None, 'parity') - want).max():.3g}")
    conv = layers.conv_f32_accumulate

    def conv64(x, w, strides=(1, 1), padding=(0, 0)):
        return layers.to_nhwc(F.conv2d(layers.to_nchw(x).double(), w.double(),
                                       stride=tuple(strides), padding=tuple(padding))).float()

    layers.conv_f32_accumulate = conv64
    try:
        floor = np.abs(port_probs(cfg, state, raw, None) - perf).max()
    finally:
        layers.conv_f32_accumulate = conv
    print(f"image, port perf with float64 convs vs port perf: {floor:.3g}")

    small = dict(vocab_size=200, embed_dim=16)
    jcfg, cfg = configs("fused_inference", model="joint", **small)
    state = joint_model.init_state(build_model(cfg, device="meta"), 7)
    tok = synthetic_ids(np.random.RandomState(9), 4, 12, 200)
    print(f"joint, perf vs JAX perf: "
          f"{np.abs(port_probs(cfg, state, raw, tok) - jax_probs(jcfg, state, raw, tok)).max():.3g}")

    for agg in ("mean", "sum", "rnn"):
        jcfg, cfg = configs("text_only", vocab_size=300, embed_dim=24, aggregator=agg,
                            rnn_hidden=16)
        state = text_model.init_state(build_model(cfg, device="meta"), 5)
        tok = synthetic_ids(np.random.RandomState(3), 6, 12, 300)
        diff = np.abs(port_probs(cfg, state, None, tok) - jax_probs(jcfg, state, None, tok))
        print(f"text {agg}, perf vs JAX perf: {diff.max():.3g}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    main()
