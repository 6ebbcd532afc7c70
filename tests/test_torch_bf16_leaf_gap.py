"""The bf16 train step's gap on ``InceptionV3.Conv2d_2b_3x3.BatchNorm.beta``
is the JAX package's own: on the same weights and inputs, the JAX perf
step moves that leaf's first gradient as far from the JAX float32 step as
the port's perf step moves it from the port's float32 step.

That ``beta`` receives the sum, over the batch and every position, of the
loss's derivative before its ReLU; behind it a max pool and a 1x1 conv feed
a train-mode batch norm, which takes out those terms' mean, so the sum
nearly cancels (the float32 gradient's norm is a hundredth of the norm of
the terms' summed magnitudes, ``S``).  A bf16 step rounds every term, and
the sum moves by that rounding times the terms: next to the cancelled sum
the gap reads of the order of the sum itself, on the port and on the JAX
package alike, while against ``S`` both read a few times bf16's 2^-9.

Sizes: depth 0.25 at 139 px, 16 rows, dropout off, model-ready images (the
benchmark's smooth colour fields, ``benchmark/traffic.py``) and the
benchmark's seeded weights (``benchmark/weights.py``), so the inputs are
those the benchmark's cells feed, cut to size.  Measured on the CPU (seeds
1-4): S is 141-199 times the leaf's float32 norm; the f32 paths agree on
the leaf to 1.2e-4-2.3e-4 of S; the bf16 steps lie 0.0067-0.0089 (port)
and 0.0048-0.0088 (JAX) of S from their f32 steps, which is 1.24-1.33
(port) and 0.96-1.27 (JAX) of the leaf's own norm.  At full width and 128
rows on an H100 the worst leaves read 0.2-0.7 on their own norms and a few
thousandths on their terms' (PERF.md, the data-parallel cell).
"""

import functools
import sys
from pathlib import Path

import flax
import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark import traffic, weights  # noqa: E402
from benchmark.reference import preprocess as ref_pre  # noqa: E402
from tumblr_emotions_torch import config as tconfig  # noqa: E402
from tumblr_emotions_torch import convert  # noqa: E402
from tumblr_emotions_torch.models import layers  # noqa: E402
from tumblr_emotions_torch.train.trainer import Trainer  # noqa: E402
from tumblr_emotions_tpu import config as jconfig  # noqa: E402
from tumblr_emotions_tpu.parallel import mesh as mesh_lib  # noqa: E402
from tumblr_emotions_tpu.train import trainer as jtrainer  # noqa: E402

LEAF = "InceptionV3.Conv2d_2b_3x3.BatchNorm.beta"
LAYER = "InceptionV3.Conv2d_2b_3x3"
DEPTH, SIZE, ROWS, SEEDS = 0.25, 139, 16, (1, 2, 3, 4)
CAPTIONS = {"max_len": 50, "median_len": 12, "sigma": 0.8, "zipf_s": 1.0, "vocab_size": 50000,
            "reserved_ids": 2}


def _cfg(package, precision):
    cfg = package.get_preset("data_parallel")
    return cfg.replace(image=cfg.image.replace(depth_multiplier=DEPTH, image_size=SIZE,
                                               dropout_keep_prob=1.0),
                       train=cfg.train.replace(precision_mode=precision, batch_size=ROWS))


def _inputs(seed):
    sizes = dict(image_size=SIZE, depth_multiplier=DEPTH, num_classes=15, vocab_size=50000,
                 embed_dim=200)
    state = weights.make(seed, torch.device("cpu"), **sizes)
    p = dict(batch=ROWS, pool_batches=1, image_hw=[160, 160], captions=CAPTIONS,
             num_classes=15)
    b = traffic.pool(seed, p, torch.device("cpu"))[0]
    batch = {"image": ref_pre.eval_images(torch.from_numpy(b["image"]), SIZE),
             "tokens": torch.from_numpy(b["tokens"]), "lengths": torch.from_numpy(b["lengths"]),
             "label": torch.from_numpy(b["label"])}
    return state, batch


class _Terms(torch.autograd.Function):
    """The identity before Conv2d_2b's ReLU; its backward keeps the sum of
    the incoming terms' magnitudes per channel."""

    @staticmethod
    def forward(ctx, y, into):
        ctx.into = into
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        ctx.into.append(g.detach().double().abs().sum((0, 1, 2)))
        return g, None


def _port(precision, state, batch):
    """The leaf's first gradient and, in f32, its terms' summed magnitudes."""
    tr = Trainer(_cfg(tconfig, precision), device="cpu")
    ts = tr.init_state(state)
    terms = []
    real = layers.ConvBN.forward

    def forward(self, x):
        if self is not layer:
            return real(self, x)
        y = _Terms.apply(self.unrounded(x), terms).to(self.dtype)
        return torch.relu(y)

    layer = dict(tr.model.named_modules())[LAYER]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers.ConvBN, "forward", forward)
        _, _, grads = tr.loss_and_grads(ts, tr._to_device(batch))
    return grads[LEAF].double().numpy(), float(terms[0].norm())


@functools.lru_cache(maxsize=None)
def _jax_grad_fn(precision):
    jcfg = _cfg(jconfig, precision)
    mesh = mesh_lib.create_mesh(jconfig.MeshConfig(data=1), devices=jax.devices()[:1])
    jtr = jtrainer.Trainer(jcfg, mesh=mesh, preprocess=None)
    return jax.jit(jax.grad(lambda p, stats, b: jtr._loss_fn(p, stats, b, jax.random.PRNGKey(0),
                                                             True)[0]))


def _jax(precision, state, batch):
    v = convert.to_variables(state)
    g = _jax_grad_fn(precision)(v["params"], v["batch_stats"],
                                {k: np.asarray(t) for k, t in batch.items()})
    flat = {".".join(k): x for k, x in flax.traverse_util.flatten_dict(jax.device_get(g)).items()}
    (key,) = [k for k in flat if "Conv2d_2b_3x3" in k and k.endswith("beta")]
    return np.asarray(flat[key], np.float64)


@functools.lru_cache(maxsize=None)
def _case(seed):
    torch.set_num_threads(2)
    state, batch = _inputs(seed)
    pf, s = _port("parity", state, batch)
    pb, _ = _port("perf", state, batch)
    return {"port_f32": pf, "port_bf16": pb, "jax_f32": _jax("parity", state, batch),
            "jax_bf16": _jax("perf", state, batch), "S": s}


def _n(a):
    return float(np.linalg.norm(a))


def test_the_float32_paths_agree_on_the_leaf():
    for seed in SEEDS:
        c = _case(seed)
        assert _n(c["port_f32"] - c["jax_f32"]) <= 1e-3 * c["S"], seed


def test_both_bf16_steps_move_the_leaf_by_rounding_of_its_terms():
    """Against S, each package's bf16 step lies a few times 2^-9 from its
    own float32 step, and the two packages by about as much."""
    port, jax_ = [], []
    for seed in SEEDS:
        c = _case(seed)
        port.append(_n(c["port_bf16"] - c["port_f32"]) / c["S"])
        jax_.append(_n(c["jax_bf16"] - c["jax_f32"]) / c["S"])
    assert all(2.0 ** -11 < d < 2.0 ** -5 for d in port + jax_), (port, jax_)
    assert 0.5 < np.mean(jax_) / np.mean(port) < 2.0, (port, jax_)


def test_on_the_leafs_own_norm_the_gap_shows_in_both_packages():
    """Against the leaf's float32 norm the same rounding reads as a gap of
    the order of the gradient itself, in the JAX package as in the port."""
    for seed in SEEDS:
        c = _case(seed)
        port = _n(c["port_bf16"] - c["port_f32"]) / _n(c["port_f32"])
        jax_ = _n(c["jax_bf16"] - c["jax_f32"]) / _n(c["jax_f32"])
        assert c["S"] > 50 * _n(c["port_f32"]), seed
        assert port > 0.5 and jax_ > 0.5, (seed, port, jax_)
