"""The port's trainer against the JAX package's on the CPU: train-mode
layers, two train steps of every model and optimizer, evaluation, the L2
leaf set and the optimizer-state bridge.

Weights are made by the port (``init_state``) and carried to JAX with
``convert.to_variables``; each JAX train step runs jitted, once per model,
in a module-scoped fixture.  Sizes are small: depth 0.25 at 139 px with
the aux head, vocabulary 64.
"""

import dataclasses
import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_preprocessing import jax_train_draws
from tumblr_emotions_tpu import config as jconfig
from tumblr_emotions_tpu.models.layers import ConvBN as JaxConvBN
from tumblr_emotions_tpu.parallel import mesh as mesh_lib
from tumblr_emotions_tpu.train import trainer as jtrainer
from tumblr_emotions_tpu.utils import metrics as jmetrics
from tumblr_emotions_torch import config as tconfig
from tumblr_emotions_torch import convert
from tumblr_emotions_torch.models import build_model, inception_v3, joint_model, text_model
from tumblr_emotions_torch.models.layers import ConvBN, Dropout
from tumblr_emotions_torch.train import optim
from tumblr_emotions_torch.train import trainer as ttrainer
from tumblr_emotions_torch.utils import metrics as tmetrics

torch.set_num_threads(2)

B, HW, SRC = 4, 139, (160, 170)
V, D, T = 64, 16, 8
# Two train steps of the port against two jitted JAX steps.  The text
# models and image_frozen (the tower frozen) are well conditioned: per leaf,
# max|p_port - p_jax| within UPDATE_TOL of the update's own max|p_jax -
# p_init| (the optimizer's moments against their own max), plus ATOL.
# Measured: text 2e-6 to 7e-6, image_frozen 2.1e-4 (parameters) and 5.0e-4
# (BN statistics).
UPDATE_TOL = 1e-3
ATOL = 1e-7
# Training the whole tower is not: train-mode batch norm over 4 images
# centres activations whose mean is large against their spread, so f32
# rounding grows through the tower and a step's gradients move by ~1% (up
# to 20% on a leaf) when the inputs move by 1e-7 (eval-mode gradients agree
# with JAX to 2e-6, test_backward_matches_jax_grad).  There the f32 noise
# floor is measured: the port is run again from weights (and statistics)
# moved by NOISE_EPS of themselves, once per seed of NOISE_SEEDS, and the
# distance of the port's update to JAX's, ||(got - init) - (want - init)|| /
# ||want - init|| over all leaves, must be within NOISE_FACTOR of the mean
# distance of those runs' updates to the port's.  The joint case's JAX
# inputs also carry the jitted preprocessing's drift from its own op-by-op
# run (2.3e-6 RMS, 2.9e-5 at most: test_torch_train_preprocessing.JIT_TOL),
# so its noise runs also move each image's brightness delta by NOISE_INPUT
# (times N(0, 1)), that drift's RMS.  Measured, parameters: image 0.34 to
# JAX against floors of 0.23-0.37, joint 0.084 against 0.096-0.106 (0.017-
# 0.036 without the input move); BN statistics: image 0.016 against
# 0.006-0.018, joint 2.1e-4 against 2.5e-4-2.9e-4.
NOISE_FACTOR = 3.0
NOISE_EPS = 1e-7
NOISE_INPUT = 2.3e-6
NOISE_SEEDS = (1, 2, 3)
# The first step's loss is a forward pass: f32 summation order, measured
# 1e-6, and 1.6e-5 for the joint case (its JAX inputs carry the jitted
# preprocessing's drift).
LOSS_RTOL = 1e-4


def _cfgs(preset, model=None, image=None, text=None, train=None):
    """The same configuration in both packages."""
    image = {"image_size": HW, "depth_multiplier": 0.25, "dropout_keep_prob": 1.0,
             **(image or {})}
    text = {"vocab_size": V, "embed_dim": D, "max_len": T, **(text or {})}
    train = {"batch_size": B, **(train or {})}
    out = []
    for c in (jconfig, tconfig):
        cfg = c.get_preset(preset)
        cfg = cfg.replace(image=cfg.image.replace(**image), text=cfg.text.replace(**text),
                          train=cfg.train.replace(**train))
        out.append(cfg.replace(model=model) if model else cfg)
    return out


CASES = {
    # RMSProp (eps 1.0 inside the root, momentum after the lr) with the
    # staircase moving every step; the whole tower trains.
    "image": dict(preset="image_frozen", model="image", noisy=True,
                  train=dict(trainable_scopes="", lr_decay_steps=1)),
    # joint_finetune (RMSProp) with the train distortions and global-norm
    # clipping.
    "joint": dict(preset="joint_finetune", train=dict(grad_clip_norm=1.0),
                  preprocess="train", noisy=True),
    "text_mean": dict(preset="text_only"),                                     # Adam
    "text_rnn": dict(preset="text_only", text=dict(aggregator="rnn", rnn_hidden=12),
                     train=dict(optimizer="sgd", momentum=0.9, learning_rate=0.1)),
    # Logits and AuxLogits trainable, the tower frozen in train mode.
    "image_frozen": dict(preset="image_frozen", train=dict(learning_rate=1e-2)),
}


def _init(tcfg, seed=0):
    model = build_model(tcfg, device="meta")
    return {"image": inception_v3.init_state, "joint": joint_model.init_state,
            "text": text_model.init_state}[tcfg.model](model, seed)


def _batches(tcfg, preprocess, n=2, seed=1):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        b = {"tokens": rng.randint(0, V, (B, T)).astype(np.int32),
             "lengths": np.array([T, 3, 0, 5], np.int32),
             "label": rng.randint(0, 15, B).astype(np.int32)}
        if tcfg.model != "text":
            b["image"] = (rng.randint(0, 256, (B, *SRC, 3)).astype(np.uint8) if preprocess
                          else rng.uniform(-1, 1, (B, HW, HW, 3)).astype(np.float32))
        out.append(b)
    return out


def _jax_trainer(jcfg, preprocess):
    mesh = mesh_lib.create_mesh(jconfig.MeshConfig(data=1), devices=jax.devices()[:1])
    return jtrainer.Trainer(jcfg, mesh=mesh, preprocess=preprocess)


def _port_steps(tcfg, preprocess, state, batches, draws):
    tr = ttrainer.Trainer(tcfg, preprocess=preprocess, device="cpu")
    ts = tr.init_state(state)
    metrics = []
    for b, d in zip(batches, draws):
        ts, m = tr.train_step(ts, b, draws=d)
        metrics.append({k: v.item() for k, v in m.items()})
    return tr, ts, metrics


@functools.lru_cache(maxsize=None)
def run_case(name):
    """Two train steps of the port and of the JAX trainer on the same
    weights, batches and distortion draws (and, for a noisy case, the port
    again from weights moved by NOISE_EPS)."""
    case = CASES[name]
    jcfg, tcfg = _cfgs(case["preset"], case.get("model"), case.get("image"), case.get("text"),
                       case.get("train"))
    preprocess = case.get("preprocess")
    state = _init(tcfg)
    batches = _batches(tcfg, preprocess)
    jtr = _jax_trainer(jcfg, preprocess)
    js = jtr.init_state(jax.random.PRNGKey(0), batches[0],
                        initial_variables=convert.to_variables(state))
    j_init = jax.device_get(js)
    step = jax.jit(jtr.train_step)
    rng = jax.random.PRNGKey(3)
    j_metrics, draws = [], []
    for b in batches:
        rng_pp, _ = jax.random.split(jax.random.fold_in(rng, js.step))
        draws.append(jax_train_draws(rng_pp, B, SRC) if preprocess else None)
        js, m = step(js, b, rng)
        j_metrics.append(jax.device_get(m))
    tr, ts, t_metrics = _port_steps(tcfg, preprocess, state, batches, draws)
    noise = None
    if case.get("noisy"):
        noise = []
        for seed in NOISE_SEEDS:
            g = torch.Generator().manual_seed(seed)
            moved = {k: v * (1 + NOISE_EPS * torch.randn(v.shape, generator=g))
                     for k, v in state.items()}
            nd = [d if d is None else dataclasses.replace(
                d, delta=d.delta + NOISE_INPUT * torch.randn(B, generator=g)) for d in draws]
            noise.append((moved, _port_steps(tcfg, preprocess, moved, batches, nd)[1]))
    return dict(jcfg=jcfg, tcfg=tcfg, jtr=jtr, tr=tr, j_init=j_init, js=jax.device_get(js),
                ts=ts, noise=noise, j_metrics=j_metrics, t_metrics=t_metrics,
                batches=batches)


def _flat(tree):
    return {".".join(k): np.asarray(v)
            for k, v in flax.traverse_util.flatten_dict(tree).items()}


def _close_to_update(got, want, before, what):
    """max|got - want| <= UPDATE_TOL * max|want - before| + ATOL."""
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want - before).max())
    assert err <= UPDATE_TOL * scale + ATOL, (what, err, scale)
    return err / max(scale, 1e-30)


def _distance(a, a0, b, b0, keys):
    """||(a - a0) - (b - b0)|| / ||b - b0|| over ``keys`` (dicts of arrays):
    how far update a is from update b."""
    def cat(d):
        return np.concatenate([np.ravel(d[k]).astype(np.float64) for k in keys])

    da, db = cat(a) - cat(a0), cat(b) - cat(b0)
    return float(np.linalg.norm(da - db) / np.linalg.norm(db))


def _compare(got, want, before, noise):
    """got, want, before: dicts of arrays with the same keys; noise: None
    for a well-conditioned case, else [(init, final)] of the noise runs."""
    assert sorted(got) == sorted(want)
    keys = sorted(want)
    if noise is None:
        for k in keys:
            _close_to_update(got[k], want[k], before[k], k)
        return
    to_jax = _distance(got, before, want, before, keys)
    floor = np.mean([_distance(n, n0, got, before, keys) for n0, n in noise])
    assert to_jax <= NOISE_FACTOR * floor + 1e-6, (to_jax, floor)


@pytest.mark.parametrize("name", list(CASES))
def test_train_steps_loss_and_accuracy_match_jax(name):
    r = run_case(name)
    (j1, j2), (t1, t2) = r["j_metrics"], r["t_metrics"]
    np.testing.assert_allclose(t1["loss"], j1["loss"], rtol=LOSS_RTOL)
    assert t1["accuracy"] == pytest.approx(float(j1["accuracy"]), abs=1e-6)
    # the second step's loss reads the first update (see NOISE_FACTOR)
    np.testing.assert_allclose(t2["loss"], j2["loss"],
                               rtol=5e-2 if CASES[name].get("noisy") else LOSS_RTOL)


def _noise_vars(r, collection):
    """[(init, final)] of the noise runs as flat arrays of ``collection``."""
    if r["noise"] is None:
        return None
    return [tuple(_flat(convert.to_variables(s)[collection]) for s in (moved, ts.state))
            for moved, ts in r["noise"]]


@pytest.mark.parametrize("name", list(CASES))
def test_train_steps_parameters_match_jax(name):
    r = run_case(name)
    got = _flat(convert.to_variables(r["ts"].state)["params"])
    want, before = _flat(r["js"].params), _flat(r["j_init"].params)
    scopes = ttrainer.parse_scopes(r["tcfg"].train.trainable_scopes)
    frozen = [k for k in want if scopes and not ttrainer.path_in_scopes(k, scopes)]
    for k in frozen:
        # no update at all in the port (JAX adds a zero update)
        np.testing.assert_array_equal(got.pop(k), before[k])
        np.testing.assert_array_equal(want.pop(k), before[k])
    _compare(got, want, before, _noise_vars(r, "params"))


@pytest.mark.parametrize("name", ["image", "joint", "image_frozen"])
def test_train_steps_batch_norm_statistics_match_jax(name):
    r = run_case(name)
    got = _flat(convert.to_variables(r["ts"].state)["batch_stats"])
    want, before = _flat(r["js"].batch_stats), _flat(r["j_init"].batch_stats)
    assert len(want) > 100
    for k in want:
        assert np.abs(want[k] - before[k]).max() > 0, k   # the frozen tower's move too
    _compare(got, want, before, _noise_vars(r, "batch_stats"))


@pytest.mark.parametrize("name", list(CASES))
def test_train_steps_optimizer_state_matches_jax(name):
    r = run_case(name)
    want = r["js"].opt_state

    def leaves(opt_state):
        tree = convert.opt_state_to_optax(opt_state, want)
        assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(want)
        return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]

    names = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    w = dict(zip(names, (np.asarray(x) for x in jax.tree_util.tree_leaves(want))))
    g = dict(zip(names, leaves(r["ts"].opt_state)))
    for k in [k for k in w if w[k].dtype.kind == "i"]:
        assert g[k].dtype == w[k].dtype and int(g.pop(k)) == int(w.pop(k)) == 2, k
    zeros = {k: np.zeros_like(v) for k, v in w.items()}
    noise = None if r["noise"] is None else [
        (zeros, {k: v for k, v in zip(names, leaves(ts.opt_state)) if k in w})
        for _, ts in r["noise"]]
    _compare(g, w, zeros, noise)


@pytest.mark.parametrize("name", ["image", "joint"])
def test_backward_matches_jax_grad(name):
    """The tower's backward without batch coupling: the gradient of the
    eval-mode loss (moving statistics, no aux term) against jax.grad of the
    reference's.  Per leaf, max|g_port - g_jax| / max|g_jax| has a median
    within 1e-5 (measured 5e-7 to 7e-7); a ReLU input within rounding of 0
    may flip its unit's gradient on a leaf (measured up to 1.4% on one
    leaf), so over all leaves together ||g_port - g_jax|| / ||g_jax|| is
    held within 1e-2 (measured 1.1e-3, and 1.7e-6 on other inputs)."""
    r = run_case(name)
    jtr, tr, tcfg = r["jtr"], r["tr"], r["tcfg"]
    b = _batches(tcfg, None, n=1, seed=4)[0]
    v = convert.to_variables(_init(tcfg))
    want = _flat(jax.device_get(jax.jit(jax.grad(
        lambda p: jtr._loss_fn(p, v["batch_stats"], b, None, False)[0]))(v["params"])))
    ts = tr.init_state(_init(tcfg))
    tr.model.eval()
    bt = tr._to_device(b)
    with ttrainer.full_f32():
        logits, _ = torch.func.functional_call(tr.model, ts.state, tr._model_args(bt))
        loss = (ttrainer.cross_entropy(logits, bt["label"])
                + ttrainer.l2_regularization(ts.state, tcfg.train.weight_decay))
        keys = tr.param_keys
        grads = torch.autograd.grad(loss, [ts.state[k] for k in keys], allow_unused=True)
    got = _flat(convert.to_variables({k: torch.zeros_like(ts.state[k]) if g is None else g
                                      for k, g in zip(keys, grads)})["params"])
    keys = sorted(want)
    per_leaf = [np.abs(got[k] - want[k]).max() / max(np.abs(want[k]).max(), 1e-30) for k in keys]
    assert np.median(per_leaf) <= 1e-5, np.median(per_leaf)
    g, w = (np.concatenate([d[k].ravel() for k in keys]) for d in (got, want))
    assert np.linalg.norm(g - w) <= 1e-2 * np.linalg.norm(w)


@pytest.mark.parametrize("optimizer,extra", [
    ("rmsprop", dict(lr_decay_steps=2, grad_clip_norm=0.5)),   # clip triggers
    ("rmsprop", dict(momentum=0.0, grad_clip_norm=100.0)),     # clip does not
    ("adam", dict(lr_decay_steps=1)),
    ("sgd", dict(momentum=0.9)),
    ("sgd", dict(momentum=0.0)),
    ("rmsprop", dict(trainable_scopes="Logits", grad_clip_norm=0.5)),
])
def test_optimizer_matches_optax(optimizer, extra):
    """Three updates of the port's optimizer and of the reference's optax
    transform from the same gradients: parameters and state within 1e-6
    (f32 rounding; the same operations in the same order)."""
    jcfg, tcfg = _cfgs("joint_finetune", train=dict(optimizer=optimizer, learning_rate=0.05,
                                                    **extra))
    rng = np.random.RandomState(0)
    tree = {"Conv2d_1a_3x3": {"weights": rng.normal(size=(3, 3, 2, 4))},
            "Logits/Conv2d_1c_1x1": {"biases": rng.normal(size=(5,))},
            "JointLogits": {"kernel": rng.normal(size=(6, 5))}}
    tree = jax.tree_util.tree_map(lambda a: a.astype(np.float32), tree)
    tx = jtrainer.make_optimizer(jcfg, tree)
    jstate, jparams = tx.init(tree), tree
    scopes = ttrainer.parse_scopes(tcfg.train.trainable_scopes)
    params = {k: v for k, v in convert.to_state({"params": tree}).items()
              if not scopes or ttrainer.path_in_scopes(k, scopes)}
    opt = optim.Optimizer(tcfg.train)
    state = opt.init(params)
    for i in range(3):
        grads = jax.tree_util.tree_map(
            lambda a: (rng.normal(size=a.shape) * 3).astype(np.float32), tree)
        upd, jstate = tx.update(grads, jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, upd)
        g = convert.to_state({"params": grads})
        opt.update(params, {k: g[k] for k in params}, state)
    want = _flat(jax.device_get(jparams))
    for k, p in convert.to_variables(params)["params"].items():
        for leaf, v in p.items():
            np.testing.assert_allclose(v, want[f"{k}.{leaf}"], rtol=1e-6, atol=1e-7)
    back = convert.opt_state_to_optax(state, jstate)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_rmsprop_is_not_torch_rmsprop():
    """eps inside the root and momentum after the lr: one step differs from
    torch.optim.RMSprop with the same settings."""
    t = tconfig.TrainConfig(learning_rate=0.1, rmsprop_epsilon=1.0)
    p = {"w": torch.tensor([1.0, -2.0])}
    g = {"w": torch.tensor([0.5, 3.0])}
    opt = optim.Optimizer(t)
    opt.update(p, g, opt.init(p))
    nu = 0.1 * g["w"] ** 2
    want = torch.tensor([1.0, -2.0]) - 0.1 * g["w"] / torch.sqrt(nu + 1.0)
    torch.testing.assert_close(p["w"], want)
    w2 = torch.nn.Parameter(torch.tensor([1.0, -2.0]))
    w2.grad = g["w"].clone()
    torch.optim.RMSprop([w2], lr=0.1, alpha=0.9, eps=1.0, momentum=0.9).step()
    assert not torch.allclose(w2.detach(), p["w"])


@pytest.mark.parametrize("steps,count", [(0, 0), (1, 1), (5, 2), (100, 7)])
def test_learning_rate_schedule_matches_optax(steps, count):
    jcfg, tcfg = _cfgs("joint_finetune", train=dict(lr_decay_steps=steps, lr_decay_factor=0.9))
    want = float(np.float32(jtrainer._lr_schedule(jcfg)(count)))
    assert optim.learning_rate(tcfg.train, count) == want


# ---------------------------------------------------------------------------
# Train-mode layers against flax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel,cin,cout", [((3, 3), 5, 8), ((1, 7), 8, 6)])
def test_train_mode_conv_bn_matches_flax(kernel, cin, cout):
    """Outputs, and the BN statistics after the update, against flax with
    ``mutable=["batch_stats"]``; the momentum set to 0.9 so one update
    moves the statistics well above f32 rounding."""
    rng = np.random.RandomState(0)
    x = rng.normal(0.5, 2.0, (3, 9, 11, cin)).astype(np.float32)
    port = ConvBN(cin, cout, kernel, padding="SAME", bn_momentum=0.9, device="cpu")
    state = {"weights": rng.normal(0, 0.3, (cout, cin, *kernel)).astype(np.float32),
             "BatchNorm.beta": rng.normal(0, 0.1, cout).astype(np.float32),
             "BatchNorm.moving_mean": rng.normal(0, 0.1, cout).astype(np.float32),
             "BatchNorm.moving_variance": rng.uniform(0.5, 1.5, cout).astype(np.float32)}
    state = {k: torch.from_numpy(v) for k, v in state.items()}
    port.load_state_dict(state)
    port.train()
    got = port(torch.from_numpy(x))
    flax_bn = JaxConvBN(features=cout, kernel=kernel, bn_momentum=0.9, precision="highest")
    want, upd = flax_bn.apply(convert.to_variables(state), x, train=True,
                              mutable=["batch_stats"])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)
    for s in ("moving_mean", "moving_variance"):
        np.testing.assert_allclose(getattr(port.BatchNorm, s).numpy(),
                                   np.asarray(upd["batch_stats"]["BatchNorm"][s]),
                                   atol=1e-6, rtol=1e-6)
    # the biased variance over N, H, W, not torch's unbiased one
    y = torch.nn.functional.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), state["weights"],
                                   padding="same")
    var = y.var(dim=(0, 2, 3), unbiased=False)
    want_var = 0.9 * state["BatchNorm.moving_variance"] + 0.1 * var
    torch.testing.assert_close(port.BatchNorm.moving_variance, want_var, rtol=1e-5, atol=1e-6)


def test_train_mode_batch_norm_gradient_flows_through_batch_statistics():
    """The gradient of a train-mode conv+BN against jax.grad of flax's."""
    rng = np.random.RandomState(1)
    x = rng.normal(0, 1, (2, 6, 6, 4)).astype(np.float32)
    state = {"weights": rng.normal(0, 0.3, (5, 4, 3, 3)).astype(np.float32),
             "BatchNorm.beta": np.zeros(5, np.float32),
             "BatchNorm.moving_mean": np.zeros(5, np.float32),
             "BatchNorm.moving_variance": np.ones(5, np.float32)}
    state = {k: torch.from_numpy(v) for k, v in state.items()}
    port = ConvBN(4, 5, (3, 3), padding="SAME", device="cpu")
    port.load_state_dict(state)
    port.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    (port(xt) ** 3).sum().backward()
    v = convert.to_variables(state)
    flax_bn = JaxConvBN(features=5, kernel=(3, 3), precision="highest")
    gx = jax.grad(lambda x: (flax_bn.apply(v, x, train=True, mutable=["batch_stats"])[0]
                             ** 3).sum())(x)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("window,hw", [((3, 3), 9), ((3, 3), 4), ((1, 1), 5), ((5, 3), 7)])
def test_same_avg_pool_backward_is_the_adjoint(window, hw):
    """The SAME average pool's hand-written backward against autograd of
    F.avg_pool2d on a contiguous NCHW tensor (whose CPU backward is right),
    on a channels-last view as the tower feeds it; the forward unchanged."""
    from tumblr_emotions_torch.models.layers import avg_pool, to_nchw, to_nhwc

    x = torch.rand(2, hw, hw + 1, 6, dtype=torch.float64, requires_grad=True)
    g = torch.rand(2, hw, hw + 1, 6, dtype=torch.float64)
    got = avg_pool(x, window, (1, 1))
    (gx,) = torch.autograd.grad(got, x, g)
    pad = (window[0] // 2, window[1] // 2)
    want = to_nhwc(torch.nn.functional.avg_pool2d(to_nchw(x).contiguous(), window, 1,
                                                  padding=pad, count_include_pad=False))
    (wx,) = torch.autograd.grad(want, x, g)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(gx, wx, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("keep", [0.8, 0.5])
def test_dropout_keeps_a_binomial_share_scaled_by_keep(keep):
    """flax semantics: every element is 0 or x/keep (as the reference's
    jitted step computes it, x times the f32 reciprocal of keep); the kept
    share of n elements lies within 5 binomial standard deviations of
    keep."""
    n = 200_000
    x = torch.rand(n) + 0.5
    drop = Dropout(keep)
    drop.train()
    y = drop(x, torch.Generator().manual_seed(0))
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] * float(np.float32(1) / np.float32(keep)),
                               rtol=0, atol=0)
    share = kept.float().mean().item()
    assert abs(share - keep) <= 5 * np.sqrt(keep * (1 - keep) / n), share
    drop.eval()
    assert drop(x) is x
    drop.train()
    assert Dropout(1.0).train()(x) is x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_is_flax_dropout_jitted_bit_for_bit(dtype, monkeypatch):
    """On one draw, the port's Dropout in f32 and in bf16 (perf mode) is
    bit-equal to flax's ``nn.Dropout`` run jitted by the JAX package (the
    reference's train step is jitted: XLA multiplies by the reciprocal)."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    keep = 0.8

    class Drop(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.Dropout(rate=1.0 - keep, deterministic=False)(x)

    rng = np.random.RandomState(3)
    x = (rng.normal(size=(16, 1, 1, 512)) * 4).astype(np.float32)
    x[x == 0] = 1.0
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = np.asarray(jax.jit(lambda v: Drop().apply({}, v, rngs={"dropout": jax.random.PRNGKey(5)}))(
        jx).astype(jnp.float32))
    kept = want != 0
    assert 0.7 < kept.mean() < 0.9
    u = torch.from_numpy(np.where(kept, 0.25, 0.95).astype(np.float32))
    monkeypatch.setattr(torch, "rand", lambda *a, **k: u)
    drop = Dropout(keep).train()
    got = drop(torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_joint_model_dropout_acts_before_the_fused_feature():
    """In train mode the joint model fuses the dropped-out PreLogits; the
    same generator gives the same mask."""
    _, tcfg = _cfgs("joint_finetune", image=dict(dropout_keep_prob=0.5, image_size=75,
                                                 create_aux_logits=False))
    model = build_model(tcfg, device="cpu")
    model.load_state_dict(_init(tcfg))
    model.train()
    x = torch.rand(2, 75, 75, 3) * 2 - 1
    ids = torch.randint(0, V, (2, T))
    _, ep = model(x, ids, generator=torch.Generator().manual_seed(1))
    _, ep2 = model(x, ids, generator=torch.Generator().manual_seed(1))
    img = ep["ImageFeature"]
    assert (img == 0).any() and torch.equal(img, ep2["ImageFeature"])
    torch.testing.assert_close(ep["Fused"][:, :img.shape[1]], img, rtol=0, atol=0)


def test_bf16_models_refuse_train_mode():
    """The bf16 (perf) models used to refuse train mode; they train now: a
    train-mode forward gives the logits unrounded (f32, as the reference's
    loss reads them; bf16 in eval mode), every trainable leaf gets a finite
    f32 gradient, and a perf Trainer step moves the parameters."""
    _, tcfg = _cfgs("fused_inference", image=dict(image_size=75, create_aux_logits=False))
    model = build_model(tcfg, device="cpu")
    state = _init(tcfg)
    model.load_state_dict(state)
    x = torch.rand(2, 75, 75, 3) * 2 - 1
    with torch.no_grad():
        assert model(x)[0].dtype == torch.bfloat16
    model.train()
    logits, _ = model(x)
    assert logits.dtype == torch.float32 and logits.requires_grad
    grads = torch.autograd.grad(logits.float().square().sum(), list(model.parameters()),
                                allow_unused=True)
    used = [g for g in grads if g is not None]
    assert len(used) > 50 and all(g.dtype == torch.float32 and torch.isfinite(g).all()
                                  for g in used)
    tr = ttrainer.Trainer(tcfg, device="cpu")
    ts = tr.init_state(state)
    ts, m = tr.train_step(ts, {"image": np.zeros((2, 75, 75, 3), np.float32),
                               "label": np.array([1, 2], np.int32)})
    assert np.isfinite(m["loss"].item())
    assert any(not torch.equal(ts.state[k].detach(), state[k]) for k in tr.param_keys)


# ---------------------------------------------------------------------------
# Evaluation, metrics, L2, the optimizer-state bridge, the device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["image", "joint"])
def test_evaluate_matches_jax_on_a_padded_last_batch(name):
    r = run_case(name)
    tcfg, preprocess = r["tcfg"], CASES[name].get("preprocess")
    jtr = _jax_trainer(r["jcfg"], preprocess)
    tr = ttrainer.Trainer(tcfg, preprocess=preprocess, device="cpu")
    batches = _batches(tcfg, preprocess, n=3, seed=5)
    batches[-1]["weight"] = np.array([1, 1, 0, 0], np.int32)
    # Both evaluate the JAX run's trained weights.
    js = r["js"]
    jstate = jtrainer.TrainState(step=jnp.asarray(2), params=js.params,
                                 batch_stats=js.batch_stats, opt_state=js.opt_state)
    jtr.compile()
    want = jtr.evaluate(jstate, batches)
    got = tr.evaluate(tr.init_state(convert.to_state(
        {"params": js.params, "batch_stats": js.batch_stats})), batches)
    assert got["count"] == want["count"] == 2 * B + 2
    assert got["accuracy"] == want["accuracy"]
    np.testing.assert_array_equal(got["confusion"], want["confusion"])
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)


def test_batch_stats_equal_jax_metrics():
    rng = np.random.RandomState(2)
    logits = rng.normal(size=(37, 15)).astype(np.float32)
    labels = rng.randint(0, 15, 37).astype(np.int32)
    weights = (rng.uniform(size=37) > 0.3).astype(np.int32)
    want = jmetrics.batch_stats(jnp.asarray(logits), jnp.asarray(labels), 15,
                                weights=jnp.asarray(weights))
    got = tmetrics.batch_stats(torch.from_numpy(logits), torch.from_numpy(labels), 15,
                               weights=torch.from_numpy(weights))
    for k in ("count", "correct", "confusion"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    merged = tmetrics.merge_stats(got, got)
    s = tmetrics.summarize(merged, class_names=tconfig.EMOTIONS)
    ref = jmetrics.summarize(jmetrics.merge_stats(want, want), class_names=jconfig.EMOTIONS)
    assert s["count"] == ref["count"] and s["accuracy"] == ref["accuracy"]
    assert tmetrics.format_per_class(s) == jmetrics.format_per_class(ref)


@pytest.mark.parametrize("preset,model,aggregator", [
    ("image_frozen", None, "mean"), ("joint_finetune", None, "mean"),
    ("joint_finetune", None, "rnn"), ("text_only", None, "rnn")])
def test_l2_leaf_set_equals_jax(preset, model, aggregator):
    _, tcfg = _cfgs(preset, model, text=dict(aggregator=aggregator, rnn_hidden=12))
    variables = convert.to_variables(_init(tcfg))
    want = {".".join(p) for p in flax.traverse_util.flatten_dict(variables["params"])
            if p[-1] in ("weights", "kernel")}
    got = set(ttrainer.l2_leaves(_init(tcfg)))
    assert got == want and len(got) > 0
    assert not any("WordEmbedding" in k or k.endswith(("beta", "bias", "biases")) for k in got)
    state = {k: torch.from_numpy(np.array(v)) for k, v in _init(tcfg).items()}
    jl2 = jtrainer.l2_regularization(variables["params"], 4e-5)
    np.testing.assert_allclose(ttrainer.l2_regularization(state, 4e-5).item(), float(jl2),
                               rtol=1e-6)


@pytest.mark.parametrize("scopes,key,want", [
    ("Logits", "InceptionV3.Logits/Conv2d_1c_1x1.weights", True),
    ("Logits", "InceptionV3.AuxLogits/Conv2d_1b_1x1.BatchNorm.beta", False),
    ("Logits", "JointLogits.kernel", False),
    ("Logits,AuxLogits", "AuxLogits/Conv2d_2a_5x5.BatchNorm.beta", True),
    ("Text", "Text.WordEmbedding/embeddings", True),
    ("Mixed_5b", "Mixed_5b/Branch_0/Conv2d_0a_1x1.weights", True),
    ("Branch_0", "Mixed_5b/Branch_0/Conv2d_0a_1x1.weights", True),
    ("Conv2d_0a", "Mixed_5b/Branch_0/Conv2d_0a_1x1.weights", False),
])
def test_path_in_scopes_matches_jax(scopes, key, want):
    s = ttrainer.parse_scopes(scopes)
    assert ttrainer.path_in_scopes(key, s) == want
    assert jtrainer._path_in_scopes(tuple(key.split(".")), jtrainer._parse_scopes(scopes)) == want


@pytest.mark.parametrize("name", list(CASES))
def test_optimizer_state_round_trip_is_exact(name):
    r = run_case(name)
    jstate = r["js"].opt_state
    back = convert.opt_state_to_optax(convert.opt_state_from_optax(jstate), jstate)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    port = r["ts"].opt_state
    again = convert.opt_state_from_optax(convert.opt_state_to_optax(port, jstate))
    assert again["count"] == port["count"] == 2
    assert sorted(again) == sorted(port)
    for m in again:
        if m != "count":
            assert sorted(again[m]) == sorted(port[m])
            for k in port[m]:
                torch.testing.assert_close(again[m][k], port[m][k], rtol=0, atol=0)


def test_a_jax_run_continues_in_the_port():
    """The JAX state after two steps, carried over (weights, statistics and
    optimizer state), takes a port step equal to the JAX third step."""
    r = run_case("image_frozen")
    js, jtr, tcfg = r["js"], r["jtr"], r["tcfg"]
    b = _batches(tcfg, None, n=1, seed=9)[0]
    tr = ttrainer.Trainer(tcfg, device="cpu")
    ts = tr.init_state(convert.to_state({"params": js.params, "batch_stats": js.batch_stats}))
    ts.opt_state = {k: ({kk: vv.to(tr.device) for kk, vv in v.items()} if isinstance(v, dict)
                        else v) for k, v in convert.opt_state_from_optax(js.opt_state).items()}
    ts.step = 2
    ts, _ = tr.train_step(ts, b)
    want, _ = jax.jit(jtr.train_step)(js, b, jax.random.PRNGKey(3))
    got = _flat(convert.to_variables(ts.state)["params"])
    for k, w in _flat(jax.device_get(want).params).items():
        _close_to_update(got[k], w, _flat(js.params)[k], k)


def test_full_f32_covers_the_backward():
    """TF32 stays off through the backward: a hook on the logits' gradient
    reads the flags while autograd runs."""
    _, tcfg = _cfgs("image_frozen", model="image", image=dict(image_size=75,
                                                               create_aux_logits=False),
                    train=dict(trainable_scopes=""))
    tr = ttrainer.Trainer(tcfg, device="cpu")
    ts = tr.init_state(_init(tcfg))
    seen = []

    def hook(module, args, out):
        out[0].register_hook(lambda g: seen.append(
            (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)))

    handle = tr.model.register_forward_hook(hook)
    saved = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        tr.train_step(ts, {"image": np.zeros((2, 75, 75, 3), np.float32),
                           "label": np.array([1, 2], np.int32)})
    finally:
        handle.remove()
        torch.backends.cudnn.allow_tf32 = saved
    assert seen == [(False, False)]


def test_frozen_parameters_are_bit_unchanged():
    r = run_case("image_frozen")
    init = _init(r["tcfg"])
    moved = set()
    for k, v in r["ts"].state.items():
        if not torch.equal(v.detach().cpu(), init[k]):
            moved.add(k)
    trainable = {k for k in r["tr"].param_keys
                 if ttrainer.path_in_scopes(k, ("Logits", "AuxLogits"))}
    stats = {k for k in init if k.endswith(("moving_mean", "moving_variance"))}
    assert 0 < len(trainable) < len(r["tr"].param_keys)
    assert moved - stats == trainable
    assert stats <= moved


def test_trainer_refuses_what_is_not_ported():
    _, tcfg = _cfgs("joint_finetune")
    tr = ttrainer.Trainer(tcfg, device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        tr.init_state({"x": torch.zeros(1)})
    with pytest.raises(ValueError):
        ttrainer.Trainer(tcfg, preprocess="full", device="cpu")


def test_fit_and_embedding_matrix():
    _, tcfg = _cfgs("text_only", train=dict(log_every=1, num_steps=3))
    tr = ttrainer.Trainer(tcfg, device="cpu")
    emb = np.random.RandomState(3).normal(size=(V, D)).astype(np.float32)
    ts = tr.init_state(_init(tcfg), embedding_matrix=emb)
    np.testing.assert_array_equal(ts.state["WordEmbedding/embeddings"].detach().numpy(), emb)
    batches = _batches(tcfg, None, n=5)
    ts = tr.fit(ts, iter(batches), eval_batches=lambda: batches[:2])
    assert ts.step == 3 and ts.opt_state["count"] == 3
    assert tr.evaluate(ts, [])["count"] == 0


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device is valid")
    _, tcfg = _cfgs("text_only")
    with pytest.raises(RuntimeError, match="cuda"):
        ttrainer.Trainer(tcfg)


def test_op_grads_compares_every_op():
    """The card diagnostic's comparison, run with the CPU on both sides."""
    from tumblr_emotions_torch import op_grads

    for fn, shapes, nonneg in op_grads.OPS.values():
        r = op_grads.compare(fn, shapes, torch.device("cpu"), nonneg)
        assert r["forward"] == 0 and r["grads"] and all(g == 0 for g in r["grads"])
