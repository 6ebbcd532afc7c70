"""Perf-mode (bf16) training in the port against the JAX package's jitted
perf step on the CPU: two train steps of ``text_only`` (mean and rnn),
``image_frozen`` and ``joint_finetune`` in ``precision_mode="perf"``, and
the ``data_parallel`` preset.

Weights are made by the port and carried to JAX with
``convert.to_variables``; the JAX steps run jitted, once per case, in an
lru-cached ``run_case`` (depth 0.25, 139 px, vocabulary 64, batch 4,
dropout off).  bf16 steps cannot agree bit for bit (cross-entropy's
gradient and every f32 sum are computed in another order, and a bf16
rounding flips where they differ), so each comparison is held to the
port's own floor: the distance between the port's step and the same step
with every conv and matmul of the bf16 layers, forward and backward,
accumulated in float64 instead of float32 (a change of f32 summation
order only, as ``tests/report_perf_mode.py`` measures the eval floor).
Distances are ``||got - want|| / ||want - before||`` over the leaves
(``test_torch_train._distance``); measured values beside each tolerance.

At initialisation, train-mode batch norm over 4 images amplifies each
flipped rounding through the tower: the floor of the image models'
gradients is 0.36 (image_frozen) and 1.0 (joint) already at step 1, so a
smaller learning rate cannot lower it, and a distance over every leaf
cannot tell a correct update from none.  The updates and gradients are
therefore also held leaf by leaf where the floor is small (the heads,
biases and embeddings: ``noise_floor.hold``), a check each test shows
would refuse a no-op and a sign-flipped update, and the tower's bf16
backward is held without that amplification, in eval mode
(``test_perf_eval_mode_gradients_match_jax``).  A dropped or added bf16
rounding in the tower's backward moves its gradients by about 2^-9, inside
these floors: no test here can see one (the roundings were read from the
reference's compiled program, ``models/layers.py``).
"""

import contextlib
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from test_torch_train import B, _batches, _cfgs, _distance, _flat, _init, _jax_trainer
from test_torch_train_preprocessing import jax_train_draws
from tumblr_emotions_torch import config as tconfig
from tumblr_emotions_torch import convert
from tumblr_emotions_torch.models import build_model
from tumblr_emotions_torch.train import noise_floor
from tumblr_emotions_torch.train import trainer as ttrainer
from tumblr_emotions_tpu.train import trainer as jtrainer

torch.set_num_threads(2)

PERF = dict(precision_mode="perf")
CASES = {
    "text_mean": dict(preset="text_only"),                                     # Adam
    "text_rnn": dict(preset="text_only", text=dict(aggregator="rnn", rnn_hidden=12),
                     train=dict(optimizer="sgd", momentum=0.9, learning_rate=0.1)),
    # Logits and AuxLogits trainable, the tower frozen in train mode.
    "image_frozen": dict(preset="image_frozen", train=dict(learning_rate=1e-2)),
    # RMSProp, global-norm clipping, the train distortions.
    "joint": dict(preset="joint_finetune", train=dict(grad_clip_norm=1.0), preprocess="train"),
}
# The port's distance to JAX is held within FLOOR_FACTOR x the mean of its
# floor runs: the step with the bf16 layers' products accumulated in float64
# ("f64"), and with each image moved by NOISE_INPUT x N(0, 1) (the jitted JAX
# preprocessing's drift from its own op-by-op run, test_torch_train), two
# seeds; plus an absolute term per metric where a floor is 0 (the text
# models are exact up to a few bf16 ties).
FLOOR_FACTOR = 3.0
LOSS_ATOL = 1e-5
PARAMS_ATOL = 2.0 ** -8
LEAF_ATOL = 2.0 ** -6
GRADS_ATOL = 2.0 ** -7
FLOOR_RUNS = ("f64", "nudge1", "nudge2")
NOISE_INPUT = 2.3e-6


def _steps(tcfg, preprocess, state, batches, draws, f64=False, nudge=None):
    """Two port steps; returns (trainer, state, [loss], step-1 logits, step-1
    grads); ``f64``: under ``noise_floor.float64_accumulation``; ``nudge``: a seed
    to move each image by NOISE_INPUT x N(0, 1) (through the brightness
    draw when the step distorts)."""
    tr = ttrainer.Trainer(tcfg, preprocess=preprocess, device="cpu")
    ts = tr.init_state(state)
    losses, logits1, grads1 = [], None, None
    g = None if nudge is None else torch.Generator().manual_seed(nudge)
    with noise_floor.float64_accumulation() if f64 else contextlib.nullcontext():
        for b, d in zip(batches, draws):
            if g is not None and d is not None:
                d = dataclasses.replace(d, delta=d.delta + NOISE_INPUT * torch.randn(
                    d.delta.shape, generator=g))
            elif g is not None and "image" in b:
                b = dict(b, image=b["image"] + NOISE_INPUT * torch.randn(
                    b["image"].shape, generator=g).numpy())
            inputs = tr.train_inputs(b, None, d)
            loss, logits, grads = tr.loss_and_grads(ts, inputs)
            tr.apply_gradients(ts, grads)
            ts = ttrainer.TrainState(ts.step + 1, ts.state, ts.opt_state)
            losses.append(loss.item())
            if logits1 is None:
                logits1 = logits.to(tr.model.dtype).float()
                grads1 = {k: g.clone() for k, g in grads.items()}
    return tr, ts, losses, logits1, grads1


@functools.lru_cache(maxsize=None)
def run_case(name):
    case = CASES[name]
    jcfg, tcfg = _cfgs(case["preset"], case.get("model"), case.get("image"), case.get("text"),
                       dict(case.get("train", {}), **PERF))
    preprocess = case.get("preprocess")
    state = _init(tcfg)
    batches = _batches(tcfg, preprocess)
    jtr = _jax_trainer(jcfg, preprocess)
    js = jtr.init_state(jax.random.PRNGKey(0), batches[0],
                        initial_variables=convert.to_variables(state))
    j_init = jax.device_get(js)
    step = jax.jit(jtr.train_step)
    rng = jax.random.PRNGKey(3)

    def loss_fn(params, batch_stats, batch, rng_pp):
        batch = jtr._maybe_preprocess(batch, True, rng_pp)
        p = jtrainer.stop_frozen_gradients(params, jcfg.train.trainable_scopes)
        return jtr._loss_fn(p, batch_stats, batch, jax.random.PRNGKey(0), True)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    j_losses, draws = [], []
    j_logits = j_grads = None
    for b in batches:
        rng_pp, _ = jax.random.split(jax.random.fold_in(rng, js.step))
        draws.append(jax_train_draws(rng_pp, B, b["image"].shape[1:3]) if preprocess else None)
        if j_logits is None:
            (_, (lg, _)), g = grad_fn(js.params, js.batch_stats, b, rng_pp)
            j_logits, j_grads = np.asarray(lg, np.float32), _flat(jax.device_get(g))
        js, m = step(js, b, rng)
        j_losses.append(float(m["loss"]))
    runs = {"port": _steps(tcfg, preprocess, state, batches, draws),
            "f64": _steps(tcfg, preprocess, state, batches, draws, f64=True),
            "nudge1": _steps(tcfg, preprocess, state, batches, draws, nudge=1),
            "nudge2": _steps(tcfg, preprocess, state, batches, draws, nudge=2),
            "parity": _steps(tcfg.replace(train=tcfg.train.replace(precision_mode="parity")),
                             preprocess, state, batches, draws)}
    return dict(tcfg=tcfg, j_init=j_init, js=jax.device_get(js), j_losses=j_losses,
                j_logits=j_logits, j_grads=j_grads, runs=runs, state=state)


def _collection(ts, collection):
    return _flat(convert.to_variables(ts.state)[collection])


def _leaves(r, collection):
    """(before, want, {run: got}) flat dicts of ``collection``, the leaves
    the steps move."""
    before = _flat(getattr(r["j_init"], collection))
    want = _flat(getattr(r["js"], collection))
    keys = [k for k in want if not np.array_equal(want[k], before[k])]
    got = {n: _collection(run[1], collection) for n, run in r["runs"].items()}
    return ({k: before[k] for k in keys}, {k: want[k] for k in keys},
            {n: {k: g[k] for k in keys} for n, g in got.items()}, keys)


def _held(to_jax, floors, atol, what):
    floor = float(np.mean(floors))
    assert to_jax <= FLOOR_FACTOR * floor + atol, (what, to_jax, floors)


def _floors(r, fn):
    return [fn(r["runs"][f]) for f in FLOOR_RUNS]


@pytest.mark.parametrize("name", list(CASES))
def test_perf_steps_loss_and_logits_match_jax(name):
    """Measured, to JAX (the floor's mean): text 0 and up to 2.0e-6 (0) in
    loss, 0 (0) in logits; image_frozen 3.4e-3 and 3.8e-3 (1.3e-2, 8.9e-3),
    logits 0.12 (0.14) of max|logit|; joint 1.5e-2 and 4.5e-3 (6.5e-3,
    1.7e-2), logits 0.12 (0.11).  The loss is f32 once the logits are
    given: LOSS_ATOL."""
    r = run_case(name)
    port = r["runs"]["port"]
    for i in range(2):
        want = r["j_losses"][i]
        _held(abs(port[2][i] - want) / abs(want),
              _floors(r, lambda run: abs(run[2][i] - port[2][i]) / abs(want)), LOSS_ATOL,
              f"loss {i + 1}")
    scale = np.abs(r["j_logits"]).max()
    got = port[3].numpy()
    _held(np.abs(got - r["j_logits"]).max() / scale,
          _floors(r, lambda run: np.abs(run[3].numpy() - got).max() / scale), 0.0, "logits")


def _hold(got, want, before, keys, atol=PARAMS_ATOL):
    """``noise_floor.hold`` of the port's run ``got["port"]`` against
    ``want``, with the floor runs' distances to the port's run; asserts
    that it passes and that it would refuse a no-op and a sign-flipped
    update."""
    h = noise_floor.hold(got["port"], want, got["port"], [got[f] for f in FLOOR_RUNS],
                         before, keys, FLOOR_FACTOR, atol, LEAF_ATOL)
    assert h["ok"], (h["to_ref"], h["limit"], {k: h["signal_leaves"][k]
                                               for k in h["failed_leaves"]})
    assert h["refuses_noop"] and h["refuses_flip"], h["signal_leaves"]
    return h


@pytest.mark.parametrize("name", list(CASES))
def test_perf_steps_parameters_match_jax(name):
    """The update of two steps.  Measured, to JAX (the floor's mean), over
    every leaf: text_mean 9.2e-5 (0), text_rnn 2.0e-3 (2e-9), image_frozen
    0.19 (0.34), joint 1.16 (1.05); training the whole tower in bf16 at
    batch 4 is noise-dominated, so the image cases are also held leaf by
    leaf where the floor is under ``noise_floor.SIGNAL_FLOOR``: image_frozen
    the Logits and AuxLogits biases and kernels (floors 0.006-0.16), joint
    JointLogits and the AuxLogits biases (0.03-0.04; limits 0.12-0.13),
    which refuse a no-op update (distance 1) and a sign-flipped one (2).
    PARAMS_ATOL: one bf16 rounding of the update; LEAF_ATOL: a few."""
    r = run_case(name)
    before, want, got, keys = _leaves(r, "params")
    assert keys
    _hold(got, want, before, keys)


@pytest.mark.parametrize("name", list(CASES))
def test_perf_step_gradients_match_jax(name):
    """Step 1's gradients, leaf by leaf where the floor is small, and as a
    whole: measured, to JAX (the floor's mean), text 0 and 3.9e-3 (0),
    image_frozen 0.21 (0.36), joint 1.10 (1.0); the held leaves: the text
    models' every leaf, image_frozen's Logits and AuxLogits biases (floors
    8e-3 and 1.9e-2), joint's JointLogits bias, the AuxLogits biases and
    the word embeddings (6e-3 to 1.7e-2).  GRADS_ATOL: a bf16 tie rounded
    the other way in a bf16-valued gradient (text_mean's bias: 3.9e-3 of the
    whole)."""
    r = run_case(name)
    got = {n: _flat(convert.to_variables(r["runs"][n][4])["params"])
           for n in ("port",) + FLOOR_RUNS}
    keys = [k for k in got["port"] if np.any(r["j_grads"][k] != 0)]
    assert keys
    _hold(got, r["j_grads"], None, keys, atol=GRADS_ATOL)


@pytest.mark.parametrize("name", ["image_frozen", "joint"])
def test_perf_steps_batch_norm_statistics_match_jax(name):
    """Measured, to JAX (the floor's mean): image_frozen 0.023 (0.035),
    joint 0.044 (0.042)."""
    r = run_case(name)
    before, want, got, keys = _leaves(r, "batch_stats")
    assert len(keys) > 100
    _held(_distance(got["port"], before, want, before, keys),
          [_distance(got[f], before, got["port"], before, keys) for f in FLOOR_RUNS],
          1e-6, "batch_stats")


@pytest.mark.parametrize("name", list(CASES))
def test_perf_build_differs_from_the_parity_build(name):
    """The parity (f32) build's step-1 logits are f32 values and further from
    the JAX perf step's than the perf build's (bf16 values): text 2.5e-3 and
    7.6e-3 against 0 (beyond the perf tolerance), image_frozen 0.28 against
    0.12, joint 0.21 against 0.12 of max|logit|."""
    r = run_case(name)
    scale = np.abs(r["j_logits"]).max()
    perf, parity = (r["runs"][n][3].numpy() for n in ("port", "parity"))
    to_jax = np.abs(perf - r["j_logits"]).max() / scale
    parity_to_jax = np.abs(parity - r["j_logits"]).max() / scale
    assert _is_bf16(perf) and not _is_bf16(parity)
    assert parity_to_jax > to_jax
    if name.startswith("text"):
        assert parity_to_jax > FLOOR_FACTOR * np.mean(
            _floors(r, lambda run: np.abs(run[3].numpy() - perf).max() / scale))


def _is_bf16(a) -> bool:
    a = np.asarray(a, np.float32)
    return bool(np.array_equal(torch.from_numpy(a.copy()).to(torch.bfloat16).float().numpy(), a))


@pytest.mark.parametrize("name", list(CASES))
def test_perf_weight_gradients_are_bf16_where_the_reference_rounds(name):
    """Every leaf whose JAX gradient holds only bf16 values (the heads'
    biases) gets bf16 values from the port; the conv and Dense kernels'
    gradients are f32 in both (XLA drops their rounding)."""
    r = run_case(name)
    got = _flat(convert.to_variables(r["runs"]["port"][4])["params"])
    rounded = [k for k in got if _is_bf16(r["j_grads"][k])]
    assert rounded, "the reference rounds some gradient"
    for k in rounded:
        assert _is_bf16(got[k]), k
    convs = [k for k in got if k.endswith("weights")]
    assert not any(_is_bf16(r["j_grads"][k]) or _is_bf16(got[k]) for k in convs)


def test_data_parallel_preset_trains_on_the_cpu():
    """Trainer(get_preset("data_parallel")) builds the bf16 joint model and
    takes a step on one process (its mesh is the whole group: one)."""
    cfg = tconfig.get_preset("data_parallel")
    assert (cfg.model, cfg.train.batch_size, cfg.train.precision_mode, cfg.mesh.data,
            cfg.train.num_steps) == ("joint", 1024, "perf", -1, 100_000)
    cfg = cfg.replace(image=cfg.image.replace(depth_multiplier=0.25, image_size=75,
                                              create_aux_logits=False),
                      text=cfg.text.replace(vocab_size=64, embed_dim=16),
                      train=cfg.train.replace(batch_size=2))
    tr = ttrainer.Trainer(cfg, preprocess="train", device="cpu")
    assert tr.model.dtype == torch.bfloat16 and tr.world == 1 and tr.group is None
    state = _init(cfg)
    ts = tr.init_state(state)
    rng = np.random.RandomState(0)
    batch = {"image": rng.randint(0, 256, (2, 90, 100, 3)).astype(np.uint8),
             "tokens": rng.randint(0, 64, (2, 8)).astype(np.int32),
             "lengths": np.array([8, 3], np.int32), "label": np.array([1, 4], np.int32)}
    ts, m = tr.train_step(ts, batch, torch.Generator().manual_seed(0))
    assert ts.step == 1 and np.isfinite(m["loss"].item())
    assert not torch.equal(ts.state["JointLogits.kernel"].detach(), state["JointLogits.kernel"])
    assert build_model(cfg, device="meta").dtype == torch.bfloat16
    assert dataclasses.asdict(tconfig.get_preset("data_parallel").mesh) == \
        {"data": -1, "model": 1}



def _eval_mode_grads(tr, state, batch, f64=False):
    """The port's loss and gradients of every parameter with the model in
    eval mode (batch norm on its moving statistics)."""
    ts = tr.init_state(state)
    keys = tr.trainable_keys(ts)
    with noise_floor.float64_accumulation() if f64 else contextlib.nullcontext():
        tr.model.eval()
        inputs = tr._to_device(batch)
        logits, _ = torch.func.functional_call(tr.model, ts.state, tr._model_args(inputs))
        loss = ttrainer.cross_entropy(logits, inputs["label"]) + ttrainer.l2_regularization(
            ts.state, tr.cfg.train.weight_decay)
        grads = torch.autograd.grad(loss, [ts.state[k] for k in keys], allow_unused=True)
    # the aux head's biases and batch norm are unused in eval mode
    return loss.item(), _flat(convert.to_variables(
        {k: g for k, g in zip(keys, grads) if g is not None})["params"])


def test_perf_eval_mode_gradients_match_jax():
    """The bf16 tower's backward (``_Bf16Conv``, ``_Bf16AvgPool``, the
    heads) through every layer, without train-mode batch norm's
    amplification of rounding noise: the gradient of the whole image model
    with batch norm on its moving statistics, against ``jax.grad`` of the
    reference's eval-mode loss.  Measured: 0.068 from JAX, the float64
    run's floor 0.049 (limit 0.15, where no gradient is 1 and a reversed
    one 2); loss 3.2e-4 from JAX."""
    jcfg, tcfg = _cfgs("image_frozen", "image", None, None, dict(PERF, trainable_scopes=""))
    state = _init(tcfg)
    batch = _batches(tcfg, None)[0]
    jtr = _jax_trainer(jcfg, None)
    v = convert.to_variables(state)
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(
        lambda p: jtr._loss_fn(p, v["batch_stats"], batch, jax.random.PRNGKey(0), False),
        has_aux=True))(v["params"])
    j_grads = _flat(jax.device_get(j_grads))
    tr = ttrainer.Trainer(tcfg, device="cpu")
    loss, port = _eval_mode_grads(tr, state, batch)
    _, f64 = _eval_mode_grads(tr, state, batch, f64=True)
    assert abs(loss - float(j_loss)) <= 1e-3 * abs(float(j_loss))
    keys = list(port)
    assert len(keys) > 190
    h = noise_floor.hold(port, j_grads, port, [f64], None, keys, FLOOR_FACTOR, GRADS_ATOL,
                         LEAF_ATOL)
    assert h["ok"] and h["limit"] < 0.5, (h["to_ref"], h["limit"], h["failed_leaves"])
    assert h["refuses_noop"] and h["refuses_flip"]
