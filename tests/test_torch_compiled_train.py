"""The trainer's compiled steps on the CPU: the optimizer's per-update
values as a tensor, ``Trainer.compile``, its options
(``TET_TORCH_TRAIN_COMPILER_OPTIONS``) and ``cli tune --step train``.

On the CPU ``compile`` runs the steps eagerly; the captured path's Python
(the state's addresses as part of each graph's key, the per-update values
as inputs) is driven here through an uncaptured ``compile_opts.Captured``,
and the graphs themselves are held on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` train_captured).  Sizes are small: depth 0.25 at 139 px,
batch 4.
"""

import io
import json
import logging
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from tumblr_emotions_torch import cli as tcli
from tumblr_emotions_torch import config as tconfig
from tumblr_emotions_torch.models import build_model, inception_v3, joint_model, text_model
from tumblr_emotions_torch.train import optim
from tumblr_emotions_torch.train import trainer as ttrainer
from tumblr_emotions_torch.utils import compile_opts

torch.set_num_threads(2)

B, HW, SRC = 4, 139, (160, 170)
V, D, T = 64, 16, 8


def _cfg(preset, **train):
    cfg = tconfig.get_preset(preset)
    return cfg.replace(image=cfg.image.replace(image_size=HW, depth_multiplier=0.25),
                       text=cfg.text.replace(vocab_size=V, embed_dim=D, max_len=T),
                       train=cfg.train.replace(batch_size=B, **train))


def _init(cfg, seed=0):
    model = build_model(cfg, device="meta")
    return {"image": inception_v3.init_state, "joint": joint_model.init_state,
            "text": text_model.init_state}[cfg.model](model, seed)


def _batches(cfg, n, seed=1):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        b = {"tokens": rng.randint(0, V, (B, T)).astype(np.int32),
             "lengths": np.array([T, 3, 0, 5], np.int32),
             "label": rng.randint(0, 15, B).astype(np.int32)}
        if cfg.model != "text":
            b["image"] = rng.randint(0, 256, (B, *SRC, 3)).astype(np.uint8)
        out.append(b)
    return out


# ---------------------------------------------------------------------------
# the optimizer's per-update values
# ---------------------------------------------------------------------------

def _python_scalar_update(t, params, grads, state):
    """The optimizer's update as it was written with the learning rate and
    Adam's bias corrections as Python floats (the form a captured step
    cannot take: a graph would keep the first update's values); Adam's
    square root is the optimizer's (``correctly_rounded_sqrt``)."""
    keys = list(params)
    p, g = [params[k] for k in keys], [grads[k] for k in keys]
    if t.grad_clip_norm > 0:
        g = optim._clip_by_global_norm(g, t.grad_clip_norm)
    neg_lr = -optim.learning_rate(t, state["count"])
    if t.optimizer == "rmsprop":
        d = t.rmsprop_decay
        nu = [state["nu"][k] for k in keys]
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g2, 1.0 - d)
        torch._foreach_mul_(nu, d)
        torch._foreach_add_(nu, g2)
        u = torch._foreach_add(nu, t.rmsprop_epsilon)
        torch._foreach_rsqrt_(u)
        torch._foreach_mul_(u, g)
        torch._foreach_mul_(u, neg_lr)
        u = optim._trace(state, keys, u, t.momentum)
    elif t.optimizer == "adam":
        c = state["count"] + 1
        mu = [state["mu"][k] for k in keys]
        nu = [state["nu"][k] for k in keys]
        g1 = torch._foreach_mul(g, 1.0 - optim.ADAM_B1)
        torch._foreach_mul_(mu, optim.ADAM_B1)
        torch._foreach_add_(mu, g1)
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g2, 1.0 - optim.ADAM_B2)
        torch._foreach_mul_(nu, optim.ADAM_B2)
        torch._foreach_add_(nu, g2)
        bc1 = float(np.float32(1) - np.float32(optim.ADAM_B1) ** c)
        bc2 = float(np.float32(1) - np.float32(optim.ADAM_B2) ** c)
        den = optim.correctly_rounded_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(den, optim.ADAM_EPS)
        u = torch._foreach_div(mu, bc1)
        torch._foreach_div_(u, den)
        torch._foreach_mul_(u, neg_lr)
    else:
        u = optim._trace(state, keys, g, t.momentum) if t.momentum else list(g)
        u = torch._foreach_mul(u, neg_lr)
    torch._foreach_add_(p, u)
    state["count"] += 1


OPTIMIZERS = [
    ("rmsprop", dict(lr_decay_steps=2, grad_clip_norm=0.5)),
    ("adam", dict(lr_decay_steps=1)),
    ("adam", dict(grad_clip_norm=100.0)),
    ("sgd", dict(momentum=0.9, lr_decay_steps=3)),
    ("sgd", dict(momentum=0.0)),
]


@pytest.mark.parametrize("optimizer,extra", OPTIMIZERS)
def test_tensor_scalars_equal_the_python_scalar_form(optimizer, extra):
    """Five updates with the per-update values read from a tensor are bit
    for bit the updates with them as Python floats, on the CPU (where a
    tensor list divided by a Python float is IEEE division)."""
    t = tconfig.TrainConfig(optimizer=optimizer, learning_rate=0.05, **extra)
    rng = np.random.RandomState(0)
    shapes = {"a": (3, 3, 2, 4), "b": (5,), "c": (6, 5)}
    init = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32)) for k, s in shapes.items()}
    opt = optim.Optimizer(t)
    p_new = {k: v.clone() for k, v in init.items()}
    p_old = {k: v.clone() for k, v in init.items()}
    s_new, s_old = opt.init(p_new), opt.init(p_old)
    for _ in range(5):
        grads = {k: torch.from_numpy((rng.normal(size=s) * 3).astype(np.float32))
                 for k, s in shapes.items()}
        opt.update(p_new, grads, s_new)
        _python_scalar_update(t, p_old, grads, s_old)
    assert s_new["count"] == s_old["count"] == 5
    for k in shapes:
        assert torch.equal(p_new[k], p_old[k]), k
        for m in opt.moments:
            assert torch.equal(s_new[m][k], s_old[m][k]), (m, k)


@pytest.mark.parametrize("optimizer,extra", OPTIMIZERS)
def test_apply_with_host_scalars_is_held_to_optax(optimizer, extra):
    """``Optimizer.apply`` with ``Optimizer.scalars`` (the captured step's
    form) against the reference trainer's optax chain (``make_optimizer``),
    three updates: within 1e-6 (f32 rounding; the same operations in the
    same order)."""
    pytest.importorskip("jax")
    from tumblr_emotions_tpu import config as jconfig
    from tumblr_emotions_tpu.train import trainer as jtrainer

    train = dict(optimizer=optimizer, learning_rate=0.05, **extra)
    jcfg = jconfig.get_preset("joint_finetune")
    jcfg = jcfg.replace(train=jcfg.train.replace(**train))
    t = _cfg("joint_finetune", **train).train
    rng = np.random.RandomState(1)
    params = {"w": rng.normal(size=(4, 3)).astype(np.float32)}
    tx = jtrainer.make_optimizer(jcfg, params)
    jstate, want = tx.init(params), dict(params)
    opt = optim.Optimizer(t)
    got = {"w": torch.from_numpy(params["w"].copy())}
    state = opt.init(got)
    for _ in range(3):
        g = (rng.normal(size=(4, 3)) * 3).astype(np.float32)
        upd, jstate = tx.update({"w": g}, jstate, want)
        want = {"w": np.asarray(want["w"]) + np.asarray(upd["w"])}
        opt.apply(got, {"w": torch.from_numpy(g)}, state,
                  torch.from_numpy(opt.scalars(state["count"])))
        state["count"] += 1
    np.testing.assert_allclose(got["w"].numpy(), want["w"], rtol=1e-6, atol=1e-7)


def test_adams_square_root_is_correctly_rounded_as_the_references():
    """``correctly_rounded_sqrt`` equals numpy's float32 sqrt (IEEE) and the
    reference's ``jnp.sqrt`` bit for bit, which PyTorch's vectorised
    float32 sqrt on the CPU need not."""
    rng = np.random.RandomState(0)
    x = np.concatenate([np.abs(rng.normal(size=1 << 16)), rng.uniform(0, 1e-6, 1 << 12),
                        rng.uniform(1e3, 1e6, 1 << 12)]).astype(np.float32)
    got = optim.correctly_rounded_sqrt([torch.from_numpy(x)])[0].numpy()
    np.testing.assert_array_equal(got, np.sqrt(x))
    jax = pytest.importorskip("jax")
    np.testing.assert_array_equal(got, np.asarray(jax.jit(jax.numpy.sqrt)(x)))


def test_scalars_are_the_host_float32_values():
    t = tconfig.TrainConfig(optimizer="adam", learning_rate=0.01, lr_decay_steps=2,
                            lr_decay_factor=0.5)
    s = optim.Optimizer(t).scalars(4)
    assert s.dtype == np.float32
    assert s[0] == -np.float32(0.01 * 0.25)
    assert s[1] == np.float32(1) - np.float32(0.9) ** 5
    assert s[2] == np.float32(1) - np.float32(0.999) ** 5
    assert list(optim.Optimizer(t.replace(optimizer="sgd")).scalars(0)[1:]) == [1.0, 1.0]


# ---------------------------------------------------------------------------
# Trainer.compile
# ---------------------------------------------------------------------------

CASES = {
    "joint": dict(preset="joint_finetune", preprocess="train",
                  train=dict(grad_clip_norm=1.0, lr_decay_steps=1)),
    "image_adam": dict(preset="image_frozen", preprocess="train",
                       train=dict(optimizer="adam", learning_rate=1e-3)),
    "text": dict(preset="text_only", preprocess=None, train=dict()),
}


def _states_equal(a, b):
    assert a.step == b.step and a.opt_state["count"] == b.opt_state["count"]
    for k in a.state:
        assert torch.equal(a.state[k], b.state[k]), k
    for m in a.opt_state:
        if m != "count":
            for k in a.opt_state[m]:
                assert torch.equal(a.opt_state[m][k], b.opt_state[m][k]), (m, k)


@pytest.mark.parametrize("name", list(CASES))
def test_compile_on_the_cpu_runs_eagerly_and_equals_train_step(name, caplog):
    """On the CPU ``compile`` decides the eager mode (and says so once);
    ``fit`` through it equals ``train_step`` driven by hand with the same
    seeds, and ``evaluate`` equals ``eval_step`` summed by hand."""
    case = CASES[name]
    cfg = _cfg(case["preset"], **case["train"])
    batches = _batches(cfg, 3)
    a = ttrainer.Trainer(cfg, preprocess=case["preprocess"], device="cpu")
    with caplog.at_level(logging.INFO, logger="tumblr_emotions_torch"):
        a.compile()
    assert a.step_mode == "eager"
    assert [r.message for r in caplog.records if "train and eval steps" in r.message] == \
        ["train and eval steps: eager (device cpu)"]
    sa = a.fit(a.init_state(_init(cfg)), iter(batches), num_steps=3)

    b = ttrainer.Trainer(cfg, preprocess=case["preprocess"], device="cpu")
    sb = b.init_state(_init(cfg))
    gen = torch.Generator()
    for s, batch in enumerate(batches):
        gen.manual_seed(ttrainer.step_seed(cfg.train.seed, s))
        sb, _ = b.train_step(sb, batch, gen)
    _states_equal(sa, sb)

    if case["preprocess"] == "train":
        a.preprocess = b.preprocess = "eval"
    got = a.evaluate(sa, batches[:2])
    stats = [b.eval_step(sb, x) for x in batches[:2]]
    assert got["count"] == 2 * B
    assert got["accuracy"] == sum(int(s["correct"]) for s in stats) / (2 * B)


class _Recorded(compile_opts.Captured):
    """An uncaptured program that counts its calls and clears."""

    def __init__(self, fn):
        super().__init__(fn, {"cuda_graph": "false"}, torch.device("cpu"), inference=False)
        self.clears = 0
        self.keys = []

    def clear(self):
        self.clears += 1
        super().clear()

    def __call__(self, *args, key=()):
        self.keys.append(key)
        return super().__call__(*args, key=key)


def _captured_path(trainer):
    """The trainer's captured path on the CPU: ``compile``'s programs,
    uncaptured, so the step's Python (inputs, keys, rebinding) runs."""
    trainer.compile()
    trainer._programs = {"train": _Recorded(trainer._captured_train),
                         "eval": _Recorded(trainer._captured_eval)}
    return trainer._programs


def test_the_captured_path_equals_the_eager_steps_and_rebinds_on_restore(tmp_path):
    """The captured path's program (per-update values as an input, the
    trainer's generator) equals the eager steps bit for bit; a restored
    state (its tensors elsewhere) drops the graphs and binds again, and
    training on from it equals the straight run."""
    cfg = _cfg("joint_finetune", grad_clip_norm=1.0, lr_decay_steps=1,
               checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2)
    batches = _batches(cfg, 4)
    eager = ttrainer.Trainer(cfg, preprocess="train", device="cpu")
    straight = eager.fit(eager.init_state(_init(cfg)), iter(batches), num_steps=4)

    tr = ttrainer.Trainer(cfg, preprocess="train", device="cpu")
    programs = _captured_path(tr)
    tr.checkpoint_manager()
    ts = tr.fit(tr.init_state(_init(cfg)), iter(batches[:2]), num_steps=2)
    assert programs["train"].clears == 1 and len(programs["train"].keys) == 2
    assert programs["train"].keys[0] == tuple(sorted(batches[0]))
    restored = tr.restore_latest(tr.init_state(_init(cfg)))
    assert restored.step == 2
    ts = tr.fit(restored, iter(batches[2:]), num_steps=2)
    assert programs["train"].clears == 2          # the restored tensors bound anew
    _states_equal(ts, straight)

    tr.preprocess = eager.preprocess = "eval"
    got, want = tr.evaluate(ts, batches[:2]), eager.evaluate(straight, batches[:2])
    assert got["accuracy"] == want["accuracy"] and got["loss"] == want["loss"]
    assert programs["eval"].clears == 1


def test_a_captured_step_is_one_bind_span():
    """Under a profiler each captured train or eval step's host work (the
    update's scalars, the state's addresses, the batch's order, then the
    program) is one ``trainer.bind`` range on the caller's thread."""
    cfg = _cfg("text_only")
    tr = ttrainer.Trainer(cfg, device="cpu")
    programs = _captured_path(tr)
    ts = tr.init_state(_init(cfg))
    batches = _batches(cfg, 2)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for batch in batches:
            ts, _ = tr._compiled_train(ts, batch, tr.generator)
        tr._compiled_eval(ts, batches[0])
    binds = [e for e in prof.profiler.kineto_results.events() if e.name() == "trainer.bind"]
    assert len(binds) == 3 and len(programs["train"].keys) == 2
    assert len(programs["eval"].keys) == 1


def test_the_captured_train_step_refuses_another_generator():
    cfg = _cfg("text_only")
    tr = ttrainer.Trainer(cfg, device="cpu")
    _captured_path(tr)
    with pytest.raises(ValueError, match="trainer.generator"):
        tr._compiled_train(tr.init_state(_init(cfg)), _batches(cfg, 1)[0], torch.Generator())


# ---------------------------------------------------------------------------
# TET_TORCH_TRAIN_COMPILER_OPTIONS
# ---------------------------------------------------------------------------

def test_train_options_follow_the_serving_variables_rules(monkeypatch):
    """The train variable parses as the serving one does (JSON object,
    values coerced to strings, the same option names), and neither reaches
    the other's steps."""
    monkeypatch.delenv(compile_opts.TRAIN_ENV_VAR, raising=False)
    monkeypatch.setenv(compile_opts.ENV_VAR, '{"cuda_graph": "false"}')
    assert compile_opts.train_default_options() == {"cuda_graph": "true"}
    monkeypatch.delenv(compile_opts.ENV_VAR)
    monkeypatch.setenv("TET_TRAIN_COMPILER_OPTIONS", '{"xla_tpu_scoped_vmem_limit_kib": "1"}')
    assert compile_opts.train_default_options() == {"cuda_graph": "true"}

    monkeypatch.setenv(compile_opts.TRAIN_ENV_VAR, '{"cuda_graph": false}')
    assert compile_opts.train_default_options() == {"cuda_graph": "False"}
    assert compile_opts.default_options() == {"cuda_graph": "true"}
    tr = ttrainer.Trainer(_cfg("text_only"), device="cpu").compile()
    assert tr.step_mode == "eager"
    monkeypatch.setenv(compile_opts.TRAIN_ENV_VAR, "{}")
    assert ttrainer.Trainer(_cfg("text_only"), device="cpu").compile().step_mode == "eager"
    monkeypatch.setenv(compile_opts.TRAIN_ENV_VAR, '{"bogus": "1"}')
    with pytest.raises(ValueError, match="unknown option 'bogus'"):
        ttrainer.Trainer(_cfg("text_only"), device="cpu").compile()
    monkeypatch.setenv(compile_opts.TRAIN_ENV_VAR, '{"cuda_graph": "sometimes"}')
    with pytest.raises(ValueError, match="expected one of"):
        ttrainer.Trainer(_cfg("text_only"), device="cpu").compile()
    monkeypatch.setenv(compile_opts.TRAIN_ENV_VAR, "not json")
    with pytest.raises(ValueError, match="TET_TORCH_TRAIN_COMPILER_OPTIONS is not valid JSON"):
        compile_opts.train_default_options()
    monkeypatch.setenv(compile_opts.TRAIN_ENV_VAR, '["list"]')
    with pytest.raises(ValueError, match="JSON object"):
        compile_opts.train_default_options()


# ---------------------------------------------------------------------------
# cli tune --step train
# ---------------------------------------------------------------------------

TUNE_TRAIN = ["tune", "--step", "train", "--batch-size", "2", "--image-size", "40",
              "--steps", "1", "--repeats", "1", "--depth-multiplier", "0.25", "--device", "cpu"]


def _run(argv):
    out = io.StringIO()
    with redirect_stdout(out):
        assert tcli.main(argv) == 0
    return json.loads(out.getvalue().splitlines()[-1])


def test_cli_tune_train_prints_the_reference_keys(tmp_path):
    """``tune --step train`` measures both candidates and prints the
    reference's keys, its hint naming the train variable; a second run
    serves the winner from the cache."""
    cache = str(tmp_path / "tune.json")
    first = _run([*TUNE_TRAIN, "--cache", cache])
    assert set(first) == {"step", "batch_size", "best_options", "best_images_per_sec",
                          "candidates_measured", "from_cache", "apply_hint", "results"}
    assert first["step"] == "train" and first["batch_size"] == 2
    assert first["candidates_measured"] == 2 and first["from_cache"] is False
    assert first["best_options"] in ({"cuda_graph": "false"}, {"cuda_graph": "true"})
    assert first["best_images_per_sec"] == max(r["images_per_sec"] for r in first["results"])
    assert first["apply_hint"] == ("export TET_TORCH_TRAIN_COMPILER_OPTIONS="
                                   f"'{json.dumps(first['best_options'])}'")
    assert list(json.load(open(cache))) == ["train/joint/b2"]
    again = _run([*TUNE_TRAIN, "--cache", cache])
    assert again["from_cache"] is True and again["best_options"] == first["best_options"]
    assert again["best_images_per_sec"] is None and again["results"] == []
