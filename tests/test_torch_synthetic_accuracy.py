"""The port's synthetic accuracy benchmark (``tumblr_emotions_torch/
synthetic_accuracy.py``) against the reference's
(``experiments/synthetic_accuracy.py``, loaded by path): the exact Bayes
ceilings, the corpus's rates and the image cue's arithmetic, and the four
runs' final line at a tiny size on the CPU.

The port draws the corpus with its own generator, which cannot reproduce
``jax.random``'s draws: its rates are held within binomial bands of the
reference's probabilities over 25,600 draws (5 sigma), and the image cue
is held as a function of its inputs, made with numpy and given to both.
"""

import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from tumblr_emotions_torch import synthetic_accuracy as sa

REF_PATH = Path(__file__).resolve().parents[1] / "experiments" / "synthetic_accuracy.py"
N_DRAWS = 25_600
SIGMAS = 5.0


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location("reference_synthetic_accuracy", REF_PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_exact_ceilings_equal_the_reference(ref):
    assert sa.exact_ceilings() == ref.exact_ceilings()
    assert sa.exact_ceilings() == {"image": 0.3933, "text": 0.6827, "joint": 0.7299}


def test_constants_equal_the_reference(ref):
    for name in ("P_IMG", "P_TXT", "P_AMB", "NUM_CLASSES", "NUM_PAIRS", "B", "MAX_LEN",
                 "TOKENS_PER_CLASS", "FILLER", "VOCAB", "HOST_SIDE", "EVAL_BATCHES",
                 "FINAL_EVAL_BATCHES", "EVAL_EVERY"):
        assert getattr(sa, name) == getattr(ref, name), name


def _within(count, n, p, what):
    sigma = math.sqrt(n * p * (1 - p))
    assert abs(count - n * p) <= SIGMAS * sigma, (what, count / n, p)


def test_label_rates_lie_within_binomial_bands():
    lab = sa.draw_labels(torch.Generator().manual_seed(3), N_DRAWS, "cpu")
    y, y_img, y_txt, amb = (lab[k].numpy() for k in ("y", "y_img", "y_txt", "amb"))
    for c in range(sa.NUM_CLASSES):
        _within((y == c).sum(), N_DRAWS, 1 / 15, f"label {c}")
    # kept with P, else replaced by an independent uniform label
    _within((y_img == y).sum(), N_DRAWS, sa.P_IMG + (1 - sa.P_IMG) / 15, "image keep")
    _within((y_txt == y).sum(), N_DRAWS, sa.P_TXT + (1 - sa.P_TXT) / 15, "text keep")
    paired = y_txt < 2 * sa.NUM_PAIRS
    _within(amb[paired].sum(), paired.sum(), sa.P_AMB, "ambiguity")
    assert not amb[~paired].any()
    # the keep draws are independent of each other
    both = ((y_img == y) & (y_txt == y)).sum()
    _within(both, N_DRAWS, (sa.P_IMG + (1 - sa.P_IMG) / 15) * (sa.P_TXT + (1 - sa.P_TXT) / 15),
            "both kept")


def test_tokens_lie_in_their_ranges():
    gen = torch.Generator().manual_seed(4)
    lab = sa.draw_labels(gen, N_DRAWS, "cpu")
    tok = sa.caption_tokens(gen, lab["y_txt"], lab["amb"]).numpy()
    y_txt, amb = lab["y_txt"].numpy(), lab["amb"].numpy()
    assert tok.shape == (N_DRAWS, sa.MAX_LEN) and tok.dtype == np.int32
    base = np.where(amb, (sa.NUM_CLASSES + y_txt // 2) * sa.TOKENS_PER_CLASS,
                    y_txt * sa.TOKENS_PER_CLASS) + 2
    cls = tok[:, :6] - base[:, None]
    assert cls.min() == 0 and cls.max() == sa.TOKENS_PER_CLASS - 1
    fill0 = 2 + (sa.NUM_CLASSES + sa.NUM_PAIRS) * sa.TOKENS_PER_CLASS
    assert tok[:, 6:].min() == fill0 and tok[:, 6:].max() == fill0 + sa.FILLER - 1
    assert tok.min() >= 2 and tok.max() == sa.VOCAB - 1
    for j in range(sa.TOKENS_PER_CLASS):       # uniform within a set
        _within((cls == j).sum(), cls.size, 1 / sa.TOKENS_PER_CLASS, f"class token {j}")
    for j in (0, sa.FILLER - 1):
        _within((tok[:, 6:] == fill0 + j).sum(), tok[:, 6:].size, 1 / sa.FILLER, f"filler {j}")


def _jnp_cue(y_img, phase_u, phase_v, noise):
    """The reference's image arithmetic (``experiments/synthetic_accuracy.py``
    ``make_sampler``, the lines from the grid to the uint8 cast), with jnp,
    on given draws."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    side = noise.shape[1]
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float32)
    yy, xx = jnp.asarray(yy), jnp.asarray(xx)
    angs = np.asarray([9, 27, 45, 63, 81], np.float32) * np.pi / 180.0
    ang_a = jnp.asarray(angs[np.arange(sa.NUM_CLASSES) % 5])
    y_img = jnp.asarray(y_img)
    a = ang_a[y_img][:, None, None]
    pat = (y_img // 5)[:, None, None]
    freq = 0.3
    phase_u = jnp.asarray(phase_u)[:, None, None]
    phase_v = jnp.asarray(phase_v)[:, None, None]
    u = (xx[None] * jnp.cos(a) + yy[None] * jnp.sin(a)) * freq + phase_u
    v = (-xx[None] * jnp.cos(a) + yy[None] * jnp.sin(a)) * freq + phase_v
    su, sv = jnp.sin(u), jnp.sin(v)
    wave = jnp.where(pat == 0, 0.5 * (su + sv),
                     jnp.where(pat == 1, 0.5 * (jnp.sign(su) + jnp.sign(sv)), su * sv))
    base = 127.0 + 100.0 * wave
    image = jnp.clip(base[..., None] + jnp.asarray(noise), 0, 255).astype(jnp.uint8)
    return np.asarray(image), np.asarray(wave)


def test_image_cue_matches_the_reference_arithmetic():
    """Every class and waveform, 30 images at 97 px: the port's cue (float32
    sines of the mirror components, the waveform, clip and truncate) against
    the reference's jnp arithmetic on the same labels, phases and noise.
    The sines agree within 2 f32 ulps of their argument (a 97 px grid
    reaches ~60 rad), the waveforms within 1e-5, and the bytes exactly but
    where 127 + 100 * wave + noise lies within 1e-3 of an integer."""
    rng = np.random.RandomState(0)
    n, side = 30, 97
    y_img = np.concatenate([np.arange(sa.NUM_CLASSES), rng.randint(0, 15, n - 15)])
    phase_u = (rng.uniform(size=n) * 2 * np.pi).astype(np.float32)
    phase_v = (rng.uniform(size=n) * 2 * np.pi).astype(np.float32)
    noise = rng.uniform(-25, 25, (n, side, side, 3)).astype(np.float32)
    want, wave = _jnp_cue(y_img.astype(np.int32), phase_u, phase_v, noise)
    got = sa.image_cue(torch.from_numpy(y_img), torch.from_numpy(phase_u),
                       torch.from_numpy(phase_v), torch.from_numpy(noise)).numpy()
    assert got.dtype == np.uint8 and got.shape == (n, side, side, 3)
    exact = 127.0 + 100.0 * wave[..., None].astype(np.float64) + noise
    near = np.abs(exact - np.round(exact)) < 1e-3
    differ = got != want
    assert not (differ & ~near).any(), int((differ & ~near).sum())
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    # the classes differ: their mean images are not alike
    assert len({got[i].tobytes() for i in range(sa.NUM_CLASSES)}) == sa.NUM_CLASSES


def test_sample_has_the_reference_batch_layout():
    b = sa.seeded(5, "cpu", n=6, side=23)
    assert b["image"].shape == (6, 23, 23, 3) and b["image"].dtype == torch.uint8
    assert b["tokens"].shape == (6, sa.MAX_LEN) and b["tokens"].dtype == torch.int32
    assert b["lengths"].tolist() == [sa.MAX_LEN] * 6 and b["label"].dtype == torch.int32
    again = sa.seeded(5, "cpu", n=6, side=23)
    assert all(torch.equal(b[k], again[k]) for k in b)


def test_tower_pretrained_leaves_out_the_heads():
    from tumblr_emotions_torch import config as tconfig
    from tumblr_emotions_torch.models import build_model, inception_v3

    cfg = tconfig.get_preset("image_frozen")
    cfg = cfg.replace(image=cfg.image.replace(depth_multiplier=0.25))
    state = inception_v3.init_state(build_model(cfg, device="meta"), 0)
    pre = sa.tower_pretrained(state)
    names = set(pre["params"]) | set(pre["batch_stats"])
    assert not any(n.startswith(("Logits/", "AuxLogits/")) for n in names)
    assert len(names) == len([k for k in state if not k.startswith(("Logits/", "AuxLogits/"))])
    assert "Mixed_7c/Branch_0/Conv2d_0a_1x1/BatchNorm/moving_mean" in pre["batch_stats"]


def test_main_prints_the_reference_keys(monkeypatch):
    """The four runs and the final line at a tiny size on the CPU (depth
    0.25, 139 px, batch 4, two steps each): the reference's keys, the probe
    capped at its steps, and the int8 delta's keys."""
    from tumblr_emotions_torch import config as tconfig

    preset = tconfig.get_preset

    def small(name):
        cfg = preset(name)
        return cfg.replace(image=cfg.image.replace(depth_multiplier=0.25, image_size=139))

    monkeypatch.setattr(tconfig, "get_preset", small)
    for name, value in (("B", 4), ("EVAL_BATCHES", 1), ("FINAL_EVAL_BATCHES", 2),
                        ("EVAL_EVERY", 2)):
        monkeypatch.setattr(sa, name, value)
    lines = []
    out = sa.main(["2", "2"], device="cpu", side=60, log=lines.append)
    assert json.loads(lines[-1]) == json.loads(json.dumps(out))
    assert set(out) == {"bayes_ceilings", "final", "paper_ordering_image<text<joint",
                        "trained_tower_quantization_delta", "detail"}
    assert set(out["final"]) == {"text_only", "image_frozen_probe", "image_e2e",
                                 "joint_finetune"}
    assert [d["steps"] for d in out["detail"]] == [2, 2, 2, 2]
    assert all(d["final_eval_examples"] == 8 and d["img_s"] > 0 for d in out["detail"])
    assert {"top1_agreement", "max_prob_delta", "mean_prob_delta"} <= \
        set(out["trained_tower_quantization_delta"])
    assert [json.loads(x)["model"] for x in lines[:-1]] == [
        "text_only", "image_frozen_probe", "image_e2e", "joint_finetune"]
