"""The port's batch-1 ``Predictor`` (``tumblr_emotions_torch/train/predict.py``)
against the JAX package's on the same weights and JPEG bytes, and the
embedding-file loaders (``data/vocab.py``) against the JAX package's."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tumblr_emotions_tpu import config as jconfig
from tumblr_emotions_tpu.data import vocab as jvocab
from tumblr_emotions_tpu.train.predict import Predictor as JaxPredictor
from tumblr_emotions_torch import EMOTIONS, convert
from tumblr_emotions_torch import config as tconfig
from tumblr_emotions_torch.data import vocab as tvocab
from tumblr_emotions_torch.models import build_model, inception_v3, joint_model, text_model
from tumblr_emotions_torch.train.predict import Predictor

torch.set_num_threads(2)
FIXTURES = Path(__file__).resolve().parent / "data" / "jpeg"
IMAGE, V, D = 139, 120, 16
CAPTIONS = ["so happy today #love", "sad sad rain on the dog", "calm cat"]
# Both run the f32 slim model (or, for the perf text model, the same bf16
# arithmetic) on the same decoded image: within the f32 budget.
PROB_ATOL = 1e-5

CASES = {  # name -> (preset, precision mode)
    "image": ("fused_inference", "parity"),
    "joint": ("joint_finetune", "parity"),
    "text": ("text_only", "parity"),
    "text_perf": ("text_only", "perf"),
}


def _configs(case):
    preset, mode = CASES[case]
    out = []
    for mod in (jconfig, tconfig):
        c = mod.get_preset(preset)
        out.append(c.replace(image=c.image.replace(image_size=IMAGE, depth_multiplier=0.25),
                             text=c.text.replace(vocab_size=V, embed_dim=D),
                             train=c.train.replace(precision_mode=mode)))
    return out


def _state(cfg):
    init = {"image": inception_v3, "text": text_model, "joint": joint_model}[cfg.model]
    return init.init_state(build_model(cfg, device="meta"), 13)


@pytest.mark.parametrize("case", list(CASES))
def test_predictor_matches_the_jax_predictor(case):
    jcfg, cfg = _configs(case)
    state = _state(cfg)
    jv = jvocab.build_vocabulary(CAPTIONS * 2, max_size=V)
    tv = tvocab.build_vocabulary(CAPTIONS * 2, max_size=V)
    ref = JaxPredictor(jcfg, jax.tree_util.tree_map(np.asarray, convert.to_variables(state)),
                       vocab=jv)
    port = Predictor(cfg, state, vocab=tv, device="cpu")
    images = ["baseline_420_403x301.jpg", "progressive_444_49x35.jpg"]
    if cfg.model == "text":
        images = [None, None]
    elif cfg.model == "joint":
        images = images[:1]
    for name, text in zip(images, CAPTIONS):
        data = None if name is None else (FIXTURES / name).read_bytes()
        text = None if cfg.model == "image" else text
        want, got = ref.predict(data, text), port.predict(data, text)
        assert set(got) == set(EMOTIONS)
        vals = list(got.values())
        assert vals == sorted(vals, reverse=True)
        assert max(abs(got[e] - want[e]) for e in EMOTIONS) <= PROB_ATOL
        assert next(iter(got)) == next(iter(want))


def test_predictor_raises_the_reference_errors():
    _, cfg = _configs("joint")
    state = _state(cfg)
    port = Predictor(cfg, state, device="cpu")
    jpg = (FIXTURES / "gray_31x23.jpg").read_bytes()
    with pytest.raises(ValueError, match="needs an image"):
        port.predict(None, "happy")
    with pytest.raises(ValueError, match="needs text"):
        port.predict(jpg, None)
    with pytest.raises(ValueError, match="vocabulary"):
        port.predict(jpg, "happy")
    with pytest.raises(ValueError):
        Predictor(cfg, state, vocab=tvocab.build_vocabulary(CAPTIONS), device="cpu").predict(
            b"\xff\xd8 not a jpeg", "happy")


def test_predictor_builds_the_perf_model_of_a_perf_config():
    cfg = tconfig.get_preset("fused_inference")
    cfg = cfg.replace(image=cfg.image.replace(image_size=IMAGE, depth_multiplier=0.25))
    assert cfg.train.precision_mode == "perf"
    port = Predictor(cfg, _state(cfg), device="cpu")
    assert port.model.dtype == torch.bfloat16
    probs = port.predict((FIXTURES / "odd_420_17x9.jpg").read_bytes())
    assert abs(sum(probs.values()) - 1.0) < 1e-5


def test_predictor_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device is valid")
    _, cfg = _configs("text")
    with pytest.raises(RuntimeError, match="cuda"):
        Predictor(cfg, _state(cfg))


# ---------------------------------------------------------------------------
# Embedding loaders
# ---------------------------------------------------------------------------

WORDS = ["happy", "sad", "dog", "cat", "rain", "love"]


def _vocabs():
    texts = [" ".join(WORDS[:k]) for k in range(1, len(WORDS) + 1)]
    return (tvocab.build_vocabulary(texts, min_freq=1),
            jvocab.build_vocabulary(texts, min_freq=1))


def _vec(rng, d):
    return " ".join(f"{v:.6f}" for v in rng.normal(size=d))


@pytest.mark.parametrize("fmt", ["glove", "word2vec", "npy"])
def test_embedding_loaders_match_jax(tmp_path, fmt):
    tv, jv = _vocabs()
    assert tv.id_to_token == jv.id_to_token
    rng = np.random.RandomState(0)
    dim = 7
    if fmt == "npy":
        path = tmp_path / "emb.npy"
        np.save(path, rng.normal(size=(tv.size, dim)).astype(np.float64))
    else:
        # PAD's own token and an OOV word are in the file: PAD stays zero,
        # the OOV word is skipped; "dog" is missing and keeps its init.
        lines = [f"{w} {_vec(rng, dim)}" for w in WORDS if w != "dog"]
        lines += [f"<pad> {_vec(rng, dim)}", f"zebra {_vec(rng, dim)}"]
        if fmt == "word2vec":
            lines.insert(0, f"{len(lines)} {dim}")
        path = tmp_path / "emb.txt"
        path.write_text("\n".join(lines) + "\n")
    for seed in (0, 3):
        got = tvocab.load_embeddings(str(path), tv, dim, seed=seed)
        want = jvocab.load_embeddings(str(path), jv, dim, seed=seed)
        assert got.dtype == np.float32 and got.shape == (tv.size, dim)
        np.testing.assert_array_equal(got, want)
    if fmt != "npy":
        assert not got[tvocab.PAD_ID].any()
        np.testing.assert_array_equal(
            tvocab.load_glove_embeddings(str(path), tv, dim, seed=1, scale=0.5),
            jvocab.load_glove_embeddings(str(path), jv, dim, seed=1, scale=0.5))


def test_embedding_loaders_raise_the_reference_errors(tmp_path):
    tv, _ = _vocabs()
    text = tmp_path / "emb.txt"
    text.write_text("happy 0.1 0.2 0.3\n")
    with pytest.raises(ValueError, match="embedding dim mismatch: file has 3, want 4"):
        tvocab.load_embeddings(str(text), tv, 4)
    npy = tmp_path / "emb.npy"
    np.save(npy, np.zeros((tv.size + 1, 4)))
    with pytest.raises(ValueError, match=r"embedding matrix \(\d+, 4\) != \(\d+, 4\)"):
        tvocab.load_embeddings(str(npy), tv, 4)
