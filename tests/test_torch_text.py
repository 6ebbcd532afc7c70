"""The port's text model, vocabulary and text-only served program against the
JAX package on the CPU.

The same numpy-seeded weights (the port's ``text_model.init_state``, taken
to the JAX tree by ``convert.to_variables``) and token batches go through
``tumblr_emotions_tpu.models.text_model.TextEmotionModel`` and
``tumblr_emotions_torch.models.text_model.TextEmotionModel``: the features
within 1e-5, the logits within the BASELINE 1e-4 budget, NaN where the
reference gives NaN (ids outside [-V, V))."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tumblr_emotions_tpu import config as jconfig
from tumblr_emotions_tpu.data import vocab as jvocab
from tumblr_emotions_tpu.models.text_model import TextEmotionModel as JaxText
from tumblr_emotions_tpu.ops import serving as jserving
from tumblr_emotions_tpu.parallel import create_mesh
from tumblr_emotions_tpu.train.trainer import build_model as jax_build_model
from tumblr_emotions_torch import convert, get_preset
from tumblr_emotions_torch.data import vocab as tvocab
from tumblr_emotions_torch.models import text_model as tm
from tumblr_emotions_torch.ops.serving import build_forward

torch.set_num_threads(2)

V, D, H, T = 64, 16, 12, 10
FEATURE_ATOL = 1e-5
LOGIT_ATOL = 1e-4


def _tokens():
    """[8, T] ids with lengths 0 (all pad), T, and between; row 5 holds an
    id >= V, row 6 an id < -V (NaN rows in the reference), row 7 ids in
    [-V, 0) (they wrap), row 4 an out-of-range id past its length."""
    rng = np.random.RandomState(3)
    lengths = np.array([0, T, 3, 7, 2, 5, 4, 6], np.int32)
    tok = rng.randint(2, V, (8, T)).astype(np.int32)
    tok[np.arange(T)[None, :] >= lengths[:, None]] = 0
    tok[5, 1] = V + 3
    tok[6, 2] = -V - 5
    tok[7, :3] = [-1, -V, -7]
    tok[4, 6] = V + 20
    return tok, lengths


def _models(aggregator, hidden_dim=0, seed=0):
    port = tm.TextEmotionModel(V, D, aggregator=aggregator, rnn_hidden=H,
                               hidden_dim=hidden_dim, device="cpu")
    state = tm.init_state(port, seed)
    port.load_state_dict(state)
    ref = JaxText(vocab_size=V, embed_dim=D, aggregator=aggregator, rnn_hidden=H,
                  hidden_dim=hidden_dim)
    return port, state, ref, convert.to_variables(state)


def _np(t):
    return t.detach().numpy()


@pytest.mark.parametrize("aggregator,hidden_dim", [("mean", 0), ("sum", 0), ("rnn", 0),
                                                   ("mean", 8), ("rnn", 8)])
def test_text_model_matches_jax(aggregator, hidden_dim):
    port, _, ref, variables = _models(aggregator, hidden_dim)
    tok, lengths = _tokens()
    for lens in (lengths, None):   # given, and counted from the non-pad ids
        _, want = ref.apply(variables, jnp.asarray(tok),
                            None if lens is None else jnp.asarray(lens))
        with torch.no_grad():
            _, got = port(torch.from_numpy(tok), None if lens is None else torch.from_numpy(lens))
        for key, atol in (("TextFeature", FEATURE_ATOL), ("Logits", LOGIT_ATOL),
                          ("Predictions", LOGIT_ATOL)):
            w, g = np.asarray(want[key]), _np(got[key])
            assert g.shape == w.shape and g.dtype == np.float32
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=key)
            np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=key)
        if hidden_dim:
            np.testing.assert_allclose(_np(got["TextHidden"]), np.asarray(want["TextHidden"]),
                                       atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("aggregator", ["mean", "sum", "rnn"])
def test_text_feature_rows_and_edges(aggregator):
    """The all-pad row is finite (mean divides by max(length, 1); the LSTM
    gives the reference's carry), the out-of-range ids give NaN rows as in
    the reference, and lengths past T read as the reference reads them."""
    port, _, ref, variables = _models(aggregator, seed=1)
    tok, lengths = _tokens()
    with torch.no_grad():
        feat = _np(port.represent(torch.from_numpy(tok), torch.from_numpy(lengths)))
    assert np.isfinite(feat[[0, 1, 2, 3, 7]]).all()
    assert np.isnan(feat[[5, 6]]).all(axis=1).all()
    # Row 4's bad id lies past its length: the mean/sum mask multiplies the
    # NaN row by 0 (still NaN, as in the reference); the LSTM reads an
    # earlier step.
    assert np.isnan(feat[4]).all() == (aggregator != "rnn")
    if aggregator == "mean":
        np.testing.assert_array_equal(feat[0], 0.0)
    long = np.array([T + 3, T, 0, 1, 2, 0, 0, 0], np.int32)
    want = ref.apply(variables, jnp.asarray(tok), jnp.asarray(long), method="represent")
    with torch.no_grad():
        got = port.represent(torch.from_numpy(tok), torch.from_numpy(long))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=FEATURE_ATOL, rtol=0)


def test_take_fill_matches_jnp_take():
    table = np.random.RandomState(4).randn(V, D).astype(np.float32)
    ids = np.array([[0, V - 1, V, -1, -V, -V - 1, 2 * V, -3 * V]], np.int32)
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(ids), axis=0))
    got = tm.take_fill(torch.from_numpy(table), torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want)


def test_text_state_has_the_flax_structure_and_round_trips():
    """The port's rnn text state, as a JAX tree, has model.init's shapes
    (kernels [in, out], the embedding one leaf with a '/' in its name), and
    flax -> torch -> flax is exact."""
    _, state, ref, variables = _models("rnn", hidden_dim=8)
    shapes = jax.eval_shape(lambda: ref.init(jax.random.PRNGKey(0), jnp.zeros((1, T), jnp.int32)))
    want = jax.tree_util.tree_map(lambda s: s.shape, dict(shapes))
    got = jax.tree_util.tree_map(lambda a: a.shape, {"params": variables["params"]})
    assert got == want
    init = jax.device_get(ref.init(jax.random.PRNGKey(1), jnp.zeros((1, T), jnp.int32)))
    back = convert.to_variables(convert.to_state(init))
    assert jax.tree_util.tree_structure(back["params"]) == jax.tree_util.tree_structure(
        init["params"])
    for a, b in zip(jax.tree_util.tree_leaves(back["params"]),
                    jax.tree_util.tree_leaves(init["params"])):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert state["RNN.OptimizedLSTMCell_0.ii.kernel"].shape == (H, D)


def test_text_model_refuses_what_it_does_not_have():
    with pytest.raises(ValueError):
        tm.TextEmotionModel(V, D, aggregator="max", device="cpu")
    feature_only = tm.TextEmotionModel(V, D, num_classes=0, device="cpu")
    assert feature_only.TextLogits is None and feature_only.feature_dim == D
    with pytest.raises(ValueError):
        feature_only(torch.zeros(1, T, dtype=torch.int32))
    # The bf16 (perf) model, once refused in train mode, trains
    # (tests/test_torch_perf_train.py): its gradients are f32 and finite.
    port = tm.TextEmotionModel(V, D, dtype=torch.bfloat16, device="cpu")
    port.load_state_dict(tm.init_state(port, 0))
    port.train()
    logits, _ = port(torch.ones(1, T, dtype=torch.int32))
    grads = torch.autograd.grad(logits.sum(), list(port.parameters()))
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in grads)


def test_text_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        tm.TextEmotionModel(V, D)


@pytest.mark.parametrize("aggregator", ["mean", "rnn"])
def test_build_forward_text_matches_jax(aggregator):
    """The text-only served program: the port's build_forward against the
    JAX package's (its f32 model under jit on a one-device CPU mesh), for
    every engine name (a text model always runs its f32 model)."""
    text = dict(vocab_size=V, embed_dim=D, aggregator=aggregator, rnn_hidden=H)
    jcfg = jconfig.get_preset("text_only")
    jcfg = jcfg.replace(text=jcfg.text.replace(**text))
    model, forward = jax_build_model(jcfg)
    cfg = get_preset("text_only")
    cfg = cfg.replace(text=cfg.text.replace(**text))
    port = tm.TextEmotionModel(V, D, aggregator=aggregator, rnn_hidden=H, device="cpu")
    state = tm.init_state(port, 5)
    variables = convert.to_variables(state)
    mesh = create_mesh(devices=jax.devices()[:1])
    tok, lengths = _tokens()
    tok, lengths = tok[[0, 1, 2, 3, 7]], lengths[[0, 1, 2, 3, 7]]
    runner = jserving.build_forward(jcfg, types.SimpleNamespace(forward=forward, model=model),
                                    variables, mesh)
    want = np.asarray(runner(None, jnp.asarray(tok), None))
    for engine in ("int8", "bf16", "parity"):
        got = build_forward(cfg, state, engine=engine, device="cpu")(None, tok)
        assert got.shape == (5, 15)
        np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL, rtol=0)
    got = build_forward(cfg, state, device="cpu")(None, tok, lengths)
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL, rtol=0)


TEXTS = ["I am SO happy today!! #love #sunshine", "http://t.co/x sad sad day",
         "Can't wait... excited", "", "happy happy joy", "the pensive calm of rain"]


def test_vocabulary_matches_jax(tmp_path):
    for t in TEXTS:
        assert tvocab.tokenize(t) == jvocab.tokenize(t)
    got, want = tvocab.build_vocabulary(TEXTS, min_freq=1), jvocab.build_vocabulary(TEXTS,
                                                                                 min_freq=1)
    assert got.id_to_token == want.id_to_token and got.token_to_id == want.token_to_id
    assert tvocab.build_vocabulary(TEXTS, max_size=4).id_to_token == \
        jvocab.build_vocabulary(TEXTS, max_size=4).id_to_token
    ids, lens = got.encode_batch(TEXTS, 5)
    wids, wlens = want.encode_batch(TEXTS, 5)
    np.testing.assert_array_equal(ids, wids)
    np.testing.assert_array_equal(lens, wlens)
    assert ids.dtype == wids.dtype and lens.dtype == wlens.dtype
    path = str(tmp_path / "vocab.txt")
    got.save(path)
    assert jvocab.Vocabulary.load(path).id_to_token == got.id_to_token
    assert tvocab.Vocabulary.load(path).id_to_token == got.id_to_token
    (tmp_path / "bad.txt").write_text("a\nb\n")
    with pytest.raises(ValueError):
        tvocab.Vocabulary.load(str(tmp_path / "bad.txt"))
