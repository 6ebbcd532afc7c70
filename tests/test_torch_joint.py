"""The port's joint (image+text) model and joint served programs against the
JAX package on the CPU, at depth 0.25 and 139 px.

The same numpy-seeded weights (``joint_model.init_state``, taken to the JAX
tree by ``convert.to_variables``), images and token batches go through
``tumblr_emotions_tpu.models.joint_model.DeepSentimentModel`` /
``ops.serving.joint_data_parallel_server`` (on a one-device CPU mesh) and
the port's ``DeepSentimentModel`` / ``joint_server`` / ``build_forward``,
whose kernel wrappers take their plain versions on CPU tensors."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tumblr_emotions_tpu import config as jconfig
from tumblr_emotions_tpu.data import preprocessing as jpp
from tumblr_emotions_tpu.models.joint_model import DeepSentimentModel as JaxJoint
from tumblr_emotions_tpu.ops import serving as jserving
from tumblr_emotions_tpu.ops.inference import FusedInceptionV3 as JaxFused
from tumblr_emotions_tpu.ops.quant import QuantizedInceptionV3 as JaxQuant
from tumblr_emotions_tpu.parallel import create_mesh
from tumblr_emotions_tpu.train.trainer import build_model as jax_build_model
from tumblr_emotions_torch import convert, get_preset
from tumblr_emotions_torch.data import preprocessing as tpp
from tumblr_emotions_torch.models import build_model, joint_model, text_model
from tumblr_emotions_torch.ops import quant as tq
from tumblr_emotions_torch.ops.inference import FusedInceptionV3
from tumblr_emotions_torch.ops.serving import build_forward, image_server, joint_server

torch.set_num_threads(2)

IMAGE, V, D, H, T = 139, 64, 16, 12, 10
TEXT = dict(vocab_size=V, embed_dim=D, rnn_hidden=H)
# f32 paths: the BASELINE logit budget.
ATOL = 1e-4
# The int8 engine with the reference's scales injected: the heads' mean and
# matmuls run in other summation orders (tests/test_torch_quant.py).
PROB_ATOL = 1e-5
# Each package's int8 engine calibrated by itself (tests/test_torch_serving.py).
INT8_PROB_ATOL = 2e-2
# The s2d front against the reference's jitted server: under jit XLA fuses
# the multiply-add of the dequant epilogues of Mixed_7b/7c, so the jitted
# program's features differ from its own op-by-op run (by 0.12 of a max of
# 6.6 here; every int8 stage through Mixed_7a equal), while the port's match
# the op-by-op run (4.8e-7).  Measured port vs jitted server: 2.2e-3.  The
# uint8 front shows no such drift and is held to PROB_ATOL.
JIT_PROB_ATOL = 1e-2


def _cfg(aggregator="rnn"):
    c = get_preset("joint_finetune")
    return c.replace(image=c.image.replace(image_size=IMAGE, depth_multiplier=0.25),
                     text=c.text.replace(aggregator=aggregator, **TEXT))


def _jax_cfg(aggregator="rnn"):
    c = jconfig.get_preset("joint_finetune")
    return c.replace(image=c.image.replace(image_size=IMAGE, depth_multiplier=0.25),
                     text=c.text.replace(aggregator=aggregator, **TEXT))


def _joint(aggregator, fusion_hidden, seed=7):
    port = joint_model.DeepSentimentModel(
        V, D, aggregator=aggregator, rnn_hidden=H, fusion_hidden=fusion_hidden,
        depth_multiplier=0.25, image_size=IMAGE, device="cpu")
    state = joint_model.init_state(port, seed)
    port.load_state_dict(state)
    ref = JaxJoint(vocab_size=V, embed_dim=D, aggregator=aggregator, rnn_hidden=H,
                   fusion_hidden=fusion_hidden, depth_multiplier=0.25, precision="highest")
    return port, state, ref, convert.to_variables(state)


def _inputs(n=4):
    rng = np.random.RandomState(8)
    raw = rng.randint(0, 256, (n, 160, 200, 3), dtype=np.uint8)
    lengths = np.array([0, T, 3, 6, 1, 8][:n], np.int32)
    tok = rng.randint(2, V, (n, T)).astype(np.int32)
    tok[np.arange(T)[None, :] >= lengths[:, None]] = 0
    return raw, tok, lengths


@pytest.fixture(scope="module")
def rnn_joint():
    """The joint_finetune model (no JointHidden: the config has no such
    field) with the rnn aggregator."""
    return _joint("rnn", 0)


@pytest.mark.parametrize("aggregator,fusion_hidden", [("rnn", 8), ("mean", 0), ("sum", 16)])
def test_fuse_matches_jax(aggregator, fusion_hidden):
    port, _, ref, variables = _joint(aggregator, fusion_hidden, seed=3)
    _, tok, lengths = _inputs()
    feat = np.random.RandomState(2).rand(4, port.InceptionV3.num_features).astype(np.float32)
    for lens in (lengths, None):
        _, want = ref.apply(variables, jnp.asarray(feat), jnp.asarray(tok),
                            None if lens is None else jnp.asarray(lens), method="fuse")
        with torch.no_grad():
            _, got = port.fuse(torch.from_numpy(feat), torch.from_numpy(tok),
                               None if lens is None else torch.from_numpy(lens))
        assert set(got) == set(want)
        for key, w in want.items():
            g = got[key].numpy()
            assert g.shape == w.shape and np.isfinite(g).all(), key
            np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=0, err_msg=key)


def test_f32_forward_matches_jax():
    """The parity engine's model: the f32 slim tower's PreLogits into fuse
    (with JointHidden), with the tower's AuxLogits, against flax at
    precision="highest"."""
    port, _, ref, variables = _joint("rnn", 8)
    raw, tok, lengths = _inputs()
    x = np.array(jpp.preprocess_for_eval(jnp.asarray(raw), IMAGE, IMAGE, dtype=jnp.float32))
    _, want = jax.jit(lambda v, x, t, n: ref.apply(v, x, t, n))(
        variables, x, jnp.asarray(tok), jnp.asarray(lengths))
    with torch.no_grad():
        _, got = port(torch.from_numpy(x), torch.from_numpy(tok), torch.from_numpy(lengths))
    assert set(got) == set(want)
    for key in ("TextFeature", "ImageFeature", "JointHidden", "Logits", "Predictions",
                "AuxLogits"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ATOL,
                                   rtol=ATOL, err_msg=key)


@pytest.mark.parametrize("front", ["s2d", "uint8"])
def test_joint_server_int8_matches_jax(rnn_joint, front):
    """The joint server over the int8 engine, the reference's scales
    injected, against joint_data_parallel_server on one CPU device (the s2d
    front and the all-int8 uint8 front)."""
    port, state, ref, variables = rnn_joint
    raw, tok, lengths = _inputs()
    calib = np.asarray(jpp.preprocess_for_eval(jnp.asarray(raw), IMAGE, IMAGE,
                                               dtype=jnp.float32))
    stem = "pre" if front == "s2d" else False
    tower = {c: variables[c]["InceptionV3"] for c in ("params", "batch_stats")}
    jeng = JaxQuant(tower, calib, epilogue="shift", stem_s2d=stem)
    mesh = create_mesh(devices=jax.devices()[:1])
    want = jserving.joint_data_parallel_server(jeng, ref, variables, mesh,
                                               from_uint8=front == "uint8",
                                               image_size=IMAGE)(
        jnp.asarray(raw), jnp.asarray(tok), jnp.asarray(lengths))
    eng = tq.QuantizedInceptionV3(joint_model.tower_state(state), calib, stem_s2d=stem,
                                  device="cpu")
    eng.scales = dict(jeng.scales)
    got = joint_server(eng, port, device="cpu", from_uint8=front == "uint8",
                       image_size=IMAGE)(raw, tok, lengths)
    assert got.shape == (4, 15) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=PROB_ATOL if front == "uint8" else JIT_PROB_ATOL)
    np.testing.assert_array_equal(got.numpy().argmax(-1), np.asarray(want).argmax(-1))


def _jax_runner(aggregator, variables, engine, calib=None, front="s2d"):
    cfg = _jax_cfg(aggregator)
    model, forward = jax_build_model(cfg)
    return jserving.build_forward(cfg, types.SimpleNamespace(forward=forward, model=model),
                                  variables, create_mesh(devices=jax.devices()[:1]),
                                  engine=engine, calib_images=calib, front=front)


def test_build_forward_joint_int8_and_parity_match_jax(rnn_joint):
    """The default joint program (int8, s2d front) against the JAX
    package's, each engine calibrated by its own package, and the parity
    program (the f32 model) within the f32 budget."""
    _, state, _, variables = rnn_joint
    raw, tok, lengths = _inputs()
    calib = np.asarray(jpp.preprocess_for_eval(jnp.asarray(raw), IMAGE, IMAGE,
                                               dtype=jnp.float32))
    want = np.asarray(_jax_runner("rnn", variables, "int8", calib)(
        jnp.asarray(raw), jnp.asarray(tok), None))
    runner = build_forward(_cfg(), state, device="cpu", calib_images=calib)
    got = runner(raw, tok).numpy()
    assert runner.engine.stem_s2d == "pre" and got.shape == (4, 15)
    np.testing.assert_allclose(got, want, atol=INT8_PROB_ATOL, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    want = np.asarray(_jax_runner("rnn", variables, "parity")(
        jnp.asarray(raw), jnp.asarray(tok), jnp.asarray(lengths)))
    got = build_forward(_cfg(), state, engine="parity", device="cpu")(raw, tok, lengths)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("engine,front", [("int8", "uint8"), ("int8", "float"), ("bf16", "s2d")])
def test_build_forward_joint_fronts(rnn_joint, engine, front):
    """Every other joint engine and front: the runner serves the engine the
    front picks behind joint_server, the same answer as that composition."""
    port, state, _, _ = rnn_joint
    raw, tok, lengths = _inputs()
    calib = tpp.preprocess_for_eval(torch.from_numpy(raw), IMAGE, IMAGE)
    runner = build_forward(_cfg(), state, engine=engine, device="cpu", calib_images=calib,
                           front=front)
    got = runner(raw, tok, lengths)
    if engine == "int8":
        eng = tq.QuantizedInceptionV3(joint_model.tower_state(state), calib, device="cpu")
        assert runner.engine.stem_s2d is False and runner.engine.scales == eng.scales
    else:
        eng = FusedInceptionV3(joint_model.tower_state(state), dtype=torch.bfloat16, use_kernels=False,
                               device="cpu")
    want = joint_server(eng, port, device="cpu", from_uint8=front == "uint8",
                        image_size=IMAGE)(raw, tok, lengths)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_build_forward_uint8_front_falls_back_for_other_resizes(rnn_joint):
    """As in the reference: front="uint8" with a resize other than TF1
    serves the float front (normal layout) feeding the same int8 tower."""
    _, state, _, _ = rnn_joint
    raw, tok, _ = _inputs()
    cfg = _cfg()
    cfg = cfg.replace(data=cfg.data.replace(resize_method="half_pixel"))
    calib = tpp.preprocess_for_eval(torch.from_numpy(raw), IMAGE, IMAGE)
    runner = build_forward(cfg, state, device="cpu", calib_images=calib, front="uint8")
    float_front = build_forward(cfg, state, device="cpu", calib_images=calib, front="float")
    assert runner.engine.stem_s2d is False
    np.testing.assert_array_equal(runner(raw, tok).numpy(), float_front(raw, tok).numpy())


def test_from_uint8_refusals_match_jax(rnn_joint):
    """The three refusals of the reference's _forward, raised by the port's
    servers: an engine without forward_from_uint8, a resize other than TF1,
    an engine built with stem_s2d="pre"."""
    port, state, _, variables = rnn_joint
    raw, tok, _ = _inputs(2)
    calib = tpp.preprocess_for_eval(torch.from_numpy(raw), IMAGE, IMAGE)
    tower = {c: variables[c]["InceptionV3"] for c in ("params", "batch_stats")}
    calib_j = jnp.asarray(calib.numpy())
    cases = [  # (port engine, JAX engine, resize)
        (FusedInceptionV3(joint_model.tower_state(state), device="cpu"), JaxFused(tower), "tf1"),
        (tq.QuantizedInceptionV3(joint_model.tower_state(state), calib, device="cpu"),
         JaxQuant(tower, calib_j), "half_pixel"),
        (tq.QuantizedInceptionV3(joint_model.tower_state(state), calib, stem_s2d="pre", device="cpu"),
         JaxQuant(tower, calib_j, stem_s2d="pre"), "tf1")]
    for eng, jeng, resize in cases:
        with pytest.raises(ValueError):
            jserving._forward(jeng, jnp.asarray(raw), True, jnp.bfloat16, image_size=IMAGE,
                              resize_method=resize)
        with pytest.raises(ValueError):
            image_server(eng, device="cpu", from_uint8=True, image_size=IMAGE,
                         resize_method=resize)
        with pytest.raises(ValueError):
            joint_server(eng, port, device="cpu", from_uint8=True, image_size=IMAGE,
                         resize_method=resize)


@pytest.mark.parametrize("model", ["image", "text", "joint"])
def test_build_forward_serves_every_model(rnn_joint, model):
    """build_forward takes every cfg.model with every engine and front the
    reference takes, and returns a probability row per image."""
    _, state, _, _ = rnn_joint
    raw, tok, _ = _inputs(2)
    cfg = _cfg().replace(model=model)
    if model == "image":
        state = joint_model.tower_state(state)
    elif model == "text":
        state = text_model.init_state(build_model(cfg, device="meta"), 1)
    calib = tpp.preprocess_for_eval(torch.from_numpy(raw), IMAGE, IMAGE)
    for engine, front in [("int8", "s2d"), ("int8", "uint8"), ("int8", "float"),
                          ("bf16", "s2d"), ("parity", "s2d")]:
        p = build_forward(cfg, state, engine=engine, device="cpu", calib_images=calib,
                          front=front)(raw, tok)
        assert p.shape == (2, 15) and torch.isfinite(p).all(), (engine, front)
        np.testing.assert_allclose(p.sum(-1).numpy(), 1.0, atol=1e-5)
    with pytest.raises(ValueError):
        build_forward(cfg.replace(model="audio"), state, device="cpu")


def test_joint_state_has_the_flax_structure_and_round_trips(rnn_joint):
    """The port's joint state (rnn aggregator) as a JAX tree has
    model.init's structure and shapes (the tower under InceptionV3, no text
    heads), and a flax-shaped tree goes flax -> torch -> flax exactly."""
    _, state, ref, variables = rnn_joint
    shapes = jax.eval_shape(lambda: ref.init(jax.random.PRNGKey(0),
                                             jnp.zeros((1, IMAGE, IMAGE, 3)),
                                             jnp.zeros((1, T), jnp.int32)))
    want = jax.tree_util.tree_map(lambda s: s.shape, dict(shapes))
    assert jax.tree_util.tree_map(lambda a: a.shape, variables) == want
    rng = np.random.RandomState(0)
    tree = jax.tree_util.tree_map(lambda s: rng.randn(*s.shape).astype(np.float32),
                                  dict(shapes))
    back = convert.to_variables(convert.to_state(tree))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert state["JointLogits.kernel"].shape == (15, 512 + H)
    assert state["Text.WordEmbedding/embeddings"].shape == (V, D)


def test_joint_entry_points_default_to_the_card(rnn_joint):
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device is valid")
    port, state, _, _ = rnn_joint
    with pytest.raises(RuntimeError, match="cuda"):
        joint_model.DeepSentimentModel(V, D, depth_multiplier=0.25)
    with pytest.raises(RuntimeError, match="cuda"):
        joint_server(FusedInceptionV3(joint_model.tower_state(state), device="cpu"), port)
