"""The whole slice on the CPU: the port's served programs.  The bf16 program
``image_server(FusedInceptionV3(..., use_kernels=True))`` (uint8 ->
preprocess -> fused tower -> softmax; the block kernels take their plain
versions on CPU tensors) against the JAX package's ``FusedInceptionV3``
with its Pallas blocks in interpret mode behind ``_checked``; the default
int8 program (``build_forward(engine="int8")``, s2d and float fronts)
against the JAX package's int8 engine behind ``_forward``."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tumblr_emotions_tpu.ops import serving as jserving
from tumblr_emotions_tpu.ops.inference import FusedInceptionV3 as JaxFused
from tumblr_emotions_torch import convert, get_preset
from tumblr_emotions_torch.data.preprocessing import preprocess_for_eval
from tumblr_emotions_torch.models import build_model
from tumblr_emotions_torch.models.inception_v3 import InceptionV3, init_state
from tumblr_emotions_torch.ops.inference import FusedInceptionV3
from tumblr_emotions_torch.ops.serving import build_forward, image_server

torch.set_num_threads(2)

MODEL = dict(num_classes=15, depth_multiplier=0.25, create_aux_logits=True)
IMAGE = 139
# bf16 slice: both programs round to bf16 once after every conv (~30 deep),
# in other summation orders; probabilities of a 15-way softmax then move by
# well under 1e-2, pre-logit features by under 3% of their largest value.
BF16_PROB_ATOL = 1e-2
BF16_FEATURE_TOL = 0.03


@pytest.fixture(scope="module")
def setup():
    port = InceptionV3(**MODEL, image_size=IMAGE, device="meta")
    state = init_state(port, seed=7)
    raw = np.random.RandomState(8).randint(0, 256, (4, 160, 200, 3), dtype=np.uint8)
    return state, convert.to_variables(state), raw


def _jax_served(variables, raw, dtype):
    eng = JaxFused(variables, dtype=dtype, interpret=True)
    probs, feature = jax.jit(lambda r: jserving._checked(*jserving._forward(
        eng, r, False, dtype, image_size=IMAGE)))(jnp.asarray(raw))
    return np.asarray(probs), np.asarray(feature, np.float32)


def _port_served(state, raw, dtype, use_kernels=True):
    eng = FusedInceptionV3(state, dtype=dtype, use_kernels=use_kernels, device="cpu")
    server = image_server(eng, device="cpu", preprocess_dtype=dtype, image_size=IMAGE)
    probs, feature = server(raw)
    return probs.numpy(), feature.float().numpy()


def test_slice_f32_matches_jax(setup):
    state, variables, raw = setup
    want_p, want_f = _jax_served(variables, raw, jnp.float32)
    got_p, got_f = _port_served(state, raw, torch.float32)
    assert got_p.shape == (4, 15) and got_f.shape == want_f.shape
    np.testing.assert_allclose(got_p, want_p, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_f, want_f, atol=1e-4, rtol=1e-4)


def test_slice_bf16_matches_jax(setup):
    state, variables, raw = setup
    want_p, want_f = _jax_served(variables, raw, jnp.bfloat16)
    got_p, got_f = _port_served(state, raw, torch.bfloat16)
    assert np.isfinite(got_p).all()
    np.testing.assert_allclose(got_p.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got_p, want_p, atol=BF16_PROB_ATOL, rtol=0)
    assert np.abs(got_f - want_f).max() <= BF16_FEATURE_TOL * np.abs(want_f).max()
    np.testing.assert_array_equal(got_p.argmax(-1), want_p.argmax(-1))


def _bf16_ulps(got, want):
    """|got - want| in bf16 ulps of the larger magnitude (float32 arrays of
    bf16 values)."""
    m = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(m, 1e-30))) - 7)
    return np.abs(got - want) / ulp


# Elements not bit-equal to the JAX package's bf16 conv, measured on the CPU
# at the inputs below: before the repair (the cuDNN convs ran in bf16, so the
# accumulator was rounded before the f32 bias and again after) 11.5% of the
# stem conv's and 14.3% of the packed 1x1's, up to 66 ulps; after it (f32
# conv of the bf16 values, bias, ReLU, one rounding) 0 of either.  The bound
# leaves room for the summation order of another backend.
ROUNDING_SHARE_MAX = 0.01


@pytest.mark.parametrize("which", ["stem", "packed"])
def test_bf16_convs_round_once_as_jax(setup, which):
    """The bf16 engine's cuDNN-side convs (``_conv``, ``_packed_conv1x1``)
    against ``tumblr_emotions_tpu.ops.inference._conv`` /
    ``_packed_conv1x1`` on the same bf16 input and folded weights."""
    from tumblr_emotions_tpu.ops import inference as jinf

    state, variables, _ = setup
    folded = JaxFused(variables).folded
    eng = FusedInceptionV3(state, dtype=torch.bfloat16, device="cpu")
    rng = np.random.RandomState(3)
    if which == "stem":
        scopes = ["Conv2d_2b_3x3"]
        shape = (2, 35, 35, folded[scopes[0]][0].shape[2])
    else:
        scopes = [f"Mixed_5b/{b}" for b in ("Branch_0/Conv2d_0a_1x1", "Branch_1/Conv2d_0a_1x1",
                                            "Branch_2/Conv2d_0a_1x1", "Branch_3/Conv2d_0b_1x1")]
        shape = (2, 9, 9, folded[scopes[0]][0].shape[2])
    x = torch.from_numpy(np.maximum(rng.standard_normal(shape), 0).astype(np.float32))
    x = x.to(torch.bfloat16)
    xj = jnp.asarray(x.float().numpy())
    if which == "stem":
        want = [jinf._conv(xj, folded, scopes[0], padding="SAME", dtype=jnp.bfloat16)]
        got = [eng._conv(x, scopes[0], padding="SAME")]
    else:   # the pre-activations, as the engine consumes them: ReLU, one rounding
        want = [jnp.maximum(p, 0).astype(jnp.bfloat16)
                for p in jinf._packed_conv1x1(xj, folded, scopes, jnp.bfloat16)]
        got = [torch.relu(p).to(torch.bfloat16) for p in eng._packed_conv1x1(x, scopes)]
    got = np.concatenate([g.float().numpy().ravel() for g in got])
    want = np.concatenate([np.asarray(w.astype(jnp.float32)).ravel() for w in want])
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _bf16_ulps(got, want).max() <= 1.0
    assert (got != want).mean() <= ROUNDING_SHARE_MAX


def test_kernel_and_cudnn_blocks_agree_in_f32(setup):
    """use_kernels=True (the block kernels' plain versions, pool-then-conv)
    and use_kernels=False (packed 1x1s, conv-then-pool) compute one function."""
    state, _, raw = setup
    p1, f1 = _port_served(state, raw, torch.float32, use_kernels=True)
    p2, f2 = _port_served(state, raw, torch.float32, use_kernels=False)
    np.testing.assert_allclose(p1, p2, atol=1e-5, rtol=0)
    np.testing.assert_allclose(f1, f2, atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def cfg():
    c = get_preset("fused_inference")
    return c.replace(image=c.image.replace(image_size=IMAGE, depth_multiplier=0.25))


def test_build_forward_parity_and_bf16_engines(setup, cfg):
    state, _, raw = setup
    # fused_inference is a perf preset (its parity engine is the bf16 slim
    # model: test_build_forward_parity_engine_in_perf_mode_matches_jax); the
    # f32 slim tower is the parity engine of the preset in parity mode.
    f32 = cfg.replace(train=cfg.train.replace(precision_mode="parity"))
    parity = build_forward(f32, state, engine="parity", device="cpu")(raw)
    folded_f32, _ = _port_served(state, raw, torch.float32, use_kernels=False)
    # The slim tower and the BN-folded engine compute one function in f32.
    np.testing.assert_allclose(parity.numpy(), folded_f32, atol=1e-5, rtol=0)
    bf16 = build_forward(cfg, state, engine="bf16", device="cpu")(raw)
    np.testing.assert_allclose(bf16.numpy(), parity.numpy(), atol=BF16_PROB_ATOL, rtol=0)


# The parity engine of a perf preset (fused_inference) is the bf16 slim
# model, as the JAX trainer builds it for precision_mode="perf".  Before the
# repair the port served its f32 model there: 3.46e-3 from the JAX program
# in probability at these inputs (ROADMAP Queue 3).  Now 8.5e-4, which is
# the floor for two bf16 programs here: the port's own bf16 model with its
# convs summed in float64 instead of f32 moves by 1.03e-3 (the summation
# order flips bf16 roundings that ~30 convs then carry).  Measured on the
# CPU, depth 0.25, 139 px, by tests/report_perf_mode.py.
PERF_PROB_ATOL = 2e-3
# f32 builds of one model agree to 3.6e-7 (and with JAX's); a perf build
# that silently stayed f32 would sit that close to the f32 one.
PERF_VS_F32_MIN = 1e-4


@pytest.mark.parametrize("model", ["image", "joint"])
def test_build_forward_parity_engine_in_perf_mode_matches_jax(setup, cfg, model):
    """The image model of fused_inference, and the joint model in the same
    precision mode (the reference's perf joint preset, data_parallel, is
    the training slice's)."""
    from tumblr_emotions_tpu import config as jconfig
    from tumblr_emotions_tpu.train.trainer import build_model as jax_build_model
    from tumblr_emotions_torch.data.vocab import synthetic_ids
    from tumblr_emotions_torch.models import joint_model

    state, variables, raw = setup
    jcfg = jconfig.get_preset("fused_inference")
    jcfg = jcfg.replace(image=jcfg.image.replace(image_size=IMAGE, depth_multiplier=0.25))
    assert cfg.train.precision_mode == jcfg.train.precision_mode == "perf"
    tok = None
    if model == "joint":
        small = dict(vocab_size=200, embed_dim=16)
        jcfg = jcfg.replace(model="joint", text=jcfg.text.replace(**small))
        cfg = cfg.replace(model="joint", text=cfg.text.replace(**small))
        state = joint_model.init_state(build_model(cfg, device="meta"), 7)
        variables = convert.to_variables(state)
        tok = synthetic_ids(np.random.RandomState(9), 4, 12, 200)
    jm, forward = jax_build_model(jcfg)
    want = np.asarray(jserving.build_forward(
        jcfg, types.SimpleNamespace(forward=forward, model=jm), variables, None,
        engine="parity")(jnp.asarray(raw), None if tok is None else jnp.asarray(tok), None))
    got = build_forward(cfg, state, engine="parity", device="cpu")(raw, tok).numpy()
    assert got.shape == (4, 15) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=PERF_PROB_ATOL, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    f32 = build_forward(cfg.replace(train=cfg.train.replace(precision_mode="parity")), state,
                        engine="parity", device="cpu")(raw, tok).numpy()
    assert np.abs(got - f32).max() > PERF_VS_F32_MIN
    port = build_model(cfg, device="cpu")
    port.load_state_dict(state)
    x = preprocess_for_eval(torch.from_numpy(raw), IMAGE, IMAGE)
    logits, ep = port(x) if tok is None else port.InceptionV3(x)
    assert logits.dtype == ep["Mixed_6e"].dtype == torch.bfloat16
    assert ep["PreLogits"].dtype == ep["Predictions"].dtype == torch.float32


# The int8 served program against the reference's, each engine calibrated
# by its own package on the same batch: the scales differ by a few bf16
# rounding steps (tests/test_torch_quant.py), which moves requantized
# values by a level here and there, about 30 convs deep (measured: 6.8e-3
# at most, both fronts; with the scales injected the two agree to 1.2e-7).
INT8_PROB_ATOL = 2e-2


@pytest.mark.parametrize("front", ["s2d", "float"])
def test_build_forward_int8_engine(setup, cfg, front):
    """The default engine: int8, shift epilogues, behind the s2d (default)
    or the float front, against the JAX package's int8 engine served by
    its own ``_forward``."""
    from tumblr_emotions_tpu.data.preprocessing import preprocess_for_eval as jax_pp
    from tumblr_emotions_tpu.ops.quant import QuantizedInceptionV3 as JaxQuant

    state, variables, raw = setup
    calib = np.asarray(jax_pp(jnp.asarray(raw), IMAGE, IMAGE, dtype=jnp.float32))
    kw = {} if front == "s2d" else dict(front=front)
    got = build_forward(cfg, state, device="cpu", calib_images=calib, **kw)(raw).numpy()
    jeng = JaxQuant(variables, calib, epilogue="shift",
                    stem_s2d="pre" if front == "s2d" else False)
    want, _ = jserving._checked(*jserving._forward(
        jeng, jnp.asarray(raw), False, jnp.bfloat16, image_size=IMAGE))
    assert got.shape == (4, 15) and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), atol=INT8_PROB_ATOL, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), np.asarray(want).argmax(-1))


def test_build_forward_rejects_what_is_not_ported(setup, cfg):
    """Every model, engine and front the reference takes is ported (the
    joint and text programs: tests/test_torch_joint.py); what the reference
    refuses, the port refuses."""
    state, _, raw = setup
    with pytest.raises(ValueError):
        build_forward(cfg, state, device="cpu")           # int8 without calib_images
    with pytest.raises(ValueError):
        build_forward(cfg, state, front="jpeg", device="cpu")
    with pytest.raises(ValueError):
        build_forward(cfg, state, engine="fp8", device="cpu")
    with pytest.raises(ValueError):
        build_forward(cfg.replace(model="video"), state, device="cpu")
    calib = np.zeros((1, IMAGE, IMAGE, 3), np.float32)
    runner = build_forward(cfg, state, front="uint8", device="cpu", calib_images=calib)
    assert runner.engine.stem_s2d is False and runner(raw).shape == (4, 15)


def test_server_rejects_non_uint8_batches(setup):
    state, _, raw = setup
    eng = FusedInceptionV3(state, dtype=torch.float32, device="cpu")
    server = image_server(eng, device="cpu", image_size=IMAGE)
    with pytest.raises(ValueError):
        server(raw.astype(np.float32))
    with pytest.raises(ValueError):
        server(raw[0])
