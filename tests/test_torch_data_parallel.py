"""One batch served over several devices, on the CPU at depth 0.25 and 139
px: the port's ``data_parallel_server`` / ``joint_data_parallel_server`` and
``build_forward(devices=...)`` split over two runners against the one
runner (bit for bit) and against the JAX package's servers over a 2-device
virtual CPU mesh (``tests/conftest.py`` gives 8 devices)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tumblr_emotions_tpu.data import preprocessing as jpp
from tumblr_emotions_tpu.models.joint_model import DeepSentimentModel as JaxJoint
from tumblr_emotions_tpu.ops import serving as jserving
from tumblr_emotions_tpu.ops.quant import QuantizedInceptionV3 as JaxQuant
from tumblr_emotions_tpu.parallel import create_mesh
from tumblr_emotions_torch import convert, get_preset
from tumblr_emotions_torch.data.preprocessing import preprocess_for_eval
from tumblr_emotions_torch.data.vocab import synthetic_ids
from tumblr_emotions_torch.models import build_model, joint_model
from tumblr_emotions_torch.models.inception_v3 import InceptionV3, init_state
from tumblr_emotions_torch.ops import quant as tq
from tumblr_emotions_torch.ops.serving import (
    build_forward, data_parallel_server, joint_data_parallel_server)
from tumblr_emotions_torch.server import BatchedPredictor

torch.set_num_threads(2)

IMAGE, V, D = 139, 64, 16
# Each package's int8 engine on the reference's scales: the s2d front's
# jitted reference drifts from its own op-by-op run (XLA fuses the dequant
# epilogues of Mixed_7b/7c), the uint8 front does not
# (tests/test_torch_joint.py measures both).
PROB_ATOL = {"uint8": 1e-5, "s2d": 1e-2}


@pytest.fixture(scope="module")
def image_setup():
    c = get_preset("fused_inference")
    cfg = c.replace(image=c.image.replace(image_size=IMAGE, depth_multiplier=0.25))
    state = init_state(InceptionV3(num_classes=15, depth_multiplier=0.25,
                                   create_aux_logits=True, image_size=IMAGE,
                                   device="meta"), seed=7)
    raw = np.random.RandomState(8).randint(0, 256, (4, 160, 200, 3), dtype=np.uint8)
    calib = preprocess_for_eval(torch.from_numpy(raw), IMAGE, IMAGE, dtype=torch.float32)
    return cfg, state, raw, calib


@pytest.fixture(scope="module")
def joint_setup(image_setup):
    _, _, raw, calib = image_setup
    c = get_preset("joint_finetune")        # f32, as the reference's joint model below
    jcfg = c.replace(image=c.image.replace(image_size=IMAGE, depth_multiplier=0.25),
                     text=c.text.replace(vocab_size=V, embed_dim=D, aggregator="mean"))
    state = joint_model.init_state(build_model(jcfg, device="meta"), 7)
    tok = synthetic_ids(np.random.RandomState(9), 4, 12, V)
    return jcfg, state, raw, calib, tok


@pytest.mark.parametrize("engine,front", [("int8", "s2d"), ("int8", "uint8"),
                                          ("int8", "float"), ("bf16", "s2d")])
@pytest.mark.parametrize("model", ["image", "joint"])
def test_two_runner_split_equals_one_runner(image_setup, joint_setup, model, engine, front):
    """``build_forward`` over ``["cpu", "cpu"]`` (two rows each) answers the
    batch bit for bit as the one-device runner does, with one engine (one
    calibration) behind both runners and a captured program each."""
    if model == "image":
        cfg, state, raw, calib = image_setup
        tok = None
    else:
        cfg, state, raw, calib, tok = joint_setup
    one = build_forward(cfg, state, engine=engine, device="cpu", calib_images=calib,
                        front=front)
    two = build_forward(cfg, state, engine=engine, devices=["cpu", "cpu"],
                        calib_images=calib, front=front)
    assert len(two.programs) == 2 and two.programs[0] is not two.programs[1]
    assert two.devices == [torch.device("cpu")] * 2 and two.device == torch.device("cpu")
    a, b = one(raw, tok), two(raw, tok)
    assert type(a) is type(b) and b.shape == (4, 15) and b.device == torch.device("cpu")
    assert torch.equal(a, b)


@pytest.mark.parametrize("front", ["s2d", "uint8"])
def test_data_parallel_server_matches_the_reference_over_two_devices(image_setup, front):
    """The image server over two runners against the reference's
    ``data_parallel_server`` over a 2-device mesh, the reference's scales
    injected into the port's engine."""
    cfg, state, raw, _ = image_setup
    calib = np.asarray(jpp.preprocess_for_eval(jnp.asarray(raw), IMAGE, IMAGE,
                                               dtype=jnp.float32))
    stem = "pre" if front == "s2d" else False
    jeng = JaxQuant(convert.to_variables(state), calib, epilogue="shift", stem_s2d=stem)
    mesh = create_mesh(devices=jax.devices()[:2])
    want_p, want_f = jserving.data_parallel_server(
        jeng, mesh, from_uint8=front == "uint8", image_size=IMAGE)(jnp.asarray(raw))
    eng = tq.QuantizedInceptionV3(state, calib, stem_s2d=stem, device="cpu")
    eng.scales = dict(jeng.scales)
    got_p, got_f = data_parallel_server(eng, ["cpu", "cpu"], from_uint8=front == "uint8",
                                        image_size=IMAGE)(raw)
    assert got_p.shape == (4, 15) and got_f.shape == tuple(want_f.shape)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=0,
                               atol=PROB_ATOL[front])
    np.testing.assert_array_equal(got_p.numpy().argmax(-1), np.asarray(want_p).argmax(-1))


@pytest.mark.parametrize("front", ["s2d", "uint8"])
def test_joint_data_parallel_server_matches_the_reference_over_two_devices(joint_setup,
                                                                            front):
    cfg, state, raw, _, tok = joint_setup
    variables = convert.to_variables(state)
    calib = np.asarray(jpp.preprocess_for_eval(jnp.asarray(raw), IMAGE, IMAGE,
                                               dtype=jnp.float32))
    stem = "pre" if front == "s2d" else False
    tower = {c: variables[c]["InceptionV3"] for c in ("params", "batch_stats")}
    jeng = JaxQuant(tower, calib, epilogue="shift", stem_s2d=stem)
    ref = JaxJoint(vocab_size=V, embed_dim=D, aggregator="mean", depth_multiplier=0.25,
                   precision="highest")
    lengths = (tok != 0).sum(-1).astype(np.int32)
    mesh = create_mesh(devices=jax.devices()[:2])
    want = jserving.joint_data_parallel_server(
        jeng, ref, variables, mesh, from_uint8=front == "uint8", image_size=IMAGE)(
        jnp.asarray(raw), jnp.asarray(tok), jnp.asarray(lengths))
    port = build_model(cfg, device="cpu")
    port.load_state_dict(state)
    eng = tq.QuantizedInceptionV3(joint_model.tower_state(state), calib, stem_s2d=stem,
                                  device="cpu")
    eng.scales = dict(jeng.scales)
    got = joint_data_parallel_server(eng, port, ["cpu", "cpu"], from_uint8=front == "uint8",
                                     image_size=IMAGE)(raw, tok, None)
    assert got.shape == (4, 15) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=PROB_ATOL[front])
    np.testing.assert_array_equal(got.numpy().argmax(-1), np.asarray(want).argmax(-1))


def test_a_batch_that_does_not_split_is_refused(image_setup):
    """Three rows over two devices: refused naming both numbers, as the
    reference's sharding refuses it; the batcher refuses such a batch size
    when it is built."""
    cfg, state, raw, calib = image_setup
    two = build_forward(cfg, state, devices=["cpu", "cpu"], calib_images=calib)
    with pytest.raises(ValueError, match="3 rows does not split over 2 devices"):
        two(raw[:3])
    with pytest.raises(ValueError, match="batch size 3 does not split over the runner's 2"):
        BatchedPredictor(two, 3, host_size=64)
    predictor = BatchedPredictor(two, 4, host_size=64)
    predictor.close()
