"""The port's int8 serving engine against the JAX package on the CPU.

The same numpy-seeded weights and images go through ``tumblr_emotions_tpu/
ops/quant.py`` (run eagerly, op by op) and ``tumblr_emotions_torch/ops/
quant.py``, whose kernel wrappers take their plain versions on CPU tensors:
the numpy constants are equal, the int8 conv and pool are bit-equal to the
reference's XLA ops (and K1 to its Pallas kernel in interpret mode), and the
whole engine, with the reference's scales injected, gives equal int8
activations at every site."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tumblr_emotions_tpu.data import preprocessing as jpp
from tumblr_emotions_tpu.ops import quant as jq
from tumblr_emotions_tpu.ops import serving as jserving
from tumblr_emotions_tpu.ops.fused_inception import fold_batchnorm as jax_fold
from tumblr_emotions_tpu.ops.pallas_conv import valid_conv3x3_int8_shift as pallas_k1
from tumblr_emotions_torch import convert
from tumblr_emotions_torch.data import preprocessing as tpp
from tumblr_emotions_torch.models.inception_v3 import InceptionV3, init_state
from tumblr_emotions_torch.ops import int8_conv as ic
from tumblr_emotions_torch.ops import int8_pool as ip
from tumblr_emotions_torch.ops import quant as tq
from tumblr_emotions_torch.ops.serving import image_server

torch.set_num_threads(2)

MODEL = dict(num_classes=15, depth_multiplier=0.25, create_aux_logits=True)
IMAGE = 139
# Calibration runs on bf16-rounded operands in both packages, in other
# summation orders; a per-site max |activation| then moves by a few bf16
# rounding steps (measured: at most 0.30% at depth 0.25).
CALIB_RTOL = 0.02
# Sites with a float step (f32 epilogue, pool_act, max-pool rescale,
# stem_in) may land one int8 level apart on at most this share of their
# elements (measured: 0 elements at depth 0.25, 139 px, 4 images, both fronts);
# integer sites (shift epilogue, int32 pre-activations, unscaled max pool)
# must be equal.
FLOAT_SITE_SHARE = 1e-3
# Final probabilities with the reference's scales injected: the heads'
# mean and matmul run in other summation orders (measured: 1.2e-7).
PROB_ATOL = 1e-5


def _np(a):
    return np.asarray(a).astype(np.float32) if np.asarray(a).dtype.kind == "V" \
        or str(np.asarray(a).dtype) == "bfloat16" else np.asarray(a)


@pytest.fixture(scope="module")
def setup():
    state = init_state(InceptionV3(**MODEL, image_size=IMAGE, device="meta"), seed=7)
    variables = convert.to_variables(state)
    raw = np.random.RandomState(8).randint(0, 256, (4, 160, 200, 3), dtype=np.uint8)
    calib = np.asarray(jpp.preprocess_for_eval(jnp.asarray(raw), IMAGE, IMAGE,
                                               dtype=jnp.float32))
    jeng = jq.QuantizedInceptionV3(variables, calib, epilogue="shift", stem_s2d="pre")
    return state, variables, raw, calib, jeng


@pytest.fixture(scope="module")
def port(setup):
    state, _, _, calib, jeng = setup
    eng = tq.QuantizedInceptionV3(state, calib, stem_s2d="pre", device="cpu")
    calibrated = dict(eng.scales)
    eng.scales = dict(jeng.scales)
    return eng, calibrated


# ---------------------------------------------------------------------------
# The numpy half: bit-equal constants
# ---------------------------------------------------------------------------

def test_folded_weights_and_quantization_equal_jax(setup, port):
    _, variables, _, _, jeng = setup
    eng, _ = port
    want = jax_fold(jax.device_get(variables["params"]),
                    jax.device_get(variables["batch_stats"]))
    assert set(eng.folded) == set(want)
    for scope, (w, b) in want.items():
        np.testing.assert_array_equal(eng.folded[scope][0], np.asarray(w))
        np.testing.assert_array_equal(eng.folded[scope][1], np.asarray(b))
    got_q, want_q = tq.quantize_weights(eng.folded), jq.quantize_weights(jeng.folded)
    for scope in want_q:
        for g, w in zip(got_q[scope], want_q[scope]):
            np.testing.assert_array_equal(g, w)
    w_stem = want_q["Conv2d_1a_3x3"][0]
    np.testing.assert_array_equal(tq._s2d_kernel(w_stem), jq._s2d_kernel(w_stem))


@pytest.mark.parametrize("epilogue", ["shift", "f32"])
def test_epilogue_constants_equal_jax(setup, port, epilogue):
    """_weights for every conv site of the tower, as the served forward
    calls it (its input scale and requant target), and for a dequant
    target: w_q, b_i, k, m, bq and the kind chosen, equal."""
    _, _, _, _, jeng = setup
    eng, _ = port
    rops = jq._Int8Ops(jeng.folded, jeng.scales, epilogue=epilogue)
    pops = tq._Int8Ops(eng.folded, eng.scales, "cpu", epilogue=epilogue)
    s_in = jeng.scales["input"]
    chosen = []
    for scope in jeng.folded:
        if scope.startswith(("Logits", "AuxLogits")):
            continue
        for out_key in [k for k in (scope, f"{scope.split('/')[0]}/out") if k in jeng.scales] + [None]:
            w_r, c_r = rops._weights(scope, s_in, out_key)
            w_p, c_p = pops._weights(scope, s_in, out_key)
            np.testing.assert_array_equal(w_p, w_r)
            assert c_p[0] == c_r[0] == pops.epilogue_kinds[scope]
            for a, b in zip(c_p[1:], c_r[1:]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            chosen.append(c_p[0])
    assert len(chosen) > 90 and pops.epilogue_kinds == rops.epilogue_kinds
    assert {"dequant", epilogue} <= set(chosen)


# ---------------------------------------------------------------------------
# The kernels' plain versions against the reference's ops
# ---------------------------------------------------------------------------

def test_valid_conv3x3_int8_shift_equals_pallas_interpret():
    """K1's counterpart against the TPU kernel in interpret mode, at the
    shape of tests/test_fused_inception.py's parity test."""
    rng = np.random.RandomState(0)
    B, H, W, Ci, Co = 2, 19, 17, 16, 32
    x = rng.randint(-127, 128, (B, H, W, Ci)).astype(np.int8)
    w = rng.randint(-127, 128, (3, 3, Ci, Co)).astype(np.int8)
    b = rng.randint(0, 5000, Co).astype(np.int32)
    k = rng.randint(6, 12, Co).astype(np.int32)
    want = np.asarray(pallas_k1(x, w, b, k, interpret=True))
    got = ic.valid_conv3x3_int8_shift(torch.from_numpy(x), torch.from_numpy(w), b, k)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


# (kernel, strides, padding, Cin, Cout, H): every conv form the tower issues.
FORMS = {
    "1x1": ((1, 1), (1, 1), "SAME", 24, 16, 9),
    "3x3_same": ((3, 3), (1, 1), "SAME", 16, 24, 9),
    "3x3_valid": ((3, 3), (1, 1), "VALID", 20, 16, 11),
    "5x5_same": ((5, 5), (1, 1), "SAME", 16, 16, 9),
    "1x3_same": ((1, 3), (1, 1), "SAME", 32, 16, 8),
    "3x1_same": ((3, 1), (1, 1), "SAME", 32, 16, 8),
    "1x7_same": ((1, 7), (1, 1), "SAME", 16, 24, 9),
    "7x1_same": ((7, 1), (1, 1), "SAME", 16, 24, 9),
    "3x3_stride2": ((3, 3), (2, 2), "VALID", 24, 32, 15),
    "stem_float": ((3, 3), (2, 2), "VALID", 3, 16, 21),
}
# Requant targets: a scale that lets "shift" keep the integer epilogue.
SCALES = {"in": 0.02, "out": 0.05}


def _folded(rng, kernel, cin, cout):
    return ((rng.randn(*kernel, cin, cout) * 0.1).astype(np.float32),
            (rng.randn(cout) * 0.05).astype(np.float32))


def _compare(got, want):
    if isinstance(want, tuple):
        assert got[1] == want[1]
        got, want = got[0], want[0]
    np.testing.assert_array_equal(_np(got.float() if got.dtype == torch.bfloat16 else got),
                                  _np(want))


@pytest.mark.parametrize("kind", ["shift", "f32", "dequant"])
@pytest.mark.parametrize("form", list(FORMS))
def test_conv_int8_equals_reference_conv(form, kind):
    kernel, strides, padding, cin, cout, hw = FORMS[form]
    rng = np.random.RandomState(hash(form) % 2**31)
    folded = {"c": _folded(rng, kernel, cin, cout)}
    q = rng.randint(-127 if form == "stem_float" else 0, 128, (2, hw, hw, cin)).astype(np.int8)
    out_key = None if kind == "dequant" else "out"
    epi = "f32" if kind == "f32" else "shift"
    ref = jq._Int8Ops(folded, SCALES, epilogue=epi)
    want = ref.conv((jnp.asarray(q), SCALES["in"]), "c", out_key=out_key,
                    strides=strides, padding=padding)
    ops = tq._Int8Ops(folded, SCALES, "cpu", epilogue=epi)
    got = ops.conv((torch.from_numpy(q), SCALES["in"]), "c", out_key=out_key,
                   strides=strides, padding=padding)
    assert ops.epilogue_kinds == ref.epilogue_kinds == {"c": kind}
    _compare(got, want)


@pytest.mark.parametrize("stem_s2d", [True, "pre"])
@pytest.mark.parametrize("kind", ["shift", "f32"])
def test_conv_s2d_equals_reference(stem_s2d, kind):
    rng = np.random.RandomState(11)
    folded = {"Conv2d_1a_3x3": _folded(rng, (3, 3), 3, 32)}
    q = rng.randint(-127, 128, (2, 31, 31, 3)).astype(np.int8)
    q_in = np.array(jq._space_to_depth_2x2(jnp.asarray(q))) if stem_s2d == "pre" else q
    want = jq._Int8Ops(folded, SCALES, epilogue=kind, stem_s2d=stem_s2d).conv_s2d(
        (jnp.asarray(q_in), SCALES["in"]), "Conv2d_1a_3x3", out_key="out")
    got = tq._Int8Ops(folded, SCALES, "cpu", epilogue=kind, stem_s2d=stem_s2d).conv_s2d(
        (torch.from_numpy(q_in), SCALES["in"]), "Conv2d_1a_3x3", out_key="out")
    assert got[0].shape == (2, 15, 15, 32)
    _compare(got, want)


@pytest.mark.parametrize("epilogue", ["shift", "f32"])
def test_packed_equals_reference(epilogue):
    """One launch, four kinds: requant (shift or f32), dequant and the
    int32 pre-activation of the pool branch; then act and pool_act."""
    rng = np.random.RandomState(12)
    scopes = ["a", "b", "c", "d"]
    folded = {s: _folded(rng, (1, 1), 32, n) for s, n in zip(scopes, (16, 24, 16, 8))}
    scales = dict(SCALES, out2=0.04)
    q = rng.randint(0, 128, (2, 9, 9, 32)).astype(np.int8)
    keys = ["out", None, "out2", "pool"]
    ref = jq._Int8Ops(folded, scales, epilogue=epilogue)
    want = ref.packed((jnp.asarray(q), SCALES["in"]), scopes, out_keys=keys)
    ops = tq._Int8Ops(folded, scales, "cpu", epilogue=epilogue)
    got = ops.packed((torch.from_numpy(q), SCALES["in"]), scopes, out_keys=keys)
    assert ops.epilogue_kinds == ref.epilogue_kinds
    for g, w in zip(got[:3], want[:3]):
        _compare(g, w)
    assert got[3][0] == want[3][0] == "pre"
    np.testing.assert_array_equal(got[3][1].numpy(), np.asarray(want[3][1]))
    for a, b in zip(got[3][2:], want[3][2:]):
        np.testing.assert_array_equal(a, b)
    for key in ("out", None):
        _compare(ops.pool_act(got[3], key), ref.pool_act(want[3], key))
        _compare(ops.act(got[3], key), ref.act(want[3], key))


@pytest.mark.parametrize("shape", [(2, 147, 147, 32), (2, 35, 35, 24), (1, 16, 15, 20)])
@pytest.mark.parametrize("rescale", [None, 0.8125, 1.37])
def test_maxpool_equals_reference(shape, rescale):
    """The pool (plain) against quant._maxpool, the oracle K4a/K4b were
    held to, and _Int8Ops.maxpool's rescale to another scale."""
    q = np.random.RandomState(13).randint(-128, 128, shape).astype(np.int8)
    if rescale is None:
        want = np.asarray(jq._maxpool(jnp.asarray(q)))
        got = ip.maxpool3x3s2_int8(torch.from_numpy(q))
        np.testing.assert_array_equal(got.numpy(), want)
        return
    scales = {"a": 0.03, "b": 0.03 / rescale}
    want = jq._Int8Ops({}, scales).maxpool((jnp.asarray(q), scales["a"]), out_key="b")
    got = tq._Int8Ops({}, scales, "cpu").maxpool((torch.from_numpy(q), scales["a"]),
                                                 out_key="b")
    _compare(got, want)


# ---------------------------------------------------------------------------
# The s2d front and the whole engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,atol", [("float32", 2e-6), ("bfloat16", 0.0)])
def test_preprocess_for_eval_s2d_matches_jax(dtype, atol):
    """Within the ~1 ulp the reference's docstring allows between fronts;
    measured: 1.2e-7 in f32, bit-equal in bf16."""
    u8 = np.random.RandomState(0).randint(0, 256, (2, 347, 341, 3), dtype=np.uint8)
    want = _np(jpp.preprocess_for_eval_s2d(jnp.asarray(u8), dtype=getattr(jnp, dtype)))
    got = tpp.preprocess_for_eval_s2d(torch.from_numpy(u8), dtype=getattr(torch, dtype))
    assert got.shape == (2, 150, 150, 12)
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)
    x = np.random.RandomState(1).randn(2, 7, 9, 3).astype(np.float32)
    np.testing.assert_array_equal(tpp.space_to_depth_2x2(torch.from_numpy(x)).numpy(),
                                  np.asarray(jq._space_to_depth_2x2(jnp.asarray(x))))


def test_calibration_agrees_with_jax(setup, port):
    _, _, _, _, jeng = setup
    _, calibrated = port
    assert set(calibrated) == set(jeng.scales)
    for k, s in jeng.scales.items():
        assert abs(calibrated[k] / s - 1) <= CALIB_RTOL, k


def test_quantile_calibration_agrees_with_jax(setup):
    """calibration_quantile: the quantile of |activation| over the same
    strided subsample, linear interpolation in both packages."""
    state, variables, _, calib, _ = setup
    want = jq.QuantizedInceptionV3(variables, calib, calibration_quantile=0.999).scales
    got = tq.QuantizedInceptionV3(state, calib, calibration_quantile=0.999,
                                  device="cpu").scales
    assert set(got) == set(want)
    for k, s in want.items():
        assert abs(got[k] / s - 1) <= CALIB_RTOL, k


_SITES = ("stem_in", "conv", "conv_s2d", "packed", "pool_act", "maxpool")


def _record(ops):
    """Log every site's output, in call order."""
    log = []
    for name in _SITES:
        fn = getattr(ops, name)

        def rec(*a, _fn=fn, _name=name, **k):
            y = _fn(*a, **k)
            scope = a[1] if len(a) > 1 else k.get("out_key")
            log.append((_name, scope, y))
            return y
        setattr(ops, name, rec)
    return log


def _leaves(y):
    """(array, integer-only?) pairs of one site output."""
    if isinstance(y, list):
        return [leaf for t in y for leaf in _leaves(t)]
    if isinstance(y, tuple) and y[0] == "pre":
        return [(y[1], True)]
    if isinstance(y, tuple):
        return [(y[0], None)]
    return [(y, False)]


@pytest.mark.parametrize("stem_s2d", ["pre", False])
def test_engine_sites_equal_jax(setup, port, stem_s2d):
    """The whole tower with the reference's scales: int8 activations equal
    at every integer site, float sites within FLOAT_SITE_SHARE, and every
    stage output the same."""
    _, _, raw, _, _ = setup
    if stem_s2d == "pre":
        x = _np(jpp.preprocess_for_eval_s2d(jnp.asarray(raw), IMAGE, IMAGE))
    else:
        x = _np(jpp.preprocess_for_eval(jnp.asarray(raw), IMAGE, IMAGE, dtype=jnp.bfloat16))
    _sites_equal(setup, port, stem_s2d, "f32", jnp.asarray(x, jnp.bfloat16),
                 torch.from_numpy(x).to(torch.bfloat16))


@pytest.mark.parametrize("front,pool_mode", [("uint8", "f32"), ("s2d", "int8"),
                                             ("uint8", "int8")])
def test_engine_sites_equal_jax_uint8_front_and_int8_pool(setup, port, front, pool_mode):
    """As above, behind the all-int8 uint8 front (``forward_from_uint8``'s
    input: the reference's and the port's ``preprocess_for_eval_int8``) and
    with ``pool_mode="int8"`` (the pool branch averaged in int8)."""
    _, _, raw, _, jeng = setup
    s_in = jeng.scales["input"]
    if front == "uint8":
        xj = (jq.preprocess_for_eval_int8(jnp.asarray(raw), s_in, IMAGE, IMAGE), s_in)
        xp = (tq.preprocess_for_eval_int8(torch.from_numpy(raw), s_in, IMAGE, IMAGE), s_in)
        stem_s2d = False
    else:
        x = _np(jpp.preprocess_for_eval_s2d(jnp.asarray(raw), IMAGE, IMAGE))
        xj, xp = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
        stem_s2d = "pre"
    _sites_equal(setup, port, stem_s2d, pool_mode, xj, xp)


def _sites_equal(setup, port, stem_s2d, pool_mode, xj, xp):
    _, _, _, _, jeng = setup
    eng, _ = port
    rops = jq._Int8Ops(jeng.folded, jeng.scales, epilogue="shift", stem_s2d=stem_s2d,
                       pool_mode=pool_mode)
    pops = tq._Int8Ops(eng.folded, eng.scales, "cpu", epilogue="shift", stem_s2d=stem_s2d,
                       pool_mode=pool_mode)
    rlog, plog = _record(rops), _record(pops)
    want = jq._tower(rops, xj)
    got = tq._tower(pops, xp)
    assert [s[:2] for s in plog] == [s[:2] for s in rlog] and len(plog) == 80
    kinds = pops.epilogue_kinds
    assert kinds == rops.epilogue_kinds and "shift" in kinds.values()
    float_diff = float_total = 0
    for (name, scope, g), (_, _, w) in zip(plog, rlog):
        glv, wlv = _leaves(g), _leaves(w)
        for i, ((ga, integer), (wa, _)) in enumerate(zip(glv, wlv)):
            ga = ga.float().numpy() if ga.dtype == torch.bfloat16 else ga.numpy()
            wa = _np(wa)
            assert ga.shape == wa.shape, (name, scope)
            if integer is None:   # requantized int8: integer iff the shift epilogue
                key = scope[i] if name == "packed" else scope
                integer = name in ("conv", "conv_s2d", "packed") and kinds.get(key) == "shift" \
                    or name == "maxpool" and scope is None
            if integer:
                np.testing.assert_array_equal(ga, wa, err_msg=f"{name} {scope}")
            else:
                d = np.abs(ga.astype(np.float64) - wa)
                tol = 1.0 if ga.dtype == np.int8 else np.abs(wa) * 2.0 ** -8
                assert (d <= tol).all(), (name, scope)
                float_diff += int((d > 0).sum())
                float_total += d.size
    assert float_diff <= FLOAT_SITE_SHARE * float_total
    np.testing.assert_allclose(got.numpy(), _np(want), atol=0, rtol=0)


def test_served_s2d_program_matches_jax(setup, port):
    """image_server on the int8 engine (s2d front) against the reference's
    _forward + _checked on the same raw batch, scales injected."""
    _, _, raw, _, jeng = setup
    eng, _ = port
    want_p, want_f = jserving._checked(*jserving._forward(
        jeng, jnp.asarray(raw), False, jnp.bfloat16, image_size=IMAGE))
    got_p, got_f = image_server(eng, device="cpu", image_size=IMAGE)(raw)
    assert got_p.shape == (4, 15)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=PROB_ATOL, rtol=0)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), atol=1e-5, rtol=1e-5)
    assert set(eng.last_epilogue_kinds.values()) <= {"shift", "f32", "dequant"}


def test_quantization_delta_against_bf16(setup):
    """The harness on the port: int8 (s2d front) vs the bf16 engine."""
    state, _, _, calib, _ = setup
    d = tq.quantization_delta(state, calib, device="cpu", stem_s2d="pre")
    assert d["top1_agreement"] >= 0.75
    assert d["max_prob_delta"] < 0.1 and d["mean_prob_delta"] < 0.02
    assert 0.0 < d["shift_epilogue_rate"] <= 1.0 and d["f32_fallback_convs"] >= 0


def test_engine_rejects_what_is_not_ported(setup):
    """Every epilogue, pool mode and front of the reference is ported; the
    engine refuses the values it has no meaning for and a float batch on
    the uint8 front."""
    state, _, _, calib, _ = setup
    with pytest.raises(ValueError):
        tq.QuantizedInceptionV3(state, calib, pool_mode="int4", device="cpu")
    with pytest.raises(ValueError):
        tq.QuantizedInceptionV3(state, calib, epilogue="lut", device="cpu")
    eng = tq.QuantizedInceptionV3(state, calib, pool_mode="int8", device="cpu")
    with pytest.raises(ValueError):
        eng.forward_from_uint8(np.zeros((1, 160, 200, 3), np.float32))
    with pytest.raises(ValueError):
        tq.preprocess_for_eval_int8(torch.zeros(160, 200, 3, dtype=torch.uint8), 0.01)


# ---------------------------------------------------------------------------
# The uint8 front and pool_mode="int8"
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("out_size,in_size", [(299, 303), (139, 175), (139, 140), (53, 61),
                                              (17, 40), (299, 150), (64, 64)])
def test_quantized_interp_matrix_equals_jax(out_size, in_size):
    np.testing.assert_array_equal(tq._quantized_interp_matrix(out_size, in_size),
                                  jq._quantized_interp_matrix(out_size, in_size))


# The final int8 of preprocess_for_eval_int8 may land one level apart where
# XLA fuses the reference's z*a + b into an FMA (the port rounds the multiply
# and the add apart); at most FLOAT_SITE_SHARE of the elements.  Measured: 0
# of 231,852 (4x160x200 -> 139), 0 of 536,406 (2x347x347 -> 299), 0 of
# 25,281 (3x97x61 -> 53): bit-equal.
@pytest.mark.parametrize("shape,size,scale", [((4, 160, 200, 3), IMAGE, 0.0081),
                                              ((2, 347, 347, 3), 299, 0.00787),
                                              ((3, 97, 61, 3), 53, 0.0123)])
def test_preprocess_for_eval_int8_matches_jax(shape, size, scale):
    raw = np.random.RandomState(sum(shape)).randint(0, 256, shape, dtype=np.uint8)
    # The row-resized int8 intermediate, by the reference's own steps.
    n, h, w, c = shape
    oh, ow, ch, cw = jpp.central_crop_sizes(h, w, 0.875)
    crop = raw[:, oh:oh + ch, ow:ow + cw]
    x = (jnp.asarray(crop).astype(jnp.int16) - 128).astype(jnp.int8)
    y = jnp.einsum("oh,nhwc->nowc", jnp.asarray(jq._quantized_interp_matrix(size, ch)), x,
                   preferred_element_type=jnp.int32)
    y = jnp.clip(jnp.round(y.astype(jnp.float32) * (1.0 / 127.0)), -127, 127).astype(jnp.int8)
    rows = tq._resize_rows_int8(torch.from_numpy(crop), size)
    assert rows.shape[-1] % 8 == 0 and (rows[..., cw:] == 0).all()
    np.testing.assert_array_equal(rows[..., :cw].permute(0, 1, 3, 2).numpy(), np.asarray(y))
    want = np.asarray(jq.preprocess_for_eval_int8(jnp.asarray(raw), scale, size, size))
    got = tq.preprocess_for_eval_int8(torch.from_numpy(raw), scale, size, size)
    assert got.dtype == torch.int8 and got.shape == want.shape == (n, size, size, c)
    d = np.abs(got.numpy().astype(np.int32) - want)
    assert d.max() <= 1 and (d > 0).mean() <= FLOAT_SITE_SHARE


@pytest.mark.parametrize("shape", [(2, 9, 9, 24), (1, 5, 7, 16)])
def test_pool_act_int8_equals_reference(shape):
    """pool_mode="int8": the pre-activation requantized to int8 at its own
    scale, the 3x3 SAME int32 window sum, the rescale with the per-pixel tap
    count folded in; into a channel slice where given."""
    rng = np.random.RandomState(shape[-1])
    y = rng.randint(-30000, 30000, shape).astype(np.int32)
    m = rng.uniform(1e-4, 2e-3, shape[-1]).astype(np.float32)
    b = (rng.randn(shape[-1]) * 0.5).astype(np.float32)
    scales = {"out": 0.05, "out:poolpre": 0.11}
    want = jq._Int8Ops({}, scales, pool_mode="int8").pool_act(("pre", jnp.asarray(y), m, b),
                                                              "out")
    ops = tq._Int8Ops({}, scales, "cpu", pool_mode="int8")
    got = ops.pool_act(("pre", torch.from_numpy(y), m, b), "out")
    _compare(got, want)
    buf = torch.zeros(*shape[:-1], shape[-1] + 8, dtype=torch.int8)
    got = ops.pool_act(("pre", torch.from_numpy(y), m, b), "out", dst=buf[..., 8:])
    _compare(got, want)
    assert (buf[..., :8] == 0).all() and (buf[..., 8:] == got[0]).all()
    # The last block (out_key None) dequantizes, as with pool_mode="f32".
    _compare(ops.pool_act(("pre", torch.from_numpy(y), m, b), None),
             jq._Int8Ops({}, scales, pool_mode="int8").pool_act(("pre", jnp.asarray(y), m, b),
                                                                None))


def test_served_uint8_program_matches_jax(setup):
    """image_server(from_uint8=True) on the int8 engine against the
    reference's _forward(from_uint8=True) + _checked, scales injected."""
    state, variables, raw, calib, jeng = setup
    jeng_u8 = jq.QuantizedInceptionV3.__new__(jq.QuantizedInceptionV3)
    jeng_u8.__dict__.update(jeng.__dict__, stem_s2d=False)
    want_p, want_f = jserving._checked(*jserving._forward(
        jeng_u8, jnp.asarray(raw), True, jnp.bfloat16, image_size=IMAGE))
    eng = tq.QuantizedInceptionV3(state, calib, device="cpu")
    eng.scales = dict(jeng.scales)
    got_p, got_f = image_server(eng, device="cpu", from_uint8=True, image_size=IMAGE)(raw)
    assert got_p.shape == (4, 15)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=PROB_ATOL, rtol=0)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), atol=1e-5, rtol=1e-5)
