"""The PyTorch port's weight bridge, BN folding and fused Inception-A/B
blocks against the JAX package, on the CPU.

The JAX blocks run their Pallas kernels in interpret mode, as
tests/test_fused_inception.py runs them; the port's blocks take their plain
versions because the tensors lie on the CPU.  Inputs and weights are made
with numpy and handed to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tumblr_emotions_tpu.models import InceptionV3 as JaxInceptionV3
from tumblr_emotions_tpu.ops import fused_inception as jfi
from tumblr_emotions_torch import convert
from tumblr_emotions_torch.models.inception_v3 import InceptionV3
from tumblr_emotions_torch.ops import fused_inception as tfi

torch.set_num_threads(2)

MODEL = dict(num_classes=7, depth_multiplier=0.25, min_depth=8,
             create_aux_logits=True)
IMAGE = 139

# bf16 blocks: both sides accumulate in f32 and round to bf16 after every
# conv, in another summation order, so an output may sit one bf16 ulp
# (<= 2^-7 of its magnitude) apart and a flipped intermediate moves later
# outputs by less.  Tolerance on max|port - jax| / max|jax|:
BF16_BLOCK_TOL = 2.0 ** -6


@pytest.fixture(scope="module")
def jax_variables():
    """A variable tree with the JAX model's exact structure (from
    eval_shape), filled from a numpy seed: He-scaled weights, random BN
    statistics so that folding is exercised."""
    model = JaxInceptionV3(**MODEL)
    shapes = jax.eval_shape(
        lambda: model.init({"params": jax.random.PRNGKey(0)},
                           jnp.zeros((1, IMAGE, IMAGE, 3)), train=False))
    rng = np.random.RandomState(0)

    def fill(path, s):
        leaf = path[-1].key
        if leaf == "weights":
            return rng.normal(0, np.sqrt(2.0 / np.prod(s.shape[:3])),
                              s.shape).astype(np.float32)
        if leaf in ("moving_mean", "moving_variance"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return rng.normal(0, 0.1, s.shape).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    return jax.tree_util.tree_map(np.asarray, dict(tree))


@pytest.fixture(scope="module")
def folded(jax_variables):
    state = convert.to_state(jax_variables)
    port = tfi.fold_batchnorm(state)
    taps = {s: (tfi._taps(w), b) for s, (w, b) in port.items()}
    ref = jfi.fold_batchnorm(jax_variables["params"], jax_variables["batch_stats"])
    return port, taps, ref


def test_convert_round_trip_is_exact(jax_variables):
    back = convert.to_variables(convert.to_state(jax_variables))
    want = jax.tree_util.tree_leaves_with_path(jax_variables)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))


def test_convert_layouts_and_collections(jax_variables):
    state = convert.to_state(jax_variables)
    p = jax_variables["params"]["Mixed_5b/Branch_1/Conv2d_0b_5x5"]
    w = state["Mixed_5b/Branch_1/Conv2d_0b_5x5.weights"]
    assert p["weights"].shape == (5, 5, 12, 16)          # HWIO
    assert tuple(w.shape) == (16, 12, 5, 5)              # OIHW
    np.testing.assert_array_equal(w.numpy().transpose(2, 3, 1, 0), p["weights"])
    assert "Logits/Conv2d_1c_1x1.biases" in state
    back = convert.to_variables(state)
    assert "moving_mean" in back["batch_stats"]["Conv2d_1a_3x3"]["BatchNorm"]
    assert "beta" in back["params"]["Conv2d_1a_3x3"]["BatchNorm"]


def test_state_loads_into_port_module(jax_variables):
    """The slim scopes, quirks included, are the port's module names."""
    model = InceptionV3(**MODEL, image_size=IMAGE, device="cpu")
    model.load_state_dict(convert.to_state(jax_variables), strict=True)
    names = dict(model.named_parameters())
    assert "Mixed_5c/Branch_1/Conv_1_0c_5x5.weights" in names
    assert "Mixed_6a/Branch_0/Conv2d_1a_1x1.weights" in names
    assert "AuxLogits/Conv2d_2a_1x1.weights" in names
    assert "Conv2d_1a_3x3.BatchNorm.moving_mean" in dict(model.named_buffers())


def test_fold_batchnorm_matches_jax(folded):
    port, _, ref = folded
    assert sorted(port) == sorted(ref)
    for scope, (w, b) in ref.items():
        pw, pb = port[scope]
        np.testing.assert_array_equal(pw.numpy().transpose(2, 3, 1, 0), w, err_msg=scope)
        np.testing.assert_array_equal(pb.numpy(), b, err_msg=scope)


def _block_input(shape, seed):
    return np.maximum(np.random.RandomState(seed).normal(size=shape), 0).astype(np.float32)


BLOCKS = [  # (scope, kind, quirky_5c, input channels at depth 0.25)
    ("Mixed_5b", "a", False, 48),
    ("Mixed_5c", "a", True, 64),
    ("Mixed_5d", "a", False, 72),
    ("Mixed_6b", "b", False, 192),
    ("Mixed_6e", "b", False, 192),
]


def _run_both(folded, scope, kind, quirky, cin, dtype_j, dtype_t, seed):
    _, taps, ref = folded
    x = _block_input((2, 9, 9, cin), seed)
    xj = jnp.asarray(x, dtype_j)
    xt = torch.from_numpy(x).to(dtype_t)
    taps = {s: (w.to(dtype_t), b) for s, (w, b) in taps.items()}
    if kind == "a":
        want = jfi.fused_inception_a(xj, ref, scope, quirky_5c=quirky, interpret=True)
        got = tfi.fused_inception_a(xt, taps, scope, quirky_5c=quirky)
    else:
        want = jfi.fused_inception_b(xj, ref, scope, interpret=True)
        got = tfi.fused_inception_b(xt, taps, scope)
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("scope,kind,quirky,cin", BLOCKS)
def test_block_plain_matches_pallas_f32(folded, scope, kind, quirky, cin):
    got, want = _run_both(folded, scope, kind, quirky, cin, jnp.float32,
                          torch.float32, seed=1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("scope,kind,quirky,cin", [BLOCKS[0], BLOCKS[3]])
def test_block_plain_matches_pallas_bf16(folded, scope, kind, quirky, cin):
    got, want = _run_both(folded, scope, kind, quirky, cin, jnp.bfloat16,
                          torch.bfloat16, seed=2)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= BF16_BLOCK_TOL, err


def test_conv_wrapper_writes_its_channel_slice(folded):
    _, taps, _ = folded
    w, b = taps["Mixed_5b/Branch_2/Conv2d_0b_3x3"]           # [9, 16, 24]
    x = torch.from_numpy(_block_input((2, 9, 9, 40), 3))[..., 8:24]  # a slice
    out = torch.zeros(2, 9, 9, 40)
    y = tfi.conv_same_bias_relu(x, w, b, (3, 3), out=out[..., 8:32])
    want = tfi.conv_same_bias_relu_plain(x.contiguous(), w, b, (3, 3))
    torch.testing.assert_close(out[..., 8:32], want, rtol=0, atol=0)
    assert y.data_ptr() == out[..., 8:32].data_ptr()
    assert out[..., :8].abs().max() == 0 and out[..., 32:].abs().max() == 0
    with pytest.raises(ValueError):
        tfi.conv_same_bias_relu(x, w, b, (1, 3))  # 3 taps, not 9


def test_avg_pool_plain_divides_by_in_image_taps():
    x = torch.ones(1, 4, 5, 3)
    x[0, 0, 0] = 10.0
    y = tfi.avg_pool3_same_plain(x)
    # Corner window holds 4 in-image taps: (10 + 3) / 4.
    assert y[0, 0, 0, 0].item() == pytest.approx(13 / 4)
    assert y[0, 2, 2, 0].item() == pytest.approx(1.0)


def test_wrappers_never_fall_back_off_the_cpu(folded):
    """A tensor off the CPU goes to the kernel or raises; it never takes the
    plain version (here: 'meta' tensors, which no kernel accepts)."""
    _, taps, _ = folded
    w, b = taps["Mixed_5b/Branch_0/Conv2d_0a_1x1"]
    x = torch.empty(2, 9, 9, 48, device="meta", dtype=torch.bfloat16)
    before = (tfi.conv_same_bias_relu.launches, tfi.fused_inception_a.launches)
    with pytest.raises((ValueError, RuntimeError)):
        tfi.conv_same_bias_relu(x, w.to(torch.bfloat16), b, (1, 1))
    with pytest.raises((ValueError, RuntimeError)):       # the pooled form
        tfi.ConvOp([(w.to(torch.bfloat16), b)], (1, 1), pooled=True)(x)
    with pytest.raises((ValueError, RuntimeError)):
        tfi.fused_inception_a(x, taps, "Mixed_5b")
    assert (tfi.conv_same_bias_relu.launches, tfi.fused_inception_a.launches) == before
