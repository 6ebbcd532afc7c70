"""The port's train distortions against the JAX package's on the CPU.

Random streams cannot match across frameworks, so the JAX draws are made
from the key the JAX trainer hands ``preprocess_for_train`` and fed to the
port's ``apply_train``; the port's own sampler is held to TF's constraints
(hypothesis) and to the JAX sampler's distribution (a KS test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from scipy import stats

from tumblr_emotions_tpu.data import preprocessing as jpp
from tumblr_emotions_torch.data import preprocessing as tpp

torch.set_num_threads(2)

# apply_train with the JAX draws against jpp.preprocess_for_train run op by
# op: both run the same f32 matrix products (the reference at
# Precision.HIGHEST) and elementwise steps, so the outputs in [-1, 1] agree
# to f32 summation order (measured 4.8e-7).
APPLY_TOL = 1e-5
# The jitted reference drifts from its own op-by-op run (XLA fuses the
# colour steps into the resize's epilogue): 2.9e-5 at 139 px.
JIT_TOL = 1e-4
# The KS test of the port's crop sampler against the JAX sampler: the
# p-value below which the two distributions are called different.
KS_LEVEL = 1e-3
KS_DRAWS = 4096


def jax_train_draws(rng_pp, n, image_hw, fast_mode=True) -> tpp.TrainDraws:
    """The draws ``jpp.preprocess_for_train(rng_pp, images, fast_mode=...)``
    makes for ``n`` images of ``image_hw``, re-derived from its key splits
    (``preprocessing.py:463-468, 486, 522-527, 567-577``)."""
    r_crop, r_resize, r_flip, r_color = jax.random.split(rng_pp, 4)
    oy, ox, ch, cw = jax.vmap(lambda k: jpp.distorted_bounding_box_crop(k, image_hw))(
        jax.random.split(r_crop, n))
    flip = jax.random.bernoulli(r_flip, shape=(n,))

    def t(a, dtype=None):
        return torch.from_numpy(np.array(a).reshape(n)).to(dtype)

    crop = (t(oy, torch.long), t(ox, torch.long), t(ch, torch.long), t(cw, torch.long),
            t(flip))
    if fast_mode:
        r_b, r_s, r_o = jax.random.split(r_color, 3)
    else:
        r_b, r_s, r_h, r_c, r_o = jax.random.split(r_color, 5)
    delta = jax.random.uniform(r_b, (n, 1, 1, 1), minval=-32.0 / 255.0, maxval=32.0 / 255.0)
    factor = jax.random.uniform(r_s, (n, 1, 1, 1), minval=0.5, maxval=1.5)
    if fast_mode:
        order = jax.random.bernoulli(r_o, shape=(n, 1, 1, 1))
        return tpp.TrainDraws(*crop, t(delta), t(factor), t(order))
    return tpp.TrainDraws(
        *crop, t(delta), t(factor), torch.zeros(n, dtype=torch.bool),
        resize=t(jax.random.randint(r_resize, (n,), 0, 4), torch.long),
        hue=t(jax.random.uniform(r_h, (n, 1, 1), minval=-0.2, maxval=0.2)),
        contrast=t(jax.random.uniform(r_c, (n, 1, 1, 1), minval=0.5, maxval=1.5)),
        chain=t(jax.random.randint(r_o, (n, 1, 1, 1), 0, 4), torch.long))


def _images(seed, shape, dtype=np.uint8):
    rng = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rng.randint(0, 256, shape).astype(np.uint8)
    return rng.uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("hw,size,method,dtype", [
    ((160, 200), 139, "tf1", np.uint8),
    ((347, 347), 299, "tf1", np.uint8),
    ((120, 90), 75, "half_pixel", np.uint8),
    ((100, 100), 75, "bilinear", np.float32),
])
def test_apply_train_with_jax_draws_matches_preprocess_for_train(hw, size, method, dtype):
    n = 6 if hw[0] < 300 else 2
    raw = _images(1, (n, *hw, 3), dtype)
    # The key the JAX trainer passes at step 3 (trainer.py:301).
    rng_pp, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(7), 3))

    def ref(k, x):
        return jpp.preprocess_for_train(k, x, size, size, resize_method=method)

    got = tpp.apply_train(torch.from_numpy(raw), jax_train_draws(rng_pp, n, hw), size, size,
                          resize_method=method)
    want = np.asarray(ref(rng_pp, raw))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=APPLY_TOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.jit(ref)(rng_pp, raw)),
                               atol=JIT_TOL, rtol=0)


def test_saturate_and_colour_order_match_jax():
    x = _images(2, (5, 9, 11, 3), np.float32) * 1.2 - 0.1
    factor = np.array([0.5, 0.9, 1.0, 1.3, 1.5], np.float32)
    want = np.asarray(jpp._saturate(jnp.asarray(x), jnp.asarray(factor)[:, None, None, None]))
    got = tpp._saturate(torch.from_numpy(x), torch.from_numpy(factor)[:, None, None, None])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-7, rtol=0)


def test_crop_resize_matrix_matches_jax():
    off = np.array([0, 3, 17], np.int32)
    size = np.array([40, 33, 23], np.int32)
    for method in ("tf1", "half_pixel"):
        want = np.asarray(jpp._crop_resize_matrix(29, jnp.asarray(off), jnp.asarray(size), 40,
                                                  method))
        got = tpp._crop_resize_matrix(29, torch.from_numpy(off).long(),
                                      torch.from_numpy(size).long(), 40, method)
        np.testing.assert_array_equal(got.numpy(), want)


def test_flip_reverses_the_output_columns():
    raw = torch.from_numpy(_images(3, (2, 50, 60, 3)))
    g = torch.Generator().manual_seed(0)
    d = tpp.draw_train(g, 2, (50, 60))
    d.flip = torch.tensor([False, False])
    plain = tpp.apply_train(raw, d, 41, 41)
    d.flip = torch.tensor([True, False])
    flipped = tpp.apply_train(raw, d, 41, 41)
    torch.testing.assert_close(flipped[0], plain[0].flip(1), rtol=0, atol=0)
    torch.testing.assert_close(flipped[1], plain[1], rtol=0, atol=0)


def test_preprocess_for_train_draws_from_the_generator():
    raw = torch.from_numpy(_images(4, (3, 64, 80, 3)))
    a = tpp.preprocess_for_train(torch.Generator().manual_seed(5), raw, 47, 47)
    b = tpp.preprocess_for_train(torch.Generator().manual_seed(5), raw, 47, 47)
    c = tpp.preprocess_for_train(torch.Generator().manual_seed(6), raw, 47, 47)
    assert a.shape == (3, 47, 47, 3) and a.min() >= -1 and a.max() <= 1
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    # Full mode draws from the generator too, and distorts otherwise.
    f = tpp.preprocess_for_train(torch.Generator().manual_seed(5), raw, 47, 47, fast_mode=False)
    g = tpp.preprocess_for_train(torch.Generator().manual_seed(5), raw, 47, 47, fast_mode=False)
    assert f.shape == a.shape and f.min() >= -1 and f.max() <= 1
    torch.testing.assert_close(f, g, rtol=0, atol=0)
    assert not torch.equal(f, a)


# ---------------------------------------------------------------------------
# The crop sampler
# ---------------------------------------------------------------------------

def _check_boxes(oy, ox, ch, cw, h, w):
    """TF's constraints on every box, or the whole-image fallback."""
    oy, ox, ch, cw = (v.numpy() for v in (oy, ox, ch, cw))
    area = ch * cw
    whole = (oy == 0) & (ox == 0) & (ch == h) & (cw == w)
    ar = cw / ch
    # the area tests in f32, as TF's sampler makes them
    share = area.astype(np.float32) / np.float32(h * w)
    ok = ((share >= np.float32(0.05)) & (area <= h * w) & (share >= np.float32(0.1))
          & (ch >= 1) & (cw >= 1)
          & (oy >= 0) & (ox >= 0) & (oy + ch <= h) & (ox + cw <= w)
          # the aspect ratio is drawn in [0.75, 1.333] before the width is
          # rounded, so cw/ch can stray by half a pixel's worth
          & (ar >= 0.75 - 0.5 / ch - 1e-6) & (ar <= 1.333 + 0.5 / ch + 1e-6)
          # TF's Uniform(H - h) offset: never the last admissible row
          & ((ch == h) | (oy < h - ch)) & ((cw == w) | (ox < w - cw)))
    bad = ~(ok | whole)
    assert not bad.any(), list(zip(oy[bad], ox[bad], ch[bad], cw[bad]))


@settings(max_examples=40, deadline=None)
@given(h=st.integers(1, 400), w=st.integers(1, 400), seed=st.integers(0, 2 ** 31 - 1))
def test_crop_sampler_obeys_tf_constraints(h, w, seed):
    g = torch.Generator().manual_seed(seed)
    _check_boxes(*tpp.distorted_bounding_box_crop(g, 64, (h, w)), h, w)


@pytest.mark.parametrize("hw", [(347, 347), (160, 200), (40, 300)])
def test_crop_sampler_distribution_matches_jax(hw):
    """Area share and aspect ratio of the port's boxes against the JAX
    sampler's, KS_DRAWS each, two-sample KS at KS_LEVEL."""
    g = torch.Generator().manual_seed(11)
    oy, ox, ch, cw = tpp.distorted_bounding_box_crop(g, KS_DRAWS, hw)
    _check_boxes(oy, ox, ch, cw, *hw)
    keys = jax.random.split(jax.random.PRNGKey(11), KS_DRAWS)
    joy, jox, jch, jcw = (np.asarray(v) for v in jax.jit(jax.vmap(
        lambda k: jpp.distorted_bounding_box_crop(k, hw)))(keys))
    h, w = hw
    port = {"area": (ch * cw).numpy() / (h * w), "aspect": (cw / ch).numpy(),
            "oy": oy.numpy() / h}
    ref = {"area": jch * jcw / (h * w), "aspect": jcw / jch, "oy": joy / h}
    for name in port:
        p = stats.ks_2samp(port[name], ref[name]).pvalue
        assert p > KS_LEVEL, (name, p)
