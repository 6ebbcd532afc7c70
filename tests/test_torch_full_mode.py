"""Slim's full-mode train distortions in the port against the JAX package
on the CPU: the per-image resize among four methods, the hue and contrast
chains in four orders, the HSV round trip and the per-image
``distort_color``.

The JAX draws are re-derived from the key the reference's
``preprocess_for_train(fast_mode=False)`` splits (``jax_train_draws``) and
fed to the port's ``apply_train``; the reference runs op by op.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_preprocessing import jax_train_draws
from tumblr_emotions_tpu.data import preprocessing as jpp
from tumblr_emotions_torch.data import preprocessing as tpp

torch.set_num_threads(2)

# Both sides run the same f32 matrix products and elementwise steps, so the
# outputs in [-1, 1] agree to f32 summation order.
FULL_TOL = 1e-5
# The HSV round trip and the matrices are the same f32 operations in the same
# order.
HSV_TOL = 1e-6


def _images(seed, shape, dtype=np.uint8):
    rng = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rng.randint(0, 256, shape).astype(np.uint8)
    return rng.uniform(0, 1, shape).astype(np.float32)


# One image shape for every case: the reference's ops compile once per shape.
@pytest.mark.parametrize("hw,size,method,dtype,seed", [
    ((96, 120), 61, "tf1", np.uint8, 3),
    ((96, 120), 61, "half_pixel", np.uint8, 4),
    ((96, 120), 61, "bilinear", np.float32, 5),
])
def test_full_mode_apply_train_with_jax_draws_matches_the_reference(hw, size, method, dtype,
                                                                     seed):
    n = 16
    raw = _images(seed, (n, *hw, 3), dtype)
    rng_pp = jax.random.PRNGKey(seed)
    draws = jax_train_draws(rng_pp, n, hw, fast_mode=False)
    # Every resize case and every chain order is on the test.
    assert set(draws.resize.tolist()) == {0, 1, 2, 3}
    assert set(draws.chain.tolist()) == {0, 1, 2, 3}
    got = tpp.apply_train(torch.from_numpy(raw), draws, size, size, resize_method=method,
                          fast_mode=False)
    want = np.asarray(jpp.preprocess_for_train(rng_pp, jnp.asarray(raw), size, size,
                                               resize_method=method, fast_mode=False))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=FULL_TOL, rtol=0)
    # Full mode is not fast mode on the same draws.
    fast = tpp.apply_train(torch.from_numpy(raw), draws, size, size, resize_method=method)
    assert np.abs(fast.numpy() - want).max() > 1e-2


@pytest.mark.parametrize("method", ["nearest", "bicubic", "area", "tf1"])
def test_crop_resize_matrix_of_every_method_matches_jax(method):
    off = np.array([0, 3, 17, 5], np.int32)
    size = np.array([40, 33, 23, 12], np.int32)   # down- and upscales
    for out in (29, 17):
        want = np.asarray(jpp._crop_resize_matrix(out, jnp.asarray(off), jnp.asarray(size), 40,
                                                  method))
        got = tpp._crop_resize_matrix(out, torch.from_numpy(off).long(),
                                      torch.from_numpy(size).long(), 40, method)
        np.testing.assert_allclose(got.numpy(), want, atol=HSV_TOL, rtol=0)


def _colours(seed, n=4000):
    """Random colours plus the awkward ones: greys, pure hues, sector edges,
    black and white, saturated and out-of-range values."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    edges = np.array([[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                      [0, 1, 1], [0, 0, 1], [1, 0, 1], [1, 0.5, 0], [0.2, 0.2, 0.7],
                      [0.7, 0.2, 0.2], [1e-7, 0, 0]], np.float32)
    return np.concatenate([x, edges])


def test_hsv_round_trip_matches_jax():
    x = _colours(6)
    hsv_j = np.asarray(jpp.rgb_to_hsv(jnp.asarray(x)))
    hsv_t = tpp.rgb_to_hsv(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(hsv_t, hsv_j, atol=HSV_TOL, rtol=0)
    # hsv_to_rgb over hues that cross every sector, including h >= 1 and < 0
    rng = np.random.RandomState(7)
    hsv = np.stack([rng.uniform(-1.5, 2.5, 4000), rng.uniform(0, 1, 4000),
                    rng.uniform(0, 1, 4000)], -1).astype(np.float32)
    hsv[:12, 0] = np.arange(12, dtype=np.float32) / 6.0   # exact sector starts
    np.testing.assert_allclose(tpp.hsv_to_rgb(torch.from_numpy(hsv)).numpy(),
                               np.asarray(jpp.hsv_to_rgb(jnp.asarray(hsv))), atol=HSV_TOL,
                               rtol=0)
    back = tpp.hsv_to_rgb(torch.from_numpy(hsv_t)).numpy()
    np.testing.assert_allclose(back, x, atol=1e-5, rtol=0)


def test_hue_and_contrast_match_jax():
    x = _images(8, (3, 9, 11, 3), np.float32) * 1.2 - 0.1
    delta = np.array([-0.2, 0.05, 0.19], np.float32)[:, None, None]
    factor = np.array([0.5, 1.0, 1.4], np.float32)[:, None, None, None]
    np.testing.assert_allclose(
        tpp._hue_rotate(torch.from_numpy(x), torch.from_numpy(delta)).numpy(),
        np.asarray(jpp._hue_rotate(jnp.asarray(x), jnp.asarray(delta))), atol=HSV_TOL, rtol=0)
    np.testing.assert_allclose(
        tpp._contrast(torch.from_numpy(x), torch.from_numpy(factor)).numpy(),
        np.asarray(jpp._contrast(jnp.asarray(x), jnp.asarray(factor))), atol=HSV_TOL, rtol=0)


def _order_key(target, n):
    """A key whose ``randint(key, (), 0, n)`` is ``target``."""
    for k in range(1000):
        key = jax.random.PRNGKey(k)
        if int(jax.random.randint(key, (), 0, n)) == target:
            return key
    raise AssertionError(f"no key draws {target}")


@pytest.mark.parametrize("fast_mode,order", [(True, 0), (True, 1), (False, 0), (False, 1),
                                             (False, 2), (False, 3)])
def test_per_image_distort_color_matches_jax(fast_mode, order):
    img = _images(9, (13, 17, 3), np.float32)
    rng = jax.random.PRNGKey(10 + order)
    order_rng = _order_key(order, 2 if fast_mode else 4)
    want = np.asarray(jpp.distort_color(rng, order_rng, jnp.asarray(img), fast_mode=fast_mode))
    # The draws the reference makes from rng (preprocessing.py:643-649).
    r = jax.random.split(rng, 4)
    delta = float(jax.random.uniform(r[0], (), minval=-32.0 / 255.0, maxval=32.0 / 255.0))
    sat = float(jax.random.uniform(r[1], (), minval=0.5, maxval=1.5))
    hue = float(jax.random.uniform(r[2], (), minval=-0.2, maxval=0.2))
    con = float(jax.random.uniform(r[3], (), minval=0.5, maxval=1.5))
    got = tpp.distort_color(torch.from_numpy(img), delta, sat, hue, con, order,
                            fast_mode=fast_mode)
    np.testing.assert_allclose(got.numpy(), want, atol=FULL_TOL, rtol=0)


def test_full_mode_draws():
    g = torch.Generator().manual_seed(11)
    full = tpp.draw_train(g, 400, (60, 80), fast_mode=False)
    fast = tpp.draw_train(torch.Generator().manual_seed(11), 400, (60, 80))
    # The fast draws come first, unchanged.
    for name in ("oy", "ox", "ch", "cw", "flip", "delta", "factor", "order"):
        torch.testing.assert_close(getattr(full, name), getattr(fast, name), rtol=0, atol=0)
    assert fast.resize is None and fast.chain is None
    assert set(full.resize.tolist()) == {0, 1, 2, 3} == set(full.chain.tolist())
    assert -0.2 <= full.hue.min() and full.hue.max() < 0.2
    assert 0.5 <= full.contrast.min() and full.contrast.max() < 1.5
    half = full.rows(slice(0, 200))
    assert half.chain.shape == (200,) and half.hue.shape == (200,)
    with pytest.raises(ValueError, match="full-mode draws"):
        tpp.apply_train(torch.zeros(2, 20, 20, 3, dtype=torch.uint8), fast.rows(slice(0, 2)),
                        9, 9, fast_mode=False)
