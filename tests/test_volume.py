"""Volume compositing golden tests (SURVEY.md §4: exclusive-cumprod
transmittance per rendering.py:120-122; alpha compositing incl white
background per rendering.py:143-151)."""

import numpy as np
import jax.numpy as jnp

from nerf_jax.ops.volume import composite, exclusive_cumprod
from nerf_jax.utils.metrics import mse_to_psnr


def test_exclusive_cumprod_golden():
    x = jnp.asarray([[0.5, 0.5, 0.5], [1.0, 2.0, 3.0]])
    out = np.asarray(exclusive_cumprod(x))
    np.testing.assert_allclose(out, [[1.0, 0.5, 0.25], [1.0, 1.0, 2.0]])


def reference_composite_numpy(colors, densities, deltas, white_background):
    alpha = 1.0 - np.exp(-densities * deltas)
    betas = 1.0 - alpha
    accum = np.cumprod(betas, axis=1)
    trans = np.concatenate([np.ones((alpha.shape[0], 1)), accum[:, :-1]], axis=1)
    weights = trans * alpha
    rgb = (weights[..., None] * colors).sum(axis=1)
    if white_background:
        rgb = rgb + (1.0 - weights.sum(axis=1, keepdims=True))
    return rgb, weights


def test_composite_matches_reference_math():
    rng = np.random.default_rng(0)
    R, S = 6, 12
    colors = rng.uniform(size=(R, S, 3)).astype(np.float64)
    densities = rng.uniform(0, 3, size=(R, S)).astype(np.float64)
    deltas = rng.uniform(0.01, 0.5, size=(R, S)).astype(np.float64)
    for wb in (True, False):
        want_rgb, want_w = reference_composite_numpy(colors, densities, deltas, wb)
        got = composite(
            jnp.asarray(colors, jnp.float32),
            jnp.asarray(densities, jnp.float32),
            jnp.asarray(deltas, jnp.float32),
            white_background=wb,
        )
        np.testing.assert_allclose(np.asarray(got.rgb), want_rgb, atol=1e-5)
        np.testing.assert_allclose(np.asarray(got.weights), want_w, atol=1e-5)


def test_composite_shared_deltas_broadcast():
    # 1-D deltas shared across rays: the reference's layout (rendering.py:56).
    colors = jnp.ones((2, 4, 3)) * 0.5
    densities = jnp.ones((2, 4))
    deltas = jnp.asarray([0.1, 0.1, 0.1, 1e10])
    out = composite(colors, densities, deltas, white_background=True)
    assert out.rgb.shape == (2, 3)
    # opaque far sample -> acc ~ 1 -> no white added beyond composited color
    np.testing.assert_allclose(np.asarray(out.acc), 1.0, atol=1e-5)


def test_empty_ray_is_background():
    colors = jnp.zeros((1, 8, 3))
    densities = jnp.zeros((1, 8))
    deltas = jnp.full((1, 8), 0.5)
    out_white = composite(colors, densities, deltas, white_background=True)
    np.testing.assert_allclose(np.asarray(out_white.rgb), 1.0, atol=1e-6)
    out_black = composite(colors, densities, deltas, white_background=False)
    np.testing.assert_allclose(np.asarray(out_black.rgb), 0.0, atol=1e-6)


def test_depth_of_opaque_wall():
    # A wall at t=2: depth should be ~2.
    S = 64
    t = jnp.broadcast_to(jnp.linspace(0.0, 4.0, S), (1, S))
    densities = jnp.where(t > 2.0, 1e5, 0.0)
    deltas = jnp.full((1, S), 4.0 / S)
    colors = jnp.ones((1, S, 3))
    out = composite(colors, densities, deltas, t=t, white_background=False)
    assert abs(float(out.depth[0]) - 2.0) < 0.1


def test_mse_to_psnr_reference_formula():
    for mse in (0.1, 0.01, 0.004):
        assert abs(mse_to_psnr(mse) - 20 * np.log10(1 / np.sqrt(mse))) < 1e-9
    assert abs(mse_to_psnr(0.01) - 20.0) < 1e-9
