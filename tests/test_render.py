"""Renderer integration tests: composition against manual math on fixed
samples, chunked full-image equivalence, hierarchical sampling wiring."""

import numpy as np
import jax
import jax.numpy as jnp

from nerf_jax.models import NeRFModel
from nerf_jax.ops.sampling import deltas_from_t, normalize_positions
from nerf_jax.ops.volume import composite
from nerf_jax.render import RenderSettings, render_image, render_rays


def _toy_rays(n):
    rng = np.random.default_rng(0)
    ro = rng.normal(scale=0.1, size=(n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return jnp.asarray(ro), jnp.asarray(rd)


def test_render_rays_matches_manual_pipeline():
    model = NeRFModel()
    params = model.init(jax.random.key(0))
    ro, rd = _toy_rays(9)
    s = RenderSettings(near=2.0, far=6.0, num_samples=11, perturb=False)
    key = jax.random.key(1)
    out = render_rays(model.apply, params, ro, rd, key, s)

    # manual: midpoint samples (perturb=False)
    edges = np.linspace(2.0, 6.0, 12)
    t = jnp.broadcast_to(
        jnp.asarray((edges[:-1] + edges[1:]) / 2, jnp.float32), (9, 11)
    )
    pts = ro[:, None, :] + t[..., None] * rd[:, None, :]
    pts_n = normalize_positions(pts, 2.0, 6.0)
    dirs = jnp.broadcast_to(rd[:, None, :], pts.shape)
    rgb, sigma = model.apply(params, pts_n, dirs)
    manual = composite(rgb, sigma, deltas_from_t(t), t=t, white_background=True)
    np.testing.assert_allclose(np.asarray(out.rgb), np.asarray(manual.rgb), atol=1e-5)
    np.testing.assert_allclose(np.asarray(out.depth), np.asarray(manual.depth), atol=1e-4)


def test_render_image_equals_render_rays_when_deterministic():
    model = NeRFModel()
    params = model.init(jax.random.key(0))
    ro, rd = _toy_rays(50)
    s = RenderSettings(num_samples=8, perturb=False, chunk_size=16)
    key = jax.random.key(0)
    full = render_rays(model.apply, params, ro, rd, key, s)
    tiled = render_image(model.apply, params, ro, rd, key, s)
    np.testing.assert_allclose(np.asarray(tiled.rgb), np.asarray(full.rgb), atol=1e-5)
    np.testing.assert_allclose(np.asarray(tiled.acc), np.asarray(full.acc), atol=1e-5)


def test_hierarchical_outputs_differ_and_shapes():
    model = NeRFModel()
    params = model.init(jax.random.key(0))
    fine_params = model.init(jax.random.key(1))
    ro, rd = _toy_rays(7)
    s = RenderSettings(num_samples=8, num_fine_samples=16)
    out = render_rays(
        model.apply, params, ro, rd, jax.random.key(2), s, fine_params=fine_params
    )
    assert out.rgb.shape == (7, 3)
    assert out.rgb_coarse.shape == (7, 3)
    assert not np.allclose(np.asarray(out.rgb), np.asarray(out.rgb_coarse))


def test_coarse_only_rgb_equals_rgb_coarse():
    model = NeRFModel()
    params = model.init(jax.random.key(0))
    ro, rd = _toy_rays(5)
    s = RenderSettings(num_samples=8)
    out = render_rays(model.apply, params, ro, rd, jax.random.key(0), s)
    np.testing.assert_array_equal(np.asarray(out.rgb), np.asarray(out.rgb_coarse))


def test_render_is_jittable_and_grads_flow():
    model = NeRFModel()
    params = model.init(jax.random.key(0))
    ro, rd = _toy_rays(6)
    s = RenderSettings(num_samples=8, num_fine_samples=4)

    @jax.jit
    def loss(p):
        out = render_rays(model.apply, p, ro, rd, jax.random.key(0), s)
        return jnp.mean(out.rgb**2)

    g = jax.grad(loss)(params)
    norms = [float(jnp.abs(x).max()) for x in jax.tree_util.tree_leaves(g)]
    assert max(norms) > 0.0
    assert all(np.isfinite(n) for n in norms)


def test_shared_jitter_parity_mode():
    """jitter_mode='shared' reproduces the reference's one-t-vector-per-chunk
    semantics (rendering.py:23-27) for allclose comparisons."""
    model = NeRFModel()
    params = model.init(jax.random.key(0))
    ro = jnp.zeros((4, 3))
    rd = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]]), (4, 1))
    s = RenderSettings(num_samples=8, jitter_mode="shared")
    out = render_rays(model.apply, params, ro, rd, jax.random.key(5), s)
    # identical rays + shared jitter -> identical outputs
    rgb = np.asarray(out.rgb)
    assert np.ptp(rgb, axis=0).max() < 1e-7


def test_resample_fine_mode_close_to_merge():
    """fine_sampling="resample" draws one sorted stratified inverse-CDF set
    (no merge op). It is a different (lower-variance) estimator of the
    same integral — renders must agree closely with the merge mode on a
    smooth field, and exactly sorted t must feed the compositor."""
    from nerf_jax.render.renderer import _fine_t
    from nerf_jax.ops.sampling import stratified_sample

    model = NeRFModel(hidden_dim=32, pos_encoding_dim=2, dir_encoding_dim=1)
    params = model.init(jax.random.key(0))
    fine_params = model.init(jax.random.key(1))
    ro, rd = _toy_rays(64)
    base = dict(near=2.0, far=6.0, num_samples=16, num_fine_samples=32)
    key = jax.random.key(3)

    out_m = render_rays(model.apply, params, ro, rd, key,
                        RenderSettings(**base, fine_sampling="merge"),
                        fine_params=fine_params)
    out_r = render_rays(model.apply, params, ro, rd, key,
                        RenderSettings(**base, fine_sampling="resample"),
                        fine_params=fine_params)
    # same integral, different stratification: close but not bitwise
    np.testing.assert_allclose(np.asarray(out_m.rgb), np.asarray(out_r.rgb),
                               atol=0.06)
    assert not np.array_equal(np.asarray(out_m.rgb), np.asarray(out_r.rgb))

    # the resampled t is sorted by construction (both perturb modes)
    for perturb in (True, False):
        s = RenderSettings(**base, fine_sampling="resample", perturb=perturb)
        t = stratified_sample(key, 2.0, 6.0, 16, 64, perturb=perturb)
        w = jnp.ones((64, 16), jnp.float32)
        t_all = _fine_t(s, key, t, w)
        assert t_all.shape == (64, 48)
        assert bool(jnp.all(t_all[:, 1:] >= t_all[:, :-1]))

    # unknown mode is a clear error
    import pytest

    with pytest.raises(ValueError, match="fine_sampling"):
        _fine_t(RenderSettings(**base, fine_sampling="nope"), key,
                jnp.ones((4, 16)), jnp.ones((4, 16)))


def test_resample_mode_grads_flow():
    model = NeRFModel(hidden_dim=32, pos_encoding_dim=2, dir_encoding_dim=1)
    params = model.init(jax.random.key(0))
    ro, rd = _toy_rays(8)
    s = RenderSettings(near=2.0, far=6.0, num_samples=8, num_fine_samples=8,
                       fine_sampling="resample")

    def loss(p):
        out = render_rays(model.apply, p, ro, rd, jax.random.key(1), s,
                          fine_params=p)
        return jnp.mean(out.rgb ** 2)

    g = jax.jit(jax.grad(loss))(params)
    assert all(np.isfinite(np.asarray(x)).all() for x in jax.tree.leaves(g))
