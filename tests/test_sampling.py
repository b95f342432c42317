"""Sampling golden tests (SURVEY.md §4: stratified bin edges/deltas per
rendering.py:23-27,54-57; hierarchical inverse-CDF properties)."""

import numpy as np
import jax
import jax.numpy as jnp

from nerf_jax.ops.sampling import (
    deltas_from_t,
    merge_samples,
    normalize_positions,
    sample_pdf,
    sample_positions,
    stratified_sample,
)


def test_stratified_within_bins():
    key = jax.random.key(0)
    near, far, S, R = 2.0, 6.0, 16, 32
    t = np.asarray(stratified_sample(key, near, far, S, R))
    edges = np.linspace(near, far, S + 1)
    assert t.shape == (R, S)
    assert (t >= edges[:-1][None, :]).all()
    assert (t <= edges[1:][None, :]).all()


def test_shared_mode_is_identical_across_rays():
    t = np.asarray(
        stratified_sample(jax.random.key(1), 2.0, 6.0, 8, 5, jitter_mode="shared")
    )
    assert np.ptp(t, axis=0).max() == 0.0


def test_per_ray_mode_differs_across_rays():
    t = np.asarray(
        stratified_sample(jax.random.key(1), 2.0, 6.0, 8, 5, jitter_mode="per_ray")
    )
    assert np.ptp(t, axis=0).max() > 0.0


def test_no_perturb_is_bin_midpoints():
    t = np.asarray(stratified_sample(jax.random.key(0), 0.0, 1.0, 4, 2, perturb=False))
    np.testing.assert_allclose(t[0], [0.125, 0.375, 0.625, 0.875], rtol=1e-6)


def test_deltas_match_reference_law():
    t = jnp.asarray([[1.0, 2.0, 4.0, 7.0]])
    d = np.asarray(deltas_from_t(t))
    np.testing.assert_allclose(d, [[1.0, 2.0, 3.0, 1e10]])


def test_sample_positions_broadcast():
    ro = jnp.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    rd = jnp.asarray([[0.0, 0.0, 1.0], [0.0, 0.0, 2.0]])
    t = jnp.asarray([[1.0, 2.0], [3.0, 4.0]])
    p = np.asarray(sample_positions(ro, rd, t))
    assert p.shape == (2, 2, 3)
    np.testing.assert_allclose(p[0, 1], [1.0, 0.0, 2.0])
    np.testing.assert_allclose(p[1, 0], [0.0, 1.0, 6.0])


def test_normalize_positions_range():
    p = jnp.asarray([[2.0, 4.0, 6.0]])
    np.testing.assert_allclose(
        np.asarray(normalize_positions(p, 2.0, 6.0)), [[-1.0, 0.0, 1.0]]
    )


def test_sample_pdf_deterministic_concentrates_mass():
    # All weight in one bin -> all fine samples land in that bin.
    bins = jnp.broadcast_to(jnp.linspace(0.0, 1.0, 9), (4, 9))
    weights = jnp.zeros((4, 8)).at[:, 3].set(1.0)
    t = np.asarray(sample_pdf(jax.random.key(0), bins, weights, 64,
                              deterministic=True))
    lo, hi = 3 / 8, 4 / 8
    frac_inside = ((t >= lo - 1e-3) & (t <= hi + 1e-3)).mean()
    assert frac_inside > 0.9  # the +1e-5 weight floor leaks the extreme u's


def test_sample_pdf_within_range_and_sorted_merge():
    key = jax.random.key(3)
    bins = jnp.broadcast_to(jnp.linspace(2.0, 6.0, 17), (8, 17))
    weights = jax.random.uniform(key, (8, 16))
    t_fine = sample_pdf(key, bins, weights, 32)
    tf = np.asarray(t_fine)
    assert (tf >= 2.0).all() and (tf <= 6.0).all()
    t_coarse = jnp.broadcast_to(jnp.linspace(2.0, 6.0, 16), (8, 16))
    merged = np.asarray(merge_samples(t_coarse, t_fine))
    assert merged.shape == (8, 48)
    assert (np.diff(merged, axis=-1) >= 0).all()


def test_sample_pdf_uniform_weights_cover_range():
    bins = jnp.broadcast_to(jnp.linspace(0.0, 1.0, 65), (1, 65))
    weights = jnp.ones((1, 64))
    t = np.asarray(
        sample_pdf(jax.random.key(0), bins, weights, 256, deterministic=True)
    )
    # deterministic + uniform -> approximately evenly spaced over [0,1)
    np.testing.assert_allclose(
        t[0], np.linspace(0.0, 1.0 - 1e-5, 256), atol=0.02
    )
