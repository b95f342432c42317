"""Strict-parity epoch sampling: one epoch must touch every ray exactly once
(DataLoader shuffle-without-replacement semantics,
/root/reference/train.py:119-121,155-160), implemented as a stateless
Feistel-cipher permutation (nerf_jax/data/pipeline.py::epoch_indices)."""

import numpy as np
import jax
import jax.numpy as jnp

from nerf_jax.data.pipeline import RayPool, _feistel_permute, epoch_indices


def test_feistel_is_exact_permutation():
    for m in (8, 100, 1000, 4097):  # powers of two and awkward sizes
        out = np.asarray(
            _feistel_permute(jax.random.key(0), jnp.arange(m), m)
        )
        assert sorted(out.tolist()) == list(range(m)), m


def test_epoch_touches_every_ray_exactly_once():
    m, b = 1024, 128  # batch divides the pool
    key = jax.random.key(7)
    seen = []
    for step in range(m // b):
        seen.append(np.asarray(epoch_indices(key, jnp.asarray(step), b, m)))
    seen = np.concatenate(seen)
    assert sorted(seen.tolist()) == list(range(m))


def test_epoch_wrap_straddles_into_next_permutation():
    """With a batch size that does not divide the pool, the straddling batch
    finishes the old epoch and starts the new one — every 1000-position
    window still covers every ray exactly once."""
    m, b = 1000, 64
    key = jax.random.key(3)
    steps = -(-2 * m // b)  # enough steps for two full epochs
    all_idx = np.concatenate(
        [np.asarray(epoch_indices(key, jnp.asarray(s), b, m)) for s in range(steps)]
    )
    epoch0, epoch1 = all_idx[:m], all_idx[m : 2 * m]
    assert sorted(epoch0.tolist()) == list(range(m))
    assert sorted(epoch1.tolist()) == list(range(m))
    assert not np.array_equal(epoch0, epoch1)  # epochs reshuffle


def test_batch_larger_than_pool_rejected():
    """A batch spanning 3+ epochs would silently reuse epoch e0+1's cipher;
    the builder refuses instead."""
    import pytest

    with pytest.raises(ValueError, match="batch_size"):
        epoch_indices(jax.random.key(0), jnp.asarray(0), 256, 100)


def test_epochs_differ_and_are_key_dependent():
    m, b = 512, 512
    e0 = np.asarray(epoch_indices(jax.random.key(0), jnp.asarray(0), b, m))
    e1 = np.asarray(epoch_indices(jax.random.key(0), jnp.asarray(1), b, m))
    other = np.asarray(epoch_indices(jax.random.key(9), jnp.asarray(0), b, m))
    assert not np.array_equal(e0, e1)
    assert not np.array_equal(e0, other)


def test_pool_sample_epoch_jits_and_scans():
    m, b = 256, 64
    k = jax.random.key(1)
    ones = jnp.arange(m, dtype=jnp.float32)[:, None].repeat(3, 1)
    pool = RayPool(rays_o=ones, rays_d=ones, rgb=ones, viewdirs=ones)

    @jax.jit
    def batch_ids(step):
        return pool.sample_epoch(k, step, b).rgb[:, 0].astype(jnp.int32)

    seen = np.concatenate(
        [np.asarray(batch_ids(jnp.asarray(s))) for s in range(m // b)]
    )
    assert sorted(seen.tolist()) == list(range(m))


def test_train_step_epoch_sampling_end_to_end(tmp_path):
    """fit-level smoke: the epoch_sampling config trains and changes params."""
    from nerf_jax.config import Config
    from nerf_jax.data.pipeline import load_scene
    from nerf_jax.train.loop import render_settings_from_config
    from nerf_jax.train.state import create_train_state
    from nerf_jax.train.step import make_train_step
    from tests.synthetic import make_synthetic_blender_scene

    root = tmp_path / "scene"
    make_synthetic_blender_scene(str(root), h=12, w=12, num_train=2)
    cfg = Config(
        dataset_path=str(root), num_random_rays=32, num_samples=4,
        hidden_dim=32, pos_encoding_dim=2, dir_encoding_dim=1,
        donate_state=False, epoch_sampling=True,
    )
    scene = load_scene(cfg)
    settings = render_settings_from_config(cfg)
    model, tx, state = create_train_state(cfg, jax.random.key(0))
    step_fn = make_train_step(
        model, tx, settings, cfg.num_random_rays, jax.random.key(1),
        donate=False, epoch_sampling=True,
    )
    losses = []
    for _ in range(20):
        state, metric = step_fn(state, scene.pool)
        losses.append(float(metric["mse"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
