"""LLFF loader + NDC training tests (BASELINE.json config 3: forward-facing
scene, NDC rays, white background off) on a synthetic LLFF-format scene."""

import numpy as np
import jax
import pytest

from nerf_jax.config import Config
from nerf_jax.data.llff import load_llff
from nerf_jax.data.pipeline import load_scene
from nerf_jax.train.loop import render_settings_from_config
from nerf_jax.train.state import create_train_state
from nerf_jax.train.step import make_train_step
from tests.synthetic import make_synthetic_llff_scene


@pytest.fixture(scope="module")
def llff_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("llff")
    return make_synthetic_llff_scene(str(root), h=24, w=32, num_images=10)


def test_load_llff_structure(llff_dir):
    data = load_llff(llff_dir, factor=1)
    assert data["images"].shape == (10, 24, 32, 3)
    assert data["poses"].shape == (10, 3, 4)
    assert data["bds"].shape == (10, 2)
    assert data["render_poses"].shape[0] == 120
    # holdout: every 8th is test
    assert list(data["i_test"]) == [0, 8]
    assert len(data["i_train"]) == 8
    # recentered: average camera position ~ origin
    assert np.abs(data["poses"][:, :3, 3].mean(0)).max() < 0.5
    # rotations orthonormal
    r = data["poses"][0, :3, :3]
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-5)


def test_load_llff_downsample(llff_dir):
    data = load_llff(llff_dir, factor=2)
    assert data["images"].shape[1:3] == (12, 16)


def test_load_scene_llff_ndc(llff_dir):
    cfg = Config(dataset_path=llff_dir, dataset_type="llff", llff_factor=1,
                 ndc=True)
    scene = load_scene(cfg)
    assert scene.ndc and not scene.white_background
    assert scene.near == 0.0 and scene.far == 1.0
    assert scene.pool.size == 8 * 24 * 32
    # NDC rays: o + d reaches the z=1 plane (infinity)
    o = np.asarray(scene.pool.rays_o)
    d = np.asarray(scene.pool.rays_d)
    np.testing.assert_allclose(o[:, 2] + d[:, 2], 1.0, atol=1e-4)
    # viewdirs stay world-space unit vectors
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(scene.pool.viewdirs), axis=-1), 1.0, atol=1e-5
    )


def test_ndc_training_loss_decreases(llff_dir):
    cfg = Config(
        dataset_path=llff_dir, dataset_type="llff", llff_factor=1, ndc=True,
        num_random_rays=128, num_samples=8, hidden_dim=32, pos_encoding_dim=4,
        dir_encoding_dim=2, learning_rate=5e-3,
        donate_state=False,
    )
    scene = load_scene(cfg)
    import dataclasses

    settings = dataclasses.replace(
        render_settings_from_config(cfg, ndc=True),
        near=scene.near, far=scene.far, white_background=False,
    )
    model, tx, state = create_train_state(cfg, jax.random.key(0))
    step_fn = make_train_step(model, tx, settings, 128, jax.random.key(1),
                              donate=False)
    losses = []
    for _ in range(60):
        state, m = step_fn(state, scene.pool)
        losses.append(float(m["mse"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < 0.7 * np.mean(losses[:5])
