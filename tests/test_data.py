"""Data loader tests on a synthetic Blender-format scene written to disk
(alpha compositing per data.py:46-48; focal per data.py:60; RayPool device
pipeline; NDC ray properties)."""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nerf_jax.data.blender import load_blender
from nerf_jax.data.pipeline import RayPool, build_ray_pool, load_scene
from nerf_jax.data.rays import compute_rays
from nerf_jax.ops.ndc import ndc_rays
from nerf_jax.config import Config
from tests.synthetic import make_synthetic_blender_scene


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene")
    return make_synthetic_blender_scene(str(root), h=24, w=24, num_train=4)


def test_load_blender_shapes_and_focal(scene_dir):
    images, c2w, focal = load_blender(scene_dir, "train")
    assert images.shape == (4, 24, 24, 3)
    assert c2w.shape == (4, 4, 4)
    assert images.dtype == np.float32
    assert images.min() >= 0.0 and images.max() <= 1.0
    want_focal = 0.5 * 24 / np.tan(0.5 * 0.6911112070083618)
    assert abs(focal - want_focal) < 1e-4


def test_white_vs_black_background(scene_dir):
    white, _, _ = load_blender(scene_dir, "train", white_background=True)
    black, _, _ = load_blender(scene_dir, "train", white_background=False)
    # background pixels: 1.0 under white, 0.0 under black
    bg = white[0, 0, 0]
    np.testing.assert_allclose(bg, 1.0, atol=1e-6)
    np.testing.assert_allclose(black[0, 0, 0], 0.0, atol=1e-6)
    # foreground (alpha=1) identical either way
    fg_mask = (np.abs(white - black) < 1e-6).all(-1)
    assert fg_mask.mean() > 0.1


def test_single_image_mode(scene_dir):
    images, c2w, _ = load_blender(scene_dir, "test", single_image=True)
    assert images.shape[0] == 1 and c2w.shape[0] == 1


def test_half_res(scene_dir):
    images, _, focal_full = load_blender(scene_dir, "train")
    half, _, focal_half = load_blender(scene_dir, "train", half_res=True)
    assert half.shape[1:3] == (12, 12)
    assert abs(focal_half - focal_full / 2) < 1e-3


def test_ray_pool_sample(scene_dir):
    images, c2w, focal = load_blender(scene_dir, "train")
    rays_o, rays_d, rgb = compute_rays(images, c2w, focal)
    pool = build_ray_pool(rays_o, rays_d, rgb)
    assert pool.size == 4 * 24 * 24
    batch = pool.sample(jax.random.key(0), 64)
    assert batch.rays_o.shape == (64, 3)
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(batch.viewdirs), axis=-1), 1.0, atol=1e-5
    )
    # two different keys draw different batches
    batch2 = pool.sample(jax.random.key(1), 64)
    assert not np.allclose(np.asarray(batch.rgb), np.asarray(batch2.rgb))


def test_load_scene_blender(scene_dir):
    cfg = Config(dataset_path=scene_dir, near=2.0, far=6.0)
    scene = load_scene(cfg)
    assert scene.pool.size == 4 * 24 * 24
    assert scene.hw == (24, 24)
    assert scene.white_background and not scene.ndc


def test_ndc_rays_land_in_unit_cube():
    # forward-facing camera at origin looking down -z
    rng = np.random.default_rng(0)
    n = 256
    rays_o = np.zeros((n, 3), np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 1.0  # ensure forward
    d[:, :2] *= 0.2                    # mild FOV
    o_ndc, d_ndc = ndc_rays(100, 100, 120.0, 1.0, jnp.asarray(rays_o), jnp.asarray(d))
    o, dd = np.asarray(o_ndc), np.asarray(d_ndc)
    # at t=0 (near plane) z=-1... mapped o_z = 1 + 2*near/oz; check range
    assert np.isfinite(o).all() and np.isfinite(dd).all()
    # endpoint at t=1 reaches z->1 (infinity plane)
    end = o + dd
    np.testing.assert_allclose(end[:, 2], 1.0, atol=1e-4)
    assert (np.abs(o[:, 2]) <= 1.0 + 1e-4).all()


def test_bad_dataset_type():
    with pytest.raises(ValueError, match="Unknown dataset_type"):
        load_scene(Config(dataset_type="shapenet"))
