"""Sharded full-image eval rendering (make_eval_render's mesh mode).

On a multi-device mesh the renderer shard_maps rays across devices with
replicated params. Sharded-vs-unsharded equality for every family, with
padding, is a case of tests/test_families.py. These tests pin, on the
8-way virtual CPU mesh:

  * the same equality for the hierarchical (coarse + fine) render;
  * the trilinear gather path executing under shard_map against the
    unsharded call;
  * fit() on the mesh with validation renders of a grid family.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nerf_jax.config import Config
from nerf_jax.parallel.mesh import create_mesh
from nerf_jax.render.renderer import RenderSettings
from nerf_jax.train.state import create_train_state
from nerf_jax.train.step import make_eval_render


def _rays(n, seed=0):
    rng = np.random.RandomState(seed)
    rays_o = np.zeros((n, 3), np.float32)
    rays_d = rng.normal(size=(n, 3)).astype(np.float32)
    rays_d /= np.linalg.norm(rays_d, axis=-1, keepdims=True)
    return jnp.asarray(rays_o), jnp.asarray(rays_d)


def _render_pair(cfg, settings, n_rays, seed=3):
    """Render the same rays unsharded and on the 8-device mesh."""
    model, _, state = create_train_state(cfg, jax.random.key(seed))
    plain = make_eval_render(model, settings)
    sharded = make_eval_render(model, settings,
                               mesh=create_mesh("data:8"))
    rays_o, rays_d = _rays(n_rays, seed)
    key = jax.random.key(7)
    a = plain(state.params, state.fine_params, rays_o, rays_d, key)
    b = sharded(state.params, state.fine_params, rays_o, rays_d, key)
    return a, b


def test_sharded_eval_hierarchical():
    cfg = Config(num_samples=8, num_fine_samples=8, hidden_dim=32,
                 pos_encoding_dim=4, dir_encoding_dim=2)
    settings = RenderSettings(num_samples=8, num_fine_samples=8,
                              perturb=False, chunk_size=128)
    a, b = _render_pair(cfg, settings, 256)
    np.testing.assert_allclose(np.asarray(a.rgb), np.asarray(b.rgb),
                               atol=1e-5)


def test_grid_kernel_runs_under_shard_map():
    """The trilinear gather (and its custom VJP) executes under manual
    shard_map partitioning with the vma check on, matching the unsharded
    value and grid gradient."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from nerf_jax.ops.interp import trilinear

    mesh = create_mesh("data:8")
    rng = np.random.RandomState(0)
    grid = jnp.asarray(rng.normal(size=(16, 16, 16, 4)).astype(np.float32))

    # 8 shards x 8 rays x 8 samples
    base = rng.uniform(-0.6, 0.6, size=(64, 1, 3)).astype(np.float32)
    pts = np.clip(base + rng.uniform(0, 0.04, size=(64, 8, 3)), -1, 1)
    pts = jnp.asarray(pts.astype(np.float32))

    f = shard_map(
        lambda g, p: trilinear(g, p.reshape(-1, 3)).reshape(p.shape[:-1] + (4,)),
        mesh=mesh, in_specs=(P(), P("data")), out_specs=P("data"),
    )
    got = jax.jit(f)(grid, pts)
    want = trilinear(grid, pts.reshape(-1, 3)).reshape(64, 8, 4)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=1e-5)
    g_got = jax.jit(jax.grad(lambda g: jnp.sum(f(g, pts) ** 2)))(grid)
    g_want = jax.grad(lambda g: jnp.sum(
        trilinear(g, pts.reshape(-1, 3)) ** 2))(grid)
    np.testing.assert_allclose(np.asarray(g_got), np.asarray(g_want),
                               rtol=1e-5, atol=1e-5)


def test_fit_keeps_grid_kernel_for_eval(tmp_path):
    """fit() on the 8-device mesh with a grid family: the GSPMD train step
    and the shard_map'd validation render both run, and a short run
    completes."""
    from tests.synthetic import make_synthetic_blender_scene
    from nerf_jax.train.loop import fit

    root = tmp_path / "scene"
    make_synthetic_blender_scene(str(root), h=16, w=16, num_train=3,
                                 num_val=1)
    cfg = Config(
        dataset_path=str(root), model_type="plenoxels", grid_res=16,
        num_samples=8, num_random_rays=64, num_iters=4, log_interval=2,
        val_interval=2, save_interval=100, learning_rate=1e-2,
        save_path=str(tmp_path / "ckpt"), log_dir=str(tmp_path / "logs"),
        donate_state=False,
    )
    state = fit(cfg, enable_tensorboard=False)
    assert int(state.step) == 4
