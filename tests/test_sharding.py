"""Multi-device tests on the 8-way virtual CPU mesh (SURVEY.md §4 item 3):
sharded-vs-single-device equivalence of loss/grads, the explicit shard_map
data-parallel step, and multi-scene batched training."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nerf_jax.config import Config
from nerf_jax.data.pipeline import load_scene
from nerf_jax.parallel.dp import make_dp_train_step
from nerf_jax.parallel.mesh import create_mesh, data_sharding, shard_pool
from nerf_jax.parallel.multiscene import make_multiscene_train_step, stack_scenes
from nerf_jax.train.loop import render_settings_from_config
from nerf_jax.train.state import TrainState, create_train_state
from nerf_jax.train.step import make_train_step
from tests.synthetic import make_synthetic_blender_scene


@pytest.fixture(scope="module")
def tiny_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene")
    make_synthetic_blender_scene(str(root), h=16, w=16, num_train=4)
    cfg = Config(
        dataset_path=str(root),
        num_random_rays=64,
        num_samples=8,
        hidden_dim=32,
        pos_encoding_dim=4,
        dir_encoding_dim=2,
        learning_rate=5e-3,
        donate_state=False,
    )
    scene = load_scene(cfg)
    return cfg, scene


def test_eight_virtual_devices():
    assert jax.device_count() == 8


def test_gspmd_step_matches_single_device(tiny_setup):
    """Same step, same keys: GSPMD-sharded batch must reproduce the
    single-device result (allclose; reduction order differs)."""
    cfg, scene = tiny_setup
    settings = render_settings_from_config(cfg)
    mesh = create_mesh("data:8")
    shard = data_sharding(mesh)

    model, tx, state0 = create_train_state(cfg, jax.random.key(0))
    step_single = make_train_step(model, tx, settings, 64, jax.random.key(1),
                                  donate=False)
    step_sharded = make_train_step(model, tx, settings, 64, jax.random.key(1),
                                   data_sharding=shard,
                                   donate=False)
    s1, m1 = step_single(state0, scene.pool)
    s2, m2 = step_sharded(state0, scene.pool)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-5)
    for a, b in zip(
        jax.tree_util.tree_leaves(s1.params), jax.tree_util.tree_leaves(s2.params)
    ):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_dp_shard_map_step_trains(tiny_setup):
    cfg, scene = tiny_setup
    settings = render_settings_from_config(cfg)
    mesh = create_mesh("data:8")
    model, tx, state = create_train_state(cfg, jax.random.key(0))
    pool = shard_pool(scene.pool, mesh)
    step_fn = make_dp_train_step(model, tx, settings, 64, jax.random.key(1),
                                 mesh, donate=False)
    losses = []
    for _ in range(30):
        state, m = step_fn(state, pool)
        losses.append(float(m["mse"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert int(state.step) == 30


def test_dp_grads_match_replicated_average(tiny_setup):
    """The psum-averaged sharded gradient equals the gradient of the same
    global batch computed on one device."""
    cfg, scene = tiny_setup
    settings = render_settings_from_config(cfg)
    mesh = create_mesh("data:8")
    model, tx, state = create_train_state(cfg, jax.random.key(0))
    pool = shard_pool(scene.pool, mesh)
    step_fn = make_dp_train_step(model, tx, settings, 64, jax.random.key(1),
                                 mesh, donate=False)
    state2, m = step_fn(state, pool)

    # the same per-shard body on one device: vmap over the 8 pool shards
    # with the collectives bound to the vmapped axis
    from nerf_jax.parallel.dp import make_dp_grads, make_shard_grads

    body = make_shard_grads(model, settings, 64 // 8, jax.random.key(1))
    shards = jax.tree.map(
        lambda x: np.asarray(x).reshape(8, -1, *x.shape[1:]), pool)
    pair = (state.params, state.fine_params)
    (loss_ref, _), grads_ref = jax.jit(jax.vmap(
        body, in_axes=(None, 0, None), axis_name="data"))(
        pair, shards, state.step)
    np.testing.assert_allclose(float(m["loss"]), float(loss_ref[0]),
                               rtol=1e-5)
    # the gradients themselves, leaf by leaf: Adam's update below is blind
    # to a common scale (an n x mean would pass it)
    _, grads = jax.jit(make_dp_grads(model, settings, 64, jax.random.key(1),
                                     mesh))(pair, pool, state.step)
    for g, r in zip(jax.tree_util.tree_leaves(grads),
                    jax.tree_util.tree_leaves(grads_ref)):
        r = np.asarray(r[0])
        err = np.abs(np.asarray(g) - r).max() / np.abs(r).max()
        assert err < 1e-5, err
    updates, _ = tx.update(jax.tree.map(lambda g: g[0], grads_ref),
                           state.opt_state, (state.params, state.fine_params))
    for a, p, u in zip(jax.tree_util.tree_leaves(state2.params),
                       jax.tree_util.tree_leaves(state.params),
                       jax.tree_util.tree_leaves(updates[0])):
        # Adam's first step divides by |g|: summation-order noise in a
        # near-zero gradient shows in the update at ~1e-6 of lr=5e-3
        np.testing.assert_allclose(np.asarray(a), np.asarray(p + u),
                                   atol=1e-5)
    # params must have moved and be replicated across devices
    moved = any(
        float(jnp.abs(a - b).max()) > 0
        for a, b in zip(
            jax.tree_util.tree_leaves(state.params),
            jax.tree_util.tree_leaves(state2.params),
        )
    )
    assert moved
    leaf = jax.tree_util.tree_leaves(state2.params)[0]
    assert leaf.sharding.is_fully_replicated


def test_multiscene_step(tiny_setup, tmp_path_factory):
    cfg, scene_a = tiny_setup
    root_b = tmp_path_factory.mktemp("scene_b")
    make_synthetic_blender_scene(str(root_b), h=16, w=16, num_train=4,
                                 seed=1)
    cfg_b = dataclasses.replace(cfg, dataset_path=str(root_b))
    scene_b = load_scene(cfg_b)

    settings = render_settings_from_config(cfg)
    mesh = create_mesh("scene:2,data:4")

    model, tx, _ = create_train_state(cfg, jax.random.key(0))
    params = stack_scenes(
        [model.init(jax.random.key(i)) for i in range(2)]
    )
    opt_state = tx.init((params, {}))
    state = TrainState(
        step=jnp.zeros((), jnp.int32), params=params, fine_params={},
        opt_state=opt_state,
    )
    pools = stack_scenes([scene_a.pool, scene_b.pool])

    step_fn = make_multiscene_train_step(
        model, tx, settings, 32, jax.random.key(1), mesh,
        donate=False,
    )
    losses = []
    for _ in range(25):
        state, m = step_fn(state, pools)
        losses.append(np.asarray(m["mse"]))
    losses = np.stack(losses)  # (T, S)
    assert losses.shape[1] == 2
    assert np.isfinite(losses).all()
    # each scene's loss decreases independently
    assert losses[-5:, 0].mean() < losses[:5, 0].mean()
    assert losses[-5:, 1].mean() < losses[:5, 1].mean()


@pytest.mark.parametrize("model_type", ["kilonerf", "plenoxels"])
def test_multiscene_step_new_families(tiny_setup, tmp_path_factory,
                                      model_type):
    """Multi-scene batching is family-generic: the grid/dispatch families
    vmap over the scene axis too (their pure paths; KiloNeRF's grouped
    kernel is explicitly excluded from vmap inside make_multiscene_...)."""
    cfg, scene_a = tiny_setup
    root_b = tmp_path_factory.mktemp(f"scene_b_{model_type}")
    make_synthetic_blender_scene(str(root_b), h=16, w=16, num_train=4,
                                 seed=1)
    cfg = dataclasses.replace(
        cfg, model_type=model_type, hidden_dim=16, grid_res=4,
        pos_encoding_dim=4, dir_encoding_dim=2,
    )
    scene_b = load_scene(dataclasses.replace(cfg, dataset_path=str(root_b)))

    settings = render_settings_from_config(cfg)
    mesh = create_mesh("scene:2,data:4")
    model, tx, _ = create_train_state(cfg, jax.random.key(0))
    params = stack_scenes([model.init(jax.random.key(i)) for i in range(2)])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       fine_params={}, opt_state=tx.init((params, {})))
    pools = stack_scenes([scene_a.pool, scene_b.pool])

    step_fn = make_multiscene_train_step(
        model, tx, settings, 32, jax.random.key(1), mesh,
        donate=False,
    )
    losses = []
    for _ in range(20):
        state, m = step_fn(state, pools)
        losses.append(np.asarray(m["mse"]))
    losses = np.stack(losses)
    assert np.isfinite(losses).all()
    assert losses[-5:].mean() < losses[:5].mean()


def test_fit_multiscene_driver(tiny_setup, tmp_path_factory, tmp_path):
    """End-to-end multi-scene driver: 2 scenes on a scene:2,data:4 mesh."""
    import dataclasses

    from nerf_jax.train.multiscene_loop import fit_multiscene

    cfg, _ = tiny_setup
    root_b = tmp_path_factory.mktemp("scene_c")
    make_synthetic_blender_scene(str(root_b), h=16, w=16, num_train=3,
                                 seed=1)
    cfg = dataclasses.replace(
        cfg, mesh_shape="scene:2,data:4", save_path=str(tmp_path),
        num_random_rays=32, log_interval=10, save_interval=100000,
    )
    state = fit_multiscene(
        cfg, [cfg.dataset_path, str(root_b)], max_steps=12,
        enable_tensorboard=False,
    )
    assert int(state.step) == 12
    leaf = jax.tree_util.tree_leaves(state.params)[0]
    assert leaf.shape[0] == 2  # scene-stacked
    import os
    assert any("multiscene" in n for n in os.listdir(tmp_path))
