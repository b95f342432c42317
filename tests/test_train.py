"""Training-step tests: loss decreases on the synthetic scene, checkpoints
round-trip, resume continues bit-identically (SURVEY.md §4 item 4)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nerf_jax.config import Config
from nerf_jax.data.pipeline import load_scene
from nerf_jax.train.loop import render_settings_from_config
from nerf_jax.train.state import create_train_state
from nerf_jax.train.step import make_eval_render, make_train_step
from nerf_jax.utils.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    read_metadata,
    save_checkpoint,
)
from tests.synthetic import make_synthetic_blender_scene


@pytest.fixture(scope="module")
def tiny_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene")
    make_synthetic_blender_scene(str(root), h=20, w=20, num_train=6)
    cfg = Config(
        dataset_path=str(root),
        num_random_rays=128,
        num_samples=8,
        hidden_dim=32,
        pos_encoding_dim=4,
        dir_encoding_dim=2,
        model_type="nerf",
        learning_rate=5e-3,
        donate_state=False,
    )
    scene = load_scene(cfg)
    return cfg, scene


def _train(cfg, scene, steps, state=None, model_tx=None):
    settings = render_settings_from_config(cfg)
    if model_tx is None:
        model, tx, state0 = create_train_state(cfg, jax.random.key(cfg.seed))
        state = state0 if state is None else state
    else:
        model, tx = model_tx
    step_fn = make_train_step(
        model, tx, settings, cfg.num_random_rays, jax.random.key(1),
        donate=False,
    )
    losses = []
    for _ in range(steps):
        state, m = step_fn(state, scene.pool)
        losses.append(float(m["mse"]))
    return (model, tx), state, losses


def test_loss_decreases(tiny_setup):
    cfg, scene = tiny_setup
    _, state, losses = _train(cfg, scene, 60)
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first * 0.7, (first, last)
    assert int(state.step) == 60


def test_metrics_finite_and_psnr_consistent(tiny_setup):
    cfg, scene = tiny_setup
    settings = render_settings_from_config(cfg)
    model, tx, state = create_train_state(cfg, jax.random.key(0))
    step_fn = make_train_step(model, tx, settings, 64, jax.random.key(1),
                              donate=False)
    state, m = step_fn(state, scene.pool)
    mse, psnr = float(m["mse"]), float(m["psnr"])
    assert np.isfinite(mse) and np.isfinite(psnr)
    np.testing.assert_allclose(psnr, -10 * np.log10(mse), rtol=1e-4)


def test_checkpoint_roundtrip_and_resume_identical(tiny_setup, tmp_path):
    cfg, scene = tiny_setup
    model_tx, state20, _ = _train(cfg, scene, 20)

    path = save_checkpoint(state20, str(tmp_path), cfg.model_type, 20)
    meta = read_metadata(path)
    assert meta == {"step": 20, "model_type": "nerf"}
    assert latest_checkpoint(str(tmp_path)) == path

    # continue 10 more steps from live state
    _, state30_live, _ = _train(cfg, scene, 10, state=state20, model_tx=model_tx)

    # restore and continue 10 steps: must be bit-identical (same fold_in keys)
    model, tx, template = create_train_state(cfg, jax.random.key(cfg.seed))
    restored = load_checkpoint(path, template)
    assert int(restored.step) == 20
    _, state30_resumed, _ = _train(cfg, scene, 10, state=restored, model_tx=model_tx)

    for a, b in zip(
        jax.tree_util.tree_leaves(state30_live.params),
        jax.tree_util.tree_leaves(state30_resumed.params),
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_full_image_eval_render(tiny_setup):
    cfg, scene = tiny_setup
    settings = render_settings_from_config(cfg)
    model, tx, state = create_train_state(cfg, jax.random.key(0))
    render = make_eval_render(model, settings)
    from nerf_jax.data.rays import compute_rays

    rays_o, rays_d, _ = compute_rays(
        scene.val_images[:1], scene.val_c2w[:1], scene.focal
    )
    out = render(
        state.params, state.fine_params,
        jnp.asarray(rays_o[0]), jnp.asarray(rays_d[0]), jax.random.key(0),
    )
    img = np.asarray(out.rgb).reshape(*scene.hw, 3)
    assert np.isfinite(img).all()
    assert img.min() >= 0.0 and img.max() <= 1.0 + 1e-5


def test_hierarchical_train_step_runs(tiny_setup):
    cfg, scene = tiny_setup
    import dataclasses

    cfg2 = dataclasses.replace(cfg, num_fine_samples=8, separate_fine_model=True)
    settings = render_settings_from_config(cfg2)
    model, tx, state = create_train_state(cfg2, jax.random.key(0))
    assert state.fine_params  # separate fine model present
    step_fn = make_train_step(model, tx, settings, 64, jax.random.key(1),
                              donate=False)
    before = jax.tree.map(lambda x: x.copy(), state.fine_params)
    state, m = step_fn(state, scene.pool)
    assert np.isfinite(float(m["loss"]))
    changed = any(
        float(jnp.abs(a - b).max()) > 0
        for a, b in zip(
            jax.tree_util.tree_leaves(before),
            jax.tree_util.tree_leaves(state.fine_params),
        )
    )
    assert changed  # fine model receives gradients


def test_fit_with_odd_intervals(tmp_path):
    """The event-aligned chunking must handle intervals that don't divide
    each other (gcd chunking + tail) and still produce checkpoints."""
    import os

    from nerf_jax.train.loop import fit

    root = tmp_path / "scene"
    make_synthetic_blender_scene(str(root), h=16, w=16, num_train=4)
    cfg = Config(
        dataset_path=str(root),
        num_random_rays=64,
        num_samples=4,
        hidden_dim=32,
        pos_encoding_dim=2,
        dir_encoding_dim=1,
        model_type="nerf",
        donate_state=False,
        log_interval=3,
        val_interval=7,
        save_interval=5,
        num_iters=17,
        save_path=str(tmp_path / "models"),
        log_dir=str(tmp_path / "logs"),
    )
    state = fit(cfg, max_steps=17, enable_tensorboard=False)
    assert int(state.step) == 17
    saved = os.listdir(tmp_path / "models")
    assert any("nerf_model_000005" in s for s in saved)  # interval save
    assert any("nerf_model_000017" in s for s in saved)  # final save


def test_scan_hostile_families_dispatch_per_step(tmp_path, monkeypatch):
    """Grid/hash families carry scan_hostile=True and fit()'s auto chunking
    then never builds a multi-step scan (measured ~15% slower for them);
    MLP families keep scan chunks."""
    import nerf_jax.train.loop as loop_mod
    from nerf_jax.train.loop import fit
    from tests.synthetic import make_synthetic_blender_scene

    root = tmp_path / "scene"
    make_synthetic_blender_scene(str(root), h=16, w=16, num_train=2,
                                 num_val=1, num_test=1)
    seen = []
    orig = loop_mod.make_scan_train_step

    def spy(*args, **kw):
        seen.append(kw.get("num_steps"))
        return orig(*args, **kw)

    monkeypatch.setattr(loop_mod, "make_scan_train_step", spy)
    base = dict(
        dataset_path=str(root), num_random_rays=16, num_samples=4,
        log_interval=4, val_interval=1000,
        save_interval=1000, save_path=str(tmp_path / "m"),
        log_dir=str(tmp_path / "l"), learning_rate=0.01,
    )
    fit(Config(model_type="plenoxels", grid_res=4, **base),
        max_steps=8, enable_tensorboard=False)
    assert seen == [], f"plenoxels must not scan, got chunks {seen}"

    fit(Config(model_type="nerf", hidden_dim=32, pos_encoding_dim=2,
               dir_encoding_dim=1, **base),
        max_steps=8, enable_tensorboard=False)
    assert any(c and c > 1 for c in seen), seen
