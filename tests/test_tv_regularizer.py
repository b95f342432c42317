"""Plenoxels total-variation prior (models/plenoxels.py::tv +
train/loop.py::make_regularizer + the train-step regularizer hook)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nerf_jax.config import Config
from nerf_jax.models.plenoxels import PlenoxelsModel
from nerf_jax.models.registry import model_from_config
from nerf_jax.train.loop import make_regularizer


def _np_tv(g):
    tv_sigma = tv_sh = 0.0
    for axis in range(3):
        d = np.diff(g, axis=axis)
        tv_sigma += np.mean(d[..., 0] ** 2)
        tv_sh += np.mean(d[..., 1:] ** 2)
    return tv_sigma, tv_sh


def test_tv_matches_numpy():
    model = PlenoxelsModel(grid_res=5)
    rng = np.random.RandomState(0)
    g = rng.normal(size=(5, 5, 5, model.channels)).astype(np.float32)
    tv_sigma, tv_sh = model.tv({"grid": jnp.asarray(g)})
    ref_sigma, ref_sh = _np_tv(g)
    np.testing.assert_allclose(float(tv_sigma), ref_sigma, rtol=1e-5)
    np.testing.assert_allclose(float(tv_sh), ref_sh, rtol=1e-5)


def test_tv_zero_for_constant_grid():
    model = PlenoxelsModel(grid_res=4)
    g = jnp.full((4, 4, 4, model.channels), 0.7)
    tv_sigma, tv_sh = model.tv({"grid": g})
    assert float(tv_sigma) == 0.0 and float(tv_sh) == 0.0


def test_make_regularizer_gating():
    assert make_regularizer(Config(model_type="plenoxels"),
                            PlenoxelsModel(grid_res=4)) is None
    with pytest.raises(ValueError, match="no TV regularizer"):
        make_regularizer(Config(model_type="nerf", tv_lambda=1e-3),
                         model_from_config(Config(model_type="nerf")))


def test_regularizer_weights_and_fine_params():
    cfg = Config(model_type="plenoxels", tv_lambda=0.5, tv_sh_lambda=0.25)
    model = PlenoxelsModel(grid_res=5)
    rng = np.random.RandomState(1)
    g = rng.normal(size=(5, 5, 5, model.channels)).astype(np.float32)
    reg = make_regularizer(cfg, model)
    ref_sigma, ref_sh = _np_tv(g)
    one = float(reg(({"grid": jnp.asarray(g)}, {})))
    np.testing.assert_allclose(one, 0.5 * ref_sigma + 0.25 * ref_sh,
                               rtol=1e-5)
    # a separate hierarchical fine grid is regularized too
    two = float(reg(({"grid": jnp.asarray(g)}, {"grid": jnp.asarray(g)})))
    np.testing.assert_allclose(two, 2 * one, rtol=1e-5)


def test_train_step_adds_tv_to_loss_not_mse():
    from nerf_jax.data.pipeline import RayPool
    from nerf_jax.render.renderer import RenderSettings
    from nerf_jax.train.optim import make_optimizer
    from nerf_jax.train.state import TrainState
    from nerf_jax.train.step import make_train_step

    cfg = Config(model_type="plenoxels", tv_lambda=1.0, tv_sh_lambda=1.0,
                 grid_res=8)
    model = model_from_config(cfg)
    params = model.init(jax.random.key(0))
    params["grid"] = jax.random.normal(jax.random.key(1),
                                       params["grid"].shape) * 0.1
    tx = make_optimizer(cfg)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       fine_params={}, opt_state=tx.init((params, {})))
    settings = RenderSettings(near=2.0, far=6.0, num_samples=8,
                              white_background=False, perturb=False)
    k = jax.random.key(2)
    d = jax.random.normal(k, (64, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    pool = RayPool(rays_o=jnp.zeros((64, 3)), rays_d=d,
                   rgb=jax.random.uniform(k, (64, 3)), viewdirs=d)
    reg = make_regularizer(cfg, model)

    def run(regularizer):
        step = make_train_step(model, tx, settings, 32, jax.random.key(3),
                               donate=False,
                               regularizer=regularizer)
        return step(state, pool)

    _, m_reg = run(reg)
    _, m_plain = run(None)
    tv_sigma, tv_sh = model.tv(params)
    expect = float(tv_sigma) + float(tv_sh)
    # identical batch/key => loss differs by exactly the TV term; the
    # logged mse is the photometric error either way
    np.testing.assert_allclose(float(m_reg["mse"]), float(m_plain["mse"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m_reg["loss"]) - float(m_plain["loss"]),
                               expect, rtol=1e-4)


def test_tv_gradient_smooths_grid():
    """Gradient descent on pure TV flattens the grid (the prior's point)."""
    model = PlenoxelsModel(grid_res=6)
    g = jax.random.normal(jax.random.key(0),
                          (6, 6, 6, model.channels)) * 1.0
    params = {"grid": g}

    def loss(p):
        s, sh = model.tv(p)
        return s + sh

    before = float(loss(params))
    grad = jax.grad(loss)(params)["grid"]
    after = float(loss({"grid": g - 0.1 * grad}))
    assert after < before
