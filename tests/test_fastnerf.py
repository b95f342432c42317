"""FastNeRF (reference roadmap, /root/reference/notes.txt:5): factorized
position/direction field + the MLP-free baked cache."""

import numpy as np
import jax
import jax.numpy as jnp

from nerf_jax.models import FastNeRFModel, create_model
from tests.test_encoding import reference_encoding_numpy


def _unit(rng, n):
    d = rng.normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def test_param_shapes():
    m = FastNeRFModel()
    params = m.init(jax.random.key(0))
    assert [p["w"].shape for p in params["trunk1"]] == [
        (63, 256), (256, 256), (256, 256), (256, 256), (256, 256)]
    assert params["trunk2"][0]["w"].shape == (319, 256)
    assert params["head"]["w"].shape == (256, 1 + 3 * 8)
    assert float(params["head"]["b"][0]) == 0.5  # density guard, column 0
    assert params["dir"][0]["w"].shape == (27, 128)
    assert params["dir"][1]["w"].shape == (128, 8)


def fastnerf_forward_numpy(model, params, points, dirs):
    g = lambda lyr: {k: np.asarray(v, np.float64) for k, v in lyr.items()}
    relu = lambda x: np.maximum(x, 0.0)
    pe = reference_encoding_numpy(points, model.pos_encoding_dim)
    x = pe
    for lyr in params["trunk1"]:
        lyr = g(lyr)
        x = relu(x @ lyr["w"] + lyr["b"])
    x = np.concatenate([x, pe], axis=-1)
    for lyr in params["trunk2"]:
        lyr = g(lyr)
        x = relu(x @ lyr["w"] + lyr["b"])
    h = g(params["head"])
    x = x @ h["w"] + h["b"]
    sigma = relu(x[:, 0])
    factors = x[:, 1:].reshape(-1, model.num_factors, 3)
    de = reference_encoding_numpy(dirs, model.dir_encoding_dim)
    d0, d1 = g(params["dir"][0]), g(params["dir"][1])
    y = relu(de @ d0["w"] + d0["b"])
    beta = y @ d1["w"] + d1["b"]
    rgb = 1.0 / (1.0 + np.exp(-np.einsum("nd,ndc->nc", beta, factors)))
    return rgb, sigma


def test_forward_matches_numpy():
    m = FastNeRFModel(hidden_dim=256)
    params = m.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, size=(25, 3)).astype(np.float32)
    dirs = _unit(rng, 25)
    rgb, sigma = m.apply(params, jnp.asarray(pts), jnp.asarray(dirs))
    want_rgb, want_sigma = fastnerf_forward_numpy(m, params, pts, dirs)
    np.testing.assert_allclose(np.asarray(rgb), want_rgb, atol=2e-5)
    np.testing.assert_allclose(np.asarray(sigma), want_sigma, atol=2e-4)


def test_factorization_is_position_direction_separable():
    """The defining property: sigma and the factors depend only on x, beta
    only on d — so crossing any (x, d) pairs just re-contracts cached parts."""
    m = FastNeRFModel(hidden_dim=64, num_factors=4, pos_encoding_dim=4)
    params = m.init(jax.random.key(1))
    rng = np.random.default_rng(1)
    pts = jnp.asarray(rng.uniform(-1, 1, size=(7, 3)), jnp.float32)
    dirs = jnp.asarray(_unit(rng, 5))
    sigma, factors = m.pos_factors(params, pts)       # (7,), (7,4,3)
    beta = m.dir_weights(params, dirs)                # (5,4)
    # all 35 combinations via the caches vs direct apply
    pp = jnp.repeat(pts, 5, axis=0)
    dd = jnp.tile(dirs, (7, 1))
    rgb_direct, sigma_direct = m.apply(params, pp, dd)
    rgb_cached = jax.nn.sigmoid(
        jnp.einsum("pd,qdc->qpc", beta, factors).reshape(-1, 3)
    )
    np.testing.assert_allclose(np.asarray(rgb_direct), np.asarray(rgb_cached),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(sigma_direct),
                               np.asarray(jnp.repeat(sigma, 5)), atol=1e-5)


def test_baked_matches_live_at_grid_nodes():
    """Trilinear/bilinear interpolation is exact at grid nodes, so the baked
    cache must reproduce the live field there bit-for-bit-ish."""
    m = FastNeRFModel(hidden_dim=64, num_factors=4, pos_encoding_dim=2,
                      dir_encoding_dim=1, dir_hidden_dim=32)
    params = m.init(jax.random.key(2))
    baked = m.bake(params, grid_res=9, dir_res=8, chunk=128)
    assert baked.pos_grid.shape == (9, 9, 9, 13)
    assert baked.beta_grid.shape == (8, 16, 4)

    # query exactly at grid nodes x dir-grid nodes
    lin = np.linspace(-1, 1, 9, dtype=np.float32)
    pts = np.stack(np.meshgrid(lin[2:5], lin[3:6], lin[4:7], indexing="ij"),
                   axis=-1).reshape(-1, 3)
    th = np.pi * 3 / 7  # theta grid node (index 3 of 8)
    ph = -np.pi + 2 * np.pi * 5 / 15  # phi grid node (index 5 of 16)
    d = np.asarray([[np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                     np.cos(th)]], np.float32)
    dirs = np.repeat(d, pts.shape[0], axis=0)

    rgb_live, sigma_live = m.apply(params, jnp.asarray(pts), jnp.asarray(dirs))
    rgb_b, sigma_b = baked.apply(None, jnp.asarray(pts), jnp.asarray(dirs))
    np.testing.assert_allclose(np.asarray(sigma_b), np.asarray(sigma_live),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(rgb_b), np.asarray(rgb_live),
                               rtol=1e-4, atol=1e-4)


def test_baked_renders_through_renderer():
    """BakedFastNeRF.apply satisfies the field contract — render_rays can
    drive it with params=None."""
    from nerf_jax.render.renderer import RenderSettings, render_rays

    m = FastNeRFModel(hidden_dim=32, num_factors=2, pos_encoding_dim=2,
                      dir_encoding_dim=1, dir_hidden_dim=16)
    params = m.init(jax.random.key(3))
    baked = m.bake(params, grid_res=8, dir_res=4, chunk=64)
    rng = np.random.default_rng(3)
    ro = jnp.asarray(rng.normal(scale=0.1, size=(16, 3)), jnp.float32)
    rd = jnp.asarray(_unit(rng, 16))
    settings = RenderSettings(near=2.0, far=6.0, num_samples=8)
    out = render_rays(baked.apply, None, ro, rd, jax.random.key(0), settings)
    assert out.rgb.shape == (16, 3)
    assert np.isfinite(np.asarray(out.rgb)).all()


def test_registry_and_train_step():
    from nerf_jax.config import Config
    from nerf_jax.data.pipeline import RayPool
    from nerf_jax.models.registry import model_from_config
    from nerf_jax.render.renderer import RenderSettings
    from nerf_jax.train.optim import make_optimizer
    from nerf_jax.train.state import TrainState
    from nerf_jax.train.step import make_train_step

    assert create_model("FastNeRF").name == "fastnerf"
    cfg = Config(model_type="fastnerf", hidden_dim=64, pos_encoding_dim=4,
                 dir_encoding_dim=2)
    model = model_from_config(cfg)
    assert model.name == "fastnerf"
    tx = make_optimizer(cfg)
    params = model.init(jax.random.key(0))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       fine_params={}, opt_state=tx.init((params, {})))
    k = jax.random.key(1)
    rd = jax.random.normal(k, (512, 3))
    rd = rd / jnp.linalg.norm(rd, axis=-1, keepdims=True)
    pool = RayPool(rays_o=jax.random.normal(k, (512, 3)) * 0.1, rays_d=rd,
                   rgb=jax.random.uniform(k, (512, 3)), viewdirs=rd)
    settings = RenderSettings(near=2.0, far=6.0, num_samples=8)
    step = make_train_step(model, tx, settings, 64, jax.random.key(2),
                           donate=False)
    losses = []
    for _ in range(30):
        state, m = step(state, pool)
        losses.append(float(m["mse"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
