"""KiloNeRF (reference roadmap, /root/reference/notes.txt:4): per-voxel tiny
MLPs with static-shape grouped-matmul dispatch.

The correctness chain: a numpy per-network loop (evaluate each point with its
voxel's individually-indexed weights) pins `apply_pointwise`, and the grouped
production path must match `apply_pointwise` exactly."""

import numpy as np
import jax
import jax.numpy as jnp

from nerf_jax.models import KiloNeRFModel, create_model
from nerf_jax.models.common import param_count
from tests.test_encoding import reference_encoding_numpy


def _unit(rng, n):
    d = rng.normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def test_param_shapes_and_count():
    model = KiloNeRFModel(grid_res=4, hidden_dim=32)
    params = model.init(jax.random.key(0))
    g = 64
    assert params["l1"]["w"].shape == (g, model.pos_in, 32)
    assert params["l2"]["w"].shape == (g, 32, 32)
    assert params["trunk"]["w"].shape == (g, 32, 33)
    assert params["rgb1"]["w"].shape == (g, 32 + model.dir_in, 32)
    assert params["rgb2"]["w"].shape == (g, 32, 3)
    # every network independently initialized
    assert not np.allclose(
        np.asarray(params["l1"]["w"][0]), np.asarray(params["l1"]["w"][1])
    )
    # density-bias dead-ReLU guard applied per network
    assert np.all(np.asarray(params["trunk"]["b"][:, -1]) == 0.5)
    per_net = param_count(jax.tree.map(lambda p: p[0], params))
    assert param_count(params) == g * per_net


def test_voxel_of():
    model = KiloNeRFModel(grid_res=4)
    pts = jnp.asarray(
        [
            [-1.0, -1.0, -1.0],   # first voxel corner
            [0.99, 0.99, 0.99],   # last voxel
            [-0.75, -0.75, -0.75],  # center of voxel (0,0,0)
            [1.5, 0.0, -2.0],     # outside: clamps to border voxels
        ]
    )
    vid, local = model.voxel_of(pts)
    assert vid.tolist() == [0, 63, 0, 3 * 16 + 2 * 4 + 0]
    np.testing.assert_allclose(np.asarray(local[2]), [0.0, 0.0, 0.0], atol=1e-6)
    np.testing.assert_allclose(np.asarray(local[0]), [-1.0, -1.0, -1.0], atol=1e-6)
    # outside points extrapolate: |local| > 1 on the offending axis
    assert float(local[3, 0]) > 1.0 and float(local[3, 2]) < -1.0
    # vids cover the grid for uniform points
    rng = np.random.default_rng(0)
    p = rng.uniform(-1, 1, size=(4096, 3)).astype(np.float32)
    v, _ = model.voxel_of(jnp.asarray(p))
    assert set(np.asarray(v).tolist()) == set(range(64))


def kilonerf_forward_numpy(model, params, points, dirs):
    """Float64 per-network loop: the math KiloNeRF defines, network by
    network, with no dispatch machinery at all."""
    g = lambda a: np.asarray(a, np.float64)
    vid, local = model.voxel_of(jnp.asarray(points))
    vid, local = np.asarray(vid), np.asarray(local, np.float64)
    pe = reference_encoding_numpy(local, model.pos_encoding_dim)
    de = reference_encoding_numpy(np.asarray(dirs, np.float64),
                                  model.dir_encoding_dim)
    relu = lambda x: np.maximum(x, 0.0)
    rgb = np.zeros((len(points), 3))
    sigma = np.zeros(len(points))
    for i in range(len(points)):
        n = vid[i]
        lin = lambda name, x: x @ g(params[name]["w"][n]) + g(params[name]["b"][n])
        x = relu(lin("l1", pe[i]))
        x = relu(lin("l2", x))
        x = lin("trunk", x)
        sigma[i] = relu(x[-1])
        y = np.concatenate([x[:-1], de[i]])
        y = relu(lin("rgb1", y))
        rgb[i] = 1.0 / (1.0 + np.exp(-lin("rgb2", y)))
    return rgb, sigma


def test_pointwise_matches_numpy_loop():
    model = KiloNeRFModel(grid_res=3, hidden_dim=16, pos_encoding_dim=4,
                          dir_encoding_dim=2)
    params = model.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1.2, 1.2, size=(50, 3)).astype(np.float32)  # incl. outside
    dirs = _unit(rng, 50)
    rgb, sigma = model.apply_pointwise(params, jnp.asarray(pts), jnp.asarray(dirs))
    want_rgb, want_sigma = kilonerf_forward_numpy(model, params, pts, dirs)
    np.testing.assert_allclose(np.asarray(rgb), want_rgb, atol=2e-5)
    np.testing.assert_allclose(np.asarray(sigma), want_sigma, atol=2e-4)


def test_grouped_dispatch_matches_pointwise():
    model = KiloNeRFModel(grid_res=4, hidden_dim=16, pos_encoding_dim=4,
                          dir_encoding_dim=2, dispatch_tile=16)
    params = model.init(jax.random.key(1))
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1, 1, size=(333, 3)).astype(np.float32)  # ragged N
    dirs = _unit(rng, 333)
    ref = model.apply_pointwise(params, jnp.asarray(pts), jnp.asarray(dirs))
    got = model.apply(params, jnp.asarray(pts), jnp.asarray(dirs))
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(ref[0]), atol=1e-6)
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(ref[1]), atol=1e-5)


def test_grouped_dispatch_skewed_distributions():
    """All points in ONE voxel (worst-case skew) and a batch smaller than one
    tile — the static tile map must stay exact."""
    model = KiloNeRFModel(grid_res=4, hidden_dim=16, pos_encoding_dim=2,
                          dir_encoding_dim=1, dispatch_tile=32)
    params = model.init(jax.random.key(2))
    rng = np.random.default_rng(2)
    # every point inside voxel (0,0,0): [-1, -0.5)^3
    pts = rng.uniform(-0.99, -0.51, size=(100, 3)).astype(np.float32)
    dirs = _unit(rng, 100)
    ref = model.apply_pointwise(params, jnp.asarray(pts), jnp.asarray(dirs))
    got = model.apply(params, jnp.asarray(pts), jnp.asarray(dirs))
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(ref[1]), atol=1e-5)
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(ref[0]), atol=1e-6)

    tiny_p, tiny_d = jnp.asarray(pts[:5]), jnp.asarray(dirs[:5])
    ref = model.apply_pointwise(params, tiny_p, tiny_d)
    got = model.apply(params, tiny_p, tiny_d)
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(ref[0]), atol=1e-6)


def test_registry_and_train_step():
    from nerf_jax.config import Config
    from nerf_jax.data.pipeline import RayPool
    from nerf_jax.models.registry import model_from_config
    from nerf_jax.render.renderer import RenderSettings
    from nerf_jax.train.optim import make_optimizer
    from nerf_jax.train.state import TrainState
    from nerf_jax.train.step import make_train_step

    assert create_model("KiloNeRF").name == "kilonerf"
    cfg = Config(model_type="kilonerf", hidden_dim=16, grid_res=4,
                 pos_encoding_dim=4, dir_encoding_dim=2)
    model = model_from_config(cfg)
    assert model.name == "kilonerf" and model.grid_res == 4
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
