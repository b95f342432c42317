"""PlenOctrees (reference roadmap, /root/reference/notes.txt:6): NeRF-SH
training, dense-grid baking into the Plenoxels render path, and the sparse
octree-leaf storage format."""

import numpy as np
import jax
import jax.numpy as jnp

from nerf_jax.models import PlenOctreeModel, create_model
from nerf_jax.models.plenoctree import from_octree, to_octree
from tests.test_encoding import reference_encoding_numpy
from tests.test_plenoxels import sh_basis_numpy


def _unit(rng, n):
    d = rng.normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def test_param_shapes():
    m = PlenOctreeModel()
    params = m.init(jax.random.key(0))
    assert [p["w"].shape for p in params["trunk1"]] == [
        (63, 256), (256, 256), (256, 256), (256, 256), (256, 256)]
    assert params["trunk2"][0]["w"].shape == (319, 256)
    assert params["head"]["w"].shape == (256, 1 + 27)
    assert float(params["head"]["b"][0]) == 0.5


def test_forward_matches_numpy():
    m = PlenOctreeModel(hidden_dim=64, pos_encoding_dim=4, sh_degree=1)
    params = m.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, size=(20, 3)).astype(np.float32)
    dirs = _unit(rng, 20)

    g = lambda lyr: {k: np.asarray(v, np.float64) for k, v in lyr.items()}
    relu = lambda x: np.maximum(x, 0.0)
    pe = reference_encoding_numpy(pts, 4)
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
    want_sigma = relu(x[:, 0])
    sh = x[:, 1:].reshape(-1, 3, 4)
    basis = sh_basis_numpy(dirs, 1)
    want_rgb = 1 / (1 + np.exp(-np.einsum("ncl,nl->nc", sh, basis)))

    rgb, sigma = m.apply(params, jnp.asarray(pts), jnp.asarray(dirs))
    np.testing.assert_allclose(np.asarray(sigma), want_sigma, atol=2e-4)
    np.testing.assert_allclose(np.asarray(rgb), want_rgb, atol=2e-5)


def test_view_independence_of_sh_field():
    """The bakeability property: sigma and SH coefficients depend only on
    position — any view direction reads the same leaf payload."""
    m = PlenOctreeModel(hidden_dim=32, pos_encoding_dim=2, sh_degree=2)
    params = m.init(jax.random.key(1))
    rng = np.random.default_rng(1)
    pts = jnp.asarray(rng.uniform(-1, 1, size=(5, 3)), jnp.float32)
    s1, sh1 = m.sh_field(params, pts)
    s2, sh2 = m.sh_field(params, pts)
    np.testing.assert_array_equal(np.asarray(s1), np.asarray(s2))
    # crossing dirs: rgb from apply equals manual SH eval of the cached field
    dirs = jnp.asarray(_unit(rng, 5))
    rgb, sigma = m.apply(params, pts, dirs)
    want = 1 / (1 + np.exp(-np.einsum(
        "ncl,nl->nc", np.asarray(sh1), sh_basis_numpy(np.asarray(dirs), 2))))
    np.testing.assert_allclose(np.asarray(rgb), want, atol=1e-5)
    np.testing.assert_allclose(np.asarray(sigma), np.asarray(s1), atol=1e-6)


def test_bake_into_plenoxels_matches_at_nodes():
    m = PlenOctreeModel(hidden_dim=32, pos_encoding_dim=2, sh_degree=1)
    params = m.init(jax.random.key(2))
    baked_model, baked_params = m.bake(params, grid_res=8, chunk=64)
    assert baked_model.name == "plenoxels"
    assert baked_params["grid"].shape == (8, 8, 8, 13)

    lin = np.linspace(-1, 1, 8, dtype=np.float32)
    pts = np.stack(np.meshgrid(lin[1:4], lin[2:5], lin[3:6], indexing="ij"),
                   axis=-1).reshape(-1, 3)
    dirs = _unit(np.random.default_rng(2), len(pts))
    rgb_live, sigma_live = m.apply(params, jnp.asarray(pts), jnp.asarray(dirs))
    rgb_b, sigma_b = baked_model.apply(baked_params, jnp.asarray(pts),
                                       jnp.asarray(dirs))
    np.testing.assert_allclose(np.asarray(sigma_b), np.asarray(sigma_live),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(rgb_b), np.asarray(rgb_live),
                               rtol=1e-4, atol=1e-4)


def test_octree_roundtrip_and_pruning():
    rng = np.random.default_rng(3)
    grid = rng.normal(scale=0.2, size=(8, 8, 8, 13)).astype(np.float32)
    tree = to_octree(grid, sigma_threshold=0.1)
    assert tree["res"] == 8
    back = from_octree(tree)
    kept = grid[..., 0] > 0.1
    # kept cells identical, pruned cells zero
    np.testing.assert_array_equal(back[kept], grid[kept])
    assert np.all(back[~kept] == 0.0)
    # sparse: fewer leaves than cells (random normal -> ~31% above 0.1 sigma)
    assert 0 < len(tree["coords"]) < 8 ** 3


def test_registry_and_train_step():
    from nerf_jax.config import Config
    from nerf_jax.data.pipeline import RayPool
    from nerf_jax.models.registry import model_from_config
    from nerf_jax.render.renderer import RenderSettings
    from nerf_jax.train.optim import make_optimizer
    from nerf_jax.train.state import TrainState
    from nerf_jax.train.step import make_train_step

    assert create_model("PlenOctree").name == "plenoctree"
    cfg = Config(model_type="plenoctree", hidden_dim=64, pos_encoding_dim=4)
    model = model_from_config(cfg)
    assert model.name == "plenoctree"
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
        state, mtr = step(state, pool)
        losses.append(float(mtr["mse"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
