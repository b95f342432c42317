"""Plenoxels (reference roadmap, /root/reference/notes.txt:8): density+SH
voxel grid, trilinear stencil, no neural network."""

import numpy as np
import jax
import jax.numpy as jnp

from nerf_jax.models import PlenoxelsModel, create_model
from nerf_jax.models.plenoxels import sh_basis
from nerf_jax.ops.interp import trilinear


def _unit(rng, n):
    d = rng.normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def sh_basis_numpy(d, degree):
    """Independent float64 real-SH table (standard Y_lm, degrees 0-2)."""
    x, y, z = d[:, 0].astype(np.float64), d[:, 1].astype(np.float64), d[:, 2].astype(np.float64)
    cols = [np.full_like(x, 0.28209479177387814)]
    if degree >= 1:
        c1 = 0.4886025119029199
        cols += [-c1 * y, c1 * z, -c1 * x]
    if degree >= 2:
        cols += [
            1.0925484305920792 * x * y,
            -1.0925484305920792 * y * z,
            0.31539156525252005 * (3 * z * z - 1),
            -1.0925484305920792 * x * z,
            0.5462742152960396 * (x * x - y * y),
        ]
    return np.stack(cols, axis=-1)


def test_sh_basis_golden():
    rng = np.random.default_rng(0)
    d = _unit(rng, 40)
    for deg in (0, 1, 2):
        got = np.asarray(sh_basis(jnp.asarray(d), deg))
        want = sh_basis_numpy(d, deg)
        assert got.shape == (40, (deg + 1) ** 2)
        np.testing.assert_allclose(got, want, atol=1e-6)
    # orthonormality spot check: mean over the sphere of Y_lm * Y_l'm'
    # ~ delta / (4 pi) with enough samples
    d = _unit(rng, 200_000)
    b = sh_basis_numpy(d, 2)
    gram = 4 * np.pi * (b.T @ b) / len(d)
    np.testing.assert_allclose(gram, np.eye(9), atol=0.05)


def test_apply_matches_manual_at_grid_nodes():
    m = PlenoxelsModel(grid_res=7, sh_degree=2)
    rng = np.random.default_rng(1)
    grid = rng.normal(scale=0.5, size=(7, 7, 7, m.channels)).astype(np.float32)
    params = {"grid": jnp.asarray(grid)}
    lin = np.linspace(-1, 1, 7, dtype=np.float32)
    idx = [(1, 2, 3), (0, 0, 0), (6, 6, 6), (4, 1, 5)]
    pts = np.asarray([[lin[i], lin[j], lin[k]] for i, j, k in idx], np.float32)
    dirs = _unit(rng, len(idx))
    rgb, sigma = m.apply(params, jnp.asarray(pts), jnp.asarray(dirs))
    for n, (i, j, k) in enumerate(idx):
        v = grid[i, j, k].astype(np.float64)
        assert abs(float(sigma[n]) - np.logaddexp(0.0, v[0])) < 1e-5
        sh = v[1:].reshape(3, 9)
        want = 1 / (1 + np.exp(-(sh @ sh_basis_numpy(dirs[n:n+1], 2)[0])))
        np.testing.assert_allclose(np.asarray(rgb[n]), want, atol=1e-5)


def test_trilinear_interpolates_between_nodes():
    r = 5
    grid = jnp.zeros((r, r, r, 1)).at[2, 2, 2, 0].set(1.0)
    # halfway between nodes (1,2,2) and (2,2,2) on the x axis
    lin = np.linspace(-1, 1, r)
    p = jnp.asarray([[(lin[1] + lin[2]) / 2, lin[2], lin[2]]], jnp.float32)
    v = trilinear(grid, p)
    np.testing.assert_allclose(np.asarray(v), [[0.5]], atol=1e-6)


def test_gradient_touches_only_stencil_corners():
    """The plenoxel training property: one sample's gradient lands on its 8
    cell corners and nowhere else."""
    m = PlenoxelsModel(grid_res=6, sh_degree=1)
    params = m.init(jax.random.key(0))
    p = jnp.asarray([[0.05, -0.1, 0.17]], jnp.float32)  # interior, off-node
                                                        # on every axis
    d = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)

    def loss(pr):
        rgb, sigma = m.apply(pr, p, d)
        return jnp.sum(rgb) + jnp.sum(sigma)

    g = jax.grad(loss)(params)["grid"]
    nz = np.argwhere(np.abs(np.asarray(g)).sum(-1) > 0)
    assert len(nz) == 8
    # corners span exactly one cell
    for axis in range(3):
        vals = sorted(set(nz[:, axis]))
        assert len(vals) == 2 and vals[1] - vals[0] == 1


def test_upsample_preserves_field_at_nodes():
    m = PlenoxelsModel(grid_res=5, sh_degree=1)
    rng = np.random.default_rng(2)
    params = {"grid": jnp.asarray(
        rng.normal(size=(5, 5, 5, m.channels)).astype(np.float32))}
    up = m.upsample(params, 9)   # 9 = 2*5-1: every old node is a new node
    assert up["grid"].shape == (9, 9, 9, m.channels)
    np.testing.assert_allclose(
        np.asarray(up["grid"][::2, ::2, ::2]), np.asarray(params["grid"]),
        atol=1e-5,
    )


def test_registry_and_train_step():
    from nerf_jax.config import Config
    from nerf_jax.data.pipeline import RayPool
    from nerf_jax.models.registry import model_from_config
    from nerf_jax.render.renderer import RenderSettings
    from nerf_jax.train.optim import make_optimizer
    from nerf_jax.train.state import TrainState
    from nerf_jax.train.step import make_train_step

    assert create_model("Plenoxels").name == "plenoxels"
    assert create_model("plenoxels").grid_res == 128  # model default kept
    cfg = Config(model_type="plenoxels", grid_res=16)
    model = model_from_config(cfg)
    assert model.grid_res == 16
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
    for _ in range(40):
        state, mtr = step(state, pool)
        losses.append(float(mtr["mse"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_plenoxels_upsample_exact():
    rng = np.random.default_rng(7)
    model = PlenoxelsModel(grid_res=16, sh_degree=0)
    grid = jnp.asarray(
        rng.normal(size=(16, 16, 16, model.channels)).astype(np.float32)
    )
    up = model.upsample({"grid": grid}, 24)["grid"]
    lin = jnp.linspace(-1.0, 1.0, 24, dtype=jnp.float32)
    pts = jnp.stack(jnp.meshgrid(lin, lin, lin, indexing="ij"),
                    axis=-1).reshape(-1, 3)
    want = trilinear(grid, pts).reshape(24, 24, 24, model.channels)
    np.testing.assert_allclose(np.asarray(up), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
