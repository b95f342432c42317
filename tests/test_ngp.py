"""Instant NGP (reference roadmap, /root/reference/notes.txt:7): multires
hash encoding + tiny MLPs."""

import numpy as np
import jax
import jax.numpy as jnp

from nerf_jax.models import create_model
from nerf_jax.models.ngp import NGPModel, _PRIMES


def _unit(rng, n):
    d = rng.normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def test_level_resolutions_geometric():
    m = NGPModel(num_levels=16, base_res=16, max_res=2048)
    res = m.level_resolutions()
    assert res[0] == 16 and res[-1] == 2048
    assert len(res) == 16
    ratios = res[1:] / res[:-1]
    b = np.exp((np.log(2048) - np.log(16)) / 15)
    assert np.all(np.abs(ratios - b) < 0.1)  # floor() wobble only


def test_param_shapes():
    m = NGPModel(num_levels=4, log2_table=10, feat_dim=2)
    params = m.init(jax.random.key(0))
    assert len(params["tables"]) == 4
    assert params["tables"][0].shape == (1024, 2)
    assert float(np.abs(np.asarray(params["tables"][0])).max()) <= 1e-4
    assert params["density"][0]["w"].shape == (8, 64)
    assert params["density"][1]["w"].shape == (64, 16)
    assert params["color"][0]["w"].shape == (15 + 9, 64)


def encode_numpy(model, tables, p):
    """Independent float64 re-derivation of the multires hash encoding."""
    t = 1 << model.log2_table
    x01 = np.clip((np.asarray(p, np.float64) + 1) / 2, 0, 1)
    outs = []
    for lvl, res in enumerate(model.level_resolutions()):
        res = int(res)
        x = x01 * res
        x0 = np.minimum(np.floor(x), res - 1)
        f = x - x0
        acc = np.zeros((len(p), model.feat_dim))
        for corner in range(8):
            off = np.asarray([(corner >> 2) & 1, (corner >> 1) & 1, corner & 1])
            c = (x0 + off).astype(np.uint32)
            if (res + 1) ** 3 <= t:
                stride = res + 1
                idx = (c[:, 0] * stride + c[:, 1]) * stride + c[:, 2]
            else:
                h = c[:, 0] * np.uint32(_PRIMES[0])
                h = h ^ (c[:, 1] * np.uint32(_PRIMES[1]))
                h = h ^ (c[:, 2] * np.uint32(_PRIMES[2]))
                idx = h & np.uint32(t - 1)
            w = np.prod(np.where(off.astype(bool), f, 1 - f), axis=-1)
            acc += w[:, None] * np.asarray(tables[lvl], np.float64)[idx]
        outs.append(acc)
    return np.concatenate(outs, axis=-1)


def test_encode_matches_numpy_direct_and_hashed():
    # level 0 (res 4 -> direct) and level 3 (res 32 -> (33)^3 > 2^10, hashed)
    m = NGPModel(num_levels=4, base_res=4, max_res=32, log2_table=10)
    resolutions = m.level_resolutions()
    t = 1 << m.log2_table
    assert (int(resolutions[0]) + 1) ** 3 <= t < (int(resolutions[-1]) + 1) ** 3
    params = m.init(jax.random.key(0))
    # make features big enough to compare meaningfully
    tables = [jnp.asarray(np.random.default_rng(i).normal(size=tb.shape),
                          jnp.float32) for i, tb in enumerate(params["tables"])]
    rng = np.random.default_rng(5)
    p = rng.uniform(-1, 1, size=(64, 3)).astype(np.float32)
    got = np.asarray(m.encode(tables, jnp.asarray(p)))
    want = encode_numpy(m, tables, p)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_encode_exact_at_cell_corners():
    """At a level-0 lattice point with zero fraction the encoding is exactly
    one table row (direct indexing, collision-free)."""
    m = NGPModel(num_levels=1, base_res=4, max_res=4, log2_table=10)
    params = m.init(jax.random.key(1))
    table = jnp.asarray(
        np.random.default_rng(0).normal(size=params["tables"][0].shape),
        jnp.float32,
    )
    # lattice point (1, 2, 3) of the res-4 grid: x01 = (1/4, 2/4, 3/4)
    p = jnp.asarray([[2 * 0.25 - 1, 2 * 0.5 - 1, 2 * 0.75 - 1]], jnp.float32)
    got = np.asarray(m.encode([table], p))[0]
    idx = (1 * 5 + 2) * 5 + 3
    np.testing.assert_allclose(got, np.asarray(table[idx]), atol=1e-6)


def test_gradient_reaches_only_touched_rows():
    m = NGPModel(num_levels=1, base_res=4, max_res=4, log2_table=10)
    params = m.init(jax.random.key(2))
    p = jnp.asarray([[0.03, -0.11, 0.21]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)

    def loss(pr):
        rgb, sigma = m.apply(pr, p, d)
        return jnp.sum(rgb) + jnp.sum(sigma)

    g = jax.grad(loss)(params)["tables"][0]
    nz = np.argwhere(np.abs(np.asarray(g)).sum(-1) > 0)
    assert 1 <= len(nz) <= 8  # the one sample's stencil, nothing else


def test_registry_and_train_step():
    from nerf_jax.config import Config
    from nerf_jax.data.pipeline import RayPool
    from nerf_jax.models.registry import model_from_config
    from nerf_jax.render.renderer import RenderSettings
    from nerf_jax.train.optim import make_optimizer
    from nerf_jax.train.state import TrainState
    from nerf_jax.train.step import make_train_step

    assert create_model("NGP").name == "ngp"
    cfg = Config(model_type="ngp")
    model = model_from_config(cfg)
    assert model.name == "ngp"
    model = NGPModel(num_levels=4, base_res=4, max_res=64, log2_table=12)
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
