"""One property per test, each a case for every field family at a tiny width.

The eight families sit behind one ``apply(params, points, viewdirs) ->
(rgb, sigma)`` contract; these cases hold each of them to it: shapes,
gradients, bf16 against float32 at "highest" precision, the renderer
against an independent NumPy compositor, chunking invariance, the
data-parallel step and the sharded eval render on a 4-device virtual mesh
against one device, checkpoint round-trip + resume, and a scan of N train
steps against N single steps.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

from nerf_jax.data.pipeline import RayPool
from nerf_jax.models import create_model
from nerf_jax.parallel.mesh import create_mesh, data_sharding
from nerf_jax.render.renderer import RenderSettings, render_image, render_rays
from nerf_jax.train.state import TrainState
from nerf_jax.train.step import (make_eval_render, make_scan_train_step,
                                 make_train_step)
from nerf_jax.utils.checkpoint import load_checkpoint, save_checkpoint

FAMILIES = {
    "nerf": dict(hidden_dim=16, pos_encoding_dim=2, dir_encoding_dim=1),
    "siren": dict(hidden_dim=16, num_layers=3, dir_encoding_dim=1),
    "gabor": dict(hidden_dim=16, num_layers=3, dir_encoding_dim=1),
    "kilonerf": dict(grid_res=2, hidden_dim=8, pos_encoding_dim=2,
                     dir_encoding_dim=1, dispatch_tile=16),
    "fastnerf": dict(hidden_dim=16, dir_hidden_dim=8, num_factors=2,
                     pos_encoding_dim=2, dir_encoding_dim=1),
    "plenoctree": dict(hidden_dim=16, pos_encoding_dim=2, sh_degree=1),
    "ngp": dict(num_levels=2, log2_table=8, base_res=4, max_res=16,
                hidden_dim=8, geo_feat_dim=3, sh_degree=1),
    "plenoxels": dict(grid_res=8, sh_degree=1),
}
family = pytest.mark.parametrize("name", sorted(FAMILIES))

NEAR, FAR = 2.0, 6.0
SETTINGS = RenderSettings(near=NEAR, far=FAR, num_samples=8, perturb=False,
                          chunk_size=1024)


def _model(name, dtype="float32"):
    return create_model(name, compute_dtype=dtype, **FAMILIES[name])


def _params(model):
    params = model.init(jax.random.key(0))
    if "grid" in params:  # a uniform grid has no structure to test against
        g = np.random.default_rng(0).normal(
            size=params["grid"].shape).astype(np.float32)
        params = {"grid": jnp.asarray(0.5 * g)}
    return params


def _rays(n, seed=0):
    """Rays from radius 4 through a small ball around the origin."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = -4.0 * d + rng.normal(scale=0.3, size=(n, 3))
    return o.astype(np.float32), d.astype(np.float32)


def _pool(n=256):
    o, d = _rays(n, seed=1)
    rgb = np.random.default_rng(2).uniform(size=(n, 3)).astype(np.float32)
    return RayPool(rays_o=jnp.asarray(o), rays_d=jnp.asarray(d),
                   rgb=jnp.asarray(rgb), viewdirs=jnp.asarray(d))


def _state(model, tx):
    params = _params(model)
    return TrainState(step=jnp.zeros((), jnp.int32), params=params,
                      fine_params={}, opt_state=tx.init((params, {})))


def _leaves_close(a, b, **tol):
    for x, y in zip(jax.tree_util.tree_leaves(a),
                    jax.tree_util.tree_leaves(b)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), **tol)


@family
def test_field_contract(name):
    """(R, S, 3) queries give (R, S, 3) rgb in [0, 1] and (R, S) finite
    sigma >= 0 (> 0 under NGP's exp activation), equal to the flat call; a
    ragged flat batch keeps its length."""
    model = _model(name)
    params = _params(model)
    rng = np.random.default_rng(3)
    pts = jnp.asarray(rng.uniform(-1, 1, (5, 7, 3)).astype(np.float32))
    d = rng.normal(size=(5, 7, 3))
    d = jnp.asarray((d / np.linalg.norm(d, axis=-1, keepdims=True))
                    .astype(np.float32))
    apply = jax.jit(model.apply)
    rgb, sigma = apply(params, pts, d)
    assert rgb.shape == (5, 7, 3) and sigma.shape == (5, 7)
    assert float(rgb.min()) >= 0.0 and float(rgb.max()) <= 1.0
    assert np.isfinite(np.asarray(sigma)).all()
    assert float(sigma.min()) > 0.0 if name == "ngp" else \
        float(sigma.min()) >= 0.0
    rgb_f, sigma_f = apply(params, pts.reshape(-1, 3), d.reshape(-1, 3))
    np.testing.assert_allclose(np.asarray(rgb).reshape(-1, 3),
                               np.asarray(rgb_f), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(sigma).reshape(-1),
                               np.asarray(sigma_f), rtol=1e-5, atol=1e-6)
    rgb_r, sigma_r = apply(params, pts.reshape(-1, 3)[:33],
                           d.reshape(-1, 3)[:33])
    assert rgb_r.shape == (33, 3) and sigma_r.shape == (33,)


@family
def test_grad_finite_and_adam_step_lowers_loss(name):
    """value_and_grad of the render MSE is finite and nonzero, and one Adam
    step on the same fixed batch lowers that loss (lr small enough that
    the first-order decrease, lr * sum|g|, dominates)."""
    model = _model(name)
    params = _params(model)
    pool = _pool(128)

    def loss(p):
        out = render_rays(model.apply, p, pool.rays_o, pool.rays_d,
                          jax.random.key(0), SETTINGS)
        return jnp.mean((out.rgb - pool.rgb) ** 2)

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    leaves = jax.tree_util.tree_leaves(grads)
    assert np.isfinite(float(value))
    assert all(np.isfinite(np.asarray(g)).all() for g in leaves)
    assert any(float(jnp.abs(g).max()) > 0 for g in leaves)
    tx = optax.adam(1e-4)
    updates, _ = tx.update(grads, tx.init(params), params)
    assert float(jax.jit(loss)(optax.apply_updates(params, updates))) < \
        float(value)


@family
def test_bf16_close_to_float32_highest(name):
    """compute_dtype=bfloat16 against float32 at "highest" precision. bf16
    operands keep 8 mantissa bits (2^-9 relative rounding); through these
    few-layer tiny fields the outputs stay within 3e-2 of the reference
    (sigma relative to its scale). The grid-only family has no products
    to round and matches exactly."""
    model32, model16 = _model(name), _model(name, "bfloat16")
    params = _params(model32)
    rng = np.random.default_rng(4)
    pts = jnp.asarray(rng.uniform(-1, 1, (64, 3)).astype(np.float32))
    d = rng.normal(size=(64, 3))
    d = jnp.asarray((d / np.linalg.norm(d, axis=-1, keepdims=True))
                    .astype(np.float32))
    with jax.default_matmul_precision("highest"):
        rgb_ref, sigma_ref = jax.jit(model32.apply)(params, pts, d)
    rgb, sigma = jax.jit(model16.apply)(params, pts, d)
    scale = max(float(jnp.abs(sigma_ref).max()), 1.0)
    np.testing.assert_allclose(np.asarray(rgb), np.asarray(rgb_ref),
                               atol=3e-2)
    np.testing.assert_allclose(np.asarray(sigma) / scale,
                               np.asarray(sigma_ref) / scale, atol=3e-2)


@family
def test_render_rays_matches_numpy_composite(name):
    """render_rays against an independent NumPy renderer of the same field:
    bin-midpoint stratified samples, the [near, far] -> [-1, 1] position
    map, deltas with the 1e10 tail, exclusive-cumprod transmittance and a
    white background — in float64."""
    model = _model(name)
    params = _params(model)
    o, d = _rays(16)
    s = SETTINGS.num_samples
    edges = np.linspace(NEAR, FAR, s + 1)
    t = np.broadcast_to(0.5 * (edges[:-1] + edges[1:]), (16, s))
    pts = o[:, None] + t[..., None] * d[:, None]
    pts_n = 2.0 * (pts - NEAR) / (FAR - NEAR) - 1.0
    dirs = np.broadcast_to(d[:, None], pts.shape)
    rgb_f, sigma_f = jax.jit(model.apply)(
        params, jnp.asarray(pts_n, jnp.float32), jnp.asarray(dirs, jnp.float32))
    rgb_f = np.asarray(rgb_f, np.float64)
    sigma_f = np.asarray(sigma_f, np.float64)
    delta = np.concatenate([np.diff(t, axis=-1), np.full((16, 1), 1e10)], -1)
    alpha = 1.0 - np.exp(-sigma_f * delta)
    trans = np.concatenate([np.ones((16, 1)),
                            np.cumprod(1.0 - alpha, axis=-1)[:, :-1]], -1)
    w = trans * alpha
    want = (w[..., None] * rgb_f).sum(1) + (1.0 - w.sum(-1, keepdims=True))

    out = jax.jit(lambda p, o, d: render_rays(
        model.apply, p, o, d, jax.random.key(0), SETTINGS))(
        params, jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_allclose(np.asarray(out.rgb), want, atol=1e-5)


@family
def test_render_image_chunking_invariant(name):
    """lax.map tiling is a memory bound only: 40 rays in tiles of 16 (with
    padding) or in one tile render the same image."""
    model = _model(name)
    params = _params(model)
    o, d = _rays(40, seed=5)
    o, d = jnp.asarray(o), jnp.asarray(d)
    outs = []
    for chunk in (16, 64):
        settings = RenderSettings(near=NEAR, far=FAR, num_samples=8,
                                  perturb=False, chunk_size=chunk)
        outs.append(jax.jit(lambda p, o, d: render_image(
            model.apply, p, o, d, jax.random.key(0), settings).rgb)(
            params, o, d))
    np.testing.assert_allclose(np.asarray(outs[0]), np.asarray(outs[1]),
                               rtol=1e-5, atol=1e-6)


@family
def test_data_parallel_step_matches_single_device(name):
    """One GSPMD train step with the batch sharded over a 4-device mesh
    equals the single-device step (same keys, same global batch)."""
    model = _model(name)
    tx = optax.adam(1e-3)
    state = _state(model, tx)
    pool = _pool()
    settings = RenderSettings(near=NEAR, far=FAR, num_samples=8)
    single = make_train_step(model, tx, settings, 64, jax.random.key(1),
                             donate=False)
    mesh = create_mesh("data:4", devices=jax.devices()[:4])
    sharded = make_train_step(model, tx, settings, 64, jax.random.key(1),
                              data_sharding=data_sharding(mesh), donate=False)
    s1, m1 = single(state, pool)
    s2, m2 = sharded(state, pool)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    # Adam's first step divides by |g|: summation-order noise in near-zero
    # gradients shows in the update at ~1e-6 of lr=1e-3
    _leaves_close(s1.params, s2.params, atol=1e-5)


@family
def test_sharded_eval_matches_single_device(name):
    """make_eval_render shard_map'd over a 4-device mesh (42 rays: the
    padding engages) renders what one device renders."""
    model = _model(name)
    params = _params(model)
    o, d = _rays(42, seed=6)
    mesh = create_mesh("data:4", devices=jax.devices()[:4])
    key = jax.random.key(0)
    a = make_eval_render(model, SETTINGS)(params, {}, o, d, key)
    b = make_eval_render(model, SETTINGS, mesh=mesh)(params, {}, o, d, key)
    assert b.rgb.shape == (42, 3)
    np.testing.assert_allclose(np.asarray(a.rgb), np.asarray(b.rgb),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(a.depth), np.asarray(b.depth),
                               atol=1e-5)


@family
def test_checkpoint_round_trip_and_resume(name, tmp_path):
    """A saved state restores leaf for leaf, and the step after a resume
    equals the step without one."""
    model = _model(name)
    tx = optax.adam(1e-3)
    pool = _pool()
    step = make_train_step(model, tx, SETTINGS, 64, jax.random.key(1),
                           donate=False)
    state, _ = step(_state(model, tx), pool)
    path = save_checkpoint(state, str(tmp_path), name, 1)
    restored = load_checkpoint(path, _state(model, tx))
    _leaves_close(restored, state, rtol=0, atol=0)
    assert int(restored.step) == 1
    _leaves_close(step(restored, pool)[0], step(state, pool)[0],
                  rtol=0, atol=0)


@family
def test_scan_steps_equal_single_steps(name):
    """Four train steps inside one lax.scan dispatch equal four single-step
    calls bit for bit on the CPU: each step's randomness derives from
    state.step, so chunking only amortises dispatch."""
    model = _model(name)
    tx = optax.adam(1e-3)
    pool = _pool()
    one = make_train_step(model, tx, SETTINGS, 64, jax.random.key(1),
                          donate=False)
    four = make_scan_train_step(model, tx, SETTINGS, 64, jax.random.key(1),
                                num_steps=4, donate=False)
    state = _state(model, tx)
    s_a, losses = state, []
    for _ in range(4):
        s_a, m = one(s_a, pool)
        losses.append(np.asarray(m["mse"]))
    s_b, ms = four(state, pool)
    np.testing.assert_array_equal(np.asarray(ms["mse"]), np.stack(losses))
    _leaves_close(s_a, s_b, rtol=0, atol=0)
    assert int(s_b.step) == 4
