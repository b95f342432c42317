"""Tests that need a CUDA GPU (marker ``gpu``; skipped elsewhere).

    NERF_JAX_TEST_GPU=1 python -m pytest tests/ -m gpu

They pin what only the card can show: float32 products really are float32
(no TF32), bfloat16 products really are rounded, scan-chunked training
matches single-step dispatch bit for bit for an MLP family, and within
atomics noise for a grid family whose gradient is a scatter-add.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nerf_jax.config import Config
from nerf_jax.data.pipeline import RayPool
from nerf_jax.models.common import linear
from nerf_jax.render.renderer import RenderSettings
from nerf_jax.train.state import create_train_state
from nerf_jax.train.step import make_scan_train_step, make_train_step

pytestmark = pytest.mark.gpu


def _operands(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(4096, 256)).astype(np.float32)
    w = rng.normal(size=(256, 256)).astype(np.float32) / 16.0
    return x, {"w": w, "b": np.zeros(256, np.float32)}


def _rel_err(got, x, w):
    want = x.astype(np.float64) @ w["w"].astype(np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


def test_float32_linear_is_not_tf32(gpu):
    """TF32 keeps 10 mantissa bits (relative rounding ~5e-4 per operand);
    a true float32 product over 256 terms stays near 1e-6."""
    x, w = _operands()
    got = jax.jit(lambda x, w: linear(w, x, jnp.float32))(x, w)
    assert _rel_err(got, x, w) < 1e-5


def test_bfloat16_linear_rounds_operands(gpu):
    """bf16 operands (8 mantissa bits) put the product error near 2^-9 of
    its scale: above float32 noise, below 1%."""
    x, w = _operands(1)
    got = jax.jit(lambda x, w: linear(w, x, jnp.bfloat16))(x, w)
    err = _rel_err(got, x, w)
    assert 1e-5 < err < 1e-2


def _pool(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return RayPool(rays_o=jnp.asarray(-4.0 * d), rays_d=jnp.asarray(d),
                   rgb=jnp.asarray(rng.uniform(size=(n, 3)), jnp.float32),
                   viewdirs=jnp.asarray(d))


def _scan_and_single(cfg, steps=4):
    settings = RenderSettings(num_samples=cfg.num_samples)
    model, tx, state = create_train_state(cfg, jax.random.key(0))
    pool = _pool()
    single = make_train_step(model, tx, settings, 256, jax.random.key(1),
                             donate=False)
    scan = make_scan_train_step(model, tx, settings, 256, jax.random.key(1),
                                num_steps=steps, donate=False)
    s1, losses = state, []
    for _ in range(steps):
        s1, m = single(s1, pool)
        losses.append(float(m["loss"]))
    s2, m2 = scan(state, pool)
    return s1, s2, np.asarray(losses), np.asarray(m2["loss"])


def test_scan_matches_single_steps_nerf(gpu):
    """Randomness keys off state.step, so a scan of N steps and N single
    dispatches run the same arithmetic: bit-identical for the MLP path."""
    cfg = Config(model_type="nerf", num_samples=32, hidden_dim=128)
    s1, s2, l1, l2 = _scan_and_single(cfg)
    np.testing.assert_array_equal(l1, l2)
    for a, b in zip(jax.tree_util.tree_leaves(s1.params),
                    jax.tree_util.tree_leaves(s2.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_scan_matches_single_steps_grid_family(gpu):
    """A voxel grid's gradient is a scatter-add, which the GPU runs with
    atomics in no fixed order: the losses agree to float32 summation noise
    (1e-5 relative), not bit for bit."""
    cfg = Config(model_type="plenoxels", grid_res=64, num_samples=32,
                 learning_rate=1e-2)
    _, _, l1, l2 = _scan_and_single(cfg)
    np.testing.assert_allclose(l1, l2, rtol=1e-5)
