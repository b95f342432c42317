"""LR schedule golden test vs the reference law (train.py:126-131):
lr(step) = lr0 * max(gamma**step, lr_min/lr0), gamma = factor**(1/(decay*1000))."""

import numpy as np
import jax.numpy as jnp

from nerf_jax.train.optim import lr_schedule


def test_schedule_matches_reference_law():
    lr0, decay, factor, lr_min = 5e-4, 300.0, 0.1, 1e-4
    sched = lr_schedule(lr0, decay, factor, lr_min)
    gamma = factor ** (1 / (decay * 1000))
    for step in (0, 1, 100, 10_000, 200_000):
        want = lr0 * max(gamma**step, lr_min / lr0)
        got = float(sched(jnp.asarray(step)))
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_schedule_floor():
    sched = lr_schedule(5e-4, 1.0, 0.1, 1e-4)  # fast decay: floor by ~700 steps
    assert abs(float(sched(jnp.asarray(10_000))) - 1e-4) < 1e-9
    assert abs(float(sched(jnp.asarray(10_000_000))) - 1e-4) < 1e-9


def test_schedule_initial_lr():
    sched = lr_schedule(5e-4, 300.0, 0.1, 1e-5)
    np.testing.assert_allclose(float(sched(jnp.asarray(0))), 5e-4, rtol=1e-6)
