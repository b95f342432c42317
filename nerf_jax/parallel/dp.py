"""Explicit data-parallel training step via shard_map.

This is the explicit-collectives twin of the GSPMD path in
`nerf_jax.train.step` (which relies on sharding constraints and lets XLA
place the psum). Here the mapping is spelled out per device:

  * the RayPool is sharded along the ``data`` mesh axis (each device
    holds M/D rays in its memory — the pool never exists replicated),
  * each device samples ``batch/D`` rays from ITS OWN shard with a
    per-device PRNG key (fold_in of the step and the axis index),
  * each device renders and differentiates locally,
  * gradients and metrics are ``pmean``-averaged over the data axis —
    the only communication in the whole step (MLP params are ~661k
    floats, a small all-reduce next to the render).

The sample axis stays device-local by construction (it is never sharded), so
hierarchical inverse-CDF resampling needs no communication either.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from nerf_jax.data.pipeline import RayBatch, RayPool
from nerf_jax.render.renderer import RenderSettings, render_rays
from nerf_jax.train.state import TrainState


def make_shard_grads(model, settings: RenderSettings, local_batch: int,
                     base_key: jax.Array, axis: str = "data"):
    """The per-device body of the data-parallel step:
    ``grad_shard(param_pair, pool_shard, step) -> ((loss, mse), grads)``,
    with gradients and metrics averaged over the mesh axis ``axis``.

    It runs under ``shard_map`` (`make_dp_train_step`) or, on one device,
    under ``jax.vmap(..., in_axes=(None, 0, None), axis_name=axis)`` over a
    pool reshaped to (shards, rows per shard, ...) — the same per-shard
    sampling and the same mean, which is how the sharded step is checked
    against one device."""

    def loss_fn(param_pair, batch: RayBatch, key):
        params, fine_params = param_pair
        out = render_rays(
            model.apply,
            params,
            batch.rays_o,
            batch.rays_d,
            key,
            settings,
            fine_params=fine_params if fine_params else None,
            viewdirs=batch.viewdirs,
        )
        mse = jnp.mean((out.rgb - batch.rgb) ** 2)
        loss = mse
        if settings.num_fine_samples > 0:
            loss = loss + jnp.mean((out.rgb_coarse - batch.rgb) ** 2)
        return loss, mse

    def grad_shard(param_pair, pool_shard: RayPool, step):
        # per-device gradients: differentiated as replicated (invariant)
        # inputs, shard_map's autodiff would already sum them over the axis
        # and the pmean below would return that sum
        param_pair = jax.lax.pcast(param_pair, axis, to="varying")
        my_idx = jax.lax.axis_index(axis)
        key = jax.random.fold_in(jax.random.fold_in(base_key, step), my_idx)
        k_sample, k_render = jax.random.split(key)

        batch = pool_shard.sample(k_sample, local_batch)
        (loss, mse), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            param_pair, batch, k_render
        )
        grads = jax.lax.pmean(grads, axis)
        loss = jax.lax.pmean(loss, axis)
        mse = jax.lax.pmean(mse, axis)
        return (loss, mse), grads

    return grad_shard


def make_dp_grads(
    model,
    settings: RenderSettings,
    batch_size: int,
    base_key: jax.Array,
    mesh: Mesh,
    axis: str = "data",
):
    """``grads(param_pair, pool, step) -> ((loss, mse), grads)``: the
    `make_shard_grads` body shard_map'd over ``axis``, returning the
    averaged gradients of the global batch (replicated)."""
    num_shards = mesh.shape[axis]
    if batch_size % num_shards:
        raise ValueError(f"batch_size {batch_size} not divisible by {num_shards}")
    return shard_map(
        make_shard_grads(model, settings, batch_size // num_shards, base_key,
                         axis),
        mesh=mesh,
        in_specs=(P(), P(axis), P()),
        out_specs=(P(), P()),
    )


def make_dp_train_step(
    model,
    tx,
    settings: RenderSettings,
    batch_size: int,
    base_key: jax.Array,
    mesh: Mesh,
    axis: str = "data",
    donate: bool = True,
):
    """Returns ``step(state, pool) -> (state, metrics)`` with explicit
    per-device sampling and psum gradient reduction. ``pool`` must be placed
    with `nerf_jax.parallel.mesh.shard_pool`."""
    grad_shard = make_dp_grads(model, settings, batch_size, base_key, mesh,
                               axis)

    def step(state: TrainState, pool: RayPool):
        (loss, mse), grads = grad_shard(
            (state.params, state.fine_params), pool, state.step
        )
        updates, opt_state = tx.update(
            grads, state.opt_state, (state.params, state.fine_params)
        )
        params, fine_params = jax.tree.map(
            lambda p, u: p + u, (state.params, state.fine_params), updates
        )
        new_state = TrainState(
            step=state.step + 1,
            params=params,
            fine_params=fine_params,
            opt_state=opt_state,
        )
        return new_state, {"loss": loss, "mse": mse, "psnr": -10.0 * jnp.log10(mse)}

    return jax.jit(step, donate_argnums=(0,) if donate else ())
