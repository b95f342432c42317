"""Multi-scene batched training: N scenes trained concurrently on one mesh.

No reference counterpart (single scene only); required by BASELINE.json
config 5 ("4 Blender scenes trained concurrently, rays sharded across 2
hosts"). Design: per-scene parameter pytrees are STACKED along a leading
scene axis and sharded over the mesh's ``scene`` axis; each scene's ray pool
is sharded over the ``data`` axis. The per-scene train step is ``vmap``-ed
over the scene axis, so under GSPMD each (scene, data) mesh tile trains its
scene slice with zero cross-scene communication — gradients all-reduce only
within a scene's data-axis group, and the scene axis maps naturally onto
the slower links between hosts.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from nerf_jax.data.pipeline import RayPool
from nerf_jax.render.renderer import RenderSettings, render_rays
from nerf_jax.train.state import TrainState


def stack_scenes(per_scene_pytrees):
    """Stack a list of identically-structured pytrees along a new leading
    scene axis (params or pools)."""
    return jax.tree.map(lambda *xs: jnp.stack(xs, axis=0), *per_scene_pytrees)


def make_multiscene_train_step(
    model,
    tx,
    settings: RenderSettings,
    batch_size_per_scene: int,
    base_key: jax.Array,
    mesh: Mesh,
    scene_axis: str = "scene",
    data_axis: str = "data",
    donate: bool = True,
    regularizer=None,
    num_steps: int = 1,
):
    """Returns ``step(state, pools) -> (state, metrics)``.

    ``state`` holds scene-stacked params/opt_state (leading axis S);
    ``pools`` is a RayPool with leaves (S, M, 3). Metrics are per-scene
    vectors of shape (S,). ``regularizer(param_pair) -> scalar`` (e.g.
    the grid families' TV prior, train/loop.py::make_regularizer) is
    applied PER SCENE inside the vmap — gradients stay scene-local.

    ``num_steps > 1`` runs that many iterations inside ONE compiled
    dispatch via ``lax.scan`` (metrics leaves become ``(num_steps, S)``).
    Randomness keys off ``state.step``, so a scan of N steps is
    bit-identical to N single-step calls — the same dispatch-amortization
    contract as ``train.step.make_scan_train_step``."""
    param_sharding = NamedSharding(mesh, P(scene_axis))
    pool_sharding = NamedSharding(mesh, P(scene_axis, data_axis))

    def scene_loss(params, fine_params, pool: RayPool, key):
        k_sample, k_render = jax.random.split(key)
        batch = pool.sample(k_sample, batch_size_per_scene)
        out = render_rays(
            model.apply,
            params,
            batch.rays_o,
            batch.rays_d,
            k_render,
            settings,
            fine_params=fine_params if fine_params else None,
            viewdirs=batch.viewdirs,
        )
        mse = jnp.mean((out.rgb - batch.rgb) ** 2)
        loss = mse
        if settings.num_fine_samples > 0:
            loss = loss + jnp.mean((out.rgb_coarse - batch.rgb) ** 2)
        return loss, mse

    def scene_loss_reg(params, fine_params, pool, key):
        loss, mse = scene_loss(params, fine_params, pool, key)
        if regularizer is not None:
            loss = loss + regularizer((params, fine_params))
        return loss, mse

    def loss_fn(param_pair, pools, keys):
        params, fine_params = param_pair
        losses, mses = jax.vmap(scene_loss_reg)(params, fine_params, pools,
                                                keys)
        # Sum over scenes: gradients stay per-scene (no cross-terms).
        return jnp.sum(losses), (losses, mses)

    def step(state: TrainState, pools: RayPool):
        num_scenes = jax.tree_util.tree_leaves(state.params)[0].shape[0]
        key = jax.random.fold_in(base_key, state.step)
        keys = jax.random.split(key, num_scenes)

        param_pair = jax.tree.map(
            lambda x: jax.lax.with_sharding_constraint(x, param_sharding),
            (state.params, state.fine_params),
        )
        pools = jax.tree.map(
            lambda x: jax.lax.with_sharding_constraint(x, pool_sharding), pools
        )

        (_, (losses, mses)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            param_pair, pools, keys
        )
        updates, opt_state = tx.update(grads, state.opt_state, param_pair)
        params, fine_params = jax.tree.map(lambda p, u: p + u, param_pair, updates)
        new_state = TrainState(
            step=state.step + 1,
            params=params,
            fine_params=fine_params,
            opt_state=opt_state,
        )
        # metrics replicate so the host can fetch them under multihost
        # (the (S,) vectors otherwise inherit the scene sharding and span
        # non-addressable devices); S scalars of all-gather is free
        rep = NamedSharding(mesh, P())
        metrics = {
            "loss": losses,
            "mse": mses,
            "psnr": -10.0 * jnp.log10(mses),
        }
        metrics = jax.tree.map(
            lambda x: jax.lax.with_sharding_constraint(x, rep), metrics
        )
        return new_state, metrics

    if num_steps > 1:
        def step_n(state: TrainState, pools: RayPool):
            def body(carry, _):
                return step(carry, pools)

            return jax.lax.scan(body, state, None, length=num_steps)

        return jax.jit(step_n, donate_argnums=(0,) if donate else ())
    return jax.jit(step, donate_argnums=(0,) if donate else ())
