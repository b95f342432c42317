"""The jitted training step — the whole hot loop in one compiled program.

The reference's per-iteration work (batch fetch -> H2D copy -> chunked
render -> MSE -> backward -> Adam -> LR step, /root/reference/train.py:154-183)
becomes ONE jit-compiled function of (TrainState, RayPool): on-device batch
sampling, a single un-chunked render, value_and_grad, and the optax update,
with the state donated so parameter/optimizer buffers update in place in
device memory. Per-step randomness derives from ``fold_in(base_key, step)``, so runs
are exactly reproducible and resume continues the same random sequence.

Loss matches the reference: MSE of rendered vs target rgb (train.py:124,180);
with hierarchical sampling the coarse MSE is added (original-NeRF style),
which the coarse-only reference never reaches.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp

from nerf_jax.data.pipeline import RayBatch, RayPool
from nerf_jax.render.renderer import RenderSettings, render_image, render_rays
from nerf_jax.train.state import TrainState


def _make_step_body(
    apply_fn: Callable,
    tx,
    settings: RenderSettings,
    batch_size: int,
    base_key: jax.Array,
    data_sharding=None,
    epoch_sampling: bool = False,
    regularizer: Optional[Callable] = None,
    occupancy_opts: Optional[tuple] = None,
):
    """The un-jitted single-iteration body shared by the one-step and
    scanned trainers: sample batch -> render -> MSE -> grad -> optax update.

    ``regularizer(param_pair) -> scalar`` is added to the photometric loss
    (but not to the logged mse) — fit() wires the grid families' TV prior
    through it.

    ``occupancy_opts = (domain, num_bins, floor)`` enables the optional
    ``occ_grid`` step argument: fit() rebakes an occupancy prior from the
    live field at intervals and passes it as a TRACED array (not a closure
    constant, so a rebake never retraces), and the coarse pass draws its
    samples from the prior's inverse CDF (ops/occupancy.py)."""
    # epoch-permutation sampling keys the per-epoch cipher off a stream
    # disjoint from the per-step render keys
    k_epoch = jax.random.fold_in(base_key, 0x7FFFFFFF)

    def _occ(occ_grid):
        if occ_grid is None:
            return None
        from nerf_jax.ops.occupancy import OccupancyGrid

        domain, num_bins, floor = occupancy_opts
        return OccupancyGrid(grid=occ_grid, domain=domain,
                             num_bins=num_bins, floor=floor)

    def loss_fn(param_pair, batch: RayBatch, key: jax.Array, occ_grid):
        params, fine_params = param_pair
        out = render_rays(
            apply_fn,
            params,
            batch.rays_o,
            batch.rays_d,
            key,
            settings,
            fine_params=fine_params if fine_params else None,
            viewdirs=batch.viewdirs,
            occupancy=_occ(occ_grid),
        )
        mse = jnp.mean((out.rgb - batch.rgb) ** 2)
        loss = mse
        if settings.num_fine_samples > 0:
            loss = loss + jnp.mean((out.rgb_coarse - batch.rgb) ** 2)
        if regularizer is not None:
            loss = loss + regularizer(param_pair)
        return loss, mse

    def step(state: TrainState, pool: RayPool, occ_grid=None):
        key = jax.random.fold_in(base_key, state.step)
        k_sample, k_render = jax.random.split(key)

        if epoch_sampling:
            batch = pool.sample_epoch(k_epoch, state.step, batch_size)
        else:
            batch = pool.sample(k_sample, batch_size)
        if data_sharding is not None:
            batch = jax.tree.map(
                lambda x: jax.lax.with_sharding_constraint(x, data_sharding), batch
            )

        (loss, mse), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            (state.params, state.fine_params), batch, k_render, occ_grid
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
        metrics = {
            "loss": loss,
            "mse": mse,
            "psnr": -10.0 * jnp.log10(mse),
        }
        return new_state, metrics

    return step


def make_train_step(
    model,
    tx,
    settings: RenderSettings,
    batch_size: int,
    base_key: jax.Array,
    data_sharding=None,
    donate: bool = True,
    epoch_sampling: bool = False,
    regularizer: Optional[Callable] = None,
    occupancy_opts: Optional[tuple] = None,
):
    """Returns ``step(state, pool[, occ_grid]) -> (state, metrics)``
    (jitted).

    ``data_sharding`` optionally constrains the sampled ray batch onto the
    mesh's data axis; with replicated params XLA then emits the gradient
    all-reduce automatically.
    """
    step = _make_step_body(
        model.apply, tx, settings, batch_size, base_key,
        data_sharding, epoch_sampling=epoch_sampling,
        regularizer=regularizer, occupancy_opts=occupancy_opts,
    )
    return jax.jit(step, donate_argnums=(0,) if donate else ())


def make_scan_train_step(
    model,
    tx,
    settings: RenderSettings,
    batch_size: int,
    base_key: jax.Array,
    num_steps: int,
    data_sharding=None,
    donate: bool = True,
    epoch_sampling: bool = False,
    regularizer: Optional[Callable] = None,
    occupancy_opts: Optional[tuple] = None,
):
    """Returns ``step_n(state, pool[, occ_grid]) -> (state, metrics)``
    running
    ``num_steps`` training iterations inside ONE compiled program via
    ``lax.scan``; ``metrics`` leaves are stacked ``(num_steps,)`` arrays.

    Because each iteration's randomness and batch selection derive from
    ``state.step`` (fold_in), a scan of N steps computes the same values as
    N single-step calls — chunking is purely a dispatch-amortization
    choice: between host touchpoints (log/val/save boundaries) there is
    nothing for the host to do, so one dispatch carries the whole chunk.
    """
    one_step = _make_step_body(
        model.apply, tx, settings, batch_size, base_key,
        data_sharding, epoch_sampling=epoch_sampling,
        regularizer=regularizer, occupancy_opts=occupancy_opts,
    )

    def step_n(state: TrainState, pool: RayPool, occ_grid=None):
        # occ_grid is constant across the chunk by design: fit() rebakes
        # only at event boundaries
        def body(carry, _):
            new_state, metrics = one_step(carry, pool, occ_grid)
            return new_state, metrics

        return jax.lax.scan(body, state, None, length=num_steps)

    return jax.jit(step_n, donate_argnums=(0,) if donate else ())


def make_eval_render(
    model,
    settings: RenderSettings,
    mesh=None,
    occupancy=None,
):
    """Returns a full-image renderer:
    ``render(params, fine_params, rays_o, rays_d, key, viewdirs=None)
    -> RenderOutput``. Memory is bounded by ``settings.chunk_size`` via
    lax.map tiling.

    When ``mesh`` (a multi-device, single-process jax.sharding.Mesh) is
    given, the render is shard_map'd over the mesh's ``data`` axis: rays
    split into contiguous per-device shards, params replicated, each
    device running the full per-ray pipeline locally; the only
    cross-device traffic is the output's logical concat. Ray counts are
    padded to a multiple of the device count."""
    ndev = int(np.prod(mesh.devices.shape)) if mesh is not None else 1
    use_mesh = ndev > 1 and jax.process_count() == 1

    def _render_body(params, fine_params, rays_o, rays_d, viewdirs, key):
        return render_image(
            model.apply,
            params,
            rays_o,
            rays_d,
            key,
            settings,
            fine_params=fine_params if fine_params else None,
            viewdirs=viewdirs,
            # an OccupancyGrid prior concentrates the coarse samples in
            # occupied space (ops/occupancy.py) — a closure constant, so
            # it replicates onto every device under the shard_map below
            occupancy=occupancy,
        )

    if use_mesh:
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        axis = "data" if "data" in mesh.axis_names else mesh.axis_names[0]

        def _shard_body(params, fine_params, rays_o, rays_d, viewdirs, key):
            # decorrelate the stratified jitter across ray shards
            key = jax.random.fold_in(key, jax.lax.axis_index(axis))
            return _render_body(params, fine_params, rays_o, rays_d,
                                viewdirs, key)

        _render = jax.jit(shard_map(
            _shard_body,
            mesh=mesh,
            in_specs=(P(), P(), P(axis), P(axis), P(axis), P()),
            out_specs=P(axis),
        ))
    else:
        _render = jax.jit(_render_body)

    def render(params, fine_params, rays_o, rays_d, key, viewdirs=None):
        if viewdirs is None:
            viewdirs = rays_d / jnp.linalg.norm(rays_d, axis=-1, keepdims=True)
        if use_mesh:
            # params restored from a checkpoint (or trained single-device)
            # arrive committed to one device — incompatible with the
            # mesh-spanning shard_map; re-place replicated (no-op when
            # already mesh-placed, e.g. from fit()). Rays get the same
            # treatment: a caller may pass arrays committed to a single
            # device (e.g. sliced from a device-resident pool), which the
            # mesh jit would otherwise reject with a device-assignment
            # error.
            from jax.sharding import NamedSharding, PartitionSpec

            rep = NamedSharding(mesh, PartitionSpec())
            params = jax.device_put(params, rep)
            if fine_params:
                fine_params = jax.device_put(fine_params, rep)
            rays_o = jax.device_put(jnp.asarray(rays_o), rep)
            rays_d = jax.device_put(jnp.asarray(rays_d), rep)
            viewdirs = jax.device_put(jnp.asarray(viewdirs), rep)
        num_rays = rays_o.shape[0]
        pad = (-num_rays) % ndev if use_mesh else 0
        if pad:
            def padded(x):
                filler = jnp.ones((pad,) + x.shape[1:], x.dtype)
                return jnp.concatenate([x, filler], axis=0)

            rays_o, rays_d = padded(rays_o), padded(rays_d)
            viewdirs = padded(viewdirs)
        out = _render(params, fine_params, rays_o, rays_d, viewdirs, key)
        if pad:
            out = type(out)(*(x[:num_rays] for x in out))
        return out

    return render
