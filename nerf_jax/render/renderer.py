"""Volumetric renderer: sample -> query -> composite, fully batched.

Capability-equivalent to the reference renderer
(/root/reference/nerf/rendering.py:156-226) with two structural differences:

  * No Python chunk loop in the training path. The reference loops over
    ``chunk_size`` ray chunks in Python (rendering.py:191) purely to bound
    GPU memory; here a training batch is rendered in ONE traced computation
    so XLA sees a single static graph (batch x samples points through the
    MLP), which is what lets the whole step fuse. Full-image renders use
    ``jax.lax.map`` over fixed-size ray tiles (`render_image`) — the same
    memory bound, but inside the compiled program instead of the host.

  * Hierarchical coarse/fine sampling (absent in the reference, which is
    coarse-only) with device-local inverse-CDF resampling.

Numerics match the reference: single shared-or-per-ray stratified jitter,
deltas with the 1e10 tail, componentwise [near,far]->[-1,1] position
normalization before the model query, exclusive-cumprod transmittance, and
optional white-background compositing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from nerf_jax.ops.sampling import (
    deltas_from_t,
    merge_samples,
    normalize_positions,
    sample_pdf,
    sample_positions,
    stratified_sample,
)
from nerf_jax.ops.volume import composite


@dataclass(frozen=True)
class RenderSettings:
    """Static (hashable) render options — safe to close over under jit."""

    near: float = 2.0
    far: float = 6.0
    num_samples: int = 256
    num_fine_samples: int = 0        # >0 enables hierarchical sampling
    white_background: bool = True
    jitter_mode: str = "per_ray"     # "per_ray" | "shared" (reference parity)
    perturb: bool = True             # False => deterministic midpoint samples
    chunk_size: int = 8192           # ray tile size for full-image renders
    normalize_positions: bool = True  # the reference's [near,far]->[-1,1] map
    # Fine-pass construction (hierarchical only):
    #   "merge"    — original-NeRF: iid-uniform inverse-CDF draws, sorted
    #                union with the coarse t (the parity default).
    #   "resample" — mip-NeRF-style: ONE stratified sorted inverse-CDF
    #                draw of (num_samples + num_fine_samples) quantiles;
    #                monotone by construction, so merge_samples' (R, M, M)
    #                rank/one-hot broadcasts vanish and sample_pdf runs
    #                once. Statistically a lower-variance estimator of the
    #                same integral (stratified beats iid), not bit-parity.
    fine_sampling: str = "merge"


class RenderOutput(NamedTuple):
    rgb: jax.Array                 # (R, 3) final color (fine if hierarchical)
    depth: jax.Array               # (R,)
    acc: jax.Array                 # (R,)
    disparity: jax.Array           # (R,)
    rgb_coarse: jax.Array          # (R, 3) coarse color (== rgb if coarse-only)


ApplyFn = Callable[[dict, jax.Array, jax.Array], tuple[jax.Array, jax.Array]]


def _query(
    apply_fn: ApplyFn,
    params: dict,
    points: jax.Array,       # (R, S, 3) world-space sample positions
    viewdirs: jax.Array,     # (R, 3) unit view directions
    settings: RenderSettings,
) -> tuple[jax.Array, jax.Array]:
    """Normalize positions and evaluate the field; returns (rgb, sigma) with
    shapes (R, S, 3) and (R, S)."""
    if settings.normalize_positions:
        points = normalize_positions(points, settings.near, settings.far)
    dirs = jnp.broadcast_to(viewdirs[..., None, :], points.shape)
    return apply_fn(params, points, dirs)


def _render_pass(
    apply_fn: ApplyFn,
    params: dict,
    rays_o: jax.Array,
    rays_d: jax.Array,
    viewdirs: jax.Array,
    t: jax.Array,
    settings: RenderSettings,
):
    points = sample_positions(rays_o, rays_d, t)
    rgb, sigma = _query(apply_fn, params, points, viewdirs, settings)
    deltas = deltas_from_t(t)
    out = composite(
        rgb, sigma, deltas, t=t, white_background=settings.white_background
    )
    return out


def render_rays(
    apply_fn: ApplyFn,
    params: dict,
    rays_o: jax.Array,
    rays_d: jax.Array,
    key: jax.Array,
    settings: RenderSettings,
    fine_params: Optional[dict] = None,
    viewdirs: Optional[jax.Array] = None,
    occupancy=None,
) -> RenderOutput:
    """Render a batch of rays. Jittable; no data-dependent control flow.

    Args:
      apply_fn: ``(params, points, dirs) -> (rgb, sigma)`` field evaluator.
      rays_o/rays_d: (R, 3). ``rays_d`` need not be unit length (NDC rays
        aren't); ``viewdirs`` defaults to normalized ``rays_d`` and is what
        the view-dependent branch sees.
      key: PRNG key for stratified jitter + inverse-CDF sampling.
      fine_params: parameters for the fine pass (defaults to ``params``).
      occupancy: optional ops.occupancy.OccupancyGrid — the coarse pass
        then draws its samples from the occupancy prior's inverse CDF
        instead of uniform stratification (static-shape empty-space skip:
        fixed sample count, samples moved into occupied space).
    """
    num_rays = rays_o.shape[0]
    if viewdirs is None:
        viewdirs = rays_d / jnp.linalg.norm(rays_d, axis=-1, keepdims=True)

    k_coarse, k_fine = jax.random.split(key)
    if occupancy is not None:
        from nerf_jax.ops.occupancy import occupancy_t

        t = occupancy_t(
            k_coarse, occupancy, rays_o, rays_d,
            settings.near, settings.far, settings.num_samples,
            normalize=settings.normalize_positions,
            perturb=settings.perturb,
        )
    else:
        t = stratified_sample(
            k_coarse,
            settings.near,
            settings.far,
            settings.num_samples,
            num_rays,
            jitter_mode=settings.jitter_mode,
            perturb=settings.perturb,
        )
    coarse = _render_pass(apply_fn, params, rays_o, rays_d, viewdirs, t,
                          settings)

    if settings.num_fine_samples <= 0:
        return RenderOutput(
            rgb=coarse.rgb,
            depth=coarse.depth,
            acc=coarse.acc,
            disparity=coarse.disparity,
            rgb_coarse=coarse.rgb,
        )

    # Hierarchical pass: importance-sample the coarse weights (device-local).
    t_all = _fine_t(settings, k_fine, t, coarse.weights)

    fine = _render_pass(
        apply_fn,
        fine_params if fine_params is not None else params,
        rays_o,
        rays_d,
        viewdirs,
        t_all,
        settings,
    )
    return RenderOutput(
        rgb=fine.rgb,
        depth=fine.depth,
        acc=fine.acc,
        disparity=fine.disparity,
        rgb_coarse=coarse.rgb,
    )


def _fine_t(settings: RenderSettings, k_fine, t, weights):
    """The fine pass's t-vector from the coarse weights (stop-gradient).

    "merge": original-NeRF — iid inverse-CDF draws merged with the coarse
    t (reference-extension parity default). "resample": one stratified
    sorted inverse-CDF draw of all (num_samples + num_fine_samples)
    quantiles — monotone by construction, no merge op (see
    RenderSettings.fine_sampling)."""
    t_mid = 0.5 * (t[..., 1:] + t[..., :-1])
    w_mid = jax.lax.stop_gradient(weights[..., 1:-1])
    if settings.fine_sampling == "resample":
        mf = settings.num_samples + settings.num_fine_samples
        num_rays = t.shape[0]
        base = jnp.arange(mf, dtype=jnp.float32)[None, :]
        if settings.perturb:
            jit = jax.random.uniform(k_fine, (num_rays, mf),
                                     dtype=jnp.float32, maxval=1.0 - 1e-5)
        else:
            jit = jnp.full((1, mf), 0.5, jnp.float32)
        u = (base + jit) / mf                      # sorted per ray
        u = jnp.broadcast_to(u, (num_rays, mf))
        return jax.lax.stop_gradient(
            sample_pdf(k_fine, t_mid, w_mid, mf, u=u))
    if settings.fine_sampling != "merge":
        raise ValueError(
            f"fine_sampling must be 'merge' or 'resample', got "
            f"{settings.fine_sampling!r}")
    t_fine = sample_pdf(
        k_fine, t_mid, w_mid, settings.num_fine_samples,
        deterministic=not settings.perturb,
    )
    return merge_samples(t, jax.lax.stop_gradient(t_fine))


def render_image(
    apply_fn: ApplyFn,
    params: dict,
    rays_o: jax.Array,
    rays_d: jax.Array,
    key: jax.Array,
    settings: RenderSettings,
    fine_params: Optional[dict] = None,
    viewdirs: Optional[jax.Array] = None,
    occupancy=None,
) -> RenderOutput:
    """Render many rays (e.g. a full image) under a fixed memory bound.

    The reference bounds memory with a host-side Python loop over
    ``chunk_size`` chunks (rendering.py:191); here the loop is a
    ``jax.lax.map`` over equal ray tiles inside the compiled program — one
    compilation, sequential tile execution, no host round-trips. Rays are
    padded up to a tile multiple and the padding is stripped after.
    """
    total = rays_o.shape[0]
    tile = min(settings.chunk_size, total) if total > 0 else settings.chunk_size
    num_tiles = -(-total // tile)
    pad = num_tiles * tile - total

    if viewdirs is None:
        viewdirs = rays_d / jnp.linalg.norm(rays_d, axis=-1, keepdims=True)

    def pad_tile(x):
        x = jnp.concatenate([x, jnp.ones((pad,) + x.shape[1:], x.dtype)], axis=0)
        return x.reshape(num_tiles, tile, *x.shape[1:])

    ro, rd, vd = pad_tile(rays_o), pad_tile(rays_d), pad_tile(viewdirs)
    keys = jax.random.split(key, num_tiles)

    def render_tile(args):
        k, o, d, v = args
        return render_rays(
            apply_fn, params, o, d, k, settings,
            fine_params=fine_params, viewdirs=v, occupancy=occupancy,
        )

    out = jax.lax.map(render_tile, (keys, ro, rd, vd))
    return RenderOutput(*(x.reshape(-1, *x.shape[2:])[:total] for x in out))
