"""Occupancy-guided sampling: empty-space skipping with static shapes.

The CUDA renderers this framework re-designs (KiloNeRF sec. 4.2, Instant
NGP, NerfAcc) skip empty space by ray-marching an occupancy grid and
early-terminating — data-dependent loops and compacted sample lists, the
exact shapes a static-shape compiled program cannot hold. The equivalent
here keeps the sample
count STATIC and moves the samples instead: a cheap occupancy prepass
scores ``num_bins`` t-midpoints per ray, and the coarse pass draws its
``num_samples`` from the resulting piecewise-constant PDF through the
same branch-free inverse-CDF used for hierarchical sampling
(ops/sampling.py::sample_pdf, with sorted stratified quantiles so t stays
monotonic for the compositor). Every sample the field evaluates then lies
in occupied space — equal quality at a fraction of ``num_samples``, which
is a direct rays/s multiplier since field evaluation dominates render
cost.

Composes with every field family unchanged: the renderer takes ``t`` as
an input, so occupancy only changes WHERE the samples are.

A floor keeps the PDF strictly positive everywhere (the grid is a prior,
not a hard mask — content the bake missed still receives samples), and
the bake dilates occupancy by one cell, both standard practice.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from nerf_jax.models.common import remap_domain
from nerf_jax.ops.sampling import normalize_positions, sample_pdf


class OccupancyGrid(NamedTuple):
    """A baked binary occupancy prior over the model-input-space ``domain``
    cube (registry.py::grid_domain), plus the sampling knobs. Pass to
    ``render_rays(occupancy=...)`` / ``make_eval_render(occupancy=...)``."""

    grid: jax.Array              # (R, R, R, 1) float32 in {0, 1}
    domain: tuple = (-1.0, 1.0)  # cube the grid spans (model input space)
    num_bins: int = 64           # t-bins scored per ray
    floor: float = 1e-2          # minimum bin weight (prior, not a mask)


def bake_occupancy(
    sigma_fn,
    grid_res: int = 64,
    domain: tuple = (-1.0, 1.0),
    threshold: float = 1e-2,
    dilate: int = 1,
    chunk: int = 65536,
) -> jax.Array:
    """Sample ``sigma_fn(pts (N,3) in domain^3) -> (N,)`` on a dense
    lattice and threshold into a {0,1} grid, dilated by ``dilate`` cells
    (3^3 max-pool per step) so surfaces straddling a cell face keep their
    neighborhood sampled."""
    r = grid_res
    lin = jnp.linspace(domain[0], domain[1], r, dtype=jnp.float32)
    pts = jnp.stack(jnp.meshgrid(lin, lin, lin, indexing="ij"),
                    axis=-1).reshape(-1, 3)
    n = pts.shape[0]
    pad = (-n) % chunk
    pts_p = jnp.concatenate([pts, jnp.zeros((pad, 3), jnp.float32)])
    sigma = jax.lax.map(sigma_fn, pts_p.reshape(-1, min(chunk, n + pad), 3))
    occ = (sigma.reshape(-1)[:n] > threshold).astype(jnp.float32)
    occ = occ.reshape(r, r, r)
    for _ in range(dilate):
        occ = jax.lax.reduce_window(
            occ, -jnp.inf, jax.lax.max,
            window_dimensions=(3, 3, 3), window_strides=(1, 1, 1),
            padding="SAME",
        )
    return occ[..., None]


def sigma_field(apply_fn, params):
    """Adapt the standard field contract to ``bake_occupancy``'s
    ``pts -> sigma`` (density is view-independent in every family)."""

    def fn(pts):
        _, sigma = apply_fn(params, pts, jnp.broadcast_to(
            jnp.asarray([0.0, 0.0, 1.0], pts.dtype), pts.shape))
        return sigma

    return fn


def _occ_trilinear(grid: jax.Array, p: jax.Array) -> jax.Array:
    """Trilinear lookup specialized for the tiny 1-channel occupancy grid.

    ``ops.interp.trilinear``'s (1,1,2,C)-slice pair gathers are the right
    shape for the 28-channel field grids, but at C=1 the 8-byte slices hit
    XLA's degenerate tiny-slice gather (~1.6 us/row — one 65k-point lookup
    measured 413 ms, ~60x the whole S=16 plenoxels grad step it was meant
    to guide; the same wall as the round-1 "(2,2,2,C) stencil" note in
    interp.py). Instead gather whole z-COLUMNS — row (x*r+y) holds all r
    z-values, an ordinary wide-row gather — and do the z-lerp as a lane
    one-hot contraction. 4 gathers of N rows total, ~3 ms at 65k points.

    ``p`` in [-1, 1]^3; same clamp/corner law as ``interp.trilinear``.
    """
    r = grid.shape[0]
    g2 = grid[..., 0].reshape(r * r, r)
    x = jnp.clip((p + 1.0) * 0.5 * (r - 1), 0.0, r - 1.0)
    x0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, r - 2)
    f = x - x0
    lane = jnp.arange(r, dtype=jnp.int32)[None, :]
    z0 = x0[:, 2:3]
    zsel = ((lane == z0).astype(grid.dtype) * (1.0 - f[:, 2:3])
            + (lane == z0 + 1).astype(grid.dtype) * f[:, 2:3])   # (N, r)
    out = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            w_xy = ((f[:, 0] if dx else 1.0 - f[:, 0])
                    * (f[:, 1] if dy else 1.0 - f[:, 1]))
            rows = g2[(x0[:, 0] + dx) * r + (x0[:, 1] + dy)]     # (N, r)
            out = out + w_xy * jnp.sum(rows * zsel, axis=-1)
    return out


def occupancy_t(
    key: jax.Array,
    occ: OccupancyGrid,
    rays_o: jax.Array,
    rays_d: jax.Array,
    near: float,
    far: float,
    num_samples: int,
    normalize: bool = True,
    perturb: bool = True,
) -> jax.Array:
    """(num_rays, num_samples) monotonic t-values concentrated where the
    occupancy prior is nonzero — the drop-in replacement for
    ``stratified_sample`` in the coarse pass."""
    num_rays = rays_o.shape[0]
    m = occ.num_bins
    edges = jnp.linspace(near, far, m + 1, dtype=jnp.float32)
    mids = 0.5 * (edges[1:] + edges[:-1])
    t_mid = jnp.broadcast_to(mids, (num_rays, m))
    pts = rays_o[:, None, :] + t_mid[..., None] * rays_d[:, None, :]
    if normalize:
        pts = normalize_positions(pts, near, far)
    pts = remap_domain(pts, occ.domain)
    # z-column-gather trilinear (see _occ_trilinear): both the brick-DMA
    # render kernel and the (1,1,2,1)-slice pair gathers measured
    # 345-413 ms for this ONE 1-channel lookup — ~50x the S=16 grad step
    # it guides, and the cause of round 3's hanging S=16 profile runs.
    w = _occ_trilinear(occ.grid, pts.reshape(-1, 3)).reshape(num_rays, m)
    w = jnp.maximum(w, occ.floor)

    # sorted stratified quantiles -> monotonic t straight from the CDF
    base = (jnp.arange(num_samples, dtype=jnp.float32)[None]
            + (jax.random.uniform(key, (num_rays, num_samples))
               if perturb else 0.5)) / num_samples
    bins = jnp.broadcast_to(edges, (num_rays, m + 1))
    return sample_pdf(key, bins, w, num_samples,
                      u=jnp.minimum(base, 1.0 - 1e-5))
