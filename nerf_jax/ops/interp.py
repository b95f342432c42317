"""Grid interpolation primitives shared by the grid-based field families
(FastNeRF's baked cache, Plenoxels' voxel grid).

Shape policy: the 8-corner trilinear stencil is expressed as 4 gathers of
z-PAIRS — slice sizes (1, 1, 2, C), the two z-corners are adjacent in
memory — so each sample reads 4 contiguous rows instead of 8. Whether
this beats 8 flat row gathers on the GPU has not been measured.

The pair-gather is wrapped in a custom VJP whose backward is 8 flat row
scatter-adds into the flattened grid (exactly what an 8-gather forward's
autodiff produces — how a voxel grid trains), plus the analytic point
gradient. On a GPU the scatter-add lowers to atomics, so the grid
gradient can differ between runs in the last bits.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# the stencil weights are float32; keep their products out of TF32
_HIGHEST = jax.lax.Precision.HIGHEST


def _tri_coords(p: jnp.ndarray, r: int):
    x = jnp.clip((p + 1.0) * 0.5 * (r - 1), 0.0, r - 1.0)
    x0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, r - 2)
    return x0, x - x0


def _pair_gather(grid: jnp.ndarray, x0: jnp.ndarray, dx: int, dy: int):
    """Gather the two z-adjacent corner rows at (x0+dx, y0+dy, z0) ->
    (N, 2, C). One contiguous (1,1,2,C) slice per sample."""
    dnums = jax.lax.GatherDimensionNumbers(
        offset_dims=(1, 2, 3, 4),
        collapsed_slice_dims=(),
        start_index_map=(0, 1, 2),
    )
    start = x0 + jnp.array([dx, dy, 0], jnp.int32)
    return jax.lax.gather(
        grid, start, dnums, slice_sizes=(1, 1, 2, grid.shape[-1]),
        mode=jax.lax.GatherScatterMode.CLIP,
    )[:, 0, 0]


def _xy_weight(f: jnp.ndarray, dx: int, dy: int) -> jnp.ndarray:
    return ((f[:, 0] if dx else 1.0 - f[:, 0])
            * (f[:, 1] if dy else 1.0 - f[:, 1]))


def trilinear(grid: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Trilinear interpolation of ``grid`` (R, R, R, C) at points ``p``
    (N, 3) in [-1, 1]^3 (coordinates clamp to the grid border)."""
    # Under shard_map a replicated grid queried at per-device points has a
    # per-device cotangent. Marking the grid varying over the points' mesh
    # axes first lets autodiff sum the cotangents across devices (the
    # transpose of the cast) instead of the custom VJP returning a varying
    # gradient for an invariant input.
    axes = tuple(jax.typeof(p).vma - jax.typeof(grid).vma)
    if axes:
        grid = jax.lax.pcast(grid, axes, to="varying")
    return _trilinear(grid, p)


@jax.custom_vjp
def _trilinear(grid: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    r = grid.shape[0]
    x0, f = _tri_coords(p, r)
    wz = jnp.stack([1.0 - f[:, 2], f[:, 2]], axis=-1)       # (N, 2)
    out = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            pair = _pair_gather(grid, x0, dx, dy)           # (N, 2, C)
            v = jnp.einsum("nz,nzc->nc", wz, pair, precision=_HIGHEST)
            out = out + _xy_weight(f, dx, dy)[:, None] * v
    return out


def _trilinear_fwd(grid, p):
    return _trilinear(grid, p), (grid, p)


def _trilinear_bwd(res, g):
    grid, p = res
    r, c = grid.shape[0], grid.shape[-1]
    x0, f = _tri_coords(p, r)
    wz = jnp.stack([1.0 - f[:, 2], f[:, 2]], axis=-1)

    gfx = gfy = gfz = 0.0
    scatter_idx, scatter_val = [], []
    for dx in (0, 1):
        for dy in (0, 1):
            w_xy = _xy_weight(f, dx, dy)                     # (N,)
            pair = _pair_gather(grid, x0, dx, dy)            # (N, 2, C)
            # value of this xy-corner column after z-lerp, and its pieces
            v = jnp.einsum("nz,nzc->nc", wz, pair,
                           precision=_HIGHEST)              # (N, C)
            gv = jnp.sum(g * v, axis=-1)                     # (N,)
            # d/d f_z: (pair_z1 - pair_z0) . g, scaled by w_xy
            dz = jnp.sum(g * (pair[:, 1] - pair[:, 0]), axis=-1)
            gfz = gfz + w_xy * dz
            # d/d f_x, f_y through the xy weight
            sx = (1.0 if dx else -1.0) * (f[:, 1] if dy else 1.0 - f[:, 1])
            sy = (1.0 if dy else -1.0) * (f[:, 0] if dx else 1.0 - f[:, 0])
            gfx = gfx + sx * gv
            gfy = gfy + sy * gv
            # grid cotangent rows for this xy corner (both z corners)
            base = ((x0[:, 0] + dx) * r + (x0[:, 1] + dy)) * r + x0[:, 2]
            coeff = w_xy[:, None] * g                        # (N, C)
            scatter_idx += [base, base + 1]
            scatter_val += [coeff * wz[:, :1], coeff * wz[:, 1:]]
    grad_f = jnp.stack([gfx, gfy, gfz], axis=-1)

    # ONE scatter-add for all 8 corners. Its cost is linear in rows, so the
    # lever is fewer samples: occupancy-guided training (cfg.occupancy_res)
    # moves a smaller sample count onto the surface.
    grad_flat = jnp.zeros((r * r * r, c), grid.dtype).at[
        jnp.concatenate(scatter_idx)
    ].add(jnp.concatenate(scatter_val))

    # f = x - x0 with x = clip((p+1)/2*(r-1), 0, r-1): the clip zeroes
    # dx/dp outside the volume, else it's the constant scale
    raw = (p + 1.0) * (0.5 * (r - 1))
    inside = ((raw > 0.0) & (raw < (r - 1.0))).astype(grad_f.dtype)
    grad_p = grad_f * inside * (0.5 * (r - 1))
    return grad_flat.reshape(grid.shape), grad_p.astype(p.dtype)


_trilinear.defvjp(_trilinear_fwd, _trilinear_bwd)


def bilinear(grid: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Bilinear interpolation of ``grid`` (H, W, C) at float coordinates
    ``(u, v)`` (clamped to the border cell). Same contiguous-pair law as
    ``trilinear``: 2 gathers of (1, 2, C) w-pairs. Left on autodiff — the
    direction grid is small (64 x 128) and is only trained through
    FastNeRF's MLP, never as a raw grid."""
    h, w = grid.shape[0], grid.shape[1]
    u0 = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, h - 2)
    v0 = jnp.clip(jnp.floor(v).astype(jnp.int32), 0, w - 2)
    fu, fv = u - u0, v - v0

    dnums = jax.lax.GatherDimensionNumbers(
        offset_dims=(1, 2, 3),
        collapsed_slice_dims=(),
        start_index_map=(0, 1),
    )
    wv = jnp.stack([1.0 - fv, fv], axis=-1)                 # (N, 2)
    out = 0.0
    for du in (0, 1):
        start = jnp.stack([u0 + du, v0], axis=-1)
        pair = jax.lax.gather(
            grid, start, dnums, slice_sizes=(1, 2, grid.shape[-1]),
            mode=jax.lax.GatherScatterMode.CLIP,
        )[:, 0]                                             # (N, 2, C)
        val = jnp.einsum("nz,nzc->nc", wv, pair, precision=_HIGHEST)
        out = out + (fu if du else 1.0 - fu)[:, None] * val
    return out
