"""Ray sampling: stratified (coarse) and inverse-CDF importance (fine).

Reference behavior matched (see /root/reference/nerf/rendering.py):
  * stratified bins: ``num_samples + 1`` uniform edges in [near, far], one
    uniform jitter per bin (rendering.py:6-27). The reference draws a SINGLE
    t-vector shared by every ray in the chunk; that is exposed here as
    ``jitter_mode="shared"`` for parity testing, while the default is the
    statistically correct per-ray jitter.
  * deltas: ``t[i+1]-t[i]`` with 1e10 appended (rendering.py:54-57).

Hierarchical inverse-CDF sampling (``sample_pdf``) is a capability the
reference lacks (coarse-only renderer, rendering.py:156-226) but the build
targets require; it follows the original NeRF formulation and is designed
to stay device-local: no collectives, static shapes, vectorized searchsorted.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def stratified_sample(
    key: jax.Array,
    near: float,
    far: float,
    num_samples: int,
    num_rays: int,
    jitter_mode: str = "per_ray",
    perturb: bool = True,
) -> jax.Array:
    """Stratified t-samples along rays.

    Returns ``t`` of shape ``(num_rays, num_samples)``. With
    ``jitter_mode="shared"`` a single jitter vector is broadcast to all rays
    (reference semantics, rendering.py:23-27); with ``"per_ray"`` each ray
    gets independent jitter. With ``perturb=False`` the offsets are fixed at
    bin midpoints (deterministic rendering).
    """
    edges = jnp.linspace(near, far, num_samples + 1, dtype=jnp.float32)
    lower = edges[:-1]
    width = edges[1:] - edges[:-1]
    if not perturb:
        u = jnp.full((1, num_samples), 0.5, dtype=jnp.float32)
    elif jitter_mode == "shared":
        u = jax.random.uniform(key, (1, num_samples), dtype=jnp.float32)
    else:
        u = jax.random.uniform(key, (num_rays, num_samples), dtype=jnp.float32)
    t = lower[None, :] + width[None, :] * u
    return jnp.broadcast_to(t, (num_rays, num_samples))


def deltas_from_t(t: jax.Array, inf_delta: float = 1e10) -> jax.Array:
    """Per-sample intervals: ``t[i+1]-t[i]`` with ``inf_delta`` appended
    (reference: rendering.py:54-57, reference deltas are 1-D/shared; here
    they carry the ray axis)."""
    d = t[..., 1:] - t[..., :-1]
    last = jnp.full_like(t[..., :1], inf_delta)
    return jnp.concatenate([d, last], axis=-1)


def sample_positions(
    rays_o: jax.Array, rays_d: jax.Array, t: jax.Array
) -> jax.Array:
    """Points ``o + t*d`` with shape (num_rays, num_samples, 3)
    (reference: rendering.py:59-62)."""
    return rays_o[..., None, :] + t[..., :, None] * rays_d[..., None, :]


def normalize_positions(p: jax.Array, near: float, far: float) -> jax.Array:
    """Componentwise map of xyz from [near, far] to [-1, 1], applied to every
    model query (reference: rendering.py:67-82,106)."""
    return 2.0 * (p - near) / (far - near) - 1.0


def sample_pdf(
    key: jax.Array,
    bins: jax.Array,
    weights: jax.Array,
    num_samples: int,
    deterministic: bool = False,
    u: jax.Array | None = None,
) -> jax.Array:
    """Inverse-transform sampling from a piecewise-constant PDF.

    Args:
      bins: (num_rays, M+1) bin edges (typically midpoints of the coarse t).
      weights: (num_rays, M) unnormalized weights per bin.
      num_samples: number of fine samples to draw per ray.
      deterministic: evenly spaced u instead of uniform random.
      u: optional (num_rays, num_samples) quantiles in [0, 1) overriding
        both modes — pass SORTED u (e.g. stratified) to get monotonic t
        directly usable by the compositor (ops/occupancy.py does).

    Returns (num_rays, num_samples) t-values. Entirely device-local: a
    vectorized ``searchsorted`` over static shapes — no sorting network or
    data-dependent shapes, so it fuses cleanly under jit.
    """
    weights = weights + 1e-5  # avoid nans from empty rays
    pdf = weights / jnp.sum(weights, axis=-1, keepdims=True)
    cdf = jnp.cumsum(pdf, axis=-1)
    cdf = jnp.concatenate([jnp.zeros_like(cdf[..., :1]), cdf], axis=-1)  # (R, M+1)

    num_rays = cdf.shape[0]
    if u is not None:
        pass
    elif deterministic:
        u = jnp.linspace(0.0, 1.0 - 1e-5, num_samples, dtype=jnp.float32)
        u = jnp.broadcast_to(u, (num_rays, num_samples))
    else:
        u = jax.random.uniform(
            key, (num_rays, num_samples), dtype=jnp.float32, maxval=1.0 - 1e-5
        )

    # searchsorted(side="right") as a vectorized compare-count: one
    # (R, F, M+1) broadcast instead of a binary-search loop — exact same
    # result for a sorted cdf. Whether jnp.searchsorted is faster on the
    # GPU has not been measured.
    idx = jnp.sum(
        (u[..., None] >= cdf[..., None, :]).astype(jnp.int32), axis=-1
    )
    below = jnp.clip(idx - 1, 0, cdf.shape[-1] - 1)
    above = jnp.clip(idx, 0, cdf.shape[-1] - 1)

    # One-hot contraction instead of take_along_axis; exact: the indices
    # are in range by construction. ONE (R, F, M+1) one-hot per index set,
    # shared by cdf AND bins (both are (R, M+1))
    assert bins.shape[-1] == cdf.shape[-1], (bins.shape, cdf.shape)
    kw = cdf.shape[-1]

    def take2(ix):
        onehot = ix[..., None] == jnp.arange(kw, dtype=jnp.int32)
        c = jnp.sum(jnp.where(onehot, cdf[..., None, :], 0.0), axis=-1)
        b = jnp.sum(jnp.where(onehot, bins[..., None, :], 0.0), axis=-1)
        return c, b

    cdf_below, bins_below = take2(below)
    cdf_above, bins_above = take2(above)

    denom = cdf_above - cdf_below
    denom = jnp.where(denom < 1e-5, 1.0, denom)
    frac = (u - cdf_below) / denom
    return bins_below + frac * (bins_above - bins_below)


def merge_samples(t_coarse: jax.Array, t_fine: jax.Array) -> jax.Array:
    """Sorted union of coarse and fine t-samples along the last axis.

    Implemented as a stable rank-by-count + one-hot permutation rather than
    ``jnp.sort``: the (R, M, M) comparison matrix is one broadcast for
    M <= a few hundred. Identical output (stable tie order); whether
    ``jnp.sort`` is faster on the GPU has not been measured."""
    x = jnp.concatenate([t_coarse, t_fine], axis=-1)
    m = x.shape[-1]
    xi = x[..., :, None]          # element i
    xj = x[..., None, :]          # element j
    j_lt_i = (
        jnp.arange(m, dtype=jnp.int32)[:, None]
        > jnp.arange(m, dtype=jnp.int32)[None, :]
    )
    rank = jnp.sum(
        (xj < xi) | ((xj == xi) & j_lt_i), axis=-1
    )                              # (R, M) each element's sorted position
    onehot = rank[..., None] == jnp.arange(m, dtype=jnp.int32)
    return jnp.sum(jnp.where(onehot, xi, 0.0), axis=-2)
