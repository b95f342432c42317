"""Volume compositing: transmittance scan + alpha blending.

Matches the reference numerics exactly (/root/reference/nerf/rendering.py):
  * ``alpha_i = 1 - exp(-sigma_i * delta_i)``            (rendering.py:143)
  * ``T_i   = exclusive-cumprod(1 - alpha)``             (rendering.py:110-122)
  * ``w_i   = T_i * alpha_i``; ``rgb = sum_i w_i c_i``    (rendering.py:146-148)
  * white background adds ``1 - sum_i w_i``              (rendering.py:150-151)

The cumulative product along the sample axis is the only sequential
dependency in the whole pipeline. It stays device-local (the sample axis is
never sharded) and is expressed as ``jnp.cumprod``, which XLA lowers to an
associative scan. Extra outputs (depth/acc/disparity) are free byproducts the
reference does not expose.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class CompositeOutput(NamedTuple):
    rgb: jax.Array        # (R, 3) composited color
    weights: jax.Array    # (R, S) per-sample compositing weights
    depth: jax.Array      # (R,)  expected termination depth
    acc: jax.Array        # (R,)  accumulated opacity sum(w)
    disparity: jax.Array  # (R,)  1 / max(depth/acc, eps)


def exclusive_cumprod(x: jax.Array, axis: int = -1) -> jax.Array:
    """Right-shifted cumulative product with a leading 1 (the transmittance
    scan at rendering.py:120-122)."""
    p = jnp.cumprod(x, axis=axis)
    p = jnp.moveaxis(p, axis, -1)
    out = jnp.concatenate([jnp.ones_like(p[..., :1]), p[..., :-1]], axis=-1)
    return jnp.moveaxis(out, -1, axis)


def composite(
    colors: jax.Array,
    densities: jax.Array,
    deltas: jax.Array,
    t: jax.Array | None = None,
    white_background: bool = True,
) -> CompositeOutput:
    """Alpha-composite per-sample colors/densities into per-ray RGB.

    Args:
      colors: (R, S, 3); densities: (R, S); deltas: (R, S) or (S,) shared;
      t: optional (R, S) sample depths for the depth map.
    """
    deltas = jnp.broadcast_to(deltas, densities.shape)
    alpha = 1.0 - jnp.exp(-densities * deltas)
    trans = exclusive_cumprod(1.0 - alpha, axis=-1)
    weights = trans * alpha

    rgb = jnp.sum(weights[..., None] * colors, axis=-2)
    acc = jnp.sum(weights, axis=-1)
    if white_background:
        rgb = rgb + (1.0 - acc[..., None])

    if t is None:
        depth = jnp.zeros_like(acc)
    else:
        depth = jnp.sum(weights * t, axis=-1)
    disparity = 1.0 / jnp.maximum(
        depth / jnp.maximum(acc, 1e-10), 1e-10
    )
    return CompositeOutput(rgb=rgb, weights=weights, depth=depth, acc=acc,
                           disparity=disparity)
