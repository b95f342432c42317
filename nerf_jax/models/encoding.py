"""Frequency (positional) encoding.

Matches the reference layout exactly (/root/reference/nerf/encoding.py:4-20):
``[x, sin(2^0 x), cos(2^0 x), sin(2^1 x), cos(2^1 x), ...]`` concatenated on
the feature axis — identity included, NO pi factor — giving ``3 + 6L``
features for 3-D input. The interleaved per-frequency ordering is preserved
so reference-trained weights port across unchanged.

All frequencies are computed in one broadcasted sin/cos over an
``(..., L, D)`` tensor, which XLA fuses into one elementwise kernel, not a
Python loop of concats.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def positional_encoding(x: jax.Array, num_freqs: int) -> jax.Array:
    """Encode ``x`` (..., D) to (..., D*(1+2*num_freqs)).

    Output feature order matches the reference: the raw input first, then for
    each frequency j the sin block followed by the cos block.
    """
    if num_freqs == 0:
        return x
    freqs = jnp.asarray(2.0 ** np.arange(num_freqs), dtype=x.dtype)  # (L,)
    xb = x[..., None, :] * freqs[:, None]            # (..., L, D)
    sin = jnp.sin(xb)
    cos = jnp.cos(xb)
    # Interleave sin/cos per frequency: (..., L, 2, D) -> (..., 2*L*D)
    sc = jnp.stack([sin, cos], axis=-2)
    sc = sc.reshape(*x.shape[:-1], 2 * num_freqs * x.shape[-1])
    return jnp.concatenate([x, sc], axis=-1)


def encoded_dim(input_dim: int, num_freqs: int) -> int:
    return input_dim * (1 + 2 * num_freqs)
