"""Shared building blocks for the functional model zoo.

Models in nerf_jax are pure functions over parameter pytrees (nested dicts of
``jnp`` arrays): ``model.init(key) -> params`` and
``model.apply(params, points, viewdirs) -> (rgb, sigma)``. This keeps the hot
path trivially jit/vmap/shard_map-able.

Weight convention: ``y = x @ w + b`` with ``w`` of shape (in, out) — the JAX
idiom. The PyTorch reference stores (out, in); transpose when porting.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Precision of float32 products. XLA's default float32 matmul on a GPU with
# tensor cores may round the operands to TF32 (10 mantissa bits), so every
# float32 product in the models asks for HIGHEST: ``compute_dtype=float32``
# means true float32, and it is the reference the bfloat16 mode is held to.
HIGHEST = jax.lax.Precision.HIGHEST


def matmul_precision(compute_dtype):
    """``HIGHEST`` for float32 operands, the default for bfloat16 ones
    (a bf16 x bf16 product is exact in the float32 accumulator)."""
    return HIGHEST if jnp.dtype(compute_dtype) == jnp.float32 else None


def remap_domain(p: jax.Array, domain: tuple[float, float]) -> jax.Array:
    """Affine map of the grid family's ``domain`` cube (lo, hi) onto the
    internal [-1,1] convention every grid primitive uses (ops/interp.py,
    ops/occupancy.py). Identity for the default (-1, 1) domain — existing
    golden tests and NDC scenes hit that path. See
    models/registry.py::grid_domain for why grid models need this."""
    lo, hi = float(domain[0]), float(domain[1])
    if (lo, hi) == (-1.0, 1.0):
        return p
    return (p - lo) * (2.0 / (hi - lo)) - 1.0


def uniform_init(key: jax.Array, shape: tuple[int, ...], bound: float) -> jax.Array:
    return jax.random.uniform(
        key, shape, dtype=jnp.float32, minval=-bound, maxval=bound
    )


def linear_init(key: jax.Array, in_dim: int, out_dim: int) -> dict:
    """PyTorch ``nn.Linear`` default init law: weight AND bias drawn from
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (kaiming_uniform with a=sqrt(5)).
    Matched so freshly-initialized models have the same statistics as the
    reference (/root/reference/nerf/models.py uses default Linear init)."""
    kw, kb = jax.random.split(key)
    bound = 1.0 / (in_dim ** 0.5)
    return {
        "w": uniform_init(kw, (in_dim, out_dim), bound),
        "b": uniform_init(kb, (out_dim,), bound),
    }


def siren_init(
    key: jax.Array, in_dim: int, out_dim: int, w0: float, is_first: bool, c: float = 6.0
) -> dict:
    """SIREN init (/root/reference/nerf/models.py:117-122): std = 1/dim for
    the first layer else sqrt(c/dim)/w0; uniform for weight AND bias."""
    kw, kb = jax.random.split(key)
    bound = (1.0 / in_dim) if is_first else ((c / in_dim) ** 0.5 / w0)
    return {
        "w": uniform_init(kw, (in_dim, out_dim), bound),
        "b": uniform_init(kb, (out_dim,), bound),
    }


def linear(params: dict, x: jax.Array, compute_dtype=jnp.float32) -> jax.Array:
    """Dense layer ``x @ w + b`` with a controllable operand dtype.

    ``compute_dtype=float32`` is a true float32 product (precision
    ``HIGHEST``, never TF32); ``bfloat16`` rounds both operands to bf16
    (8 mantissa bits). Accumulation is float32 either way
    (``preferred_element_type``)."""
    w = params["w"].astype(compute_dtype)
    xc = x.astype(compute_dtype)
    y = jnp.dot(xc, w, preferred_element_type=jnp.float32,
                precision=matmul_precision(compute_dtype))
    return y + params["b"]


def param_count(params) -> int:
    return sum(int(p.size) for p in jax.tree_util.tree_leaves(params))


def skip_trunk_init(keys, pos_in: int, hidden: int, head_out: int,
                    reference_init: bool) -> dict:
    """The shared 5+3-layer skip-connected field trunk used by the
    grid-bakeable families (FastNeRF's F_pos, PlenOctrees' NeRF-SH) —
    the reference NeRF trunk shape (models.py:9-75) with a family-specific
    head width. Head column 0 is the density channel; the same dead-ReLU
    bias guard as models/nerf.py:53-61 applies unless ``reference_init``.
    ``keys`` is an iterator of PRNG keys (8 are consumed)."""
    trunk1 = [linear_init(next(keys), pos_in, hidden)]
    trunk1 += [linear_init(next(keys), hidden, hidden) for _ in range(4)]
    trunk2 = [linear_init(next(keys), hidden + pos_in, hidden)]
    trunk2 += [linear_init(next(keys), hidden, hidden) for _ in range(2)]
    head = linear_init(next(keys), hidden, head_out)
    if not reference_init:
        head["b"] = head["b"].at[0].set(0.5)
    return {"trunk1": trunk1, "trunk2": trunk2, "head": head}


def skip_trunk_apply(params: dict, p_enc, compute_dtype):
    """Forward of ``skip_trunk_init``'s trunk on encoded positions:
    returns (sigma (...,), tail (..., head_out-1)) — relu density from
    head column 0, raw family-specific tail (rgb factors / SH coeffs)."""
    x = p_enc
    for lyr in params["trunk1"]:
        x = jax.nn.relu(linear(lyr, x, compute_dtype))
    x = jnp.concatenate([x, p_enc], axis=-1)
    for lyr in params["trunk2"]:
        x = jax.nn.relu(linear(lyr, x, compute_dtype))
    x = linear(params["head"], x, compute_dtype)
    return jax.nn.relu(x[..., 0]), x[..., 1:]
