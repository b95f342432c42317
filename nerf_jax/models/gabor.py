"""Gabor multiplicative filter network (GaborNet) NeRF field.

The reference repo lists GaborNet first on its roadmap
(/root/reference/notes.txt:1-3) but never implements it; this follows the
published architecture it refers to — the Gabor variant of Multiplicative
Filter Networks (Fathony et al., ICLR 2021): instead of composing
nonlinearities depth-wise, each layer MULTIPLIES a linear transform of the
hidden state by a Gabor filter of the raw input,

    z_1 = g_1(x)
    z_{i+1} = (W_i z_i + b_i) * g_{i+1}(x)
    g_i(x)  = sin(omega_i . x + phi_i) * exp(-gamma_i / 2 * ||x - mu_i||^2)

which makes the network output a weighted sum of (exponentially many) Gabor
wavelets — band-limited like SIREN but with spatially localized support.

Head structure mirrors the repo's Siren variant so the renderer/trainer see
the identical contract: density = relu(Linear(h,1)) * sigma_mul on the final
hidden state, feature remap Linear(h,h), and the view-dependent rgb branch
(dirs use the L=4 frequency encoding) ending in sigmoid.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from nerf_jax.models.common import HIGHEST, linear, linear_init, uniform_init
from nerf_jax.models.encoding import encoded_dim, positional_encoding


def _gabor_filter_init(key: jax.Array, out_dim: int, input_scale: float,
                       alpha: float, beta: float) -> dict:
    """One Gabor filter bank g(x) for 3-D inputs: frequencies scaled like
    MFN (normal * input_scale weighted by sqrt(gamma)), centers uniform in
    the normalized [-1, 1] domain, bandwidths gamma ~ Gamma(alpha, beta)."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    gamma = jax.random.gamma(k1, alpha, (out_dim,)) / beta
    omega = (
        jax.random.normal(k2, (3, out_dim))
        * input_scale
        * jnp.sqrt(gamma)[None, :]
    )
    phi = uniform_init(k3, (out_dim,), jnp.pi)
    mu = jax.random.uniform(k4, (out_dim, 3), minval=-1.0, maxval=1.0)
    return {"omega": omega, "phi": phi, "mu": mu, "gamma": gamma}


def _gabor_filter(f: dict, x: jax.Array) -> jax.Array:
    """g(x) for x (..., 3) -> (..., out)."""
    arg = jnp.dot(x, f["omega"], precision=HIGHEST) + f["phi"]
    d2 = jnp.sum(
        (x[..., None, :] - f["mu"]) ** 2, axis=-1
    )  # (..., out)
    return jnp.sin(arg) * jnp.exp(-0.5 * f["gamma"] * d2)


@dataclass(frozen=True)
class GaborModel:
    num_layers: int = 8          # number of multiplicative stages
    hidden_dim: int = 256
    dir_encoding_dim: int = 4
    sigma_mul: float = 10.0
    rgb_mul: float = 1.0
    input_scale: float = 64.0    # MFN frequency scale over the [-1,1] domain
    alpha: float = 6.0           # gamma-distribution shape for bandwidths
    beta: float = 1.0
    compute_dtype: str = "float32"
    reference_init: bool = False  # strict parity: skip the density-bias guard

    name: str = "gabor"

    @property
    def dir_in(self) -> int:
        return encoded_dim(3, self.dir_encoding_dim)

    def init(self, key: jax.Array) -> dict:
        h = self.hidden_dim
        n = self.num_layers
        keys = iter(jax.random.split(key, 2 * n + 8))
        # per-stage frequency scale ~ input_scale/sqrt(n) so the PRODUCT of
        # n filters covers the target bandwidth (MFN sec. 3)
        fscale = self.input_scale / (n ** 0.5)
        filters = [
            _gabor_filter_init(next(keys), h, fscale, self.alpha / n, self.beta)
            for _ in range(n)
        ]
        linears = []
        for _ in range(n - 1):
            lyr = linear_init(next(keys), h, h)
            # MFN linear init: U(-sqrt(1/h), sqrt(1/h)) == torch default; keep
            linears.append(lyr)
        sigma = linear_init(next(keys), h, 1)
        if not self.reference_init:
            sigma["b"] = sigma["b"].at[0].set(0.5)  # same dead-ReLU guard
        return {
            "filters": filters,
            "linears": linears,
            "sigma": sigma,
            "remap": linear_init(next(keys), h, h),
            "rgb0": linear_init(next(keys), h + self.dir_in, h // 2),
            "rgb1": linear_init(next(keys), h // 2, 3),
        }

    def apply(
        self, params: dict, points: jax.Array, viewdirs: jax.Array
    ) -> tuple[jax.Array, jax.Array]:
        """points/viewdirs: (..., 3) -> (rgb (..., 3), sigma (...,))."""
        cdt = jnp.dtype(self.compute_dtype)

        z = _gabor_filter(params["filters"][0], points)
        for lyr, f in zip(params["linears"], params["filters"][1:]):
            z = linear(lyr, z, cdt) * _gabor_filter(f, points)

        sigma = jax.nn.relu(linear(params["sigma"], z, cdt)) * self.sigma_mul
        sigma = sigma[..., 0]

        feat = linear(params["remap"], z, cdt)
        d_enc = positional_encoding(viewdirs, self.dir_encoding_dim)
        y = jnp.concatenate([feat, d_enc], axis=-1)
        y = jax.nn.relu(linear(params["rgb0"], y, cdt))
        rgb = jax.nn.sigmoid(linear(params["rgb1"], y, cdt) * self.rgb_mul)
        return rgb, sigma
