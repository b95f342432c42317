"""SIREN-activation NeRF variant, as a functional pytree.

Architecture matches the reference exactly (/root/reference/nerf/models.py:130-203):
  * base: 8 SIREN layers on RAW 3-D points (no positional encoding of
    positions) — first layer w0=30, hidden layers w0=1 (models.py:163-166)
  * density = relu(Linear(256,1)) * sigma_mul(=10), squeezed (models.py:169-171,192-193)
  * feature remap: Linear(256,256), no activation (models.py:174-176)
  * rgb head: SirenLayer(256+27, 128, w0=1) -> Linear(128,3);
    rgb = sigmoid(rgb * rgb_mul(=1)) (models.py:178-183,198-202)
  * directions still use positional encoding with L=4 (models.py:197)
  * SIREN init: w_std = 1/dim if first else sqrt(6/dim)/w0, uniform for
    weight AND bias (models.py:117-122)
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from nerf_jax.models.common import linear, linear_init, siren_init
from nerf_jax.models.encoding import encoded_dim, positional_encoding


@dataclass(frozen=True)
class SirenModel:
    num_layers: int = 8
    hidden_dim: int = 256
    dir_encoding_dim: int = 4
    sigma_mul: float = 10.0
    rgb_mul: float = 1.0
    w0: float = 30.0
    hidden_w0: float = 1.0
    compute_dtype: str = "float32"
    reference_init: bool = False   # strict parity: skip the density-bias guard

    name: str = "siren"

    @property
    def dir_in(self) -> int:
        return encoded_dim(3, self.dir_encoding_dim)  # 27

    def init(self, key: jax.Array) -> dict:
        h = self.hidden_dim
        keys = iter(jax.random.split(key, self.num_layers + 8))
        base = [siren_init(next(keys), 3, h, self.w0, is_first=True)]
        base += [
            siren_init(next(keys), h, h, self.hidden_w0, is_first=False)
            for _ in range(self.num_layers - 1)
        ]
        sigma = linear_init(next(keys), h, 1)
        # Positive density bias at init — same dead-ReLU guard as NeRFModel
        # (density = relu(linear(base)) * sigma_mul, models.py:192): a
        # negative bias draw would zero all density gradients permanently.
        if not self.reference_init:
            sigma["b"] = sigma["b"].at[0].set(0.5)
        return {
            "base": base,
            "sigma": sigma,
            "remap": linear_init(next(keys), h, h),
            "rgb0": siren_init(
                next(keys), h + self.dir_in, h // 2, self.hidden_w0, is_first=False
            ),
            "rgb1": linear_init(next(keys), h // 2, 3),
        }

    def apply(
        self, params: dict, points: jax.Array, viewdirs: jax.Array
    ) -> tuple[jax.Array, jax.Array]:
        """points/viewdirs: (..., 3) -> (rgb (..., 3), sigma (...,))."""
        cdt = jnp.dtype(self.compute_dtype)

        x = points
        w0s = [self.w0] + [self.hidden_w0] * (self.num_layers - 1)
        for lyr, w0 in zip(params["base"], w0s):
            x = jnp.sin(w0 * linear(lyr, x, cdt))

        sigma = jax.nn.relu(linear(params["sigma"], x, cdt)) * self.sigma_mul
        sigma = sigma[..., 0]

        feat = linear(params["remap"], x, cdt)
        d_enc = positional_encoding(viewdirs, self.dir_encoding_dim)
        y = jnp.concatenate([feat, d_enc], axis=-1)
        y = jnp.sin(self.hidden_w0 * linear(params["rgb0"], y, cdt))
        rgb = jax.nn.sigmoid(linear(params["rgb1"], y, cdt) * self.rgb_mul)
        return rgb, sigma
