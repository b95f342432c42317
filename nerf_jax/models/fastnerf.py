"""FastNeRF: factorized position/direction field (reference roadmap,
/root/reference/notes.txt:5; Garbin et al. 2021).

FastNeRF splits the NeRF field into two independent networks so the
expensive position branch can be cached on a dense grid and a view only
costs gathers plus an inner product:

    F_pos(x)  -> sigma, {f_i in R^3}_{i=1..D}   (position-dependent factors)
    F_dir(d)  -> {beta_i}_{i=1..D}              (view-dependent weights)
    rgb(x, d) = sigmoid( sum_i beta_i * f_i )

The factorized head is the architecture; ``bake`` + ``BakedFastNeRF``
below implement the paper's acceleration: F_pos sampled on a dense 3-D
grid and F_dir on a direction grid, after which rendering touches no MLP
at all — trilinear/bilinear interpolation and a (D,3) contraction per
sample.

Trunk mirrors the repo's NeRF (models/nerf.py): 8 layers, skip concat at
layer 5, torch-default Linear init, relu density with the deterministic
density-bias guard. The direction net is 2 layers on the L=4 frequency
encoding. Plugs into the renderer/trainer through the standard
``apply(params, points, viewdirs) -> (rgb, sigma)`` contract.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp

from nerf_jax.models.common import (
    HIGHEST,
    linear,
    linear_init,
    skip_trunk_apply,
    skip_trunk_init,
)
from nerf_jax.models.encoding import encoded_dim, positional_encoding
from nerf_jax.ops.interp import bilinear as _bilinear
from nerf_jax.ops.interp import trilinear as _trilinear


@dataclass(frozen=True)
class FastNeRFModel:
    pos_encoding_dim: int = 10
    dir_encoding_dim: int = 4
    hidden_dim: int = 256
    dir_hidden_dim: int = 128
    num_factors: int = 8           # D: rank of the rgb factorization
    compute_dtype: str = "float32"
    reference_init: bool = False   # strict parity: skip the density-bias guard
    domain: tuple = (-1.0, 1.0)    # cube of model-input space ``bake``
                                   # samples (registry.py::grid_domain) —
                                   # the live MLP itself is domain-free,
                                   # but the cache must cover where the
                                   # renderer's normalized queries land

    name: str = "fastnerf"
    eval_gather_bound = True    # class trait, see plenoxels.py

    @property
    def pos_in(self) -> int:
        return encoded_dim(3, self.pos_encoding_dim)

    @property
    def dir_in(self) -> int:
        return encoded_dim(3, self.dir_encoding_dim)

    def init(self, key: jax.Array) -> dict:
        h, d = self.hidden_dim, self.num_factors
        keys = iter(jax.random.split(key, 16))
        # shared skip trunk; head = [sigma, D x 3 rgb factors]
        params = skip_trunk_init(keys, self.pos_in, h, 1 + 3 * d,
                                 self.reference_init)
        params["dir"] = [
            linear_init(next(keys), self.dir_in, self.dir_hidden_dim),
            linear_init(next(keys), self.dir_hidden_dim, d),
        ]
        return params

    # ------------------------------------------------------------- factors

    def pos_factors(
        self, params: dict, points: jax.Array
    ) -> tuple[jax.Array, jax.Array]:
        """F_pos: (..., 3) -> (sigma (...,), factors (..., D, 3)).

        Points are expected pre-normalized to [-1,1] by the renderer."""
        cdt = jnp.dtype(self.compute_dtype)
        p_enc = positional_encoding(points, self.pos_encoding_dim)
        sigma, tail = skip_trunk_apply(params, p_enc, cdt)
        factors = tail.reshape(*tail.shape[:-1], self.num_factors, 3)
        return sigma, factors

    def dir_weights(self, params: dict, viewdirs: jax.Array) -> jax.Array:
        """F_dir: (..., 3) unit dirs -> beta (..., D)."""
        cdt = jnp.dtype(self.compute_dtype)
        y = positional_encoding(viewdirs, self.dir_encoding_dim)
        y = jax.nn.relu(linear(params["dir"][0], y, cdt))
        return linear(params["dir"][1], y, cdt)

    def apply(
        self, params: dict, points: jax.Array, viewdirs: jax.Array
    ) -> tuple[jax.Array, jax.Array]:
        """points/viewdirs (..., 3) -> (rgb (..., 3), sigma (...,))."""
        sigma, factors = self.pos_factors(params, points)
        beta = self.dir_weights(params, viewdirs)
        rgb = jax.nn.sigmoid(jnp.einsum("...d,...dc->...c", beta, factors,
                                        precision=HIGHEST))
        return rgb, sigma

    # -------------------------------------------------------------- baking

    def bake(self, params: dict, grid_res: int = 128, dir_res: int = 64,
             chunk: int = 65536) -> "BakedFastNeRF":
        """Sample F_pos on a dense grid over ``domain``^3 and F_dir on a
        lat/long direction grid — the paper's cache. After this, rendering
        never evaluates an MLP (see BakedFastNeRF.apply).

        Memory: grid_res^3 * (1 + 3D) floats; 128^3 * 25 = 52M f32 = 210 MB
        (stored f32 for interpolation accuracy; fits one device's memory).
        """
        r = grid_res
        lin = jnp.linspace(self.domain[0], self.domain[1], r,
                           dtype=jnp.float32)
        pts = jnp.stack(jnp.meshgrid(lin, lin, lin, indexing="ij"),
                        axis=-1).reshape(-1, 3)

        def pos_chunk(p):
            s, f = self.pos_factors(params, p)
            return jnp.concatenate([s[:, None], f.reshape(-1, 3 * self.num_factors)],
                                   axis=-1)

        n = pts.shape[0]
        pad = (-n) % chunk
        pts_p = jnp.concatenate([pts, jnp.zeros((pad, 3), jnp.float32)])
        vals = jax.lax.map(pos_chunk, pts_p.reshape(-1, chunk, 3))
        sigma_grid = vals.reshape(-1, 1 + 3 * self.num_factors)[:n]

        # direction grid: theta in [0, pi] x phi in [-pi, pi]
        th = jnp.linspace(0.0, jnp.pi, dir_res, dtype=jnp.float32)
        ph = jnp.linspace(-jnp.pi, jnp.pi, 2 * dir_res, dtype=jnp.float32)
        tt, pp = jnp.meshgrid(th, ph, indexing="ij")
        dirs = jnp.stack(
            [jnp.sin(tt) * jnp.cos(pp), jnp.sin(tt) * jnp.sin(pp), jnp.cos(tt)],
            axis=-1,
        ).reshape(-1, 3)
        beta_grid = self.dir_weights(params, dirs).reshape(
            dir_res, 2 * dir_res, self.num_factors
        )
        pos_grid = sigma_grid.reshape(r, r, r, 1 + 3 * self.num_factors)
        return BakedFastNeRF(
            pos_grid=pos_grid,
            beta_grid=beta_grid,
            num_factors=self.num_factors,
            domain=self.domain,
        )


class BakedFastNeRF(NamedTuple):
    """MLP-free FastNeRF cache: trilinear position grid + bilinear
    direction grid. Drop-in ``apply(params=None, points, dirs)`` with the
    standard field contract so the renderer can drive it directly."""

    pos_grid: jax.Array    # (R, R, R, 1+3D)
    beta_grid: jax.Array   # (T, 2T, D)
    num_factors: int
    domain: tuple = (-1.0, 1.0)  # cube of input space pos_grid spans

    def beta(self, dirs: jax.Array) -> jax.Array:
        """F_dir from the cache: lat/long lookup of the per-direction
        factor weights — (N, 3) unit dirs -> (N, D)."""
        t_res, p_res = self.beta_grid.shape[0], self.beta_grid.shape[1]
        theta = jnp.arccos(jnp.clip(dirs[:, 2], -1.0, 1.0))
        phi = jnp.arctan2(dirs[:, 1], dirs[:, 0])
        u = theta / jnp.pi * (t_res - 1)
        v = (phi + jnp.pi) / (2 * jnp.pi) * (p_res - 1)
        return _bilinear(self.beta_grid, u, v)

    def apply(self, params, points: jax.Array, viewdirs: jax.Array):
        del params  # the grids ARE the parameters
        from nerf_jax.models.common import remap_domain

        points = remap_domain(points, self.domain)
        shape = points.shape[:-1]
        d = viewdirs.reshape(-1, 3)
        vals = _trilinear(self.pos_grid, points.reshape(-1, 3))
        sigma = jax.nn.relu(vals[:, 0])
        factors = vals[:, 1:].reshape(-1, self.num_factors, 3)
        beta = self.beta(d)                          # (N, D)
        rgb = jax.nn.sigmoid(jnp.einsum("nd,ndc->nc", beta, factors,
                                        precision=HIGHEST))
        return rgb.reshape(*shape, 3), sigma.reshape(shape)
