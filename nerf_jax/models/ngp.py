"""Instant NGP: multiresolution hash encoding + tiny MLPs (reference
roadmap, /root/reference/notes.txt:7; Mueller et al. 2022).

Field structure (paper sec. 3-4):
  * L resolution levels geometrically spaced between ``base_res`` and
    ``max_res``; each level owns a table of ``2**log2_table`` feature rows
    (``feat_dim`` wide). A point's cell corners map to rows either
    DIRECTLY (levels whose dense grid fits the table — a bijection, no
    collisions) or by SPATIAL HASH (pi_1=1, pi_2=2654435761, pi_3=805459861
    XOR-multiply, eq. 4 of the paper).
  * The 8 corner features blend trilinearly; levels concatenate to an
    (L * feat_dim)-dim encoding that replaces the frequency encoding.
  * Tiny MLPs: density net (encoding -> 64 -> 64 -> 1 + geo_feat) and a
    color net (geo_feat ++ SH-encoded dirs -> 64 -> 64 -> rgb sigmoid).
    Density uses the paper's exponential activation (clamped), the hash
    tables init U(-1e-4, 1e-4).

Implementation notes: the CUDA implementation's fully-fused kernel
interleaves hash lookups with MLP tiles; table gathers are the one NeRF op
that is genuinely gather-bound on any hardware. Here every level's 8-corner
lookup is one static-shape (N, 8) gather from its (2^T, F) table —
vectorized, jittable, VJP = scatter-add into the tables (that is how the
tables train). The tiny MLPs are ordinary matmuls. Occupancy-grid ray
pruning from the paper is a sampling-schedule optimization, orthogonal to
the field contract.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from nerf_jax.models.common import linear, linear_init
from nerf_jax.models.plenoxels import sh_basis

_PRIMES = (1, 2654435761, 805459861)  # pi_1..pi_3, NGP eq. 4


@dataclass(frozen=True)
class NGPModel:
    num_levels: int = 16
    feat_dim: int = 2
    log2_table: int = 19
    base_res: int = 16
    max_res: int = 2048
    hidden_dim: int = 64
    geo_feat_dim: int = 15
    sh_degree: int = 2            # dir encoding (paper uses degree-4 SH;
                                  # 2 keeps the shared 9-term basis — knob)
    compute_dtype: str = "float32"
    reference_init: bool = False  # strict parity: skip the density-bias guard
    domain: tuple = (-1.0, 1.0)   # cube of model-input space the hash grid
                                  # covers (registry.py::grid_domain)

    name: str = "ngp"
    eval_gather_bound = True    # hash-table gathers; eval chunks cap at 8k
    # NOT scan_hostile: NGP's 67 MB of tables alias through lax.scan, and
    # the per-dispatch cost of its ~50-leaf donated state would dominate a
    # one-step-per-call loop.
    scan_hostile = False

    @property
    def enc_dim(self) -> int:
        return self.num_levels * self.feat_dim

    @property
    def dir_in(self) -> int:
        return (self.sh_degree + 1) ** 2

    def level_resolutions(self) -> np.ndarray:
        """N_l = floor(N_min * b^l), b from eq. 3."""
        if self.num_levels == 1:
            return np.asarray([self.base_res])
        b = np.exp(
            (np.log(self.max_res) - np.log(self.base_res))
            / (self.num_levels - 1)
        )
        return np.floor(self.base_res * b ** np.arange(self.num_levels)).astype(
            np.int64
        )

    def init(self, key: jax.Array) -> dict:
        keys = iter(jax.random.split(key, self.num_levels + 8))
        t = 1 << self.log2_table
        tables = [
            jax.random.uniform(next(keys), (t, self.feat_dim),
                               minval=-1e-4, maxval=1e-4)
            for _ in range(self.num_levels)
        ]
        h = self.hidden_dim
        density = [
            linear_init(next(keys), self.enc_dim, h),
            linear_init(next(keys), h, 1 + self.geo_feat_dim),
        ]
        if not self.reference_init:
            # density channel is column 0; exp activation never dies, but a
            # very negative start stalls early compositing gradients — start
            # the field at sigma ~ exp(0.5) ~ 1.6 like the other families'
            # guards (models/nerf.py:53-61)
            density[-1]["b"] = density[-1]["b"].at[0].set(0.5)
        color = [
            linear_init(next(keys), self.geo_feat_dim + self.dir_in, h),
            linear_init(next(keys), h, 3),
        ]
        return {"tables": tables, "density": density, "color": color}

    # ------------------------------------------------------------ encoding

    def _corner_index(self, cell: jax.Array, res: int) -> jax.Array:
        """Integer corner coords (N, 8, 3) at level resolution ``res`` ->
        table rows (N, 8): direct (collision-free) when the dense grid fits
        the table, spatial hash otherwise."""
        t = 1 << self.log2_table
        if (res + 1) ** 3 <= t:
            stride = res + 1
            idx = (cell[..., 0] * stride + cell[..., 1]) * stride + cell[..., 2]
            return idx.astype(jnp.int32)
        h = cell[..., 0] * np.uint32(_PRIMES[0])
        h = h ^ (cell[..., 1] * np.uint32(_PRIMES[1]))
        h = h ^ (cell[..., 2] * np.uint32(_PRIMES[2]))
        return (h & np.uint32(t - 1)).astype(jnp.int32)

    def encode(self, tables: list, p: jax.Array) -> jax.Array:
        """Multires hash encoding of points (N, 3) in ``domain``^3 ->
        (N, L * feat_dim)."""
        from nerf_jax.models.common import remap_domain

        x01 = jnp.clip((remap_domain(p, self.domain) + 1.0) * 0.5, 0.0, 1.0)
        outs = []
        offs = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1],
                                    indexing="ij"), axis=-1).reshape(8, 3)
        offs_j = jnp.asarray(offs, jnp.uint32)
        for lvl, res in enumerate(self.level_resolutions()):
            res = int(res)
            x = x01 * res                                 # cell coords
            x0 = jnp.minimum(jnp.floor(x), res - 1)
            f = x - x0                                    # (N, 3)
            cell = x0.astype(jnp.uint32)[:, None, :] + offs_j[None]  # (N,8,3)
            idx = self._corner_index(cell, res)           # (N, 8)
            feats = tables[lvl][idx]                      # (N, 8, F)
            w = jnp.prod(
                jnp.where(offs_j[None].astype(bool), f[:, None, :],
                          1.0 - f[:, None, :]),
                axis=-1,
            )                                             # (N, 8)
            outs.append(jnp.sum(w[..., None] * feats, axis=1))
        return jnp.concatenate(outs, axis=-1)

    # --------------------------------------------------------------- field

    def apply(
        self, params: dict, points: jax.Array, viewdirs: jax.Array
    ) -> tuple[jax.Array, jax.Array]:
        """points/viewdirs (..., 3) -> (rgb (..., 3), sigma (...,)).
        Points pre-normalized to [-1,1] by the renderer."""
        cdt = jnp.dtype(self.compute_dtype)
        shape = points.shape[:-1]
        p = points.reshape(-1, 3)
        d = viewdirs.reshape(-1, 3)

        enc = self.encode(params["tables"], p)
        x = jax.nn.relu(linear(params["density"][0], enc, cdt))
        x = linear(params["density"][1], x, cdt)
        # paper's exponential density activation, clamped for stability
        sigma = jnp.exp(jnp.clip(x[:, 0], -15.0, 15.0))
        geo = x[:, 1:]

        y = jnp.concatenate([geo, sh_basis(d, self.sh_degree)], axis=-1)
        y = jax.nn.relu(linear(params["color"][0], y, cdt))
        rgb = jax.nn.sigmoid(linear(params["color"][1], y, cdt))
        return rgb.reshape(*shape, 3), sigma.reshape(shape)
