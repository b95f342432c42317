"""PlenOctrees: NeRF-SH training + octree baking (reference roadmap,
/root/reference/notes.txt:6; Yu et al. 2021).

Two halves, exactly as in the paper:

1. **NeRF-SH** (the trainable field): the NeRF trunk
   (/root/reference/nerf/models.py:9-49 structure) but the head emits
   ``[sigma, 3 * (deg+1)^2]`` spherical-harmonic coefficients instead of
   feeding a view-direction branch; color is the SH expansion evaluated in
   the view direction. Removing the dir-MLP is what makes the field
   bakeable — color becomes a closed form in d given position outputs.

2. **Baking**: sample the trained NeRF-SH on a grid and render from the
   cache without the MLP. The paper stores the cache as a sparse octree
   because a 2015-era GPU renderer wants pointer-chased empty-space
   skipping; here the cache is the dense density+SH voxel grid — which is
   exactly a Plenoxels grid, so ``bake()`` returns
   ``(PlenoxelsModel, params)`` and rendering reuses that family's
   trilinear/SH path unchanged. ``to_octree``/``from_octree`` provide the
   paper's sparse format for storage/export interop (host-side numpy): an
   occupancy-thresholded octree with leaf payloads, lossless over occupied
   cells.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from nerf_jax.models.common import HIGHEST, skip_trunk_apply, skip_trunk_init
from nerf_jax.models.encoding import encoded_dim, positional_encoding
from nerf_jax.models.plenoxels import PlenoxelsModel, sh_basis


@dataclass(frozen=True)
class PlenOctreeModel:
    """NeRF-SH: the PlenOctrees paper's trainable stage."""

    pos_encoding_dim: int = 10
    hidden_dim: int = 256
    sh_degree: int = 2
    compute_dtype: str = "float32"
    reference_init: bool = False   # strict parity: skip the density-bias guard
    domain: tuple = (-1.0, 1.0)    # cube of input space ``bake`` samples
                                   # (registry.py::grid_domain); the live
                                   # NeRF-SH MLP itself is domain-free

    name: str = "plenoctree"
    eval_gather_bound = True    # class trait, see plenoxels.py

    @property
    def pos_in(self) -> int:
        return encoded_dim(3, self.pos_encoding_dim)

    @property
    def sh_dim(self) -> int:
        return (self.sh_degree + 1) ** 2

    def init(self, key: jax.Array) -> dict:
        keys = iter(jax.random.split(key, 12))
        # shared skip trunk; head = [sigma, 3 x L SH coefficients]
        return skip_trunk_init(keys, self.pos_in, self.hidden_dim,
                               1 + 3 * self.sh_dim, self.reference_init)

    def sh_field(
        self, params: dict, points: jax.Array
    ) -> tuple[jax.Array, jax.Array]:
        """F(x) -> (sigma (...,), sh (..., 3, L)) — everything the octree
        leaf stores. Points pre-normalized to [-1,1]."""
        cdt = jnp.dtype(self.compute_dtype)
        p_enc = positional_encoding(points, self.pos_encoding_dim)
        sigma, tail = skip_trunk_apply(params, p_enc, cdt)
        sh = tail.reshape(*tail.shape[:-1], 3, self.sh_dim)
        return sigma, sh

    def apply(
        self, params: dict, points: jax.Array, viewdirs: jax.Array
    ) -> tuple[jax.Array, jax.Array]:
        """points/viewdirs (..., 3) -> (rgb (..., 3), sigma (...,))."""
        sigma, sh = self.sh_field(params, points)
        basis = sh_basis(viewdirs, self.sh_degree)
        rgb = jax.nn.sigmoid(jnp.einsum("...cl,...l->...c", sh, basis,
                                        precision=HIGHEST))
        return rgb, sigma

    # -------------------------------------------------------------- baking

    def bake(self, params: dict, grid_res: int = 128,
             chunk: int = 65536) -> tuple[PlenoxelsModel, dict]:
        """Sample the NeRF-SH field on a dense grid. Returns a
        ``(PlenoxelsModel, params)`` pair — the dense PlenOctree cache
        renders through the Plenoxels trilinear/SH path with no MLP."""
        r = grid_res
        lin = jnp.linspace(self.domain[0], self.domain[1], r,
                           dtype=jnp.float32)
        pts = jnp.stack(jnp.meshgrid(lin, lin, lin, indexing="ij"),
                        axis=-1).reshape(-1, 3)

        def field_chunk(p):
            sigma, sh = self.sh_field(params, p)
            # the Plenoxels grid stores RAW density (softplus applied at
            # eval) — store softplus^-1 so the cache reproduces this field
            raw = jnp.log(jnp.expm1(jnp.clip(sigma, 1e-8, 1e8)))
            return jnp.concatenate(
                [raw[:, None], sh.reshape(-1, 3 * self.sh_dim)], axis=-1
            )

        n = pts.shape[0]
        pad = (-n) % chunk
        pts_p = jnp.concatenate([pts, jnp.zeros((pad, 3), jnp.float32)])
        vals = jax.lax.map(field_chunk, pts_p.reshape(-1, chunk, 3))
        grid = vals.reshape(-1, 1 + 3 * self.sh_dim)[:n].reshape(
            r, r, r, 1 + 3 * self.sh_dim
        )
        model = PlenoxelsModel(grid_res=r, sh_degree=self.sh_degree,
                               domain=self.domain)
        return model, {"grid": grid}


# ---------------------------------------------------------------- octree IO


def to_octree(grid: np.ndarray, sigma_threshold: float = 1e-2) -> dict:
    """Compress a dense (R,R,R,C) density+SH grid into the sparse leaf set
    an occupancy-thresholded octree would retain (cells with sigma above
    ``sigma_threshold``). The octree's internal nodes are pure traversal
    acceleration for a pointer-chasing renderer — its information content
    IS this leaf set, which is what we store. Host-side numpy; lossless
    over kept cells; R must be a power of two (octree-subdividable).

    Returns {"res", "channels", "threshold", "coords" (M,3) uint16 leaf
    cell coords, "payload" (M,C) float32}; `from_octree` reconstructs.
    """
    grid = np.asarray(grid)
    r, c = grid.shape[0], grid.shape[-1]
    assert r & (r - 1) == 0, "octree baking needs a power-of-two grid"
    occupied = grid[..., 0] > sigma_threshold
    coords = np.argwhere(occupied).astype(np.uint16)
    payload = grid[occupied].astype(np.float32)
    return {
        "res": r,
        "channels": c,
        "threshold": float(sigma_threshold),
        "coords": coords,
        "payload": payload,
    }


def from_octree(tree: dict) -> np.ndarray:
    """Inverse of ``to_octree``: dense grid with pruned cells at zero
    density (exactly how the paper's renderer treats skipped space)."""
    r, c = tree["res"], tree["channels"]
    grid = np.zeros((r, r, r, c), np.float32)
    idx = tree["coords"].astype(np.int64)
    grid[idx[:, 0], idx[:, 1], idx[:, 2]] = tree["payload"]
    return grid
