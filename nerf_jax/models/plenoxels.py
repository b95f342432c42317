"""Plenoxels: a voxel grid of density + spherical harmonics — no neural
network at all (reference roadmap, /root/reference/notes.txt:8; Fridovich-
Keil & Yu et al. 2022).

The field is a dense R^3 grid storing per voxel one density channel and
``(sh_degree+1)^2`` SH coefficients per color channel; a sample point
trilinearly interpolates its 8 corners, and color is the SH expansion
evaluated in the view direction:

    sigma(x) = softplus( trilinear(grid_sigma, x) )
    rgb(x,d) = sigmoid( sum_l  SH_l(d) * trilinear(grid_sh, x)_l )

Two documented deviations from the paper's clamping: sigmoid color is this
repo's head contract (identical at the operating range, strictly monotone,
keeps every family interchangeable under the renderer), and density uses
softplus instead of relu — with a DIRECT grid there is no shared weight
matrix to resurrect a cell whose raw density goes negative, so relu's dead
zone freezes cells permanently; measured on the synthetic scene, relu
collapses the whole grid to empty (MSE 0.187 -> 0.23 flat) while softplus
trains (0.187 -> 0.11 and falling) at every tested learning rate.
softplus(x) = relu(x) + O(e^-|x|), so a converged grid is
indistinguishable. Grids want a much higher learning rate than MLPs
(paper: ~10-30 on density); learning_rate ~ 1e-2 is a good Adam setting.

Implementation notes: the paper's implementation is a sparse CUDA grid
with custom kernels; here the grid is dense and the 8-corner stencil is
static-shape gathers (`ops/interp.py::trilinear`), whose VJP — 8
scatter-adds into the grid — is exactly how plenoxel optimization works
(gradients only touch corners of occupied samples). Sparsity/pruning is an
optimization schedule on top (the paper prunes by occupancy), orthogonal
to the field contract; TV regularization can be added as an extra loss
over the grid pytree. Coarse-to-fine upsampling is `upsample()` below.

Grid memory: R=128, degree 2 -> 128^3 * 28 f32 = 235 MB — fine in device
memory, far too big to waste host round-trips on, which the
device-resident param pytree avoids by construction.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from nerf_jax.models.common import HIGHEST
from nerf_jax.ops.interp import trilinear


# real SH basis values, degrees 0..2 (the standard 9-term table)
_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, 1.0925484305920792, 0.31539156525252005,
       1.0925484305920792, 0.5462742152960396)


def sh_basis(dirs: jax.Array, degree: int) -> jax.Array:
    """Real spherical harmonics Y_lm(d) for unit dirs (..., 3) ->
    (..., (degree+1)^2), degrees 0-2 supported (plenoxels uses 2)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [jnp.full_like(x, _C0)]
    if degree >= 1:
        out += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree >= 2:
        out += [
            _C2[0] * x * y,
            -_C2[1] * y * z,
            _C2[2] * (3.0 * z * z - 1.0),
            -_C2[3] * x * z,
            _C2[4] * (x * x - y * y),
        ]
    return jnp.stack(out, axis=-1)


@dataclass(frozen=True)
class PlenoxelsModel:
    grid_res: int = 128
    sh_degree: int = 2
    init_sigma: float = 0.1        # initial density level: the raw grid
                                   # channel starts at softplus^-1 of this
                                   # (the voxel-grid analog of the density-
                                   # bias guard in models/nerf.py:53-61)
    compute_dtype: str = "float32"  # grids interpolate in f32 regardless
    reference_init: bool = False    # strict parity: zero-init density too
    domain: tuple = (-1.0, 1.0)     # cube of model-input space the grid
                                    # covers (registry.py::grid_domain: the
                                    # normalized scene volume, NOT [-1,1] —
                                    # the reference's [near,far]->[-1,1] map
                                    # puts content around -2)

    name: str = "plenoxels"
    # class traits (not dataclass fields): eval chunks cap at 8k (gather
    # temporaries outgrow the 32k MLP-path tile, train/loop.py)
    eval_gather_bound = True
    # fit() dispatches grid families one step per call instead of
    # scan-chunking: XLA does not alias the multi-hundred-MB grid buffers
    # across lax.scan iterations the way donation does across dispatches
    scan_hostile = True

    @property
    def sh_dim(self) -> int:
        return (self.sh_degree + 1) ** 2

    @property
    def channels(self) -> int:
        return 1 + 3 * self.sh_dim

    def init(self, key: jax.Array) -> dict:
        del key  # deterministic: grids start uniform (paper init: zeros)
        r, c = self.grid_res, self.channels
        grid = jnp.zeros((r, r, r, c), jnp.float32)
        if not self.reference_init:
            raw = float(np.log(np.expm1(self.init_sigma)))
            grid = grid.at[..., 0].set(raw)
        return {"grid": grid}

    def apply(
        self, params: dict, points: jax.Array, viewdirs: jax.Array
    ) -> tuple[jax.Array, jax.Array]:
        """points/viewdirs (..., 3) -> (rgb (..., 3), sigma (...,)).
        Points arrive reference-normalized from the renderer; ``domain``
        places the grid over the scene volume within that space."""
        from nerf_jax.models.common import remap_domain

        points = remap_domain(points, self.domain)
        shape = points.shape[:-1]
        d = viewdirs.reshape(-1, 3)
        vals = trilinear(params["grid"], points.reshape(-1, 3))  # (N, C)
        sigma = jax.nn.softplus(vals[:, 0])
        sh = vals[:, 1:].reshape(-1, 3, self.sh_dim)     # (N, 3, L)
        basis = sh_basis(d, self.sh_degree)              # (N, L)
        rgb = jax.nn.sigmoid(jnp.einsum("ncl,nl->nc", sh, basis,
                                        precision=HIGHEST))
        return rgb.reshape(*shape, 3), sigma.reshape(shape)

    def tv(self, params: dict) -> tuple[jax.Array, jax.Array]:
        """Total-variation regularizer over the voxel grid — the paper's
        core prior (Fridovich-Keil & Yu et al. 2022, eq. 3): mean squared
        forward difference along each axis, returned separately for the
        density channel and the SH channels so the two paper weights
        (lambda_TV, lambda_TV_sh) can differ.

        The paper's CUDA implementation samples random voxels (stochastic
        TV); here the FULL grid difference is taken — three shifted
        elementwise reads that XLA fuses into one bandwidth-bound pass,
        with a scatter-free gradient.
        """
        g = params["grid"]
        tv_sigma = jnp.zeros((), jnp.float32)
        tv_sh = jnp.zeros((), jnp.float32)
        for axis in range(3):
            d = (jax.lax.slice_in_dim(g, 1, None, axis=axis)
                 - jax.lax.slice_in_dim(g, 0, -1, axis=axis))
            tv_sigma = tv_sigma + jnp.mean(jnp.square(d[..., 0]))
            tv_sh = tv_sh + jnp.mean(jnp.square(d[..., 1:]))
        return tv_sigma, tv_sh

    def upsample(self, params: dict, new_res: int) -> dict:
        """Coarse-to-fine: trilinearly resample the grid to ``new_res``
        (the paper's 256^3-from-128^3 schedule)."""
        lin = jnp.linspace(-1.0, 1.0, new_res, dtype=jnp.float32)
        pts = jnp.stack(jnp.meshgrid(lin, lin, lin, indexing="ij"),
                        axis=-1)
        vals = trilinear(params["grid"], pts.reshape(-1, 3))
        return {"grid": vals.reshape(new_res, new_res, new_res,
                                     self.channels)}
