"""KiloNeRF: thousands of tiny per-voxel MLPs (reference roadmap,
/root/reference/notes.txt:4; Reiser et al. 2021).

The scene's normalized [-1,1]^3 domain is subdivided into a
``grid_res``^3 voxel grid; each voxel owns an independent tiny MLP
(hidden_dim=32 per the paper vs 256 for the monolithic NeRF — ~100x fewer
FLOPs per sample). A sample point is evaluated by the network of the voxel
it falls in, on coordinates local to that voxel.

Static-shape evaluation
-----------------------
The CUDA KiloNeRF gathers points per network with dynamic batching — a
shape-dynamic pattern XLA cannot compile. Here evaluation is a static-shape
MoE-style grouped matmul:

  1. voxel id per point; one 32-bit stable sort of (vid << B | index) groups
     points by network,
  2. each group is padded up to ``dispatch_tile`` points and tiled; a small
     per-tile gather pulls THAT network's weight block,
  3. all layers run as one batched (tiles, T, in) x (tiles, in, out) matmul
     (f32 accumulation), activations staying in tile layout,
  4. one inverse-permutation gather restores ray/sample order.

All shapes depend only on (num_points, grid_res, dispatch_tile), so the
whole thing jits into the fused train step like any other family. The tile
padding wastes at most grid_res^3 * (T-1) slots; at the training shape
(262k points, 8^3 grid, T=128) that is ~12% — far cheaper than the gathers
a per-point weight lookup would need (~6 kB of weights per point).

Parameter layout: every layer is stored batched over networks — ``w`` of
shape (G^3, in, out), ``b`` of (G^3, out) — which is also exactly what the
grouped matmul consumes; there is no per-network pytree to flatten.

Head contract matches the repo's other families (renderer/trainer see the
same API): density = relu on the last channel of the final trunk layer,
view-dependent rgb branch on encoded dirs ending in sigmoid
(/root/reference/nerf/models.py:52-75 head structure, shrunk to the tiny
width). Empty-space skipping and teacher distillation from the paper are
orthogonal training strategies and are not part of the field model.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from nerf_jax.models.common import linear_init, matmul_precision
from nerf_jax.models.encoding import encoded_dim, positional_encoding


def _batched_linear_init(key: jax.Array, g: int, in_dim: int, out_dim: int) -> dict:
    """G independent torch-default Linear draws, stored stacked."""
    init = jax.vmap(lambda k: linear_init(k, in_dim, out_dim))
    return init(jax.random.split(key, g))


def build_dispatch(vid: jax.Array, g3: int, t: int):
    """Static-shape grouped-dispatch plan for ``n`` points over ``g3``
    networks with tile size ``t`` (see module docstring).

    Returns (order, gid, src, valid, counts):
      order (n,)        stable sort of points by network id
      gid (num_tiles,)  which network each tile serves
      src (num_tiles,t) row into the SORTED array (or n = dummy) per slot
      valid (num_tiles,t)
      counts (g3,)      points per network
    with num_tiles = ceil(n/t) + g3 (static upper bound; surplus tiles are
    pure padding on the last group with zero valid slots).
    """
    order = jnp.argsort(vid)                     # stable (ties by index)
    gid, src, valid, counts = dispatch_plan_sorted(vid[order], g3, t)
    return order, gid, src, valid, counts


def dispatch_plan_sorted(svid: jax.Array, g3: int, t: int):
    """The plan half of ``build_dispatch`` given ALREADY-SORTED ids;
    ``src`` indexes rows of the SORTED array."""
    n = svid.shape[0]
    starts = jnp.searchsorted(
        svid, jnp.arange(g3, dtype=svid.dtype), side="left"
    )
    ends = jnp.concatenate([starts[1:], jnp.full((1,), n, starts.dtype)])
    counts = ends - starts

    num_tiles = -(-n // t) + g3
    tpg = -(-counts // t)                        # tiles per group
    tile_end = jnp.cumsum(tpg)
    tiles = jnp.arange(num_tiles, dtype=jnp.int32)
    gid = jnp.searchsorted(tile_end, tiles, side="right")
    gid = jnp.minimum(gid, g3 - 1).astype(jnp.int32)
    tile_rank = tiles - (tile_end[gid] - tpg[gid])
    slot = tile_rank[:, None] * t + jnp.arange(t, dtype=jnp.int32)[None, :]
    valid = slot < counts[gid][:, None]
    src = jnp.where(valid, starts[gid][:, None] + slot, n)
    return gid, src, valid, counts


@dataclass(frozen=True)
class KiloNeRFModel:
    grid_res: int = 8                # G: G^3 tiny networks
    pos_encoding_dim: int = 10       # L for voxel-local positions
    dir_encoding_dim: int = 4
    hidden_dim: int = 32             # per-network width (paper: 32)
    compute_dtype: str = "float32"
    dispatch_tile: int = 128         # points per grouped-matmul tile
    reference_init: bool = False     # strict parity: skip the density-bias guard
    domain: tuple = (-1.0, 1.0)      # cube of model-input space the expert
                                     # grid subdivides (registry.py::
                                     # grid_domain) — otherwise the scene
                                     # content lands in a handful of border
                                     # voxels and most experts never train

    name: str = "kilonerf"

    @property
    def num_networks(self) -> int:
        return self.grid_res ** 3

    @property
    def pos_in(self) -> int:
        return encoded_dim(3, self.pos_encoding_dim)

    @property
    def dir_in(self) -> int:
        return encoded_dim(3, self.dir_encoding_dim)

    def init(self, key: jax.Array) -> dict:
        g, h = self.num_networks, self.hidden_dim
        k1, k2, k3, k4, k5 = jax.random.split(key, 5)
        params = {
            "l1": _batched_linear_init(k1, g, self.pos_in, h),
            "l2": _batched_linear_init(k2, g, h, h),
            # trunk out: h features + 1 density channel (relu'd), the same
            # fused head layout as models/nerf.py block2[-1]
            "trunk": _batched_linear_init(k3, g, h, h + 1),
            "rgb1": _batched_linear_init(k4, g, h + self.dir_in, h),
            "rgb2": _batched_linear_init(k5, g, h, 3),
        }
        # Same dead-ReLU guard as the monolithic families (models/nerf.py:53-61)
        # — with G^3 independent density biases a negative draw kills that
        # voxel's gradients forever, visible as grid-aligned holes.
        if not self.reference_init:
            params["trunk"]["b"] = params["trunk"]["b"].at[:, -1].set(0.5)
        return params

    # ---------------------------------------------------------------- voxels

    def voxel_of(self, points: jax.Array) -> tuple[jax.Array, jax.Array]:
        """(vid, local) for points in the model's ``domain`` cube.

        Points outside the domain (rays exit the box laterally; the
        componentwise [near,far]->[-1,1] map does not clip) are assigned to
        the border voxel, whose local coordinates then extend past [-1,1] —
        the tiny MLP extrapolates, mirroring how the monolithic families see
        out-of-range inputs.
        """
        from nerf_jax.models.common import remap_domain

        points = remap_domain(points, self.domain)
        r = self.grid_res
        cell = jnp.clip(
            jnp.floor((points + 1.0) * (0.5 * r)).astype(jnp.int32), 0, r - 1
        )
        vid = (cell[..., 0] * r + cell[..., 1]) * r + cell[..., 2]
        center = (cell.astype(points.dtype) + 0.5) * (2.0 / r) - 1.0
        local = (points - center) * r
        return vid, local

    # ---------------------------------------------------- reference (gather)

    def _head(self, x_feats, d_enc, wb, cdt):
        """Shared math after per-point weights are in hand; ``wb`` maps layer
        name -> (w (N,in,out), b (N,out))."""

        def lin(name, x):
            w, b = wb[name]
            y = jnp.einsum(
                "ni,nio->no",
                x.astype(cdt),
                w.astype(cdt),
                preferred_element_type=jnp.float32,
                precision=matmul_precision(cdt),
            )
            return y + b

        x = jax.nn.relu(lin("l1", x_feats))
        x = jax.nn.relu(lin("l2", x))
        x = lin("trunk", x)
        sigma = jax.nn.relu(x[..., -1])
        y = jnp.concatenate([x[..., :-1], d_enc], axis=-1)
        y = jax.nn.relu(lin("rgb1", y))
        rgb = jax.nn.sigmoid(lin("rgb2", y))
        return rgb, sigma

    def apply_pointwise(
        self, params: dict, points: jax.Array, viewdirs: jax.Array
    ) -> tuple[jax.Array, jax.Array]:
        """Numerical-reference tier: per-point weight gather + einsum.

        Exact same math as the grouped path (identical reduction order per
        output element) but materializes (N, in, out) weight gathers — use
        for tests/small batches; ``apply`` is the production path.
        """
        shape = points.shape[:-1]
        p = points.reshape(-1, 3)
        d = viewdirs.reshape(-1, 3)
        vid, local = self.voxel_of(p)
        p_enc = positional_encoding(local, self.pos_encoding_dim)
        d_enc = positional_encoding(d, self.dir_encoding_dim)
        wb = {
            k: (params[k]["w"][vid], params[k]["b"][vid])
            for k in ("l1", "l2", "trunk", "rgb1", "rgb2")
        }
        rgb, sigma = self._head(p_enc, d_enc, wb, jnp.dtype(self.compute_dtype))
        return rgb.reshape(*shape, 3), sigma.reshape(shape)

    # ------------------------------------------------------ grouped dispatch

    def apply(
        self, params: dict, points: jax.Array, viewdirs: jax.Array
    ) -> tuple[jax.Array, jax.Array]:
        """points/viewdirs (..., 3) -> (rgb (..., 3), sigma (...,)).

        Static-shape grouped-matmul dispatch (see module docstring). Points
        are expected pre-normalized to [-1,1] by the renderer.
        """
        shape = points.shape[:-1]
        p = points.reshape(-1, 3)
        d = viewdirs.reshape(-1, 3)
        n = p.shape[0]
        g3 = self.num_networks
        t = self.dispatch_tile
        cdt = jnp.dtype(self.compute_dtype)

        vid, local = self.voxel_of(p)
        order, gid, src, valid, _ = build_dispatch(vid, g3, t)
        num_tiles = src.shape[0]

        # --- gather inputs once, encode in tile layout ---
        def pad1(x):
            return jnp.concatenate([x, jnp.zeros((1,) + x.shape[1:], x.dtype)])

        loc_s = pad1(local[order])[src]              # (tiles, T, 3)
        dir_s = pad1(d[order])[src]
        p_enc = positional_encoding(loc_s, self.pos_encoding_dim)
        d_enc = positional_encoding(dir_s, self.dir_encoding_dim)

        def lin(name, x):
            w = params[name]["w"][gid].astype(cdt)   # (tiles, in, out)
            b = params[name]["b"][gid]
            y = jnp.einsum(
                "gti,gio->gto", x.astype(cdt), w,
                preferred_element_type=jnp.float32,
                precision=matmul_precision(cdt),
            )
            return y + b[:, None, :]

        x = jax.nn.relu(lin("l1", p_enc))
        x = jax.nn.relu(lin("l2", x))
        x = lin("trunk", x)
        sigma_t = jax.nn.relu(x[..., -1])            # (tiles, T)
        y = jnp.concatenate([x[..., :-1], d_enc], axis=-1)
        y = jax.nn.relu(lin("rgb1", y))
        rgb_t = jax.nn.sigmoid(lin("rgb2", y))       # (tiles, T, 3)

        # --- restore original order: slot -> original index, one scatter of
        # int32 builds the inverse permutation, then a single gather ---
        orig = pad1(order.astype(jnp.int32)[:, None])[src][..., 0]  # (tiles,T)
        inv = jnp.zeros((n + 1,), jnp.int32).at[
            jnp.where(valid, orig, n).reshape(-1)
        ].set(jnp.arange(num_tiles * t, dtype=jnp.int32))
        inv = inv[:n]
        rgb = rgb_t.reshape(-1, 3)[inv]
        sigma = sigma_t.reshape(-1)[inv]
        return rgb.reshape(*shape, 3), sigma.reshape(shape)
