"""The classic NeRF MLP with view-direction branch, as a functional pytree.

Architecture matches the reference exactly (/root/reference/nerf/models.py:9-75):
  * inputs: encoded points (3+6*L_pos = 63 for L=10), encoded dirs (27 for L=4)
  * block1: Linear(63,256) + 4x Linear(256,256), ReLU after each (models.py:25-36)
  * block2: skip-concat of encoded points -> Linear(319,256) + 3x Linear(256,256)
    with ReLU, then Linear(256,257) with NO activation (models.py:39-49)
  * density = relu(last channel) (models.py:71)
  * rgb head: concat(features[...,:256], dirs_enc) -> Linear(283,128) + ReLU
    -> Linear(128,3) -> sigmoid (models.py:52-57)

``apply`` is written over arbitrary leading batch dims of flat points, so
the renderer's (rays, samples, 3) queries and flat (num_points, 3) tiles
take the same path.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from nerf_jax.models.common import linear, linear_init
from nerf_jax.models.encoding import encoded_dim, positional_encoding


@dataclass(frozen=True)
class NeRFModel:
    pos_encoding_dim: int = 10
    dir_encoding_dim: int = 4
    hidden_dim: int = 256
    compute_dtype: str = "float32"
    reference_init: bool = False   # strict parity: keep torch's raw Linear
                                   # init (skip the dead-ReLU density-bias
                                   # guard below) so fresh-init parameter
                                   # distributions match the reference exactly

    name: str = "nerf"

    @property
    def pos_in(self) -> int:
        return encoded_dim(3, self.pos_encoding_dim)  # 63

    @property
    def dir_in(self) -> int:
        return encoded_dim(3, self.dir_encoding_dim)  # 27

    def init(self, key: jax.Array) -> dict:
        h = self.hidden_dim
        keys = iter(jax.random.split(key, 16))
        block1 = [linear_init(next(keys), self.pos_in, h)]
        block1 += [linear_init(next(keys), h, h) for _ in range(4)]
        block2 = [linear_init(next(keys), h + self.pos_in, h)]
        block2 += [linear_init(next(keys), h, h) for _ in range(3)]
        block2 += [linear_init(next(keys), h, h + 1)]
        # Density-channel bias starts at +0.5: the pre-activation at init is
        # bias-dominated and nearly constant across points, so a negative draw
        # puts EVERY point on the dead side of the ReLU (models.py:71) and
        # gradients are exactly zero forever. The reference inherits this
        # coin-flip from torch's Linear init; we remove it deterministically
        # (reference_init=True keeps the coin-flip for strict init parity).
        if not self.reference_init:
            block2[-1]["b"] = block2[-1]["b"].at[-1].set(0.5)
        rgb = [
            linear_init(next(keys), h + self.dir_in, h // 2),
            linear_init(next(keys), h // 2, 3),
        ]
        return {"block1": block1, "block2": block2, "rgb": rgb}

    def apply(
        self, params: dict, points: jax.Array, viewdirs: jax.Array
    ) -> tuple[jax.Array, jax.Array]:
        """points/viewdirs: (..., 3) -> (rgb (..., 3), sigma (...,)).

        ``points`` are expected pre-normalized to [-1,1] (the renderer applies
        the reference's componentwise [near,far] -> [-1,1] map,
        rendering.py:67-82); ``viewdirs`` are unit world-space directions.
        """
        cdt = jnp.dtype(self.compute_dtype)
        p_enc = positional_encoding(points, self.pos_encoding_dim)
        d_enc = positional_encoding(viewdirs, self.dir_encoding_dim)

        x = p_enc
        for lyr in params["block1"]:
            x = jax.nn.relu(linear(lyr, x, cdt))

        x = jnp.concatenate([x, p_enc], axis=-1)
        for lyr in params["block2"][:-1]:
            x = jax.nn.relu(linear(lyr, x, cdt))
        x = linear(params["block2"][-1], x, cdt)

        sigma = jax.nn.relu(x[..., -1])
        feat = x[..., :-1]

        y = jnp.concatenate([feat, d_enc], axis=-1)
        y = jax.nn.relu(linear(params["rgb"][0], y, cdt))
        rgb = jax.nn.sigmoid(linear(params["rgb"][1], y, cdt))
        return rgb, sigma
