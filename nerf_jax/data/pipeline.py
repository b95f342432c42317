"""Device-resident data pipeline.

The reference feeds training with a host-side ``DataLoader(shuffle=True)``
over a flattened ray pool, paying a host->device copy of every batch
(/root/reference/train.py:119-121,162-164). This design inverts that: the
ENTIRE ray pool is uploaded to device memory once at startup, and each training
step draws a uniform random batch on-device with ``jax.random.randint`` + a
gather — all inside the jitted step, so steps never touch the host.

Uniform-with-replacement sampling replaces epoch-shuffling by default; for
NeRF-style training over tens of millions of rays the two are statistically
indistinguishable and with-replacement keeps the step a pure function of
(state, key).

Strict reference parity (``epoch_sampling=True``): epoch permutation without
replacement, matching the DataLoader shuffle-and-wrap semantics
(/root/reference/train.py:119-121,155-160). A materialized
``jax.random.permutation`` of a 40M-ray pool per epoch would cost a full
device sort; instead the permutation is a stateless format-preserving
cipher — a 4-round balanced Feistel network over [0, M) with cycle-walking —
so the step stays a pure function of (step, key): position ``p`` of epoch
``e`` maps to ray ``cipher(fold_in(key, e), p)``, an exact bijection, O(batch)
work, no carried shuffle state.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from nerf_jax.data.blender import load_blender
from nerf_jax.data.llff import load_llff
from nerf_jax.data.rays import compute_rays


def _feistel_permute(key: jax.Array, x: jax.Array, domain: int) -> jax.Array:
    """Exact pseudorandom permutation of ``[0, domain)`` applied elementwise.

    4-round balanced Feistel cipher over the smallest even-bit power-of-two
    domain >= ``domain``, with cycle-walking back into range (expected < 2
    walks since 2^nb < 4*domain). Bijective by construction — every epoch
    position maps to a distinct ray index.
    """
    nb = max(2, (max(domain - 1, 1)).bit_length())
    nb += nb % 2  # balanced halves
    half = nb // 2
    mask = jnp.uint32((1 << half) - 1)
    rks = jax.random.bits(key, (4,), dtype=jnp.uint32)

    def feistel(v: jax.Array) -> jax.Array:
        left = (v >> half).astype(jnp.uint32)
        right = (v & mask).astype(jnp.uint32)
        for r in range(4):
            # murmur3-style integer mix of (right, round key)
            f = (right ^ rks[r]) * jnp.uint32(0x9E3779B1)
            f = f ^ (f >> 15)
            f = f * jnp.uint32(0x85EBCA6B)
            f = f ^ (f >> 13)
            left, right = right, left ^ (f & mask)
        return (left << half) | right

    dom = jnp.uint32(domain)

    def walk(v):
        return jax.lax.while_loop(
            lambda u: jnp.any(u >= dom),
            lambda u: jnp.where(u >= dom, feistel(u), u),
            v,
        )

    return walk(feistel(x.astype(jnp.uint32))).astype(jnp.int32)


def epoch_indices(
    key: jax.Array, step: jax.Array, batch_size: int, pool_size: int
) -> jax.Array:
    """Ray indices for training step ``step`` under epoch-permutation
    (without-replacement) sampling. Pure function of (key, step): linear
    position ``p = step*batch + i`` lands in epoch ``p // pool_size`` at
    offset ``p % pool_size``; each epoch permutes offsets with its own
    cipher key (``fold_in(key, epoch)``). Batches straddling an epoch
    boundary wrap into the next epoch's permutation.

    Limits (checked where static): ``batch_size <= pool_size`` (a batch
    spans at most two epochs — more would reuse epoch e0+1's cipher), and
    the linear position must stay below 2^31 (~2M steps at batch 1024;
    jax default x64-off leaves no wider exact integer). ``fit()`` warns
    when a schedule would cross that."""
    if batch_size > pool_size:
        raise ValueError(
            f"epoch_sampling needs batch_size ({batch_size}) <= pool size "
            f"({pool_size}): a batch may straddle at most two epochs"
        )
    pos = jnp.asarray(step, jnp.int32) * batch_size + jnp.arange(
        batch_size, dtype=jnp.int32
    )
    epoch = pos // pool_size
    offset = (pos % pool_size).astype(jnp.uint32)
    e0 = epoch[0]
    # a batch spans at most two epochs (batch_size <= pool_size)
    k0 = jax.random.fold_in(key, e0)
    k1 = jax.random.fold_in(key, e0 + 1)
    idx0 = _feistel_permute(k0, offset, pool_size)
    idx1 = _feistel_permute(k1, offset, pool_size)
    return jnp.where(epoch > e0, idx1, idx0)


class RayBatch(NamedTuple):
    rays_o: jax.Array   # (B, 3)
    rays_d: jax.Array   # (B, 3)
    rgb: jax.Array      # (B, 3) target pixels
    viewdirs: jax.Array  # (B, 3) unit view directions


class RayPool(NamedTuple):
    """Flattened ray pool living in device memory (sharded or replicated)."""

    rays_o: jax.Array    # (M, 3)
    rays_d: jax.Array    # (M, 3)
    rgb: jax.Array       # (M, 3)
    viewdirs: jax.Array  # (M, 3)

    @property
    def size(self) -> int:
        return self.rays_o.shape[0]

    def sample(self, key: jax.Array, batch_size: int) -> RayBatch:
        """Uniform random ray batch; jit-safe (static batch_size)."""
        idx = jax.random.randint(key, (batch_size,), 0, self.rays_o.shape[0])
        return self._take(idx)

    def sample_epoch(self, key: jax.Array, step: jax.Array,
                     batch_size: int) -> RayBatch:
        """Without-replacement batch: reference DataLoader epoch-shuffle
        semantics (see ``epoch_indices``). ``key`` must be the SAME key every
        step (the epoch, not the step, reseeds the permutation)."""
        idx = epoch_indices(key, step, batch_size, self.rays_o.shape[0])
        return self._take(idx)

    def _take(self, idx: jax.Array) -> RayBatch:
        take = lambda x: jnp.take(x, idx, axis=0)
        return RayBatch(
            rays_o=take(self.rays_o),
            rays_d=take(self.rays_d),
            rgb=take(self.rgb),
            viewdirs=take(self.viewdirs),
        )


def build_ray_pool(
    rays_o: np.ndarray,
    rays_d: np.ndarray,
    rgb: np.ndarray,
    viewdirs: Optional[np.ndarray] = None,
    sharding=None,
) -> RayPool:
    """Flatten (N, HW, 3) host arrays into a device RayPool.

    ``viewdirs`` defaults to ``rays_d`` normalized (for NDC rays pass the
    pre-warp world directions). ``sharding`` optionally places the pool
    sharded across the mesh's data axis.
    """
    flat = lambda x: np.ascontiguousarray(x.reshape(-1, 3), dtype=np.float32)
    rays_o, rays_d, rgb = flat(rays_o), flat(rays_d), flat(rgb)
    if viewdirs is None:
        viewdirs = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    else:
        viewdirs = flat(viewdirs)
        viewdirs = viewdirs / np.linalg.norm(viewdirs, axis=-1, keepdims=True)

    if sharding is not None:
        # Pad to a shard multiple by wrapping — duplicate rays are harmless
        # for uniform with-replacement sampling (same trick as
        # mesh.shard_pool). Under epoch_sampling the exactly-once guarantee
        # then holds over the PADDED pool: the first `rem` rays appear twice
        # per epoch (rem < n_shards, i.e. <1e-5 of a real scene's pool) —
        # fit() notes this at startup when both features are active.
        n_shards = getattr(sharding, "num_devices", None) or len(sharding.device_set)
        rem = (-rays_o.shape[0]) % n_shards
        if rem:
            wrap = lambda x: np.concatenate([x, x[:rem]], axis=0)
            rays_o, rays_d, rgb, viewdirs = map(wrap, (rays_o, rays_d, rgb, viewdirs))
        put = lambda x: jax.device_put(x, sharding)
    else:
        put = jnp.asarray
    return RayPool(
        rays_o=put(rays_o), rays_d=put(rays_d), rgb=put(rgb), viewdirs=put(viewdirs)
    )


@dataclass
class Scene:
    """Everything the trainer needs for one scene."""

    pool: RayPool                 # training rays on device
    val_images: np.ndarray        # (Nv, H, W, 3)
    val_c2w: np.ndarray           # (Nv, 4, 4) or (Nv, 3, 4)
    focal: float
    hw: tuple[int, int]
    near: float
    far: float
    white_background: bool
    ndc: bool = False
    render_poses: Optional[np.ndarray] = None  # eval path (LLFF spiral)
    name: str = "scene"


def load_scene(cfg, sharding=None) -> Scene:
    """Load the dataset named by a Config into a device-resident Scene."""
    if cfg.dataset_type == "blender":
        images, c2w, focal = load_blender(
            cfg.dataset_path,
            mode="train",
            white_background=cfg.white_background,
            half_res=cfg.half_res,
        )
        val_images, val_c2w, val_focal = load_blender(
            cfg.dataset_path,
            mode="val",
            white_background=cfg.white_background,
            half_res=cfg.half_res,
        )
        rays_o, rays_d, rgb = compute_rays(images, c2w, focal)
        pool = build_ray_pool(rays_o, rays_d, rgb, sharding=sharding)
        return Scene(
            pool=pool,
            val_images=val_images,
            val_c2w=val_c2w,
            focal=val_focal,
            hw=(images.shape[1], images.shape[2]),
            near=cfg.near,
            far=cfg.far,
            white_background=cfg.white_background,
            ndc=False,
            name=cfg.dataset_path.rstrip("/").split("/")[-1],
        )

    if cfg.dataset_type == "llff":
        data = load_llff(cfg.dataset_path, factor=cfg.llff_factor)
        images, poses = data["images"], data["poses"]
        h, w = data["hw"]
        focal = data["focal"]

        i_train, i_test = data["i_train"], data["i_test"]
        c2w44 = np.tile(np.eye(4, dtype=np.float32), (poses.shape[0], 1, 1))
        c2w44[:, :3, :4] = poses
        rays_o, rays_d, rgb = compute_rays(images, c2w44, focal)

        if cfg.ndc:
            from nerf_jax.ops.ndc import ndc_rays

            world_d = rays_d[i_train]
            o_ndc, d_ndc = ndc_rays(
                h, w, focal, 1.0,
                jnp.asarray(rays_o[i_train]), jnp.asarray(rays_d[i_train]),
            )
            pool = build_ray_pool(
                np.asarray(o_ndc), np.asarray(d_ndc), rgb[i_train],
                viewdirs=world_d, sharding=sharding,
            )
            near, far = 0.0, 1.0
        else:
            pool = build_ray_pool(
                rays_o[i_train], rays_d[i_train], rgb[i_train], sharding=sharding
            )
            near, far = data["near_world"], data["far_world"]

        return Scene(
            pool=pool,
            val_images=images[i_test],
            val_c2w=c2w44[i_test],
            focal=focal,
            hw=(h, w),
            near=near,
            far=far,
            white_background=False,
            ndc=cfg.ndc,
            render_poses=data["render_poses"],
            name=cfg.dataset_path.rstrip("/").split("/")[-1],
        )

    raise ValueError(f"Unknown dataset_type: {cfg.dataset_type}")
