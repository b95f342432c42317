"""Device mesh construction and sharding helpers.

Scale-out model (the reference is strictly single-device,
/root/reference/train.py:98-99): a 1-D (or 2-D for multi-scene) logical mesh
over all devices; the RAY axis is sharded along ``data`` and parameters are
replicated. Under jit/GSPMD, replicated params + sharded rays make XLA emit
a single gradient all-reduce (psum), overlapped with the backward
pass by the latency-hiding scheduler — no hand-written communication.

Multi-host execution is the same code after `jax.distributed.initialize()`:
the mesh spans all processes' devices and per-host data feeding goes through
`jax.make_array_from_process_local_data` (see ``shard_pool``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def create_mesh(
    spec: str = "", devices: Optional[Sequence[jax.Device]] = None
) -> Mesh:
    """Build a mesh from a spec like ``"data:8"`` or ``"scene:2,data:4"``.
    Empty spec = all devices on a single ``data`` axis."""
    devices = list(devices if devices is not None else jax.devices())
    if not spec:
        return Mesh(np.asarray(devices), axis_names=("data",))
    names, sizes = [], []
    for part in spec.split(","):
        name, _, size = part.partition(":")
        names.append(name.strip())
        sizes.append(int(size))
    total = int(np.prod(sizes))
    if total != len(devices):
        raise ValueError(
            f"mesh spec {spec!r} wants {total} devices, have {len(devices)}"
        )
    arr = np.asarray(devices).reshape(tuple(sizes))
    return Mesh(arr, axis_names=tuple(names))


def data_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """Shard the leading (ray) axis across the data axis of the mesh."""
    return NamedSharding(mesh, P(axis))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_pool(pool, mesh: Mesh, axis: str = "data"):
    """Place a RayPool sharded across the mesh's data axis (pads the pool to
    a multiple of the axis size by wrapping — duplicate rays are harmless for
    uniform with-replacement sampling)."""
    import jax.numpy as jnp

    n_shards = mesh.shape[axis]
    sharding = data_sharding(mesh, axis)

    def place(x):
        m = x.shape[0]
        rem = (-m) % n_shards
        if rem:
            x = jnp.concatenate([x, x[:rem]], axis=0)
        return jax.device_put(x, sharding)

    return jax.tree.map(place, pool)
