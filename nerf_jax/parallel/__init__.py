from nerf_jax.parallel.mesh import (
    create_mesh,
    data_sharding,
    replicated_sharding,
    shard_pool,
)
from nerf_jax.parallel.dp import make_dp_train_step
from nerf_jax.parallel.multiscene import make_multiscene_train_step, stack_scenes

__all__ = [
    "create_mesh",
    "data_sharding",
    "replicated_sharding",
    "shard_pool",
    "make_dp_train_step",
    "make_multiscene_train_step",
    "stack_scenes",
]
