"""Multi-host execution helpers.

The reference is single-process/single-device (train.py:98-99). Scale-out
across hosts is the same training code after:

    from nerf_jax.parallel.multihost import init_distributed
    init_distributed()            # jax.distributed across hosts
    mesh = create_mesh()          # now spans all processes' devices

Data feeding is per-host: each process loads (or slices) its shard of the
ray pool and `global_pool_from_local` assembles a globally-sharded RayPool
with `jax.make_array_from_process_local_data` — rays stay on their host's
devices; only the initial distribution crosses hosts.
"""

from __future__ import annotations

from typing import Optional

import jax


def _is_initialized() -> bool:
    """Whether jax.distributed.initialize has already run — checked WITHOUT
    touching the backend (jax.process_count() would initialize it, after
    which distributed init is impossible)."""
    try:
        from jax._src import distributed

        return distributed.global_state.client is not None
    except Exception:  # pragma: no cover - private-API drift guard
        return False


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed (no-op when already initialized).

    With no arguments, relies on cluster auto-detection (Slurm, env vars); failure to detect a cluster is treated as a single-process run.
    With explicit arguments, failures propagate — a misconfigured coordinator
    must not silently degrade to single-process training."""
    if _is_initialized():
        return
    explicit = coordinator_address is not None or num_processes is not None
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (ValueError, RuntimeError):
        if explicit:
            raise
        # single-process run (no coordinator configured/detected) — fine.


def global_pool_from_local(local_pool, mesh, axis: str = "data"):
    """Assemble a globally data-sharded RayPool from per-process local ray
    arrays. Each process passes ITS OWN rays; the result is a global array
    sharded over `axis` whose addressable shards are the local data."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P(axis))
    return jax.tree.map(
        lambda x: jax.make_array_from_process_local_data(sharding, x),
        local_pool,
    )


def is_primary() -> bool:
    """True on the process that should write checkpoints metadata/logs."""
    return jax.process_index() == 0
