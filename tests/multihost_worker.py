"""Subprocess worker for the 2-process multi-host tests.

Each worker is one "host": it initializes jax.distributed against a local
coordinator, gets 4 virtual CPU devices (XLA_FLAGS set by the launcher), and
runs the REAL `fit()` end-to-end — globally sharded pool, GSPMD step over the
8-device cross-process mesh, process-0-gated logging, checkpoints gathered
across processes and written by process 0. The launcher (tests/test_multihost.py) supplies the full
Config as JSON so the same worker drives every family, then compares the
final checkpoint against a single-process run of the same config.

Usage: python tests/multihost_worker.py <pid> <nprocs> <port> <cfg.json> <out>
"""

import json
import os
import sys

# repo-root import without PYTHONPATH (env-var path injection can break
# platform plugin registration on some runtimes)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    pid, nprocs = int(sys.argv[1]), int(sys.argv[2])
    port, cfg_json, out_dir = sys.argv[3], sys.argv[4], sys.argv[5]

    import jax

    from nerf_jax.parallel.multihost import init_distributed, is_primary

    init_distributed(f"localhost:{port}", nprocs, pid)
    assert jax.process_count() == nprocs, jax.process_count()
    assert jax.device_count() == 4 * nprocs, jax.device_count()
    assert len(jax.local_devices()) == 4

    from nerf_jax.config import config_from_dict
    from nerf_jax.data.pipeline import load_scene
    from nerf_jax.parallel.mesh import create_mesh, data_sharding
    from nerf_jax.train.loop import fit

    with open(cfg_json) as f:
        cfg = config_from_dict(json.load(f))
    assert cfg.multihost, "launcher must set multihost=true"
    num_iters = cfg.num_iters

    # the pool must be globally sharded: every device holds M/8 rays
    mesh = create_mesh()
    probe = load_scene(cfg, sharding=data_sharding(mesh))
    shard_rows = {
        s.data.shape[0] for s in probe.pool.rays_o.addressable_shards
    }
    total = probe.pool.rays_o.shape[0]
    assert shard_rows == {total // 8}, (shard_rows, total)

    state = fit(cfg, max_steps=num_iters, enable_tensorboard=False)
    assert int(state.step) == num_iters

    if is_primary():
        with open(os.path.join(out_dir, "worker_ok.json"), "w") as f:
            json.dump({"step": int(state.step), "procs": nprocs}, f)


if __name__ == "__main__":
    main()
