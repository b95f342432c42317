"""Subprocess worker for the 2-process multi-scene test (the BASELINE
config-5 shape: scenes x data over two hosts). Mirrors multihost_worker.py
but drives ``fit_multiscene`` with two dataset paths.

Usage: python tests/multiscene_worker.py <pid> <nprocs> <port> <cfg.json> \
           <out> <scene_a> <scene_b>
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    pid, nprocs = int(sys.argv[1]), int(sys.argv[2])
    port, cfg_json, out_dir = sys.argv[3], sys.argv[4], sys.argv[5]
    scene_paths = sys.argv[6:]

    import jax

    from nerf_jax.parallel.multihost import init_distributed, is_primary

    init_distributed(f"localhost:{port}", nprocs, pid)
    assert jax.process_count() == nprocs, jax.process_count()

    from nerf_jax.config import config_from_dict
    from nerf_jax.train.multiscene_loop import fit_multiscene

    with open(cfg_json) as f:
        cfg = config_from_dict(json.load(f))
    assert cfg.multihost, "launcher must set multihost=true"

    state = fit_multiscene(cfg, scene_paths, max_steps=cfg.num_iters,
                           enable_tensorboard=False)
    assert int(state.step) == cfg.num_iters

    if is_primary():
        with open(os.path.join(out_dir, "worker_ok.json"), "w") as f:
            json.dump({"step": int(state.step), "procs": nprocs}, f)


if __name__ == "__main__":
    main()
