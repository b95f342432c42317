"""Multi-host execution: 2 jax.distributed processes (4 virtual CPU devices
each) train through the REAL ``fit()`` path and must match the
single-process run on the same 8-device-global config (SURVEY.md §5
"distributed communication backend"; the reference is single-process,
/root/reference/train.py:98-99)."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import jax
import pytest

from nerf_jax.config import Config
from tests.synthetic import make_synthetic_blender_scene

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_two_process_vs_single(tmp_path, cfg_kwargs):
    """Drive fit() as 2 jax.distributed processes AND single-process on
    the identical config; the final checkpoints must agree bit-for-bit
    (only the process layout differs)."""
    import dataclasses

    scene_dir = tmp_path / "scene"
    make_synthetic_blender_scene(str(scene_dir), h=16, w=16, num_train=4)

    # --- 2-process distributed run through fit() ---
    mh_dir = tmp_path / "mh"
    os.makedirs(mh_dir)
    cfg = Config(
        dataset_path=str(scene_dir),
        num_random_rays=64,
        num_samples=4,
        donate_state=False,
        log_interval=4,
        val_interval=4,   # exercises the multihost validation/allgather path
        save_interval=100,
        num_iters=8,
        save_path=str(mh_dir),
        log_dir=str(mh_dir / "logs"),
        multihost=True,
        **cfg_kwargs,
    )
    cfg_json = tmp_path / "cfg.json"
    cfg_json.write_text(json.dumps(
        {k: str(v) for k, v in dataclasses.asdict(cfg).items()}))
    port = _free_port()
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        JAX_PLATFORM_NAME="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
    )
    env.pop("PYTHONPATH", None)  # breaks platform plugin registration
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(_REPO, "tests", "multihost_worker.py"),
             str(pid), "2", str(port), str(cfg_json), str(mh_dir)],
            env=env, cwd=_REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
    with open(mh_dir / "worker_ok.json") as f:
        assert json.load(f)["step"] == 8

    # only process 0 writes console/meta; process 1 must be quiet about it
    assert "Training complete!" in outs[0]
    assert "Training complete!" not in outs[1]

    # --- single-process run, same config (8 local virtual devices) ---
    sp_dir = tmp_path / "sp"
    from nerf_jax.train.loop import fit

    cfg_sp = dataclasses.replace(cfg, multihost=False,
                                 save_path=str(sp_dir),
                                 log_dir=str(sp_dir / "logs"))
    state_sp = fit(cfg_sp, max_steps=8, enable_tensorboard=False)

    # --- the two final checkpoints must agree (same data, same keys, same
    # global batch; only the process layout differs) ---
    from nerf_jax.train.state import create_train_state
    from nerf_jax.utils.checkpoint import latest_checkpoint, load_checkpoint

    _, _, template = create_train_state(cfg_sp, jax.random.key(cfg.seed))
    mh_ckpt = latest_checkpoint(str(mh_dir))
    assert mh_ckpt is not None and mh_ckpt.endswith("000008")
    restored = load_checkpoint(mh_ckpt, template)

    for a, b in zip(
        jax.tree_util.tree_leaves(restored.params),
        jax.tree_util.tree_leaves(state_sp.params),
    ):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6
        )


@pytest.mark.slow
def test_two_process_fit_matches_single_process(tmp_path):
    _run_two_process_vs_single(tmp_path, dict(
        model_type="nerf", hidden_dim=32, pos_encoding_dim=2,
        dir_encoding_dim=1,
    ))


@pytest.mark.slow
def test_two_process_grid_family(tmp_path):
    """Grid families cross-process: the pure gather path (kernels disable
    under multihost), the scene-volume domain, and the direct-grid param
    pytree all ride the same GSPMD step and collective checkpointing."""
    _run_two_process_vs_single(tmp_path, dict(
        model_type="plenoxels", grid_res=8, learning_rate=0.01,
    ))
