"""Coarse-to-fine grid training (cfg.upsample_steps -> fit()'s mid-run
trilinear upsample + optimizer restart, the Plenoxels paper's schedule)."""

import numpy as np
import jax.numpy as jnp
import pytest

from nerf_jax.config import Config
from nerf_jax.train.loop import fit, parse_upsample_steps
from nerf_jax.utils.checkpoint import read_metadata
from tests.synthetic import make_synthetic_blender_scene


def test_parse_upsample_steps():
    assert parse_upsample_steps("") == []
    assert parse_upsample_steps("2000:64,5000:128") == [(2000, 64),
                                                        (5000, 128)]
    with pytest.raises(ValueError, match="increase"):
        parse_upsample_steps("2000:64,5000:64")
    with pytest.raises(ValueError, match="increase"):
        parse_upsample_steps("2000:64,1000:128")
    with pytest.raises(ValueError, match="step:res"):
        parse_upsample_steps("2000")
    with pytest.raises(ValueError, match="> 0"):
        parse_upsample_steps("0:64")


def test_upsample_rejected_for_mlp_families(tmp_path):
    root = tmp_path / "scene"
    make_synthetic_blender_scene(str(root), h=16, w=16, num_train=4)
    cfg = Config(dataset_path=str(root), model_type="nerf", hidden_dim=32,
                 pos_encoding_dim=2, dir_encoding_dim=1, num_samples=4,
                 num_random_rays=64, upsample_steps="5:16",
                 save_path=str(tmp_path / "m"),
                 log_dir=str(tmp_path / "l"))
    with pytest.raises(ValueError, match="no\\s+upsample hook"):
        fit(cfg, max_steps=8, enable_tensorboard=False)


def _cfg(tmp_path, **kw):
    root = tmp_path / "scene"
    make_synthetic_blender_scene(str(root), h=16, w=16, num_train=4)
    base = dict(
        dataset_path=str(root), model_type="plenoxels", grid_res=4,
        learning_rate=0.01, num_samples=4, num_random_rays=64,
        donate_state=False,
        log_interval=4, val_interval=100, save_interval=6,
        save_path=str(tmp_path / "models"), log_dir=str(tmp_path / "logs"),
    )
    base.update(kw)
    return Config(**base)


def test_fit_upsamples_and_records_res(tmp_path):
    cfg = _cfg(tmp_path, upsample_steps="5:6,9:8", num_iters=12)
    state = fit(cfg, max_steps=12, enable_tensorboard=False)
    assert state.params["grid"].shape[:3] == (8, 8, 8)
    assert int(state.step) == 12
    assert np.isfinite(float(jnp.sum(state.params["grid"])))
    # the final checkpoint records the grown resolution...
    meta = read_metadata(str(tmp_path / "models" / "plenoxels_model_000012"))
    assert meta["grid_res"] == 8
    # ...and the interval save at step 6 the mid-schedule one
    meta6 = read_metadata(str(tmp_path / "models" / "plenoxels_model_000006"))
    assert meta6["grid_res"] == 6


def test_resume_after_upsample(tmp_path):
    cfg = _cfg(tmp_path, upsample_steps="5:6", num_iters=14)
    fit(cfg, max_steps=8, enable_tensorboard=False)
    ckpt = str(tmp_path / "models" / "plenoxels_model_000008")
    assert read_metadata(ckpt)["grid_res"] == 6

    # fit() itself applies meta's grid_res before rebuilding the state
    # (cfg still says grid_res=4), and already-applied entries drop out
    state = fit(cfg, resume_path=ckpt, max_steps=14,
                enable_tensorboard=False)
    assert state.params["grid"].shape[:3] == (6, 6, 6)
    assert int(state.step) == 14
