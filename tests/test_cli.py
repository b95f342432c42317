"""CLI integration tests (in-process): train -> checkpoint -> eval frames,
exercising the exact reference usage patterns (train.py:29-36, eval.py:53-62)
on the synthetic scene with a tiny model."""

import os

import numpy as np
import pytest

from nerf_jax.cli.eval_cli import main as eval_main
from nerf_jax.cli.train_cli import main as train_main
from tests.synthetic import make_synthetic_blender_scene


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene")
    make_synthetic_blender_scene(str(root), h=16, w=16, num_train=4)
    save = tmp_path_factory.mktemp("models")
    logs = tmp_path_factory.mktemp("logs")
    cfg_path = tmp_path_factory.mktemp("cfg") / "cfg.txt"
    cfg_path.write_text(
        f"""
dataset_path = {root}
num_random_rays = 64
num_samples = 8
num_iters = 12
hidden_dim = 32
pos_encoding_dim = 4
dir_encoding_dim = 2
save_path = {save}
save_interval = 5
log_interval = 5
val_interval = 10
model_type = nerf
num_render_poses = 2
chunk_size = 128
log_dir = {logs}
"""
    )
    return str(cfg_path), str(save)


def test_train_cli_writes_checkpoints(trained):
    cfg_path, save = trained
    train_main(["--config", cfg_path])
    names = sorted(os.listdir(save))
    # interval ckpt at step 5/10 + final at 12
    assert any(n == "nerf_model_000012" for n in names)
    assert any(n == "nerf_model_000005" for n in names)


def test_resume_cli(trained, capsys):
    cfg_path, save = trained
    train_main(
        ["--config", cfg_path, "--resume", os.path.join(save, "nerf_model_000012"),
         "--max-steps", "14"]
    )
    out = capsys.readouterr().out
    assert "Resuming training from iteration 12" in out
    assert os.path.isdir(os.path.join(save, "nerf_model_000014"))


def test_eval_cli_renders_frames(trained, tmp_path):
    cfg_path, save = trained
    out_dir = tmp_path / "frames"
    eval_main(
        ["--config", cfg_path, "--checkpoint", os.path.join(save, "nerf_model_000012"),
         "--output", str(out_dir)]
    )
    frames = sorted(os.listdir(out_dir))
    assert frames == ["frame_0000.png", "frame_0001.png"]
    from nerf_jax.utils.png import read_png

    img = read_png(str(out_dir / "frame_0000.png"))
    assert img.shape == (16, 16, 3)
    assert img.dtype == np.uint8


def test_eval_cli_metrics_mode(trained, tmp_path, capsys):
    cfg_path, save = trained
    out_dir = tmp_path / "metrics"
    eval_main(
        ["--config", cfg_path, "--checkpoint",
         os.path.join(save, "nerf_model_000012"),
         "--output", str(out_dir), "--metrics"]
    )
    import json

    with open(out_dir / "metrics.json") as f:
        m = json.load(f)
    assert m["num_views"] == len(m["views"]) > 0
    assert np.isfinite(m["mean_psnr"]) and 0.0 < m["mean_ssim"] <= 1.0
    preds = [p for p in os.listdir(out_dir) if p.startswith("pred_")]
    assert len(preds) == m["num_views"]
    assert "PSNR" in capsys.readouterr().out


def test_ssim_metric_properties():
    from nerf_jax.utils.metrics import ssim

    rng = np.random.RandomState(0)
    img = rng.uniform(size=(32, 32, 3)).astype(np.float32)
    assert abs(ssim(img, img) - 1.0) < 1e-9
    noisy = np.clip(img + 0.2 * rng.normal(size=img.shape), 0, 1)
    worse = np.clip(img + 0.5 * rng.normal(size=img.shape), 0, 1)
    s1, s2 = ssim(img, noisy), ssim(img, worse)
    assert 0.0 < s2 < s1 < 1.0
    assert abs(ssim(noisy, img) - s1) < 1e-9  # symmetric


@pytest.fixture(scope="module")
def trained_fastnerf(tmp_path_factory):
    root = tmp_path_factory.mktemp("fn_scene")
    make_synthetic_blender_scene(str(root), h=16, w=16, num_train=4)
    save = tmp_path_factory.mktemp("fn_models")
    logs = tmp_path_factory.mktemp("fn_logs")
    cfg_path = tmp_path_factory.mktemp("fn_cfg") / "cfg.txt"
    cfg_path.write_text(
        f"""
dataset_path = {root}
num_random_rays = 64
num_samples = 8
num_iters = 10
hidden_dim = 32
pos_encoding_dim = 2
dir_encoding_dim = 1
save_path = {save}
save_interval = 100
log_interval = 5
val_interval = 100
model_type = fastnerf
num_render_poses = 1
chunk_size = 128
log_dir = {logs}
"""
    )
    return str(cfg_path), str(save)


def test_eval_cli_bake_renders_mlp_free(trained_fastnerf, tmp_path):
    """--bake renders the orbit from the MLP-free FastNeRF cache (the
    paper's acceleration), through the same eval CLI."""
    cfg_path, save = trained_fastnerf
    train_main(["--config", cfg_path])
    out_dir = tmp_path / "baked_frames"
    eval_main(
        ["--config", cfg_path,
         "--checkpoint", os.path.join(save, "fastnerf_model_000010"),
         "--output", str(out_dir), "--bake", "16"]
    )
    frames = sorted(os.listdir(out_dir))
    assert frames == ["frame_0000.png"]
    from nerf_jax.utils.png import read_png

    img = read_png(str(out_dir / "frame_0000.png"))
    assert img.shape == (16, 16, 3)
