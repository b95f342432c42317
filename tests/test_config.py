"""Config parsing: drop-in compatibility with the reference key=value format
(utils.py:9-34) including the reference's own config_lego.txt keys."""

import numpy as np

from nerf_jax.config import Config, config_from_dict, parse_config_file, parse_kv_file


def test_parse_kv_format(tmp_path):
    p = tmp_path / "cfg.txt"
    p.write_text(
        """
# full-line comment
dataset_path = ./datasets/lego     # inline comment
num_random_rays = 1024
learning_rate = 5e-4
first_step_render = false
model_type = siren
not_a_kv_line
empty_after_comment = # nothing
"""
    )
    d = parse_kv_file(str(p))
    assert d["dataset_path"] == "./datasets/lego"
    assert d["num_random_rays"] == "1024"
    assert d["learning_rate"] == "5e-4"
    assert d["model_type"] == "siren"
    assert "not_a_kv_line" not in d


def test_reference_lego_keys_roundtrip(tmp_path):
    """Every key in the reference's config_lego.txt must be understood."""
    ref_keys = {
        "dataset_path": "./datasets/lego",
        "num_random_rays": "1024",
        "chunk_size": "1024",
        "num_samples": "256",
        "num_iters": "300000",
        "learning_rate": "5e-4",
        "near": "2.0",
        "far": "6.0",
        "save_path": "./models/siren",
        "save_interval": "5000",
        "lr_decay": "300",
        "lr_decay_factor": "0.1",
        "lr_min": "1e-4",
        "log_interval": "50",
        "val_interval": "5000",
        "first_step_render": "false",
        "model_type": "siren",
        "num_render_poses": "80",
    }
    cfg = config_from_dict(ref_keys)
    assert cfg.num_random_rays == 1024
    assert cfg.num_iters == 300000
    assert cfg.learning_rate == 5e-4
    assert cfg.model_type == "siren"
    assert cfg.first_step_render is False
    assert cfg.lr_min == 1e-4
    assert cfg.num_render_poses == 80


def test_lr_gamma_matches_reference_formula():
    cfg = Config(lr_decay=300, lr_decay_factor=0.1)
    assert abs(cfg.lr_schedule_gamma - 0.1 ** (1 / 300000)) < 1e-12


def test_unknown_key_warns_not_raises(capsys):
    cfg = config_from_dict({"bogus_key": "1", "near": "3.5"})
    assert cfg.near == 3.5
    assert "Unknown config key" in capsys.readouterr().err


def test_model_type_lowercased():
    assert config_from_dict({"model_type": "NeRF"}).model_type == "nerf"
