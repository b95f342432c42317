"""Importing the reference's PyTorch checkpoints
(utils/torch_import.py): key maps, transposition, and the end-to-end
.pth -> native checkpoint -> eval path."""

import os

import numpy as np
import jax
import pytest

torch = pytest.importorskip("torch")

from nerf_jax.config import Config
from nerf_jax.models.nerf import NeRFModel
from nerf_jax.models.siren import SirenModel
from nerf_jax.utils.torch_import import (
    nerf_params_from_state_dict,
    params_from_state_dict,
    siren_params_from_state_dict,
)


def _to_sd_nerf(params):
    """Our NeRF pytree -> a reference-keyed torch state_dict
    (reference module layout: nerf/models.py:25-57)."""
    sd = {}
    for blk, idxs in (("block1", (0, 2, 4, 6, 8)), ("block2", (0, 2, 4, 6, 8))):
        for lyr, i in zip(params[blk], idxs):
            sd[f"{blk}.{i}.weight"] = torch.tensor(np.asarray(lyr["w"]).T)
            sd[f"{blk}.{i}.bias"] = torch.tensor(np.asarray(lyr["b"]))
    for lyr, i in zip(params["rgb"], (0, 2)):
        sd[f"rgb_head.{i}.weight"] = torch.tensor(np.asarray(lyr["w"]).T)
        sd[f"rgb_head.{i}.bias"] = torch.tensor(np.asarray(lyr["b"]))
    return sd


def _to_sd_siren(params):
    sd = {}
    for i, lyr in enumerate(params["base"]):
        sd[f"block1.{i}.layer.weight"] = torch.tensor(np.asarray(lyr["w"]).T)
        sd[f"block1.{i}.layer.bias"] = torch.tensor(np.asarray(lyr["b"]))
    for prefix, lyr in (("density_branch.0", params["sigma"]),
                        ("feature_remap.0", params["remap"]),
                        ("rgb_head.0.layer", params["rgb0"]),
                        ("rgb_head.1", params["rgb1"])):
        sd[f"{prefix}.weight"] = torch.tensor(np.asarray(lyr["w"]).T)
        sd[f"{prefix}.bias"] = torch.tensor(np.asarray(lyr["b"]))
    return sd


def _trees_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_nerf_state_dict_roundtrip():
    params = NeRFModel().init(jax.random.key(0))
    sd = {k: v.numpy() for k, v in _to_sd_nerf(params).items()}
    _trees_equal(nerf_params_from_state_dict(sd), params)


def test_siren_state_dict_roundtrip():
    params = SirenModel().init(jax.random.key(1))
    sd = {k: v.numpy() for k, v in _to_sd_siren(params).items()}
    _trees_equal(siren_params_from_state_dict(sd), params)


def test_unknown_family_rejected():
    with pytest.raises(ValueError, match="cannot import"):
        params_from_state_dict("plenoxels", {})


def test_end_to_end_pth_to_eval(tmp_path):
    """torch.save a reference-format checkpoint, import it, and render
    through the real eval CLI."""
    from nerf_jax.cli.eval_cli import main as eval_main
    from nerf_jax.utils.torch_import import import_torch_checkpoint
    from tests.synthetic import make_synthetic_blender_scene

    root = tmp_path / "scene"
    make_synthetic_blender_scene(str(root), h=16, w=16, num_train=2,
                                 num_val=1, num_test=1)
    model = NeRFModel(hidden_dim=32, pos_encoding_dim=2, dir_encoding_dim=1)
    params = model.init(jax.random.key(2))
    pth = tmp_path / "nerf_model_000007.pth"
    torch.save(
        {"step": 7, "model_type": "nerf",
         "model_state_dict": _to_sd_nerf(params),
         "optimizer_state_dict": {}, "scheduler_state_dict": {}},
        pth,
    )
    cfg_path = tmp_path / "cfg.txt"
    cfg_path.write_text(
        f"dataset_path = {root}\nmodel_type = nerf\nhidden_dim = 32\n"
        "pos_encoding_dim = 2\ndir_encoding_dim = 1\nnum_samples = 4\n"
        "num_render_poses = 1\n"
        f"log_dir = {tmp_path / 'logs'}\n"
    )
    from nerf_jax.config import parse_config_file

    cfg = parse_config_file(str(cfg_path))
    out_ckpt = import_torch_checkpoint(str(pth), cfg, str(tmp_path / "m"))
    assert out_ckpt.endswith("nerf_model_000007")

    # the imported run CONTINUES at step 7: TrainState.step and the
    # optimizer's count leaves carry it, so --resume fine-tunes at the
    # decayed LR instead of re-applying lr(0) to converged weights
    from nerf_jax.train.state import create_train_state
    from nerf_jax.utils.checkpoint import load_checkpoint

    _, _, fresh = create_train_state(cfg, jax.random.key(0))
    restored = load_checkpoint(out_ckpt, fresh)
    assert int(restored.step) == 7
    counts = [int(x) for x in jax.tree.leaves(restored.opt_state)
              if hasattr(x, "dtype") and x.dtype == np.int32 and x.ndim == 0]
    assert counts and all(c == 7 for c in counts), counts

    # shape mismatch is a clear error, not a silent mis-load
    bad = Config(model_type="nerf", hidden_dim=64, pos_encoding_dim=2,
                 dir_encoding_dim=1)
    with pytest.raises(ValueError, match="do not match"):
        import_torch_checkpoint(str(pth), bad, str(tmp_path / "m2"))

    out_dir = tmp_path / "frames"
    eval_main(["--config", str(cfg_path), "--checkpoint", out_ckpt,
               "--output", str(out_dir)])
    assert sorted(os.listdir(out_dir)) == ["frame_0000.png"]
