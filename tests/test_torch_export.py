"""Exporting native checkpoints to the reference's .pth format
(utils/torch_export.py): key maps, transposition, weights_only loadability,
Adam-moment continuation, and the import->export round trip."""

import numpy as np
import jax
import pytest

torch = pytest.importorskip("torch")

from nerf_jax.config import Config
from nerf_jax.models.nerf import NeRFModel
from nerf_jax.models.siren import SirenModel
from nerf_jax.utils.torch_export import state_dict_from_params
from nerf_jax.utils.torch_import import (
    nerf_params_from_state_dict,
    siren_params_from_state_dict,
)


def _trees_allclose(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=0, atol=0)


def test_nerf_export_import_roundtrip():
    params = NeRFModel().init(jax.random.key(0))
    sd = {k: v.numpy() for k, v in
          state_dict_from_params("nerf", params).items()}
    _trees_allclose(nerf_params_from_state_dict(sd), params)


def test_siren_export_import_roundtrip():
    params = SirenModel().init(jax.random.key(1))
    sd = {k: v.numpy() for k, v in
          state_dict_from_params("siren", params).items()}
    _trees_allclose(siren_params_from_state_dict(sd), params)


def test_reference_key_layout():
    """Exported keys are exactly the reference NeRF module's state_dict keys
    (reference: nerf/models.py:25-57 — Sequential indices 0,2,4,... are the
    Linears between activations)."""
    params = NeRFModel(hidden_dim=32, pos_encoding_dim=2,
                       dir_encoding_dim=1).init(jax.random.key(2))
    sd = state_dict_from_params("nerf", params)
    expected = set()
    for blk in ("block1", "block2"):
        for i in (0, 2, 4, 6, 8):
            expected |= {f"{blk}.{i}.weight", f"{blk}.{i}.bias"}
    for i in (0, 2):
        expected |= {f"rgb_head.{i}.weight", f"rgb_head.{i}.bias"}
    assert set(sd) == expected
    # torch layout: (out, in) — block1.0 maps 63-d encoding -> hidden
    assert tuple(sd["block1.0.weight"].shape) == (32, 3 + 6 * 2)


def test_unknown_family_rejected():
    with pytest.raises(ValueError, match="cannot export"):
        state_dict_from_params("plenoxels", {})


def test_end_to_end_export(tmp_path):
    """Train a couple of steps, save natively, export to .pth, and verify
    everything the reference load paths touch: weights_only=True load,
    model_state_dict values, Adam moment continuation, and that real torch
    Adam/LambdaLR instances accept the exported state dicts and step."""
    from tests.synthetic import make_synthetic_blender_scene
    from nerf_jax.train.loop import fit
    from nerf_jax.utils.checkpoint import latest_checkpoint, load_checkpoint
    from nerf_jax.utils.torch_export import (_find_adam_state,
                                             export_torch_checkpoint)
    from nerf_jax.config import parse_config_file

    root = tmp_path / "scene"
    make_synthetic_blender_scene(str(root), h=16, w=16, num_train=2,
                                 num_val=1, num_test=1)
    cfg_path = tmp_path / "cfg.txt"
    cfg_path.write_text(
        f"dataset_path = {root}\nmodel_type = nerf\nhidden_dim = 32\n"
        "pos_encoding_dim = 2\ndir_encoding_dim = 1\nnum_samples = 4\n"
        "num_random_rays = 16\nval_interval = 1000\n"
        "save_interval = 1000\nlog_interval = 1000\n"
        f"save_path = {tmp_path / 'models'}\nlog_dir = {tmp_path / 'logs'}\n"
    )
    cfg = parse_config_file(str(cfg_path))
    fit(cfg, max_steps=3, enable_tensorboard=False)
    ckpt = latest_checkpoint(str(tmp_path / "models"))
    assert ckpt is not None

    pth = str(tmp_path / "nerf_model_000003.pth")
    out = export_torch_checkpoint(ckpt, cfg, pth)
    assert out == pth

    # the reference's exact load call (eval.py:108): weights_only=True
    loaded = torch.load(pth, map_location="cpu", weights_only=True)
    assert loaded["model_type"] == "nerf"
    assert loaded["step"] == 3

    # values match the native checkpoint (transposed weights)
    from nerf_jax.train.state import create_train_state

    _, _, template = create_train_state(cfg, jax.random.key(0))
    state = load_checkpoint(ckpt, template)
    w_native = np.asarray(state.params["block1"][0]["w"])
    w_torch = loaded["model_state_dict"]["block1.0.weight"].numpy()
    np.testing.assert_allclose(w_torch, w_native.T, rtol=0, atol=0)

    # Adam moments continue: exported exp_avg equals optax's mu
    adam = _find_adam_state(state.opt_state)
    mu_w = np.asarray(adam.mu[0]["block1"][0]["w"])
    exp_avg = loaded["optimizer_state_dict"]["state"][0]["exp_avg"].numpy()
    np.testing.assert_allclose(exp_avg, mu_w.T, rtol=0, atol=0)
    assert float(loaded["optimizer_state_dict"]["state"][0]["step"]) == 3.0

    # a real torch optimizer/scheduler pair accepts the exported dicts and
    # keeps stepping — the reference resume path (train.py:143-149)
    n = len(loaded["model_state_dict"])
    dummies = [torch.nn.Parameter(torch.zeros_like(v))
               for v in loaded["model_state_dict"].values()]
    opt = torch.optim.Adam(dummies, lr=cfg.learning_rate)
    opt.load_state_dict(loaded["optimizer_state_dict"])
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lr_lambda=lambda s: 1.0)
    sched.load_state_dict(loaded["scheduler_state_dict"])
    assert sched.last_epoch == 3
    for p in dummies:
        p.grad = torch.zeros_like(p)
    opt.step()
    sched.step()
    assert n == 24  # 2 blocks x 5 linears + 2 rgb linears, w+b each
