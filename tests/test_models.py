"""Model golden tests: shapes, param counts, init laws (SIREN std per
models.py:117-122), and numpy cross-checks of the forward math."""

import numpy as np
import jax
import jax.numpy as jnp

from nerf_jax.models import NeRFModel, SirenModel, create_model
from nerf_jax.models.common import param_count
from tests.test_encoding import reference_encoding_numpy


def test_nerf_param_shapes():
    model = NeRFModel()
    params = model.init(jax.random.key(0))
    assert [p["w"].shape for p in params["block1"]] == [
        (63, 256), (256, 256), (256, 256), (256, 256), (256, 256)]
    assert [p["w"].shape for p in params["block2"]] == [
        (319, 256), (256, 256), (256, 256), (256, 256), (256, 257)]
    assert [p["w"].shape for p in params["rgb"]] == [(283, 128), (128, 3)]
    # Reference NeRF has ~661k params (SURVEY.md §3.5).
    n = param_count(params)
    assert 600_000 < n < 700_000


def test_siren_param_shapes():
    model = SirenModel()
    params = model.init(jax.random.key(0))
    assert params["base"][0]["w"].shape == (3, 256)
    assert len(params["base"]) == 8
    assert params["sigma"]["w"].shape == (256, 1)
    assert params["remap"]["w"].shape == (256, 256)
    assert params["rgb0"]["w"].shape == (283, 128)
    assert params["rgb1"]["w"].shape == (128, 3)


def test_siren_init_law():
    model = SirenModel()
    params = model.init(jax.random.key(7))
    # first layer: U(-1/3, 1/3); hidden: U(-sqrt(6/256)/1, ...)
    w0 = np.asarray(params["base"][0]["w"])
    assert np.abs(w0).max() <= 1 / 3 + 1e-6
    assert np.abs(w0).max() > 0.8 * (1 / 3)  # uniform actually fills the range
    wh = np.asarray(params["base"][1]["w"])
    bound = np.sqrt(6 / 256) / 1.0
    assert np.abs(wh).max() <= bound + 1e-6
    assert np.abs(wh).max() > 0.8 * bound
    bh = np.asarray(params["base"][1]["b"])
    assert np.abs(bh).max() <= bound + 1e-6


def test_linear_init_law():
    model = NeRFModel()
    params = model.init(jax.random.key(3))
    w = np.asarray(params["block1"][1]["w"])  # fan_in 256
    bound = 1 / np.sqrt(256)
    assert np.abs(w).max() <= bound + 1e-6
    assert np.abs(w).max() > 0.8 * bound


def _np_relu(x):
    return np.maximum(x, 0.0)


def _np_sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def nerf_forward_numpy(params, points, dirs):
    """Independent float64 re-derivation of the reference forward
    (models.py:62-73) for cross-checking."""
    p = {k: [{kk: np.asarray(vv, np.float64) for kk, vv in lyr.items()}
             for lyr in v] for k, v in params.items()}
    pe = reference_encoding_numpy(points, 10)
    de = reference_encoding_numpy(dirs, 4)
    x = pe
    for lyr in p["block1"]:
        x = _np_relu(x @ lyr["w"] + lyr["b"])
    x = np.concatenate([x, pe], axis=-1)
    for lyr in p["block2"][:-1]:
        x = _np_relu(x @ lyr["w"] + lyr["b"])
    x = x @ p["block2"][-1]["w"] + p["block2"][-1]["b"]
    sigma = _np_relu(x[:, -1])
    feat = x[:, :-1]
    y = np.concatenate([feat, de], axis=-1)
    y = _np_relu(y @ p["rgb"][0]["w"] + p["rgb"][0]["b"])
    rgb = _np_sigmoid(y @ p["rgb"][1]["w"] + p["rgb"][1]["b"])
    return rgb, sigma


def test_nerf_forward_matches_numpy():
    model = NeRFModel()
    params = model.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, size=(33, 3)).astype(np.float32)
    dirs = rng.normal(size=(33, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rgb, sigma = model.apply(params, jnp.asarray(pts), jnp.asarray(dirs))
    want_rgb, want_sigma = nerf_forward_numpy(params, pts, dirs)
    np.testing.assert_allclose(np.asarray(rgb), want_rgb, atol=2e-5)
    np.testing.assert_allclose(np.asarray(sigma), want_sigma, atol=2e-4)


def siren_forward_numpy(model, params, points, dirs):
    g = lambda d: {k: np.asarray(v, np.float64) for k, v in d.items()}
    x = np.asarray(points, np.float64)
    w0s = [model.w0] + [model.hidden_w0] * (model.num_layers - 1)
    for lyr, w0 in zip(params["base"], w0s):
        lyr = g(lyr)
        x = np.sin(w0 * (x @ lyr["w"] + lyr["b"]))
    s = g(params["sigma"])
    sigma = _np_relu(x @ s["w"] + s["b"]) * model.sigma_mul
    r = g(params["remap"])
    feat = x @ r["w"] + r["b"]
    de = reference_encoding_numpy(np.asarray(dirs, np.float64), 4)
    y = np.concatenate([feat, de], axis=-1)
    r0, r1 = g(params["rgb0"]), g(params["rgb1"])
    y = np.sin(model.hidden_w0 * (y @ r0["w"] + r0["b"]))
    rgb = _np_sigmoid((y @ r1["w"] + r1["b"]) * model.rgb_mul)
    return rgb, sigma[:, 0]


def test_siren_forward_matches_numpy():
    model = SirenModel()
    params = model.init(jax.random.key(1))
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1, 1, size=(21, 3)).astype(np.float32)
    dirs = rng.normal(size=(21, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rgb, sigma = model.apply(params, jnp.asarray(pts), jnp.asarray(dirs))
    want_rgb, want_sigma = siren_forward_numpy(model, params, pts, dirs)
    np.testing.assert_allclose(np.asarray(rgb), want_rgb, atol=2e-5)
    np.testing.assert_allclose(np.asarray(sigma), want_sigma, atol=2e-4)


def test_reference_init_keeps_raw_torch_draw():
    """reference_init=True skips the deterministic density-bias guard so the
    fresh-init distribution matches torch's Linear law exactly."""
    from nerf_jax.config import Config
    from nerf_jax.models.registry import model_from_config

    guarded = NeRFModel().init(jax.random.key(0))
    assert float(guarded["block2"][-1]["b"][-1]) == 0.5
    raw = NeRFModel(reference_init=True).init(jax.random.key(0))
    b = float(raw["block2"][-1]["b"][-1])
    assert b != 0.5 and abs(b) <= 1 / np.sqrt(256) + 1e-6
    # everything except the guarded element is identical
    np.testing.assert_array_equal(
        np.asarray(raw["block2"][-1]["b"][:-1]),
        np.asarray(guarded["block2"][-1]["b"][:-1]),
    )

    s = SirenModel(reference_init=True).init(jax.random.key(0))
    assert float(s["sigma"]["b"][0]) != 0.5

    cfg = Config(reference_init=True, model_type="nerf")
    assert model_from_config(cfg).reference_init is True


def test_registry():
    assert create_model("NeRF").name == "nerf"
    assert create_model("siren").name == "siren"
    assert create_model("gabor").name == "gabor"
    import pytest

    with pytest.raises(ValueError, match="Invalid model type"):
        create_model("mipnerf360")


class TestGaborModel:
    """MFN-Gabor field (reference roadmap, notes.txt:3); its field contract
    is a case of tests/test_families.py."""

    def test_registry_and_train_step(self):
        from nerf_jax.config import Config
        from nerf_jax.models.registry import model_from_config
        from nerf_jax.render.renderer import RenderSettings
        from nerf_jax.train.optim import make_optimizer
        from nerf_jax.train.state import TrainState
        from nerf_jax.train.step import make_train_step
        from nerf_jax.data.pipeline import RayPool

        cfg = Config(model_type="gabor", hidden_dim=64)
        model = model_from_config(cfg)
        assert model.name == "gabor"
        tx = make_optimizer(cfg)
        params = model.init(jax.random.key(0))
        state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           fine_params={}, opt_state=tx.init((params, {})))
        k = jax.random.key(1)
        rd = jax.random.normal(k, (512, 3))
        rd = rd / jnp.linalg.norm(rd, axis=-1, keepdims=True)
        pool = RayPool(rays_o=jax.random.normal(k, (512, 3)) * 0.1, rays_d=rd,
                       rgb=jax.random.uniform(k, (512, 3)), viewdirs=rd)
        settings = RenderSettings(near=2.0, far=6.0, num_samples=8)
        step = make_train_step(model, tx, settings, 64, jax.random.key(2),
                               donate=False)
        losses = []
        for _ in range(30):
            state, m = step(state, pool)
            losses.append(float(m["mse"]))
        assert np.isfinite(losses).all()
        assert losses[-1] < losses[0]
