"""KiloNeRF teacher distillation (train/distill.py): field-space matching
pulls the student toward the teacher before photometric fine-tuning."""

import numpy as np
import jax
import jax.numpy as jnp

from nerf_jax.config import Config
from nerf_jax.models.kilonerf import KiloNeRFModel
from nerf_jax.models.nerf import NeRFModel
from nerf_jax.models.registry import grid_domain
from nerf_jax.train.distill import make_distill_step
from nerf_jax.train.optim import make_optimizer
from nerf_jax.train.state import TrainState
from tests.synthetic import make_synthetic_blender_scene


def _field_mse(student, s_params, teacher, t_params, domain, n=512):
    k1, k2 = jax.random.split(jax.random.key(7))
    pts = jax.random.uniform(k1, (n, 3), minval=domain[0], maxval=domain[1])
    d = jax.random.normal(k2, (n, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    t_rgb, t_sig = teacher.apply(t_params, pts, d)
    s_rgb, s_sig = student.apply(s_params, pts, d)
    return float(jnp.mean((s_rgb - t_rgb) ** 2)
                 + jnp.mean((s_sig - t_sig) ** 2))


def test_distill_step_reduces_field_error():
    domain = (-2.75, -1.25)
    teacher = NeRFModel(hidden_dim=32, pos_encoding_dim=2, dir_encoding_dim=1)
    t_params = teacher.init(jax.random.key(0))
    student = KiloNeRFModel(grid_res=2, hidden_dim=16, pos_encoding_dim=2,
                            dir_encoding_dim=1, domain=domain)
    params = student.init(jax.random.key(1))
    cfg = Config(learning_rate=2e-3)
    tx = make_optimizer(cfg)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       fine_params={}, opt_state=tx.init((params, {})))

    before = _field_mse(student, params, teacher, t_params, domain)
    step_n = make_distill_step(
        student.apply, teacher.apply, t_params, tx, batch_size=1024,
        base_key=jax.random.key(2), domain=domain, num_steps=60,
        donate=False,
    )
    state, metrics = step_n(state)
    after = _field_mse(student, state.params, teacher, t_params, domain)
    assert after < 0.5 * before, (before, after)
    # scan stacks per-step metrics; the loss trend is downward
    losses = np.asarray(metrics["loss"])
    assert losses[-1] < losses[0]


def test_fit_distills_then_finetunes(tmp_path):
    from nerf_jax.train.loop import fit

    root = tmp_path / "scene"
    make_synthetic_blender_scene(str(root), h=16, w=16, num_train=4)
    common = dict(
        dataset_path=str(root), num_random_rays=64, num_samples=4,
        hidden_dim=32, pos_encoding_dim=2, dir_encoding_dim=1,
        donate_state=False, log_interval=5,
        val_interval=100, save_interval=100,
        save_path=str(tmp_path / "models"), log_dir=str(tmp_path / "logs"),
    )
    # teacher: a small nerf
    fit(Config(model_type="nerf", **common), max_steps=6,
        enable_tensorboard=False)
    teacher_ckpt = str(tmp_path / "models" / "nerf_model_000006")

    cfg = Config(model_type="kilonerf", grid_res=2,
                 distill_from=teacher_ckpt, distill_steps=12,
                 distill_batch=256, **common)
    state = fit(cfg, max_steps=5, enable_tensorboard=False)
    # photometric fine-tune ran after distillation, from step 0
    assert int(state.step) == 5
    assert np.isfinite(float(jnp.sum(state.params["l1"]["w"])))
    # resume path ignores distillation (checkpoint already carries it)
    ckpt = str(tmp_path / "models" / "kilonerf_model_000005")
    state2 = fit(cfg, resume_path=ckpt, max_steps=8,
                 enable_tensorboard=False)
    assert int(state2.step) == 8
