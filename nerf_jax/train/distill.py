"""Teacher distillation — the KiloNeRF paper's training procedure.

KiloNeRF (Reiser et al. 2021, sec. 4.1) does not train its thousands of
tiny MLPs from photometric loss alone: a single pretrained NeRF teacher
supervises the student FIELD directly — random points and directions are
drawn over the scene volume, and the student regresses the teacher's
(rgb, sigma) — after which photometric fine-tuning proceeds as usual.
Field-space supervision gives every expert dense, voxel-local gradients
from step one, instead of waiting for rays to happen to cross its voxel.

Shape: one distillation step is a single jitted program — PRNG point
generation, teacher forward, student forward, MSE, backward — scan-chunked
like the photometric trainer (train/step.py) so dispatch overhead
amortizes. The teacher's params are closure constants (never
differentiated), so XLA folds the teacher into a pure forward chain.

Deviation from the paper, documented: the paper matches PRE-activation
sigma; here both fields are matched post-activation through the shared
``apply(params, points, dirs) -> (rgb, sigma)`` contract, which keeps the
distiller model-agnostic (any registry family can teach any other).

Config surface: ``distill_from`` (teacher checkpoint), ``distill_steps``,
``distill_batch``; ``fit()`` runs distillation before the photometric
loop on fresh (non-resume) runs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import optax

from nerf_jax.train.state import TrainState

# distillation draws from a key stream disjoint from the photometric
# trainer's fold_in(base_key, step) stream
_DISTILL_SALT = 0x1D157111


def make_distill_step(
    student_apply,
    teacher_apply,
    teacher_params,
    tx,
    batch_size: int,
    base_key: jax.Array,
    domain: tuple,
    num_steps: int,
    data_sharding=None,
    donate: bool = True,
):
    """``step_n(state) -> (state, metrics)`` running ``num_steps``
    field-matching iterations in one compiled scan. Points are uniform
    over the ``domain`` cube (the scene volume in the model's input
    space — registry.py::grid_domain), directions uniform on the sphere."""
    lo, hi = float(domain[0]), float(domain[1])
    k_base = jax.random.fold_in(base_key, _DISTILL_SALT)

    def loss_fn(param_pair, key):
        params, fine_params = param_pair
        del fine_params  # distillation trains the coarse field
        kp, kd = jax.random.split(key)
        pts = jax.random.uniform(kp, (batch_size, 3), minval=lo, maxval=hi)
        d = jax.random.normal(kd, (batch_size, 3))
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        if data_sharding is not None:
            pts = jax.lax.with_sharding_constraint(pts, data_sharding)
            d = jax.lax.with_sharding_constraint(d, data_sharding)
        t_rgb, t_sigma = teacher_apply(teacher_params, pts, d)
        s_rgb, s_sigma = student_apply(params, pts, d)
        rgb_mse = jnp.mean((s_rgb - jax.lax.stop_gradient(t_rgb)) ** 2)
        sigma_mse = jnp.mean(
            (s_sigma - jax.lax.stop_gradient(t_sigma)) ** 2)
        return rgb_mse + sigma_mse, (rgb_mse, sigma_mse)

    def one_step(state: TrainState, _):
        key = jax.random.fold_in(k_base, state.step)
        (loss, (rgb_mse, sigma_mse)), grads = jax.value_and_grad(
            loss_fn, has_aux=True
        )((state.params, state.fine_params), key)
        updates, opt_state = tx.update(
            grads, state.opt_state, (state.params, state.fine_params)
        )
        params, fine_params = optax.apply_updates(
            (state.params, state.fine_params), updates
        )
        new_state = TrainState(
            step=state.step + 1,
            params=params,
            fine_params=fine_params,
            opt_state=opt_state,
        )
        return new_state, {"loss": loss, "rgb_mse": rgb_mse,
                           "sigma_mse": sigma_mse}

    def step_n(state: TrainState):
        return jax.lax.scan(one_step, state, None, length=num_steps)

    return jax.jit(step_n, donate_argnums=(0,) if donate else ())


def load_teacher(cfg, ckpt_path: str):
    """Build the teacher from its checkpoint's self-describing metadata
    (model_type, grid_res) over the SAME config — the usual KiloNeRF
    workflow trains teacher and student from one config file, varying
    only model_type. Returns (apply_fn, params)."""
    from nerf_jax.train.state import create_train_state
    from nerf_jax.utils.checkpoint import load_checkpoint, read_metadata

    meta = read_metadata(ckpt_path)
    tcfg = dataclasses.replace(
        cfg,
        model_type=meta.get("model_type", cfg.model_type).lower(),
        grid_res=int(meta.get("grid_res", cfg.grid_res)),
    )
    teacher, _, tstate = create_train_state(tcfg, jax.random.key(tcfg.seed))
    tstate = load_checkpoint(ckpt_path, tstate)
    return teacher.apply, tstate.params


def run_distillation(
    cfg,
    model,
    tx,
    state: TrainState,
    base_key: jax.Array,
    data_sharding=None,
    primary: bool = True,
    log=print,
) -> TrainState:
    """Distill ``cfg.distill_from`` into ``state`` for
    ``cfg.distill_steps`` steps, then hand back a state ready for the
    photometric loop: step reset to 0 and optimizer moments restarted
    (the fine-tune phase is a fresh optimization problem)."""
    from nerf_jax.models.registry import grid_domain

    teacher_apply, teacher_params = load_teacher(cfg, cfg.distill_from)
    student_apply = model.apply
    domain = grid_domain(cfg)

    total = int(cfg.distill_steps)
    chunk = min(total, 100)  # same scan-length cap as fit()
    step_fns = {}
    done = 0
    while done < total:
        c = min(chunk, total - done)
        if c not in step_fns:
            step_fns[c] = make_distill_step(
                student_apply, teacher_apply, teacher_params, tx,
                cfg.distill_batch, base_key, domain, c,
                data_sharding=data_sharding, donate=cfg.donate_state,
            )
        state, metrics = step_fns[c](state)
        done += c
        if primary:
            log(
                f"[Distill] {done}/{total}  "
                f"loss: {float(metrics['loss'][-1]):.6f}  "
                f"(rgb {float(metrics['rgb_mse'][-1]):.6f}, "
                f"sigma {float(metrics['sigma_mse'][-1]):.4f})"
            )
    return TrainState(
        step=jnp.zeros((), jnp.int32),
        params=state.params,
        fine_params=state.fine_params,
        opt_state=tx.init((state.params, state.fine_params)),
    )
