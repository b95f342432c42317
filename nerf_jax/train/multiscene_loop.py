"""Multi-scene training driver: N scenes trained concurrently on one mesh
(BASELINE.json config 5). Builds on `nerf_jax.parallel.multiscene`: per-scene
params stacked on a ``scene`` mesh axis, rays sharded on ``data``, one
vmapped jitted step for all scenes.

Driver parity with the single-scene ``fit()`` (same observable trainer
behaviors as the reference, /root/reference/train.py:20-263, per scene):
scan-chunked dispatch between host touchpoints, resume from a stacked
checkpoint (bit-identical continuation — randomness keys off state.step),
scheduled-LR logging, per-scene validation renders (one vmapped full-image
render across all scenes), async interval checkpoints, SIGINT/final saves,
process-0-gated console/TB output, and ``multihost=true`` via
jax.distributed with globally sharded pools/state.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from nerf_jax.config import Config
from nerf_jax.data.pipeline import load_scene
from nerf_jax.data.rays import compute_rays
from nerf_jax.parallel.mesh import create_mesh
from nerf_jax.parallel.multiscene import make_multiscene_train_step, stack_scenes
from nerf_jax.train.loop import (
    make_regularizer,
    print_config_summary,
    render_settings_from_config,
)
from nerf_jax.train.optim import lr_schedule, make_optimizer
from nerf_jax.train.state import TrainState
from nerf_jax.models.registry import model_from_config
from nerf_jax.utils.checkpoint import (
    AsyncCheckpointSaver,
    load_checkpoint,
    read_metadata,
    save_checkpoint,
)
from nerf_jax.utils.logging import MetricLogger
from nerf_jax.utils.metrics import mse_to_psnr
from nerf_jax.utils.timer import format_elapsed_time


def _make_val_render(model, settings):
    """One jitted, vmapped full-image renderer for ALL scenes at once:
    ``render(params, fine_params, rays_o (S,N,3), rays_d, keys (S,)) ->
    rgb (S,N,3)``."""
    from nerf_jax.render.renderer import render_image

    def render_one(params, fine_params, rays_o, rays_d, key):
        out = render_image(
            model.apply, params, rays_o, rays_d, key, settings,
            fine_params=fine_params if fine_params else None,
        )
        return out.rgb

    @jax.jit
    def render_all(params, fine_params, rays_o, rays_d, keys):
        return jax.vmap(render_one)(params, fine_params, rays_o, rays_d, keys)

    return render_all


def fit_multiscene(
    cfg: Config,
    dataset_paths: Sequence[str],
    resume_path: Optional[str] = None,
    max_steps: Optional[int] = None,
    enable_tensorboard: bool = True,
) -> TrainState:
    """Train one model per scene concurrently. ``cfg`` supplies the shared
    schedule/model; ``dataset_paths`` the scenes. The mesh comes from
    ``cfg.mesh_shape`` (e.g. "scene:2,data:4") or defaults to all devices on
    'data' with the scene axis vmapped but unsharded."""
    if cfg.multihost:
        from nerf_jax.parallel.multihost import init_distributed

        init_distributed()
    from nerf_jax.parallel.multihost import is_primary

    primary = is_primary()
    np.random.seed(cfg.seed)
    if cfg.debug_nans:
        jax.config.update("jax_debug_nans", True)
    key = jax.random.key(cfg.seed)
    k_init, k_train, k_val = jax.random.split(key, 3)
    num_scenes = len(dataset_paths)
    num_iters = int(max_steps if max_steps is not None else cfg.num_iters)

    if primary:
        print_config_summary(cfg)
        print(f"Multi-scene training over {num_scenes} scenes: "
              f"{list(dataset_paths)}")

    mesh_spec = cfg.mesh_shape
    if not mesh_spec:
        n = jax.device_count()
        if n % num_scenes == 0 and n >= num_scenes:
            mesh_spec = f"scene:{num_scenes},data:{n // num_scenes}"
        else:
            mesh_spec = f"scene:1,data:{n}"
    mesh = create_mesh(mesh_spec)
    if "scene" in mesh.axis_names and num_scenes % mesh.shape["scene"]:
        raise ValueError(
            f"{num_scenes} scenes do not shard over mesh scene axis of "
            f"size {mesh.shape['scene']} (mesh {mesh_spec!r})"
        )
    if primary:
        print(f"Mesh: {dict(zip(mesh.axis_names, mesh.devices.shape))}")

    # --- data: every process loads every scene host-side (identical
    # values), then ONE global device_put shards (scene, data) ---
    scenes = []
    for path in dataset_paths:
        scenes.append(load_scene(dataclasses.replace(cfg, dataset_path=path)))
    sizes = {s.pool.size for s in scenes}
    if len(sizes) > 1:
        # stack_scenes needs equal pools; trim to the smallest (uniform
        # with-replacement sampling is unaffected by dropping the tail)
        m = min(sizes)
        for i, s in enumerate(scenes):
            scenes[i] = dataclasses.replace(
                s, pool=jax.tree.map(lambda x: x[:m], s.pool)
            )
    hws = {s.hw for s in scenes}
    if len(hws) > 1:
        raise ValueError(
            f"multi-scene training stacks validation renders; all scenes "
            f"must share one image resolution, got {sorted(hws)}"
        )
    n_data = mesh.shape.get("data", 1)

    def _pad_rows(x):
        # wrap-pad to the data axis (duplicates are harmless for uniform
        # with-replacement sampling — same contract as mesh.shard_pool).
        # Host-side: the global device_put below is the pools' ONE placement
        # (a committed single-device array cannot be re-put onto a sharding
        # spanning other processes' devices under multihost).
        x = np.asarray(x)
        rem = (-x.shape[0]) % n_data
        return np.concatenate([x, x[:rem]], axis=0) if rem else x

    pools = jax.tree.map(
        lambda *xs: jax.device_put(
            np.stack(xs, axis=0), NamedSharding(mesh, P("scene", "data"))
        ),
        *[jax.tree.map(_pad_rows, s.pool) for s in scenes],
    )

    cfg = dataclasses.replace(cfg, near=float(scenes[0].near),
                              far=float(scenes[0].far))
    settings = render_settings_from_config(cfg, ndc=scenes[0].ndc)
    settings = dataclasses.replace(
        settings, white_background=scenes[0].white_background,
    )
    if primary:
        print(f"Loaded {num_scenes} scenes x {scenes[0].pool.size} train "
              f"rays each, {scenes[0].hw[0]}x{scenes[0].hw[1]}")

    # --- model / stacked state ---
    model = model_from_config(cfg)
    tx = make_optimizer(cfg)
    params = stack_scenes(
        [model.init(jax.random.fold_in(k_init, i)) for i in range(num_scenes)]
    )
    if cfg.num_fine_samples > 0 and cfg.separate_fine_model:
        fine_params = stack_scenes(
            [model.init(jax.random.fold_in(k_init, 1000 + i))
             for i in range(num_scenes)]
        )
    else:
        fine_params = {}
    state = TrainState(
        step=jnp.zeros((), jnp.int32),
        params=params,
        fine_params=fine_params,
        opt_state=tx.init((params, fine_params)),
    )

    def _place_state(st):
        # scene-stacked leaves shard on the scene axis; scalars (step,
        # optax counts) replicate. Valid globally: every process built the
        # identical host value.
        def put(x):
            stacked = getattr(x, "ndim", 0) >= 1 and x.shape[0] == num_scenes
            spec = P("scene") if stacked else P()
            return jax.device_put(x, NamedSharding(mesh, spec))

        return jax.tree.map(put, st)

    state = _place_state(state)
    start_step = 0
    ckpt_name = f"{cfg.model_type}_multiscene"
    if resume_path is not None:
        meta = read_metadata(resume_path)
        if int(meta.get("num_scenes", num_scenes)) != num_scenes:
            raise ValueError(
                f"checkpoint trained {meta['num_scenes']} scenes, "
                f"got {num_scenes} dataset paths"
            )
        state = load_checkpoint(resume_path, state)
        start_step = int(meta["step"])
        if primary:
            print(f"Resuming multi-scene training from iteration {start_step}")

    step_builder_kwargs = dict(
        donate=cfg.donate_state,
        regularizer=make_regularizer(cfg, model),
    )
    _step_fns: dict[int, object] = {}

    def get_step_fn(c: int):
        if c not in _step_fns:
            _step_fns[c] = make_multiscene_train_step(
                model, tx, settings, cfg.num_random_rays, k_train, mesh,
                num_steps=c, **step_builder_kwargs,
            )
        return _step_fns[c]

    # Scan-chunked stepping (same contract as fit(): chunks end exactly at
    # event steps; randomness keys off state.step so chunking is
    # bit-neutral; auto chunks cap at 100 — see train/loop.py).
    max_chunk = cfg.steps_per_call
    if max_chunk <= 0:
        import math

        max_chunk = math.gcd(
            math.gcd(cfg.log_interval, cfg.val_interval), cfg.save_interval
        )
        max_chunk = min(max_chunk, 100)

    def next_event(i: int) -> int:
        def next_mult(j: int, k: int) -> int:
            return ((j + k - 1) // k) * k

        candidates = [next_mult(i, cfg.log_interval)]
        s = next_mult(max(i, cfg.save_interval), cfg.save_interval)
        if 0 < s < num_iters - 1:
            candidates.append(s)
        v = next_mult(i, cfg.val_interval)
        if v == 0 and not cfg.first_step_render:
            v = cfg.val_interval
        candidates.append(v)
        return min(candidates)

    schedule = lr_schedule(
        cfg.learning_rate, cfg.lr_decay, cfg.lr_decay_factor, cfg.lr_min
    )
    meta_extra = {"num_scenes": num_scenes,
                  "scenes": [s.name for s in scenes],
                  "base_model_type": cfg.model_type}

    # --- per-scene validation: one vmapped render across scenes ---
    val_render = _make_val_render(model, settings)

    def run_validation(step: int) -> None:
        ro_s, rd_s, imgs = [], [], []
        for s in scenes:
            idx = np.random.randint(s.val_images.shape[0])
            img = s.val_images[idx]
            c2w = np.eye(4, dtype=np.float32)
            c2w[: s.val_c2w.shape[1]] = s.val_c2w[idx]
            ro, rd, _ = compute_rays(img[None], c2w[None], s.focal)
            ro, rd = ro[0].reshape(-1, 3), rd[0].reshape(-1, 3)
            if s.ndc:
                from nerf_jax.ops.ndc import ndc_rays

                h, w = s.hw
                ro, rd = ndc_rays(h, w, s.focal, 1.0, jnp.asarray(ro),
                                  jnp.asarray(rd))
            ro_s.append(np.asarray(ro))
            rd_s.append(np.asarray(rd))
            imgs.append(img)
        # host values / local key arrays go straight into the jit — GSPMD
        # replicates them (an explicit device_put onto the global mesh
        # would reject committed local arrays under multihost)
        rays_o, rays_d = np.stack(ro_s), np.stack(rd_s)
        keys = jax.random.split(jax.random.fold_in(k_val, step), num_scenes)
        rgb = val_render(state.params, state.fine_params, rays_o, rays_d,
                         keys)
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils

            rgb = multihost_utils.process_allgather(rgb, tiled=True)
        rgb = np.asarray(rgb)
        psnrs = []
        for i, img in enumerate(imgs):
            pred = rgb[i].reshape(*scenes[i].hw, 3)
            psnr = float(mse_to_psnr(float(np.mean((pred - img) ** 2))))
            psnrs.append(psnr)
            logger.log_scalar(f"scene{i}/val_psnr", psnr, step)
            logger.log_image(f"scene{i}/val_render", pred, step)
        logger.log_scalar("val/psnr", float(np.mean(psnrs)), step)

    os.makedirs(cfg.save_path, exist_ok=True)
    saver = AsyncCheckpointSaver()
    logger = MetricLogger(
        log_dir=cfg.log_dir,
        model_type=f"{cfg.model_type}_x{num_scenes}",
        dataset_name="multiscene",
        config_text=str(cfg),
        enable_tensorboard=enable_tensorboard,
        quiet=not primary,
    )
    start_time = datetime.datetime.now()

    from nerf_jax.utils.profiling import Throughput

    throughput = Throughput(warmup=2)
    step = start_step
    try:
        pos = start_step
        while pos < num_iters:
            ev = next_event(pos)
            boundary = min(ev + 1, num_iters)
            c = min(max_chunk, boundary - pos)

            state, metrics = get_step_fn(c)(state, pools)
            step = pos + c - 1
            throughput.update(c * cfg.num_random_rays * num_scenes)
            if c > 1:  # scan stacks metrics (c, S); take the final step
                metrics = jax.tree.map(lambda x: x[-1], metrics)

            if step % cfg.log_interval == 0:
                mses = np.asarray(metrics["mse"])
                logger.log_train(step, float(schedule(jnp.asarray(step))),
                                 float(mses.mean()))
                logger.log_scalar("rays_per_sec",
                                  throughput.rays_per_sec, step)
                for i, m in enumerate(mses):
                    logger.log_scalar(f"scene{i}/mse", float(m), step)

            if step % cfg.save_interval == 0 and 0 < step < num_iters - 1:
                with throughput.exclude():
                    path = saver.save(state, cfg.save_path, ckpt_name,
                                      step, extra=meta_extra)
                if primary:
                    print(
                        f"[{format_elapsed_time(start_time)}] Model saved "
                        f"to {path} at iteration {step}"
                    )

            if step % cfg.val_interval == 0 and (
                    step > 0 or cfg.first_step_render):
                with throughput.exclude():
                    run_validation(step)

            pos += c

        saver.wait()
        final = save_checkpoint(state, cfg.save_path, ckpt_name, num_iters,
                                extra=meta_extra)
        elapsed = format_elapsed_time(start_time)
        if primary:
            print(f"[{elapsed}] Multi-scene training complete!")
            print(f"[{elapsed}] Final model saved to {final}")
    except KeyboardInterrupt:
        elapsed = format_elapsed_time(start_time)
        if primary:
            print(f"\n[{elapsed}] Keyboard interrupt! Saving current "
                  "checkpoint...")
        saver.wait()
        path = save_checkpoint(state, cfg.save_path, ckpt_name, step,
                               extra=meta_extra)
        if primary:
            print(f"[{elapsed}] Checkpoint saved to {path}. Exiting training.")
    finally:
        saver.close()
        logger.close()
    return state
