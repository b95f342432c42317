"""End-to-end training driver.

Preserves every observable trainer behavior of the reference
(/root/reference/train.py:20-263): seeding, config summary, interval-driven
logging/checkpointing/validation (same conditions), resume, final save, and
checkpoint-on-SIGINT — while the step itself is the jitted program from
`nerf_jax.train.step` (GSPMD: sharded ray batches + replicated params make
XLA emit the gradient psum; the explicit shard_map twin lives in
`nerf_jax.parallel.dp` for tests and tooling). With ``multihost=True`` the
same loop spans processes: jax.distributed init, globally sharded pool,
process-0-gated logging/metadata, collective checkpoints.

Asynchronous dispatch: metrics are device arrays; the loop only forces them
to host on log steps, so between logs the host runs ahead and the device
queue stays full (the reference pays a D2H sync every log via ``loss.item()``,
utils.py:73 — same cadence here, zero extra syncs).
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from nerf_jax.config import Config
from nerf_jax.data.pipeline import load_scene
from nerf_jax.data.rays import compute_rays
from nerf_jax.render.renderer import RenderSettings
from nerf_jax.train.optim import lr_schedule
from nerf_jax.train.state import TrainState, create_train_state
from nerf_jax.train.step import (
    make_eval_render,
    make_scan_train_step,
    make_train_step,
)
from nerf_jax.utils.checkpoint import (
    AsyncCheckpointSaver,
    load_checkpoint,
    read_metadata,
    save_checkpoint,
)
from nerf_jax.utils.logging import MetricLogger
from nerf_jax.utils.metrics import mse_to_psnr
from nerf_jax.utils.timer import format_elapsed_time


def render_settings_from_config(cfg: Config, ndc: bool = False) -> RenderSettings:
    return RenderSettings(
        near=cfg.near,
        far=cfg.far,
        num_samples=cfg.num_samples,
        num_fine_samples=cfg.num_fine_samples,
        white_background=cfg.white_background and not ndc,
        jitter_mode=cfg.jitter_mode,
        perturb=cfg.perturb,
        chunk_size=resolve_eval_chunk(cfg),
        normalize_positions=not ndc,
        fine_sampling=cfg.fine_sampling,
    )


def make_regularizer(cfg: Config, model):
    """``cfg.tv_lambda`` / ``cfg.tv_sh_lambda`` -> a loss-term callable
    over the (params, fine_params) pair, or None when both are 0. Only
    grid families expose a ``.tv`` hook (plenoxels — the paper's prior);
    setting the knobs for any other family is a config error."""
    if cfg.tv_lambda == 0.0 and cfg.tv_sh_lambda == 0.0:
        return None
    if not hasattr(model, "tv"):
        raise ValueError(
            f"tv_lambda/tv_sh_lambda set but model '{cfg.model_type}' has "
            "no TV regularizer (voxel-grid families only)"
        )

    def reg(param_pair):
        total = jnp.zeros((), jnp.float32)
        for p in param_pair:
            if p and "grid" in p:
                tv_sigma, tv_sh = model.tv(p)
                total = (total + cfg.tv_lambda * tv_sigma
                         + cfg.tv_sh_lambda * tv_sh)
        return total

    return reg


def parse_upsample_steps(spec: str) -> list:
    """``"2000:64,5000:128"`` -> ``[(2000, 64), (5000, 128)]`` — the
    coarse-to-fine schedule (Plenoxels paper sec. 5: start 128^3, upsample
    to 256^3 mid-training). Steps and resolutions must strictly increase."""
    if not spec.strip():
        return []
    out = []
    for item in spec.split(","):
        s, _, r = item.strip().partition(":")
        if not r:
            raise ValueError(
                f"upsample_steps entries are 'step:res', got '{item}'")
        out.append((int(s), int(r)))
    if out[0][0] <= 0:
        raise ValueError("upsample steps must be > 0")
    for (s0, r0), (s1, r1) in zip(out, out[1:]):
        if s1 <= s0 or r1 <= r0:
            raise ValueError(
                f"upsample_steps must increase in step and res: '{spec}'")
    return out


# Ray tile of full-image renders when the config leaves eval_chunk_size
# at 0. chip_smoke.py's eval phase times a 400x400 64+128 bf16 NeRF frame at
# 8192 and 32768: on an H100 (400 W limit) 682.7 vs 684.8 ms, equal within
# noise, so the smaller tile, which also needs less memory, is the default.
DEFAULT_EVAL_CHUNK = 8192
# Cap for families whose field evaluation is table gathers (trilinear
# grids, hash lookups): their gather temporaries are several times the
# MLP path's per ray, so a 32k tile of a 128^3 x 28 grid does not fit.
GATHER_BOUND_EVAL_CHUNK = 8192


def _gather_bound(model_type: str) -> bool:
    """Grid/hash families declare the trait on their class (see
    plenoxels.py 'class traits') so new families cannot silently miss
    this eval-chunk cap."""
    from nerf_jax.models.registry import MODEL_REGISTRY

    cls = MODEL_REGISTRY.get(model_type.lower())
    return bool(getattr(cls, "eval_gather_bound", False))


def resolve_eval_chunk(cfg: Config) -> int:
    """Ray tile size for full-image (eval/validation) renders.

    The reference's chunk_size=8192 is a memory bound, not semantics
    (rendering.py:191 loops purely for memory). An explicit
    eval_chunk_size wins; otherwise the tile is DEFAULT_EVAL_CHUNK, or
    GATHER_BOUND_EVAL_CHUNK for the gather-bound families (the
    eval_gather_bound class trait). Fewer, larger tiles amortize the
    per-tile sample_pdf/merge glue of the lax.map loop.
    """
    if cfg.eval_chunk_size > 0:
        return cfg.eval_chunk_size
    if _gather_bound(cfg.model_type):
        return min(DEFAULT_EVAL_CHUNK, GATHER_BOUND_EVAL_CHUNK)
    return DEFAULT_EVAL_CHUNK


def print_config_summary(cfg: Config) -> None:
    print("===== Training Configuration Summary =====")
    for field in (
        "dataset_path num_random_rays chunk_size num_samples num_fine_samples "
        "num_iters learning_rate near far save_path save_interval lr_decay "
        "lr_decay_factor lr_min first_step_render log_interval val_interval "
        "model_type compute_dtype".split()
    ):
        print(f"{field}: {getattr(cfg, field)}")
    print(f"devices: {jax.device_count()} x {jax.devices()[0].device_kind}")
    print("==========================================")


def fit(
    cfg: Config,
    resume_path: Optional[str] = None,
    max_steps: Optional[int] = None,
    enable_tensorboard: bool = True,
) -> TrainState:
    """Train per the config; returns the final TrainState."""
    # Multi-host: initialize jax.distributed BEFORE the first backend query so
    # the mesh below spans every process's devices (reference is single-device,
    # train.py:98-99; this is the BASELINE north-star scale-out path).
    if cfg.multihost:
        from nerf_jax.parallel.multihost import init_distributed

        init_distributed()
    from nerf_jax.parallel.multihost import is_primary

    primary = is_primary()
    np.random.seed(cfg.seed)
    if cfg.debug_nans:
        jax.config.update("jax_debug_nans", True)
    root_key = jax.random.key(cfg.seed)
    k_init, k_train, k_val = jax.random.split(root_key, 3)

    if primary:
        print_config_summary(cfg)
    num_iters = int(max_steps if max_steps is not None else cfg.num_iters)

    # --- mesh / sharding ---
    data_shard = None
    replicated = None
    mesh = None
    if jax.device_count() > 1:
        from nerf_jax.parallel.mesh import create_mesh, data_sharding, replicated_sharding

        mesh = create_mesh(cfg.mesh_shape)
        data_shard = data_sharding(mesh)
        replicated = replicated_sharding(mesh)
        if primary:
            print(f"Mesh: {dict(zip(mesh.axis_names, mesh.devices.shape))}")

    # --- data ---
    if primary:
        print("Loading dataset...")
    # The pool lives sharded across the data axis — each device holds M/D
    # rays in its memory, never the full pool replicated. Every process loads the full
    # (host-side) ray arrays; device_put with a global sharding places each
    # process's addressable shards from the identical host value.
    scene = load_scene(cfg, sharding=data_shard)
    import dataclasses

    # The scene dictates the sampling interval (LLFF derives near/far from
    # dataset bounds; NDC uses [0,1]). Rebind cfg BEFORE the model is
    # built: grid-family domains are the normalized image of the scene
    # volume (registry.py::grid_domain) and must use the SAME near/far the
    # renderer will normalize positions with.
    cfg = dataclasses.replace(cfg, near=float(scene.near),
                              far=float(scene.far))
    settings = render_settings_from_config(cfg, ndc=scene.ndc)
    settings = dataclasses.replace(
        settings, white_background=scene.white_background,
    )
    if primary:
        print(
            f"Loaded scene '{scene.name}': {scene.pool.size} train rays, "
            f"{scene.val_images.shape[0]} val images {scene.hw[0]}x{scene.hw[1]}"
        )
    if cfg.epoch_sampling and primary:
        # epoch_indices tracks the linear position in int32 (no wider exact
        # integer with jax x64 off) and exactly-once holds over the padded
        # pool when sharding wrapped it — surface both caveats up front.
        if num_iters * cfg.num_random_rays >= 2**31:
            print(
                "WARNING: epoch_sampling position overflows int32 at step "
                f"{2**31 // cfg.num_random_rays}; epochs repeat a stale "
                "permutation beyond that point."
            )
        if data_shard is not None:
            print(
                "Note: epoch_sampling with a sharded pool counts any "
                "wrap-padded duplicate rays in its exactly-once guarantee."
            )

    # --- model / state ---
    if resume_path is not None:
        # the checkpoint is self-describing: its model_type (and, for grid
        # families that moved under upsample_steps, its grid_res) wins over
        # the config so the restored shapes match — for ALL fit() callers,
        # not just the CLI (which also applies this for its summary print)
        meta = read_metadata(resume_path)
        cfg = dataclasses.replace(
            cfg,
            model_type=meta.get("model_type", cfg.model_type).lower(),
            grid_res=int(meta.get("grid_res", cfg.grid_res)),
        )
    model, tx, state = create_train_state(cfg, k_init)
    if replicated is not None:
        # Place the fresh state replicated on the (possibly multi-process)
        # mesh. Init is deterministic from cfg.seed, so every process holds
        # the identical value — required for a global device_put.
        state = jax.device_put(state, replicated)
    start_step = 0
    if resume_path is not None:
        meta = read_metadata(resume_path)
        # restores onto the template's shardings (replicated on the mesh)
        state = load_checkpoint(resume_path, state)
        start_step = int(meta["step"])
        if primary:
            print(f"Resuming training from iteration {start_step}")
    elif cfg.distill_from and cfg.distill_steps > 0:
        # KiloNeRF-style teacher distillation before the photometric loop
        # (train/distill.py); a resumed checkpoint already carries it
        from nerf_jax.train.distill import run_distillation

        if primary:
            print(f"Distilling from teacher {cfg.distill_from} "
                  f"({cfg.distill_steps} field-matching steps)...")
        state = run_distillation(
            cfg, model, tx, state, k_train, data_sharding=data_shard,
            primary=primary,
        )
        if replicated is not None:
            state = jax.device_put(state, replicated)

    regularizer = make_regularizer(cfg, model)

    # Occupancy-guided training (cfg.occupancy_res): bake a {0,1} prior
    # from the live field at intervals and hand it to the step as a TRACED
    # array — rebakes never retrace. First bake happens before step 0 (the
    # density-bias init makes it all-occupied = plain uniform sampling).
    occ_opts = None
    occ_grid = None
    bake_occ = None
    if cfg.occupancy_res > 0:
        from nerf_jax.models.registry import grid_domain
        from nerf_jax.ops.occupancy import bake_occupancy, sigma_field

        occ_domain = grid_domain(cfg)
        occ_opts = (occ_domain, 64, 1e-2)

        def bake_occ(params):
            return bake_occupancy(
                sigma_field(model.apply, params),
                grid_res=cfg.occupancy_res, domain=occ_domain,
                threshold=cfg.occupancy_thresh,
            )

        occ_grid = bake_occ(state.params)

    train_step = make_train_step(
        model,
        tx,
        settings,
        cfg.num_random_rays,
        k_train,
        data_sharding=data_shard,
        donate=cfg.donate_state,
        epoch_sampling=cfg.epoch_sampling,
        regularizer=regularizer,
        occupancy_opts=occ_opts,
    )

    # Scan-chunked stepping: between host touchpoints (log/val/save), run N
    # iterations inside ONE compiled dispatch (bit-identical to N single
    # steps — randomness derives from state.step). Chunks are sized so every
    # event step lands exactly at a chunk end; compiled variants are cached
    # per length (steady state uses one length = gcd of the intervals).
    max_chunk = cfg.steps_per_call
    if max_chunk <= 0:
        import math

        max_chunk = math.gcd(
            math.gcd(cfg.log_interval, cfg.val_interval), cfg.save_interval
        )
        # Auto mode caps the chunk: dispatch overhead is fully amortized by
        # ~100 steps/dispatch, while very long scans inflate XLA compile
        # memory/time for gather-heavy bodies. Explicit steps_per_call is
        # honored as-is.
        max_chunk = min(max_chunk, 100)
        if getattr(model, "scan_hostile", False):
            # grid families dispatch per step — see the trait on the
            # model class
            max_chunk = 1
    _step_fns: dict[int, object] = {1: train_step}

    def get_step_fn(c: int):
        if c not in _step_fns:
            _step_fns[c] = make_scan_train_step(
                model,
                tx,
                settings,
                cfg.num_random_rays,
                k_train,
                num_steps=c,
                data_sharding=data_shard,
                donate=cfg.donate_state,
                epoch_sampling=cfg.epoch_sampling,
                regularizer=regularizer,
                occupancy_opts=occ_opts,
            )
        return _step_fns[c]

    def next_event(i: int) -> int:
        """Smallest step >= i at which the host must act (log/save/val)."""
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
        if upsample_sched and upsample_sched[0][0] - 1 >= i:
            # chunks must END right before an upsample step so the host
            # can swap the grid between dispatches
            candidates.append(upsample_sched[0][0] - 1)
        if bake_occ is not None:
            candidates.append(next_mult(max(i, 1), cfg.occupancy_interval))
        return min(candidates)
    def build_eval_render():
        return make_eval_render(
            model, settings,
            # rays shard_map'd across devices; multi-host keeps the GSPMD
            # path (mesh spans processes)
            mesh=mesh if jax.process_count() == 1 else None,
        )

    eval_render = build_eval_render()

    # Coarse-to-fine (cfg.upsample_steps): entries at or before the resume
    # point — or not above the restored grid's resolution — are already
    # baked into the checkpoint and drop out.
    upsample_sched = parse_upsample_steps(cfg.upsample_steps)
    if upsample_sched and not hasattr(model, "upsample"):
        raise ValueError(
            f"upsample_steps set but model '{cfg.model_type}' has no "
            "upsample hook (voxel-grid families only)"
        )
    if upsample_sched and "grid" in state.params:
        cur_res = int(state.params["grid"].shape[0])
        upsample_sched = [(s, r) for s, r in upsample_sched
                          if s > start_step and r > cur_res]

    def do_upsample(state: TrainState, new_res: int) -> TrainState:
        """Trilinearly upsample the grid(s) to ``new_res`` and restart the
        optimizer moments at the new shape (the paper restarts Adam too);
        randomness and batch order are untouched (they key off state.step)."""
        nonlocal model, eval_render
        params = model.upsample(state.params, new_res)
        fine = (model.upsample(state.fine_params, new_res)
                if state.fine_params else {})
        new_state = TrainState(
            step=state.step, params=params, fine_params=fine,
            opt_state=tx.init((params, fine)),
        )
        if replicated is not None:
            new_state = jax.device_put(new_state, replicated)
        import dataclasses

        model = dataclasses.replace(model, grid_res=new_res)
        # the eval renderer closes over the model — rebuild it; the TRAIN
        # step reads grid shapes from params and simply retraces at the
        # new shape
        eval_render = build_eval_render()
        return new_state

    schedule = lr_schedule(
        cfg.learning_rate, cfg.lr_decay, cfg.lr_decay_factor, cfg.lr_min
    )

    os.makedirs(cfg.save_path, exist_ok=True)

    def meta_extra():
        # record the CURRENT grid resolution (it moves under upsample_steps)
        # so resume/eval rebuild the state at the right shape
        return ({"grid_res": int(model.grid_res)}
                if hasattr(model, "grid_res") else None)

    saver = AsyncCheckpointSaver()  # interval saves overlap with training
    logger = MetricLogger(
        log_dir=cfg.log_dir,
        model_type=cfg.model_type,
        dataset_name=scene.name,
        config_text=str(cfg),
        enable_tensorboard=enable_tensorboard,
        quiet=not primary,  # console + TB from process 0 only
    )
    start_time = datetime.datetime.now()

    def run_validation(step: int) -> None:
        idx = np.random.randint(scene.val_images.shape[0])
        val_img = scene.val_images[idx]
        c2w = np.eye(4, dtype=np.float32)
        c2w[: scene.val_c2w.shape[1]] = scene.val_c2w[idx]
        rays_o, rays_d, _ = compute_rays(
            val_img[None], c2w[None], scene.focal
        )
        rays_o, rays_d = rays_o[0].reshape(-1, 3), rays_d[0].reshape(-1, 3)
        viewdirs = None
        if scene.ndc:
            from nerf_jax.ops.ndc import ndc_rays

            h, w = scene.hw
            viewdirs = rays_d
            rays_o, rays_d = ndc_rays(
                h, w, scene.focal, 1.0, jnp.asarray(rays_o), jnp.asarray(rays_d)
            )
        out = eval_render(
            state.params,
            state.fine_params,
            jnp.asarray(rays_o),
            jnp.asarray(rays_d),
            jax.random.fold_in(k_val, step),
            viewdirs=jnp.asarray(viewdirs) if viewdirs is not None else None,
        )
        rgb = out.rgb
        if jax.process_count() > 1:
            # the render output may be sharded across processes; gather the
            # global value so every host (and the logging host) sees it
            from jax.experimental import multihost_utils

            rgb = multihost_utils.process_allgather(rgb, tiled=True)
        pred = np.asarray(rgb).reshape(*scene.hw, 3)
        val_mse = float(np.mean((pred - val_img) ** 2))
        val_psnr = float(mse_to_psnr(val_mse))
        logger.log_validation(step, val_psnr, pred)

    # --- loop ---
    from nerf_jax.utils.profiling import Throughput

    throughput = Throughput(warmup=2)
    step = start_step
    try:
        pos = start_step
        chunk_idx = 0
        while pos < num_iters:
            while upsample_sched and pos >= upsample_sched[0][0]:
                _, new_res = upsample_sched.pop(0)
                with throughput.exclude():
                    state = do_upsample(state, new_res)
                if primary:
                    print(
                        f"[{format_elapsed_time(start_time)}] Upsampled "
                        f"grid to {new_res}^3 at iteration {pos}"
                    )
            ev = next_event(pos)
            boundary = min(ev + 1, num_iters)
            c = min(max_chunk, boundary - pos)

            profiling = cfg.profile_dir and chunk_idx == 2
            if profiling:
                jax.profiler.start_trace(cfg.profile_dir)
            t_call = time.perf_counter()
            state, metrics = get_step_fn(c)(state, scene.pool, occ_grid)
            if profiling:
                jax.block_until_ready(metrics["loss"])
                jax.profiler.stop_trace()
            if chunk_idx == 0:
                # the one sync outside the log cadence: how long the first
                # dispatch (its compile included) held the loop
                jax.block_until_ready(metrics["loss"])
                if primary:
                    print(f"[{format_elapsed_time(start_time)}] First train "
                          f"call ({c} steps, compile included): "
                          f"{time.perf_counter() - t_call:.2f} s")

            step = pos + c - 1  # last executed iteration
            throughput.update(c * cfg.num_random_rays)
            chunk_idx += 1
            if c > 1:  # scan stacks metrics; take the chunk-final step's
                metrics = jax.tree.map(lambda x: x[-1], metrics)

            if step % cfg.log_interval == 0:
                logger.log_train(
                    step, float(schedule(jnp.asarray(step))), float(metrics["mse"])
                )
                logger.log_scalar(
                    "rays_per_sec", throughput.rays_per_sec, step
                )

            if (bake_occ is not None and step > 0
                    and step % cfg.occupancy_interval == 0):
                with throughput.exclude():
                    occ_grid = bake_occ(state.params)

            if step % cfg.save_interval == 0 and 0 < step < num_iters - 1:
                with throughput.exclude():
                    path = saver.save(state, cfg.save_path,
                                      cfg.model_type, step,
                                      extra=meta_extra())
                if primary:
                    print(
                        f"[{format_elapsed_time(start_time)}] Model saved to "
                        f"{path} at iteration {step}"
                    )

            if step % cfg.val_interval == 0 and (step > 0 or cfg.first_step_render):
                with throughput.exclude():
                    run_validation(step)

            pos += c

        saver.wait()  # durability before the final (blocking) save
        final = save_checkpoint(state, cfg.save_path, cfg.model_type,
                                num_iters, extra=meta_extra())
        elapsed = format_elapsed_time(start_time)
        if primary:
            print(f"[{elapsed}] Training complete!")
            print(f"[{elapsed}] Final model saved to {final}")
    except KeyboardInterrupt:
        elapsed = format_elapsed_time(start_time)
        if primary:
            print(f"\n[{elapsed}] Keyboard interrupt! Saving current checkpoint...")
        saver.wait()
        path = save_checkpoint(state, cfg.save_path, cfg.model_type, step,
                               extra=meta_extra())
        if primary:
            print(f"[{elapsed}] Checkpoint saved to {path}. Exiting training.")
    finally:
        saver.close()
        logger.close()

    return state
