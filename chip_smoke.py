#!/usr/bin/env python
"""Smoke run of the main path on an NVIDIA GPU.

    python chip_smoke.py             # one card: phases 0-7 below
    python chip_smoke.py --chips 4   # four cards: the multi-card paths only

One card, through the entry points a user calls, at the full width of the
flagship recipe (configs/lego.txt: NeRF 8x256 with the skip, 64+128
hierarchical samples, 1024 rays a step, bfloat16) on a synthetic Blender
scene at lego's half-resolution shape (100 train views at 400x400), with
random weights from a seed:

  0 device     the card, its power limit, JAX version and XLA_FLAGS
  1 train      train.py's main for a few hundred steps: first-call time,
               steady ms/step and rays/s, logged MSE, val PSNR, peak bytes
  2 resume     train.py --resume continues from the saved step
  3 eval       eval.py orbit frames and --metrics; one 400x400 frame timed
               at eval chunk 8192 and 32768
  4 serve      an in-process RenderService answers three poses
  5 parity     loss and gradients of one 1024-ray batch in bf16 and float32
               against float32 at "highest" matmul precision
  6 families   ms/step of the other families' plain train step at the
               bench.py row shapes, and a 400x400 plenoxels frame
  7 gpu-tests  the tests marked ``gpu``, in this process

``--chips 4`` runs each path users run across cards against its one-card
result on the same seed and global batch, at the flagship's widths and
sample counts: fit() on ``data:4``, the parallel/dp.py shard_map
gradients and step, multi-scene ``scene:2,data:2`` through the multi-scene
CLI (two scenes from two seeds), and the sharded eval render. The
one-card runs of both CLIs happen first, in a child process that sees one
card, before this process opens any; the one-card eval frame renders on
the first card of this process. Training runs take MULTI_STEPS steps, one
step per dispatch, so each compiles one program.

Every phase prints its own lines; any failure raises and exits non-zero.
The last stdout line is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Outputs (the scene, checkpoints, frames, results.json) go under --out.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(REPO, "configs", "lego.txt")
HW = 400
TRAIN_STEPS = 300
RESUME_STEPS = 20
MULTI_STEPS = 10

# Phase 5 tolerances, relative to float32 at "highest" precision.
# float32: models/common.py pins HIGHEST on every float32 product, so what
# is left is summation order (~1e-6); a TF32 product (10 mantissa bits)
# would show ~1e-3.
F32_TOL = 1e-4
# bfloat16 operands keep 8 mantissa bits (rounding 2^-9 per operand). The
# loss averages 3072 pixel errors, so its error stays near that rounding.
BF16_LOSS_TOL = 2e-2
# A gradient passes ~20 rounded products through the 8-layer trunk and its
# backward, so per-element errors of a few per cent of the leaf's largest
# gradient are expected; a wrong gradient (sign, missing term) is off by
# order one.
BF16_GRAD_TOL = 1e-1

# --chips 4 tolerances against the one-card result.
# fit() and multi-scene: the data-axis psum sums in another order (~1e-6
# relative per step), and Adam divides by |g|, which amplifies that noise
# in near-zero gradients over the run; a wrong batch or an unsynchronised
# replica moves a fixed-batch loss by far more.
MULTI_LOSS_TOL = 1e-2
# The same runs compared by how far the parameters moved from their init:
# |P_four - P_one| / |P_one - P_init| over all leaves. Order noise flips
# the Adam update of a few near-zero gradients; training on another
# scene's rays, or on a wrong share of the batch, moves the parameters
# somewhere else (of the order of the movement itself).
MULTI_UPDATE_TOL = 1e-1
# dp.py against the same per-shard body vmapped on one card: the same
# per-ray arithmetic, the 4-way mean in another order, and possibly
# another GEMM algorithm for another shape (bf16 outputs round
# differently, ~2^-9). A gradient averaged over the wrong count is off by
# a whole factor (a sum over 4 cards instead of their mean: 3). The step
# is checked through SGD at learning rate DP_LR, so its update is minus
# DP_LR times the gradient it applied (Adam's update would hide a common
# scale); DP_LR is large enough that the update dwarfs the parameter and
# float32 rounding of the new parameter costs the gradient ~1e-7.
DP_LOSS_TOL = 1e-3
DP_GRAD_TOL = 5e-2
DP_LR = 2.0 ** 20
# sharded eval: the same per-ray arithmetic; bf16-operand products may
# accumulate in another order in another tile shape.
EVAL_RGB_TOL = 2e-3


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def run_captured(fn, *args) -> str:
    """Run ``fn(*args)`` with stdout shown and captured; returns the text."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        fn(*args)
    return buf.getvalue()


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def write_config(path: str, base: str, **overrides) -> str:
    """``base`` plus ``key = value`` lines (later keys win)."""
    with open(base) as f:
        text = f.read()
    lines = [f"{k} = {v}" for k, v in overrides.items()]
    with open(path, "w") as f:
        f.write(text + "\n# chip_smoke overrides\n" + "\n".join(lines) + "\n")
    return path


def make_scene(root: str, seed: int = 0) -> str:
    import importlib.util

    # by file path: an installed package may also be called "tests"
    spec = importlib.util.spec_from_file_location(
        "synthetic_scene", os.path.join(REPO, "tests", "synthetic.py"))
    synthetic = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synthetic)
    make_synthetic_blender_scene = synthetic.make_synthetic_blender_scene
    if not os.path.exists(os.path.join(root, "transforms_test.json")):
        make_synthetic_blender_scene(root, h=HW, w=HW, num_train=100,
                                     num_val=2, num_test=2, seed=seed)
    return root


def logged_mse(text: str) -> list:
    return [float(m) for m in re.findall(r"MSE: (\S+) PSNR", text)]


def timed(fn, reps: int):
    """(first-call seconds, steady seconds per call): the first call
    compiles; each later call ends in block_until_ready."""
    import jax

    t = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t
    jax.block_until_ready(fn())  # warm-up after the compile
    t = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return first, (time.perf_counter() - t) / reps


def rel(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------------------- phases


def phase_device(count: int) -> dict:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX found {dev.platform!r})")
    if len(jax.devices()) != count:
        raise SystemExit(f"chip_smoke: wants {count} GPUs, JAX sees "
                         f"{len(jax.devices())}")
    log("device", nvidia_smi())
    log("device", f"device_kind={dev.device_kind} count={jax.device_count()} "
        f"jax={jax.__version__} XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": jax.device_count()}


def phase_train(out: str, res: dict) -> str:
    import jax
    import numpy as np

    from nerf_jax.cli.train_cli import main as train_main
    from nerf_jax.config import parse_config_file
    from nerf_jax.data.pipeline import load_scene
    from nerf_jax.train.loop import render_settings_from_config
    from nerf_jax.train.state import create_train_state
    from nerf_jax.train.step import make_scan_train_step

    scene = make_scene(os.path.join(out, "scene"))
    cfg_path = write_config(
        os.path.join(out, "lego_smoke.txt"), FLAGSHIP,
        dataset_path=scene, save_path=os.path.join(out, "models"),
        log_dir=os.path.join(out, "logs"), num_iters=TRAIN_STEPS,
        log_interval=25, val_interval=100, save_interval=100)
    t = time.perf_counter()
    text = run_captured(train_main, ["--config", cfg_path])
    wall = time.perf_counter() - t
    mse = logged_mse(text)
    psnr = [float(p) for p in re.findall(r"\[Validation Step\] Iter \d+  "
                                         r"PSNR: (\S+)", text)]
    first = float(re.search(r"First train call \((\d+) steps, compile "
                            r"included\): (\S+) s", text).group(2))
    if not mse or not np.isfinite(mse).all():
        raise AssertionError(f"train: non-finite or missing MSE {mse}")
    if not np.mean(mse[-3:]) < 0.5 * np.mean(mse[:3]):
        raise AssertionError(f"train: loss did not fall: {mse}")

    # steady state of the same program, timed on its own
    cfg = parse_config_file(cfg_path)
    data = load_scene(cfg)
    cfg = dataclasses.replace(cfg, near=float(data.near), far=float(data.far))
    settings = dataclasses.replace(render_settings_from_config(cfg),
                                   white_background=data.white_background)
    k_init, k_train, _ = jax.random.split(jax.random.key(cfg.seed), 3)
    model, tx, state = create_train_state(cfg, k_init)
    chunk = 25
    step = make_scan_train_step(model, tx, settings, cfg.num_random_rays,
                                k_train, num_steps=chunk, donate=False)
    _, per_call = timed(lambda: step(state, data.pool)[1]["loss"], reps=8)
    ms_step = per_call / chunk * 1e3
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    res["train"] = {
        "steps": TRAIN_STEPS, "wall_s": wall,
        "first_call_s_incl_compile": first, "ms_per_step": ms_step,
        "rays_per_s": cfg.num_random_rays / (ms_step / 1e3),
        "mse_first": mse[0], "mse_last": mse[-1], "val_psnr": psnr[-1],
        "peak_bytes_in_use": peak}
    log("train", json.dumps(res["train"]))
    return cfg_path


def phase_resume(out: str, cfg_path: str, res: dict) -> str:
    from nerf_jax.cli.train_cli import main as train_main

    ckpt = os.path.join(out, "models", f"nerf_model_{TRAIN_STEPS:06d}")
    end = TRAIN_STEPS + RESUME_STEPS
    text = run_captured(train_main, ["--config", cfg_path, "--resume", ckpt,
                                     "--max-steps", str(end)])
    if f"Resuming training from iteration {TRAIN_STEPS}" not in text:
        raise AssertionError("resume: no resume line")
    new = os.path.join(out, "models", f"nerf_model_{end:06d}")
    if not os.path.isdir(new):
        raise AssertionError(f"resume: no checkpoint at step {end}")
    res["resume"] = {"from": TRAIN_STEPS, "to": end,
                     "mse": logged_mse(text)}
    log("resume", json.dumps(res["resume"]))
    return new


def phase_eval(out: str, cfg_path: str, ckpt: str, res: dict) -> str:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from nerf_jax.cli.eval_cli import main as eval_main
    from nerf_jax.config import parse_config_file
    from nerf_jax.data.poses import spherical_orbit
    from nerf_jax.data.rays import compute_rays_single
    from nerf_jax.train.loop import render_settings_from_config
    from nerf_jax.train.state import create_train_state
    from nerf_jax.train.step import make_eval_render
    from nerf_jax.utils.checkpoint import load_checkpoint
    from nerf_jax.utils.png import read_png

    eval_cfg = write_config(os.path.join(out, "lego_smoke_eval.txt"),
                            cfg_path, num_render_poses=2)
    frames = os.path.join(out, "frames")
    t = time.perf_counter()
    eval_main(["--config", eval_cfg, "--checkpoint", ckpt,
               "--output", frames])
    orbit_s = time.perf_counter() - t
    for i in range(2):
        img = read_png(os.path.join(frames, f"frame_{i:04d}.png"))
        if img.shape != (HW, HW, 3) or img.std() < 1.0:
            raise AssertionError(f"eval: frame {i} is {img.shape}, "
                                 f"std {img.std():.2f}")
    scores = os.path.join(out, "metrics")
    eval_main(["--config", eval_cfg, "--checkpoint", ckpt, "--metrics",
               "--output", scores])
    with open(os.path.join(scores, "metrics.json")) as f:
        metrics = json.load(f)
    if not np.isfinite(metrics["mean_psnr"]):
        raise AssertionError(f"eval: PSNR {metrics['mean_psnr']}")

    cfg = parse_config_file(eval_cfg)
    model, _, state = create_train_state(cfg, jax.random.key(cfg.seed))
    state = load_checkpoint(ckpt, state)
    focal = 0.5 * HW / np.tan(0.5 * 0.6911112070083618)
    ro, rd = compute_rays_single(HW, HW, focal, spherical_orbit(4)[1])
    ro, rd = jnp.asarray(ro.reshape(-1, 3)), jnp.asarray(rd.reshape(-1, 3))
    chunks = {}
    for chunk in (8192, 32768):
        settings = dataclasses.replace(render_settings_from_config(cfg),
                                       chunk_size=chunk)
        render = make_eval_render(model, settings)
        first, per = timed(lambda: render(state.params, state.fine_params,
                                          ro, rd, jax.random.key(0)).rgb,
                           reps=3)
        chunks[chunk] = {"first_call_s": first, "ms_per_frame": per * 1e3}
    res["eval"] = {"orbit_2_frames_wall_s": orbit_s,
                   "test_psnr": metrics["mean_psnr"],
                   "test_ssim": metrics["mean_ssim"], "chunks": chunks}
    log("eval", json.dumps(res["eval"]))
    return eval_cfg


def phase_serve(eval_cfg: str, ckpt: str, res: dict) -> None:
    import numpy as np

    from nerf_jax.serve import RenderService

    svc = RenderService.from_checkpoint(eval_cfg, ckpt)
    lat = []
    for i in range(3):
        t = time.perf_counter()
        img = svc.render_pose(svc.orbit_pose(i), key_idx=i)
        lat.append(time.perf_counter() - t)
        if img.shape != (HW, HW, 3) or not np.isfinite(img).all():
            raise AssertionError(f"serve: pose {i} gave {img.shape}")
    res["serve"] = {"latency_s": lat}
    log("serve", json.dumps(res["serve"]) + "  (request 0 compiles)")


def phase_parity(cfg_path: str, res: dict) -> None:
    import jax
    import jax.numpy as jnp

    from nerf_jax.config import parse_config_file
    from nerf_jax.data.pipeline import load_scene
    from nerf_jax.models.registry import model_from_config
    from nerf_jax.render.renderer import render_rays
    from nerf_jax.train.loop import render_settings_from_config

    cfg = parse_config_file(cfg_path)
    data = load_scene(cfg)
    settings = render_settings_from_config(cfg)
    batch = data.pool.sample(jax.random.key(5), cfg.num_random_rays)
    params = (model_from_config(cfg).init(jax.random.key(1)),
              model_from_config(cfg).init(jax.random.key(2)))

    def loss_and_grads(dtype):
        model = model_from_config(dataclasses.replace(cfg,
                                                      compute_dtype=dtype))

        def loss(pair):
            out = render_rays(model.apply, pair[0], batch.rays_o,
                              batch.rays_d, jax.random.key(3), settings,
                              fine_params=pair[1], viewdirs=batch.viewdirs)
            return (jnp.mean((out.rgb - batch.rgb) ** 2)
                    + jnp.mean((out.rgb_coarse - batch.rgb) ** 2))

        return jax.jit(jax.value_and_grad(loss))(params)

    with jax.default_matmul_precision("highest"):
        ref_loss, ref_grads = loss_and_grads("float32")
    out = {}
    for name, dtype, ltol, gtol in (("float32", "float32", F32_TOL, F32_TOL),
                                    ("bfloat16", "bfloat16", BF16_LOSS_TOL,
                                     BF16_GRAD_TOL)):
        loss, grads = loss_and_grads(dtype)
        lerr = rel(loss, ref_loss)
        gerr = max(rel(a, b) for a, b in zip(jax.tree.leaves(grads),
                                             jax.tree.leaves(ref_grads)))
        out[name] = {"loss_rel_err": lerr, "grad_max_rel_err": gerr,
                     "loss_tol": ltol, "grad_tol": gtol}
        log("parity", f"{name}: loss rel err {lerr:.3e} (tol {ltol:g}), "
            f"max grad rel err {gerr:.3e} (tol {gtol:g})")
        if not (lerr <= ltol and gerr <= gtol):
            raise AssertionError(f"parity: {name} outside tolerance")
    res["parity"] = out


def phase_families(res: dict) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from nerf_jax.config import Config
    from nerf_jax.data.poses import spherical_orbit
    from nerf_jax.data.rays import compute_rays_single
    from nerf_jax.train.loop import render_settings_from_config
    from nerf_jax.train.step import make_eval_render

    rows = {}
    # (family, rays, samples, steps per call, calls): bench.py's row shapes
    for name, rays, samples, scan, calls in (
            ("nerf", 1024, 256, 20, 5), ("siren", 1024, 256, 10, 5),
            ("gabor", 1024, 256, 10, 5), ("kilonerf", 1024, 256, 8, 5),
            ("plenoxels", 1024, 64, 1, 20), ("ngp", 1024, 16, 20, 5)):
        step, state, pool = bench._build(rays, samples, "bfloat16", scan,
                                         name)
        carry = [state]   # the step donates its state: chain the calls

        def call():
            carry[0], metrics = step(carry[0], pool)
            return metrics["loss"]

        first, per = timed(call, reps=calls)
        ms = per / scan * 1e3
        rows[f"train_{name}"] = {"rays": rays, "samples": samples,
                                 "first_call_s": first, "ms_per_step": ms,
                                 "rays_per_s": rays / (ms / 1e3)}
        log("families", f"train_{name}: {json.dumps(rows[f'train_{name}'])}")
        del step, state, pool, carry

    cfg = Config(model_type="plenoxels", num_samples=256, num_fine_samples=0)
    model = bench._make_model("plenoxels", "bfloat16")
    params = jax.jit(model.init)(jax.random.key(0))
    render = make_eval_render(model, render_settings_from_config(cfg))
    focal = 0.5 * HW / np.tan(0.5 * 0.6911)
    ro, rd = compute_rays_single(HW, HW, focal, spherical_orbit(4)[0])
    ro, rd = jnp.asarray(ro.reshape(-1, 3)), jnp.asarray(rd.reshape(-1, 3))
    first, per = timed(lambda: render(params, {}, ro, rd,
                                      jax.random.key(1)).rgb, reps=3)
    rows["render_plenoxels"] = {"hw": HW, "samples": 256,
                                "first_call_s": first,
                                "ms_per_frame": per * 1e3}
    log("families", f"render_plenoxels: {json.dumps(rows['render_plenoxels'])}")
    res["families"] = rows


class _Count:
    def __init__(self):
        self.passed = self.failed = self.skipped = 0

    def pytest_runtest_logreport(self, report):
        if report.passed and report.when == "call":
            self.passed += 1
        elif report.failed:
            self.failed += 1
        elif report.skipped:
            self.skipped += 1


def phase_gpu_tests(res: dict) -> None:
    import pytest

    os.environ["NERF_JAX_TEST_GPU"] = "1"
    count = _Count()
    # only the card's test file is collected: the others import the
    # repo's tests/ as a package, which an installed "tests" can shadow
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "--rootdir", REPO,
                      os.path.join(REPO, "tests", "test_gpu.py")],
                     plugins=[count])
    res["gpu_tests"] = vars(count) | {"rc": int(rc)}
    log("gpu-tests", json.dumps(res["gpu_tests"]))
    if rc != 0 or count.passed == 0 or count.skipped or count.failed:
        raise AssertionError("gpu-tests: not all passed")


# ------------------------------------------------------------ four cards


def one_card_reference(out: str) -> None:
    """The child of ``--chips 4``: the one-card runs of both CLIs, each
    first with ``--max-steps 0``, which saves the initial state."""
    from nerf_jax.cli.multiscene_cli import main as multiscene_main
    from nerf_jax.cli.train_cli import main as train_main

    phase_device(1)
    fit_cfg = os.path.join(out, "fit_one.txt")
    scenes = [os.path.join(out, "scene"), os.path.join(out, "scene_b")]
    for steps in ("0", str(MULTI_STEPS)):
        train_main(["--config", fit_cfg, "--max-steps", steps])
        multiscene_main(["--config", os.path.join(out, "ms_one.txt"),
                         "--scenes", *scenes, "--max-steps", steps])


def eval_rays():
    import numpy as np

    from nerf_jax.data.poses import spherical_orbit
    from nerf_jax.data.rays import compute_rays_single

    focal = 0.5 * HW / np.tan(0.5 * 0.6911112070083618)
    ro, rd = compute_rays_single(HW, HW, focal, spherical_orbit(4)[2])
    return ro.reshape(-1, 3), rd.reshape(-1, 3)


def make_eval_render(model, settings, mesh=None):
    from nerf_jax.train.step import make_eval_render as make

    return make(model, dataclasses.replace(settings, perturb=False),
                mesh=mesh)


def trained_pair(out: str, cfg_path: str, sub: str):
    """(model, render settings, params, fine params) of ``sub``'s fit()
    checkpoint after MULTI_STEPS steps."""
    import jax

    from nerf_jax.config import parse_config_file
    from nerf_jax.models.registry import model_from_config
    from nerf_jax.train.loop import render_settings_from_config

    cfg = parse_config_file(cfg_path)
    model = model_from_config(cfg)
    template = model.init(jax.random.key(0))
    flat = load_npz(os.path.join(out, sub, "models",
                                 f"nerf_model_{MULTI_STEPS:06d}"))
    return (model, render_settings_from_config(cfg),
            subtree(flat, ".params", template),
            subtree(flat, ".fine_params", template))


def fixed_batch_loss(cfg_path: str, batch, params, fine_params) -> float:
    import jax
    import jax.numpy as jnp

    from nerf_jax.config import parse_config_file
    from nerf_jax.models.registry import model_from_config
    from nerf_jax.render.renderer import render_rays
    from nerf_jax.train.loop import render_settings_from_config

    cfg = parse_config_file(cfg_path)
    out = render_rays(model_from_config(cfg).apply, params, batch.rays_o,
                      batch.rays_d, jax.random.key(12),
                      dataclasses.replace(render_settings_from_config(cfg),
                                          perturb=False),
                      fine_params=fine_params or None,
                      viewdirs=batch.viewdirs)
    return float(jnp.mean((out.rgb - batch.rgb) ** 2))


def load_npz(path: str) -> dict:
    import numpy as np

    with np.load(os.path.join(path, "state.npz")) as d:
        return {k: d[k] for k in d.files}


def subtree(flat: dict, prefix: str, template):
    """Rebuild ``template``'s structure from checkpoint leaves under
    ``prefix`` (e.g. ".params")."""
    import jax

    paths, treedef = jax.tree_util.tree_flatten_with_path(template)
    return jax.tree_util.tree_unflatten(treedef, [
        flat[prefix + jax.tree_util.keystr(p)] for p, _ in paths])


def param_arrays(flat: dict, scene=None) -> list:
    """The checkpoint's parameter leaves (of one scene, if stacked)."""
    return [v if scene is None else v[scene]
            for k, v in sorted(flat.items())
            if k.startswith((".params", ".fine_params"))]


def update_rel_err(init: list, one: list, four: list) -> float:
    """|P_four - P_one| / |P_one - P_init| over all leaves."""
    import numpy as np

    def sq(a, b):
        return float(np.sum((np.asarray(a, np.float64) - b) ** 2))

    diff = sum(sq(f, o) for o, f in zip(one, four))
    moved = sum(sq(o, i) for i, o in zip(init, one))
    return (diff / moved) ** 0.5


def leaf_rel_errs(a, b) -> list:
    """Per leaf, max |a - b| / max |b|."""
    import jax

    return [rel(x, y) for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b))]


def run_four(out: str, res: dict) -> None:
    import jax
    import numpy as np

    from nerf_jax.cli.multiscene_cli import main as multiscene_main
    from nerf_jax.cli.train_cli import main as train_main
    from nerf_jax.config import parse_config_file
    from nerf_jax.data.pipeline import load_scene
    from nerf_jax.models.registry import model_from_config
    import optax

    from nerf_jax.parallel.dp import make_dp_train_step, make_shard_grads
    from nerf_jax.parallel.mesh import create_mesh, shard_pool
    from nerf_jax.train.loop import render_settings_from_config
    from nerf_jax.train.state import create_train_state

    t0 = time.perf_counter()

    def stamp(phase):
        log(phase, f"done at {time.perf_counter() - t0:.1f} s")

    # fit() on data:4 against the child's one-card run
    train_main(["--config", os.path.join(out, "fit_four.txt")])
    fit_cfg = os.path.join(out, "fit_one.txt")
    cfg = parse_config_file(fit_cfg)
    model = model_from_config(cfg)
    template = model.init(jax.random.key(0))
    data = load_scene(cfg)
    batch = data.pool.sample(jax.random.key(11), 4096)
    name = f"nerf_model_{MULTI_STEPS:06d}"
    flats = {sub: load_npz(os.path.join(out, sub, "models", name))
             for sub in ("one", "four")}
    losses = [fixed_batch_loss(fit_cfg, batch,
                               subtree(flats[sub], ".params", template),
                               subtree(flats[sub], ".fine_params", template))
              for sub in ("one", "four")]
    init = load_npz(os.path.join(out, "one", "models", "nerf_model_000000"))
    upd = update_rel_err(param_arrays(init), param_arrays(flats["one"]),
                         param_arrays(flats["four"]))
    err = rel(losses[1], losses[0])
    res["fit_data4"] = {"loss_one": losses[0], "loss_four": losses[1],
                        "loss_rel_err": err, "loss_tol": MULTI_LOSS_TOL,
                        "update_rel_err": upd,
                        "update_tol": MULTI_UPDATE_TOL}
    log("fit-data4", json.dumps(res["fit_data4"]))
    if not (err <= MULTI_LOSS_TOL and upd <= MULTI_UPDATE_TOL):
        raise AssertionError("fit data:4 differs from one card")
    stamp("fit-data4")

    # dp.py: the shard_map step's gradients against the same per-shard
    # body vmapped on one card, leaf by leaf, on the batches of steps 0-2
    settings = render_settings_from_config(cfg)
    _, _, state = create_train_state(cfg, jax.random.key(cfg.seed))
    sgd = optax.sgd(DP_LR)
    state = state._replace(opt_state=sgd.init((state.params,
                                               state.fine_params)))
    mesh = create_mesh("data:4")
    key = jax.random.key(2)
    dp_step = make_dp_train_step(model, sgd, settings, cfg.num_random_rays,
                                 key, mesh, donate=False)
    body = jax.jit(jax.vmap(
        make_shard_grads(model, settings, cfg.num_random_rays // 4, key),
        in_axes=(None, 0, None), axis_name="data"))
    card0 = jax.devices()[0]
    rows = (data.pool.rays_o.shape[0] // 4) * 4
    shards = jax.device_put(jax.tree.map(
        lambda x: x[:rows].reshape(4, -1, *x.shape[1:]), data.pool), card0)
    sharded_pool = shard_pool(jax.tree.map(lambda x: x[:rows], data.pool),
                              mesh)
    loss_errs, grad_errs = [], []
    pair = (state.params, state.fine_params)
    for k in range(3):
        at = state._replace(step=state.step + k)
        (loss_ref, _), grads_ref = body(jax.device_put(pair, card0), shards,
                                        jax.device_put(at.step, card0))
        new, m = dp_step(at, sharded_pool)
        grads = jax.tree.map(lambda a, b: (np.float64(a) - b) / DP_LR, pair,
                             (new.params, new.fine_params))
        loss_errs.append(rel(m["loss"], loss_ref[0]))
        grad_errs.append(max(leaf_rel_errs(
            grads, jax.tree.map(lambda g: g[0], grads_ref))))
    res["dp_shard_map"] = {"loss_rel_err": loss_errs,
                           "loss_tol": DP_LOSS_TOL,
                           "max_leaf_grad_rel_err": grad_errs,
                           "grad_tol": DP_GRAD_TOL}
    log("dp", json.dumps(res["dp_shard_map"]))
    if not (max(loss_errs) <= DP_LOSS_TOL and max(grad_errs) <= DP_GRAD_TOL):
        raise AssertionError("dp step differs from its one-card body")
    del shards, sharded_pool, body, dp_step
    stamp("dp")

    # multi-scene scene:2,data:2 against the child's one-card run; each
    # scene's model is scored on its own scene's rays
    scenes = [os.path.join(out, "scene"), os.path.join(out, "scene_b")]
    multiscene_main(["--config", os.path.join(out, "ms_four.txt"),
                     "--scenes", *scenes])
    ms = f"nerf_multiscene_model_{MULTI_STEPS:06d}"
    stacked = {sub: load_npz(os.path.join(out, sub, "models", ms))
               for sub in ("one", "four")}
    ms_init = load_npz(os.path.join(out, "one", "models",
                                    "nerf_multiscene_model_000000"))
    per_scene = []
    for s, path in enumerate(scenes):
        own = load_scene(dataclasses.replace(cfg, dataset_path=path))
        own_batch = own.pool.sample(jax.random.key(11), 4096)
        ls = []
        for sub in ("one", "four"):
            per = {k: v[s] for k, v in stacked[sub].items() if v.ndim > 0}
            ls.append(fixed_batch_loss(
                fit_cfg, own_batch, subtree(per, ".params", template),
                subtree(per, ".fine_params", template)))
        per_scene.append({"loss_one": ls[0], "loss_four": ls[1],
                     "loss_rel_err": rel(ls[1], ls[0]),
                     "update_rel_err": update_rel_err(
                         param_arrays(ms_init, s),
                         param_arrays(stacked["one"], s),
                         param_arrays(stacked["four"], s))})
    res["multiscene_s2d2"] = {"scenes": per_scene,
                              "loss_tol": MULTI_LOSS_TOL,
                              "update_tol": MULTI_UPDATE_TOL}
    log("multiscene", json.dumps(res["multiscene_s2d2"]))
    if not all(r["loss_rel_err"] <= MULTI_LOSS_TOL
               and r["update_rel_err"] <= MULTI_UPDATE_TOL
               for r in per_scene):
        raise AssertionError("multi-scene differs from one card")
    stamp("multiscene")

    # sharded eval render of the one-card fit against the frame rendered
    # on the first card alone
    model, settings, params, fine = trained_pair(out, fit_cfg, "one")
    ro, rd = eval_rays()
    one = make_eval_render(model, settings)(
        jax.device_put(params, card0), jax.device_put(fine, card0),
        jax.device_put(ro, card0), jax.device_put(rd, card0),
        jax.random.key(0)).rgb
    four = make_eval_render(model, settings, mesh=mesh)(
        params, fine, ro, rd, jax.random.key(0)).rgb
    diff = float(np.abs(np.asarray(one) - np.asarray(four)).max())
    res["eval_sharded"] = {"max_abs_rgb_diff": diff, "tol": EVAL_RGB_TOL}
    log("eval-sharded", json.dumps(res["eval_sharded"]))
    if not diff <= EVAL_RGB_TOL:
        raise AssertionError("sharded eval differs from one card")
    stamp("eval-sharded")


def prepare_four(out: str) -> None:
    """Scenes and configs for --chips 4 (numpy only: no device yet)."""
    scene = make_scene(os.path.join(out, "scene"))
    make_scene(os.path.join(out, "scene_b"), seed=1)
    common = dict(dataset_path=scene, num_iters=MULTI_STEPS,
                  log_interval=MULTI_STEPS // 2, steps_per_call=1,
                  val_interval=10 * MULTI_STEPS,
                  save_interval=10 * MULTI_STEPS)
    for sub, mesh in (("one", ""), ("four", "data:4")):
        write_config(os.path.join(out, f"fit_{sub}.txt"), FLAGSHIP,
                     save_path=os.path.join(out, sub, "models"),
                     log_dir=os.path.join(out, sub, "logs"),
                     mesh_shape=mesh, **common)
    for sub, mesh in (("one", ""), ("four", "scene:2,data:2")):
        write_config(os.path.join(out, f"ms_{sub}.txt"), FLAGSHIP,
                     save_path=os.path.join(out, sub, "models"),
                     log_dir=os.path.join(out, sub, "logs"),
                     mesh_shape=mesh, **common)


# ------------------------------------------------------------------ main


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--chips", type=int, choices=(1, 4), default=1)
    parser.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                      "chip_smoke"))
    parser.add_argument("--one-card-reference", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    sys.path.insert(0, REPO)

    if args.one_card_reference or args.chips == 1:
        # one card: JAX sees only the first one
        first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
        os.environ["CUDA_VISIBLE_DEVICES"] = first or "0"
    if args.one_card_reference:
        one_card_reference(out)
        return

    res: dict = {}
    if args.chips == 4:
        prepare_four(out)
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--out", out, "--one-card-reference"], check=True)
        device = phase_device(4)
        run_four(out, res)
    else:
        device = phase_device(1)
        cfg_path = phase_train(out, res)
        ckpt = phase_resume(out, cfg_path, res)
        eval_cfg = phase_eval(out, cfg_path, ckpt, res)
        phase_serve(eval_cfg, ckpt, res)
        phase_parity(cfg_path, res)
        phase_families(res)
        phase_gpu_tests(res)
    res["device"] = device
    smi = nvidia_smi()
    res["nvidia_smi"] = smi
    with open(os.path.join(out, f"results_chips{args.chips}.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(smi)
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
