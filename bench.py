#!/usr/bin/env python
"""Benchmark: training-step throughput in rays/sec/chip (fwd+bwd+update).

Measures the reference workload shape (config_lego.txt:13-15: 1024 rays x
256 samples through the full-size NeRF MLP) as scan-batched jitted train
steps on the default device, then prints ONE JSON line:

    {"metric": "rays_per_sec_per_chip", "value": N, "unit": "rays/s",
     "vs_baseline": R}

``vs_baseline`` is the speedup of the configured fast path (scan-chunked
dispatch + compute dtype from NERF_JAX_BENCH_DTYPE, default bfloat16) over
the porting-fidelity baseline measured in the same run: the float32 path
with one dispatch per step, which is the shape of the reference's own loop
(the reference publishes no numbers of its own; BASELINE.md documents
this).

Timing notes: steps are chained (state_{i+1} = f(state_i)) and the clock
stops after fetching the final step's loss to host, which waits for the
whole chain. ``compile_s`` in each row is the wall time of the first
(compiling) warmup call. Every row names the device it ran on.

Knobs: NERF_JAX_BENCH_MODEL=nerf|siren|gabor|kilonerf|plenoxels|ngp,
NERF_JAX_BENCH_MODE=train (default) | render (full-image eval throughput,
400x400 hierarchical 64+128), NERF_JAX_BENCH_{RAYS,SAMPLES,ITERS,SCAN,
DTYPE,HW,FINE,CHUNK}.

SUITE mode (the default when NO bench env knobs are set — i.e. a plain
`python bench.py`): the flat-NeRF headline line prints FIRST, then one
JSON line per key configuration (model families x train/render), each run
in its own subprocess under a timeout while this parent stays off the
device (one process per device), and the headline line is RE-EMITTED
after every row, so the last complete line is always the headline.
NERF_JAX_BENCH_SUITE=0 forces single-config; any explicit knob does too;
NERF_JAX_BENCH_SUITE=1 forces the suite even with knobs (tests use this) —
but only in train mode: MODE=render is always a single-row run (it exists
to BE a suite subprocess), so SUITE=1 is ignored there. After the family
rows, one compact {"rows": {...}} summary line is emitted before the
final headline re-emit so a truncated log tail still carries every row's
number.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


def _make_model(model_type: str, compute_dtype: str):
    from nerf_jax.config import Config
    from nerf_jax.models import create_model
    from nerf_jax.models.registry import grid_domain

    # grid families carry the scene-volume domain exactly as training
    # would build them (create_model drops it for the MLP families) — the
    # render bench's cell-traversal geometry then matches real workloads
    kwargs = {"compute_dtype": compute_dtype,
              "domain": grid_domain(Config())}
    if model_type == "kilonerf":
        # paper-shaped tiny networks (512 x hidden 32), not the monolithic
        # 256-wide default the other families share
        kwargs.update(hidden_dim=32, grid_res=8)
    return create_model(model_type, **kwargs)


def _build(batch_rays: int, num_samples: int, compute_dtype: str,
           steps_per_call: int, model_type: str = "nerf"):
    import jax
    import jax.numpy as jnp

    from nerf_jax.config import Config
    from nerf_jax.render.renderer import RenderSettings
    from nerf_jax.train.optim import make_optimizer
    from nerf_jax.train.state import TrainState
    from nerf_jax.train.step import make_scan_train_step, make_train_step
    from nerf_jax.data.pipeline import RayPool

    model = _make_model(model_type, compute_dtype)
    num_fine = int(os.environ.get("NERF_JAX_BENCH_FINE", 0))
    settings = RenderSettings(
        near=2.0, far=6.0, num_samples=num_samples, white_background=True,
        jitter_mode="per_ray", num_fine_samples=num_fine,
        fine_sampling=os.environ.get("NERF_JAX_BENCH_FINE_SAMPLING", "merge"),
    )
    cfg = Config()
    tx = make_optimizer(cfg)
    # jitted init: one compiled program instead of one dispatch per layer
    params = jax.jit(model.init)(jax.random.key(0))
    fine_params = jax.jit(model.init)(jax.random.key(3)) if num_fine else {}
    state = TrainState(
        step=jnp.zeros((), jnp.int32),
        params=params,
        fine_params=fine_params,
        opt_state=tx.init((params, fine_params)),
    )

    pool_size = 1 << 20
    k = jax.random.key(1)

    @jax.jit
    def make_pool(k):
        rays_d = jax.random.normal(k, (pool_size, 3))
        rays_d = rays_d / jnp.linalg.norm(rays_d, axis=-1, keepdims=True)
        return RayPool(
            rays_o=jax.random.normal(k, (pool_size, 3)) * 0.1,
            rays_d=rays_d,
            rgb=jax.random.uniform(k, (pool_size, 3)),
            viewdirs=rays_d,
        )

    pool = make_pool(k)
    # NERF_JAX_BENCH_OCC=<res>: occupancy-guided sampling at the fit()
    # operating point (occ_opts matches loop.py; an all-ones prior costs
    # exactly what a real one does — the inverse-CDF draw is content-
    # independent, the win is the reduced sample count)
    occ_res = int(os.environ.get("NERF_JAX_BENCH_OCC", 0))
    occ_opts = None
    occ_grid = None
    if occ_res > 0:
        from nerf_jax.models.registry import grid_domain as _gd

        occ_opts = (_gd(cfg), 64, 1e-2)
        occ_grid = jnp.ones((occ_res, occ_res, occ_res, 1), jnp.float32)
    if steps_per_call > 1:
        step_fn = make_scan_train_step(
            model, tx, settings, batch_rays, jax.random.key(2),
            num_steps=steps_per_call, donate=True,
            occupancy_opts=occ_opts,
        )
    else:
        step_fn = make_train_step(
            model, tx, settings, batch_rays, jax.random.key(2),
            donate=True, occupancy_opts=occ_opts,
        )
    if occ_grid is not None:
        raw_step = step_fn
        step_fn = lambda state, pool: raw_step(state, pool, occ_grid)
    return step_fn, state, pool


def _measure(step_fn, state, pool, batch_rays: int, calls: int,
             steps_per_call: int, warmup: int):
    """Returns (rays_per_sec, state, compile_s) — compile_s is the wall
    time of the first warmup call (a compile on a cold cache; a disk
    cache-hit load otherwise — either way the first-call cost a timeout
    budget must absorb). The first call always runs, so warmup >= 1 is
    required rather than silently implied."""
    assert warmup >= 1, "warmup must be >= 1 (the compile call always runs)"
    def fetch(m):
        loss = m["loss"]
        return float(np.asarray(loss if loss.ndim == 0 else loss[-1]))

    t_c = time.perf_counter()
    state, m = step_fn(state, pool)
    fetch(m)
    compile_s = time.perf_counter() - t_c
    for _ in range(max(warmup - 1, 0)):
        state, m = step_fn(state, pool)
    fetch(m)
    t0 = time.perf_counter()
    for _ in range(calls):
        state, m = step_fn(state, pool)
    fetch(m)  # chained states => this forces the whole timed sequence
    dt = time.perf_counter() - t0
    return batch_rays * steps_per_call * calls / dt, state, compile_s


def _render_mode() -> dict:
    """NERF_JAX_BENCH_MODE=render: full-image (eval) forward throughput at
    400x400, hierarchical 64+128, bf16, auto chunk."""
    import jax
    import jax.numpy as jnp

    from nerf_jax.config import Config
    from nerf_jax.train.loop import render_settings_from_config
    from nerf_jax.train.step import make_eval_render

    hw = int(os.environ.get("NERF_JAX_BENCH_HW", 400))
    model_type = os.environ.get("NERF_JAX_BENCH_MODEL", "nerf")
    cfg = Config(
        num_samples=int(os.environ.get("NERF_JAX_BENCH_SAMPLES", 64)),
        num_fine_samples=int(os.environ.get("NERF_JAX_BENCH_FINE", 128)),
        eval_chunk_size=int(os.environ.get("NERF_JAX_BENCH_CHUNK", 0)),
        model_type=model_type,
        fine_sampling=os.environ.get("NERF_JAX_BENCH_FINE_SAMPLING", "merge"),
    )
    model = _make_model(model_type, os.environ.get("NERF_JAX_BENCH_DTYPE",
                                                   "bfloat16"))
    settings = render_settings_from_config(cfg)
    params = jax.jit(model.init)(jax.random.key(0))
    fine_params = jax.jit(model.init)(jax.random.key(1))
    render = make_eval_render(model, settings)

    # a real camera pose (orbit radius 4, lego-ish fov), not random ray
    # soup: identical cost for the MLP families, and the gather locality
    # the grid families see in eval
    from nerf_jax.data.poses import spherical_orbit
    from nerf_jax.data.rays import compute_rays_single

    n = hw * hw
    focal = 0.5 * hw / np.tan(0.5 * 0.6911)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3] = spherical_orbit(4)[0][:3]
    ro, rd = compute_rays_single(hw, hw, focal, c2w)
    rays_o = jnp.asarray(ro.reshape(-1, 3), jnp.float32)
    rays_d = jnp.asarray(rd.reshape(-1, 3), jnp.float32)

    def frame(i):
        out = render(params, fine_params, rays_o, rays_d, jax.random.key(i))
        return float(np.asarray(out.rgb[0, 0]))  # host fetch = hard sync

    t_c = time.perf_counter()
    frame(0)  # compile
    compile_s = time.perf_counter() - t_c
    reps = int(os.environ.get("NERF_JAX_BENCH_ITERS", 5))
    t0 = time.perf_counter()
    for i in range(reps):
        frame(i + 1)
    dt = (time.perf_counter() - t0) / reps
    return {
        "metric": "render_rays_per_sec",
        "value": round(n / dt, 1),
        "unit": "rays/s",
        "ms_per_frame": round(dt * 1e3, 1),
        "compile_s": round(compile_s, 1),
        **_device(),
    }


def _device() -> dict:
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "device_kind": d.device_kind,
            "device_count": jax.device_count()}


def _train_mode() -> dict:
    """The default mode: train-step throughput for NERF_JAX_BENCH_MODEL
    (flat NeRF at the reference shape when no knobs are set = the
    headline)."""
    import jax

    batch_rays = int(os.environ.get("NERF_JAX_BENCH_RAYS", 1024))
    num_samples = int(os.environ.get("NERF_JAX_BENCH_SAMPLES", 256))
    calls = int(os.environ.get("NERF_JAX_BENCH_ITERS", 10))
    scan = int(os.environ.get("NERF_JAX_BENCH_SCAN", 20))
    fast_dtype = os.environ.get("NERF_JAX_BENCH_DTYPE", "bfloat16")
    model_type = os.environ.get("NERF_JAX_BENCH_MODEL", "nerf")

    # baseline: float32, one dispatch per step (reference loop shape)
    step_fn, state, pool = _build(batch_rays, num_samples, "float32", 1,
                                  model_type)
    base_rps, _, compile_base = _measure(step_fn, state, pool, batch_rays,
                                         calls * min(scan, 4), 1, warmup=3)

    # fast path: scan-chunked dispatch + bf16 matmuls
    step_fn, state, pool = _build(batch_rays, num_samples, fast_dtype,
                                  scan, model_type)
    fast_rps, _, compile_fast = _measure(step_fn, state, pool, batch_rays,
                                         calls, scan, warmup=2)

    # Report the fast path's OWN number: a regression below the pure-JAX
    # baseline must show up as vs_baseline < 1, never be masked by max().
    if fast_rps < base_rps:
        import sys

        print(
            f"WARNING: fast path ({fast_rps:.0f} rays/s) is SLOWER than the "
            f"float32 baseline ({base_rps:.0f} rays/s) — regression!",
            file=sys.stderr,
        )
    return {
        "metric": "rays_per_sec_per_chip",
        "value": round(fast_rps, 1),
        "unit": "rays/s",
        "vs_baseline": round(fast_rps / base_rps, 3),
        "fast_rps": round(fast_rps, 1),
        "base_rps": round(base_rps, 1),
        "compile_s": round(compile_base + compile_fast, 1),
        **_device(),
        "config": f"train_{model_type}",
    }


# Suite rows: (name, env, timeout_s). Each runs `python bench.py` in a
# subprocess with these knobs; a timeout covers a cold compile.
_SUITE = [
    ("train_kilonerf",
     {"NERF_JAX_BENCH_MODEL": "kilonerf", "NERF_JAX_BENCH_ITERS": "5",
      "NERF_JAX_BENCH_SCAN": "8"}, 600),
    ("train_plenoxels",
     # SCAN=1 matches fit(): grid families dispatch per step (the
     # scan_hostile trait)
     {"NERF_JAX_BENCH_MODEL": "plenoxels", "NERF_JAX_BENCH_SAMPLES": "64",
      "NERF_JAX_BENCH_ITERS": "12", "NERF_JAX_BENCH_SCAN": "1"}, 600),
    ("train_plenoxels_occ",
     # occupancy-guided sampling at S=16: gather rows and the backward
     # scatter scale linearly in samples. Per-step dispatch (scan_hostile
     # family); occ prior at the fit() default res.
     {"NERF_JAX_BENCH_MODEL": "plenoxels", "NERF_JAX_BENCH_SAMPLES": "16",
      "NERF_JAX_BENCH_OCC": "32", "NERF_JAX_BENCH_ITERS": "12",
      "NERF_JAX_BENCH_SCAN": "1"}, 600),
    ("train_ngp",
     # occupancy operating point (16 samples); scan-chunked — NGP is not
     # scan_hostile
     {"NERF_JAX_BENCH_MODEL": "ngp", "NERF_JAX_BENCH_SAMPLES": "16",
      "NERF_JAX_BENCH_ITERS": "5", "NERF_JAX_BENCH_SCAN": "20"}, 600),
    ("train_ngp_s64",
     # dense 64 samples: the 16-level table-gradient scatter at full load
     {"NERF_JAX_BENCH_MODEL": "ngp", "NERF_JAX_BENCH_SAMPLES": "64",
      "NERF_JAX_BENCH_ITERS": "2", "NERF_JAX_BENCH_SCAN": "4"}, 600),
    ("render_nerf",
     {"NERF_JAX_BENCH_MODE": "render", "NERF_JAX_BENCH_ITERS": "3"}, 600),
    ("render_plenoxels_dense",
     {"NERF_JAX_BENCH_MODE": "render", "NERF_JAX_BENCH_MODEL": "plenoxels",
      "NERF_JAX_BENCH_SAMPLES": "256", "NERF_JAX_BENCH_FINE": "0",
      "NERF_JAX_BENCH_ITERS": "3"}, 600),
    ("train_nerf_hier",
     {"NERF_JAX_BENCH_SAMPLES": "64", "NERF_JAX_BENCH_FINE": "128",
      "NERF_JAX_BENCH_ITERS": "5", "NERF_JAX_BENCH_SCAN": "10"}, 600),
    ("train_siren",
     {"NERF_JAX_BENCH_MODEL": "siren", "NERF_JAX_BENCH_ITERS": "5",
      "NERF_JAX_BENCH_SCAN": "10"}, 600),
    ("train_gabor",
     {"NERF_JAX_BENCH_MODEL": "gabor", "NERF_JAX_BENCH_ITERS": "5",
      "NERF_JAX_BENCH_SCAN": "10"}, 600),
]


def _suite_enabled() -> bool:
    flag = os.environ.get("NERF_JAX_BENCH_SUITE")
    if flag == "0":
        return False
    if flag == "1":
        return True
    # auto: plain `python bench.py` runs the suite; any explicit knob
    # means a targeted single-config run
    return not any(
        k.startswith("NERF_JAX_BENCH_")
        and k not in ("NERF_JAX_BENCH_SUITE", "NERF_JAX_BENCH_SUITE_ROWS")
        for k in os.environ
    )


def _run_row(env_extra: dict, timeout_s: float) -> dict:
    """``python bench.py`` in a subprocess with ``env_extra`` knobs ->
    its last JSON line, or an error row."""
    import subprocess
    import sys

    env = dict(os.environ)
    env.update(env_extra)
    env["NERF_JAX_BENCH_SUITE"] = "0"
    try:
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__)],
            env=env, timeout=timeout_s, capture_output=True, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)) or ".",
        )
    except subprocess.TimeoutExpired:
        return {"error": f"timeout>{timeout_s:.0f}s"}
    line = next((ln for ln in reversed(r.stdout.splitlines())
                 if ln.startswith("{")), None)
    if r.returncode == 0 and line:
        return json.loads(line)
    return {"error": f"rc={r.returncode}", "stderr_tail": r.stderr[-300:]}


def _run_suite(headline: dict) -> None:
    """Run the family rows, re-emitting the headline after EVERY row so the
    last stdout line is the headline no matter where a watchdog strikes.
    After the loop, ONE compact {"rows": {...}} summary line carries every
    row's key numbers so a truncated log tail cannot drop family rows."""
    only = os.environ.get("NERF_JAX_BENCH_SUITE_ROWS")
    rows = _SUITE if not only else [
        r for r in _SUITE if r[0] in only.split(",")]
    summary: dict[str, dict] = {}

    def _summarize(row: dict) -> dict:
        return {k: row[k] for k in
                ("value", "unit", "vs_baseline", "ms_per_frame", "error")
                if k in row}

    reemit = dict(headline)
    reemit["headline"] = True
    for name, env_extra, timeout_s in rows:
        row = _run_row(env_extra, timeout_s)
        row["config"] = name
        summary[name] = _summarize(row)
        print(json.dumps(row), flush=True)
        print(json.dumps(reemit), flush=True)
    # the all-rows record, immediately before the final headline re-emit
    print(json.dumps({"rows": summary}), flush=True)
    print(json.dumps(reemit), flush=True)


def main() -> None:
    suite = _suite_enabled()
    mode = os.environ.get("NERF_JAX_BENCH_MODE", "train")
    if suite and mode == "train":
        # the parent stays off the device: every row, the headline
        # included, runs in its own process
        row = _run_row({}, 900)
        row.setdefault("config", "train_nerf")
        print(json.dumps(row), flush=True)
        _run_suite(row)
        return
    from nerf_jax.utils.platform import setup_compilation_cache

    setup_compilation_cache()
    if mode == "render":
        print(json.dumps(_render_mode()), flush=True)
        return
    # The headline (or the targeted single config) ALWAYS prints first.
    row = _train_mode()
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
