#!/usr/bin/env python
"""One-command BASELINE harness: time-to-PSNR-30 on real datasets.

No datasets ship in this image (zero egress), so the north-star number
(BASELINE.json: lego to PSNR 30 in <15 min) cannot be measured here; the
moment real data and hardware appear this script is the single invocation
that produces it:

    python tools/run_baseline_configs.py --lego /data/nerf_synthetic/lego \
        [--fern /data/nerf_llff_data/fern] [--out baseline_results.json] \
        [--configs 1,2,4] [--target-psnr 30] [--max-minutes 30]

Runs the BASELINE.json configs:
  1. lego coarse-only 64 samples, positional encoding (half_res)
  2. lego hierarchical 64+128, full NeRF MLP (the real workload)
  3. fern LLFF/NDC, white background off (needs --fern)
  4. lego with the SIREN variant
(5. multi-scene/multi-host is a separate launch topology — see
    nerf_jax/train/multiscene_loop.py and Config.multihost.)

For each config it trains with periodic validation renders, records the
wall-clock time and step at which val PSNR first reaches the target, and
writes one JSON blob with per-config results. Timing follows bench.py's
rules: chained steps, clock read only after a host fetch.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _config_specs(args):
    base = dict(
        num_random_rays=1024,
        compute_dtype="bfloat16",
        half_res=True,            # 800 -> 400 (config 2's stated shape)
        num_iters=10_000_000,     # the PSNR target / time cap stops us
    )
    specs = {
        1: dict(base, name="lego_coarse64", dataset_path=args.lego,
                num_samples=64, num_fine_samples=0, model_type="nerf"),
        2: dict(base, name="lego_hier_64_128", dataset_path=args.lego,
                num_samples=64, num_fine_samples=128, model_type="nerf"),
        3: dict(base, name="fern_llff_ndc", dataset_path=args.fern,
                dataset_type="llff", ndc=True, white_background=False,
                num_samples=64, num_fine_samples=64, model_type="nerf",
                half_res=False, llff_factor=args.llff_factor),
        4: dict(base, name="lego_siren", dataset_path=args.lego,
                num_samples=64, num_fine_samples=128, model_type="siren"),
    }
    return specs


def run_config(spec: dict, target_psnr: float, max_minutes: float,
               val_every: int) -> dict:
    import jax
    import jax.numpy as jnp

    from nerf_jax.config import Config
    from nerf_jax.data.pipeline import load_scene
    from nerf_jax.train.loop import render_settings_from_config
    from nerf_jax.train.state import create_train_state
    from nerf_jax.train.step import make_eval_render, make_scan_train_step
    from nerf_jax.utils.metrics import mse_to_psnr

    name = spec.pop("name")
    cfg_fields = {f.name for f in dataclasses.fields(Config)}
    cfg = Config(**{k: v for k, v in spec.items() if k in cfg_fields})
    print(f"=== {name}: loading {cfg.dataset_path}")
    scene = load_scene(cfg)
    settings = render_settings_from_config(cfg, ndc=scene.ndc)
    settings = dataclasses.replace(
        settings, near=scene.near, far=scene.far,
        white_background=scene.white_background,
    )

    model, tx, state = create_train_state(cfg, jax.random.key(cfg.seed))
    step_fn = make_scan_train_step(
        model, tx, settings, cfg.num_random_rays, jax.random.key(1),
        num_steps=val_every,
    )
    eval_render = make_eval_render(model, settings)

    from nerf_jax.data.rays import compute_rays

    h, w = scene.hw
    val_img = np.asarray(scene.val_images[0]).reshape(-1, 3)
    c2w = np.eye(4, dtype=np.float32)
    c2w[: scene.val_c2w.shape[1]] = scene.val_c2w[0]
    ro, rd, _ = compute_rays(scene.val_images[:1], c2w[None], scene.focal)
    ro, rd, viewdirs = ro[0], rd[0], None
    if scene.ndc:
        from nerf_jax.ops.ndc import ndc_rays

        viewdirs = jnp.asarray(rd)
        ro, rd = ndc_rays(h, w, scene.focal, 1.0, jnp.asarray(ro),
                          jnp.asarray(rd))
    ro, rd = jnp.asarray(ro), jnp.asarray(rd)

    def val_psnr(step):
        out = eval_render(state.params, state.fine_params, ro, rd,
                          jax.random.key(step), viewdirs=viewdirs)
        mse = float(np.mean((np.asarray(out.rgb) - val_img) ** 2))
        return float(mse_to_psnr(mse))

    # compile both programs before starting the clock
    state, m = step_fn(state, scene.pool)
    float(np.asarray(m["loss"][-1]))
    psnr = val_psnr(0)
    print(f"{name}: compiled; step {val_every} PSNR {psnr:.2f}")

    t0 = time.perf_counter()
    step, hit_step, hit_time = val_every, None, None
    history = []
    while time.perf_counter() - t0 < max_minutes * 60:
        state, m = step_fn(state, scene.pool)
        float(np.asarray(m["loss"][-1]))  # hard sync before reading the clock
        step += val_every
        psnr = val_psnr(step)
        elapsed = time.perf_counter() - t0
        history.append({"step": step, "sec": round(elapsed, 1),
                        "psnr": round(psnr, 2)})
        print(f"{name}: step {step} t={elapsed:.0f}s PSNR {psnr:.2f}")
        if psnr >= target_psnr:
            hit_step, hit_time = step, elapsed
            break

    return {
        "config": name,
        "target_psnr": target_psnr,
        "reached": hit_step is not None,
        "steps_to_target": hit_step,
        "seconds_to_target": round(hit_time, 1) if hit_time else None,
        "final_psnr": history[-1]["psnr"] if history else psnr,
        "val_hw": [int(h), int(w)],
        "history": history,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lego", type=str, default="",
                    help="path to Blender lego (nerf_synthetic/lego)")
    ap.add_argument("--fern", type=str, default="",
                    help="path to LLFF fern (nerf_llff_data/fern)")
    ap.add_argument("--llff-factor", type=int, default=8,
                    help="LLFF downsample factor (8 = the standard fern "
                         "protocol; use 1 for the tiny synthetic drill)")
    ap.add_argument("--out", type=str, default="baseline_results.json")
    ap.add_argument("--configs", type=str, default="1,2,3,4")
    ap.add_argument("--target-psnr", type=float, default=30.0)
    ap.add_argument("--max-minutes", type=float, default=30.0)
    ap.add_argument("--val-every", type=int, default=250)
    ap.add_argument("--rays", type=int, default=0,
                    help="override rays/step (smoke tests)")
    ap.add_argument("--samples", type=int, default=0,
                    help="override coarse sample count (smoke tests)")
    args = ap.parse_args()

    specs = _config_specs(args)
    if args.rays or args.samples:
        for spec in specs.values():
            if args.rays:
                spec["num_random_rays"] = args.rays
            if args.samples:
                spec["num_samples"] = args.samples
                if spec.get("num_fine_samples"):
                    spec["num_fine_samples"] = args.samples
    results = []
    for i in (int(s) for s in args.configs.split(",")):
        spec = specs[i]
        if not spec["dataset_path"]:
            print(f"config {i} ({spec['name']}): no dataset path given, skipped")
            continue
        results.append(run_config(dict(spec), args.target_psnr,
                                  args.max_minutes, args.val_every))

    blob = {"target": "BASELINE.json north_star: lego to PSNR 30 < 15 min",
            "results": results}
    with open(args.out, "w") as f:
        json.dump(blob, f, indent=2)
    print(json.dumps(blob))


if __name__ == "__main__":
    main()
