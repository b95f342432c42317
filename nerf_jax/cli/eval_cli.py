"""Evaluation CLI — novel-view rendering to PNG frames.

Drop-in replacement for the reference's
``python eval.py --config <file> --checkpoint <ckpt> [--output <dir>]``
(/root/reference/eval.py:53-62): synthesizes a spherical orbit of
``num_render_poses`` cameras (theta sweep at phi=-30 deg, radius 4 —
eval.py:91-97), renders each with the trained field, and writes
``frame_{i:04d}.png``. The test split is loaded with a single image just to
recover H/W/focal (eval.py:111-112). For LLFF scenes the spiral render path
from the loader is used instead.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import jax
import jax.numpy as jnp

from nerf_jax.config import parse_config_file
from nerf_jax.data.blender import load_blender
from nerf_jax.data.poses import spherical_orbit
from nerf_jax.data.rays import compute_rays_single
from nerf_jax.train.loop import render_settings_from_config
from nerf_jax.train.state import create_train_state
from nerf_jax.utils.checkpoint import load_checkpoint, read_metadata


def _eval_mesh():
    """All-device 1-D mesh for sharded frame renders (multi-chip hosts);
    None single-device / multi-process (make_eval_render would ignore a
    cross-process mesh anyway — eval is a single-process CLI)."""
    if jax.process_count() > 1 or jax.device_count() == 1:
        return None
    from nerf_jax.parallel.mesh import create_mesh

    return create_mesh("")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Render novel views from a trained NeRF checkpoint."
    )
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--output", type=str, default="rendered_frames")
    parser.add_argument(
        "--video", type=str, default="",
        help="also write the orbit as an animated file (.gif or .mp4) "
             "at this path (extension picks the format)",
    )
    parser.add_argument(
        "--fps", type=int, default=20, help="frame rate for --video",
    )
    parser.add_argument(
        "--bake", type=int, default=0, metavar="GRID_RES",
        help="bake the field into an MLP-free cache at this grid resolution "
             "before rendering (fastnerf / plenoctree only): the FastNeRF / "
             "PlenOctrees papers' acceleration — rendering then costs "
             "trilinear gathers + a tiny contraction per sample, no network",
    )
    parser.add_argument(
        "--metrics", action="store_true",
        help="render the dataset's TEST split instead of the orbit and "
             "report per-view + mean PSNR/SSIM (writes metrics.json and "
             "pred_*.png to --output)",
    )
    parser.add_argument(
        "--occupancy", type=int, default=0, metavar="GRID_RES",
        help="bake a binary occupancy prior at this resolution and draw "
             "the coarse samples from its inverse CDF (static-shape "
             "empty-space skipping, ops/occupancy.py): equal quality at a "
             "fraction of num_samples — pair with a smaller num_samples "
             "in the config for faster renders",
    )
    args = parser.parse_args(argv)

    from nerf_jax.utils.platform import setup_compilation_cache

    setup_compilation_cache()
    cfg = parse_config_file(args.config)
    meta = read_metadata(args.checkpoint)
    cfg.model_type = meta.get("model_type", cfg.model_type).lower()
    if "grid_res" in meta:
        # grids may have been upsampled mid-training (upsample_steps);
        # the checkpoint's recorded resolution wins
        cfg.grid_res = int(meta["grid_res"])
    os.makedirs(args.output, exist_ok=True)

    print("===== Evaluation Configuration Summary =====")
    print(f"Dataset path: {cfg.dataset_path}")
    print(f"Model type: {cfg.model_type}")
    print(f"Checkpoint: {args.checkpoint}")
    print(f"Output directory: {args.output}")
    print(f"Near/far: {cfg.near}/{cfg.far}  samples: {cfg.num_samples}")
    print(f"Number of render poses: {cfg.num_render_poses}")
    print("=============================================")

    np.random.seed(cfg.seed)

    if cfg.dataset_type == "llff":
        from nerf_jax.data.llff import load_llff
        from nerf_jax.ops.ndc import ndc_rays

        data = load_llff(cfg.dataset_path, factor=cfg.llff_factor)
        h, w = data["hw"]
        focal = data["focal"]
        poses = data["render_poses"][: cfg.num_render_poses]
        ndc = cfg.ndc
        # match training (train/loop.py): the sampling interval comes from
        # the dataset, not the config — NDC samples t in [0,1], non-NDC
        # uses the reconstruction's world bounds. Grid-family domains are
        # derived from these, so set them BEFORE building the model.
        cfg.near, cfg.far = ((0.0, 1.0) if ndc else
                             (float(data["near_world"]),
                              float(data["far_world"])))
    else:
        images, _, focal = load_blender(
            cfg.dataset_path, mode="test", single_image=True,
            white_background=cfg.white_background, half_res=cfg.half_res,
        )
        h, w = images.shape[1:3]
        poses = spherical_orbit(cfg.num_render_poses)
        ndc = False

    model, _, state = create_train_state(cfg, jax.random.key(cfg.seed))
    state = load_checkpoint(args.checkpoint, state)

    settings = render_settings_from_config(cfg, ndc=ndc)
    # occupancy prior + baked caches + eval renderer: one factory shared
    # with the serving surface (nerf_jax/serve.py)
    from nerf_jax.serve import build_renderer

    try:
        renderer, render_params = build_renderer(
            model, state, cfg, settings, mesh=_eval_mesh(),
            bake=args.bake, occupancy=args.occupancy,
        )
    except ValueError as e:
        if not str(e).startswith("bake:"):
            raise  # real errors keep their traceback
        raise SystemExit(f"--{e}")  # the no-baked-cache usage error
    key = jax.random.key(cfg.seed)

    from nerf_jax.utils.png import write_png

    if args.metrics:
        # render the held-out TEST split with the dataset's own cameras and
        # score against ground truth (the standard NeRF benchmark protocol;
        # the reference's eval renders an orbit and reports nothing)
        import json

        from nerf_jax.utils.metrics import mse_to_psnr, ssim

        if cfg.dataset_type == "llff":
            test_images = data["images"][data["i_test"]]
            test_poses = data["poses"][data["i_test"]]
        else:
            test_images, test_poses, _ = load_blender(
                cfg.dataset_path, mode="test",
                white_background=cfg.white_background, half_res=cfg.half_res,
            )
        rows = []
        num_views = test_images.shape[0]
        for i in range(num_views):
            c2w = np.eye(4, dtype=np.float32)
            c2w[: test_poses[i].shape[0]] = test_poses[i]
            rays_o, rays_d = compute_rays_single(h, w, focal, c2w)
            viewdirs = None
            if ndc:
                viewdirs = jnp.asarray(rays_d)
                rays_o, rays_d = ndc_rays(
                    h, w, focal, 1.0, jnp.asarray(rays_o), jnp.asarray(rays_d)
                )
            out = renderer(
                render_params[0], render_params[1],
                jnp.asarray(rays_o), jnp.asarray(rays_d),
                jax.random.fold_in(key, i), viewdirs=viewdirs,
            )
            pred = np.clip(np.asarray(out.rgb).reshape(h, w, 3), 0.0, 1.0)
            gt = np.asarray(test_images[i], np.float32)
            mse = float(np.mean((pred - gt) ** 2))
            rows.append({"view": i, "mse": mse,
                         "psnr": float(mse_to_psnr(mse)),
                         "ssim": ssim(pred, gt)})
            write_png(os.path.join(args.output, f"pred_{i:03d}.png"),
                      (pred * 255).astype(np.uint8))
            print(f"Scored test view {i + 1}/{num_views}: "
                  f"PSNR {rows[-1]['psnr']:.2f}")
        summary = {
            "num_views": len(rows),
            "mean_psnr": float(np.mean([r["psnr"] for r in rows])),
            "mean_ssim": float(np.mean([r["ssim"] for r in rows])),
            "views": rows,
        }
        with open(os.path.join(args.output, "metrics.json"), "w") as f:
            json.dump(summary, f, indent=1)
        print(f"Test split ({summary['num_views']} views): "
              f"PSNR {summary['mean_psnr']:.2f}  "
              f"SSIM {summary['mean_ssim']:.4f}")
        print(f"Wrote {os.path.join(args.output, 'metrics.json')}")
        return

    frames = []
    for i in range(poses.shape[0]):
        c2w = np.eye(4, dtype=np.float32)
        c2w[: poses[i].shape[0]] = poses[i]
        rays_o, rays_d = compute_rays_single(h, w, focal, c2w)
        viewdirs = None
        if ndc:
            viewdirs = jnp.asarray(rays_d)
            rays_o, rays_d = ndc_rays(
                h, w, focal, 1.0, jnp.asarray(rays_o), jnp.asarray(rays_d)
            )
        out = renderer(
            render_params[0],
            render_params[1],
            jnp.asarray(rays_o),
            jnp.asarray(rays_d),
            jax.random.fold_in(key, i),
            viewdirs=viewdirs,
        )
        frame = np.clip(np.asarray(out.rgb).reshape(h, w, 3), 0.0, 1.0)
        frame_u8 = (frame * 255).astype(np.uint8)
        write_png(os.path.join(args.output, f"frame_{i:04d}.png"), frame_u8)
        print(f"Rendered frame {i + 1}/{poses.shape[0]}")
        if args.video:
            frames.append(frame_u8)

    if args.video:
        try:
            import imageio.v2 as imageio
        except ImportError:
            raise SystemExit("--video needs the imageio package; the PNG "
                             f"frames are in {args.output}") from None
        try:
            imageio.mimsave(args.video, frames, fps=args.fps)
            print(f"Wrote {args.video} ({len(frames)} frames @ {args.fps} fps)")
        except Exception as e:  # e.g. no mp4 codec in the environment
            gif = os.path.splitext(args.video)[0] + ".gif"
            imageio.mimsave(gif, frames, fps=args.fps)
            print(f"{type(e).__name__} writing {args.video}; wrote {gif} instead")


if __name__ == "__main__":
    main()
