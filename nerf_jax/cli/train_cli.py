"""Training CLI — drop-in replacement for the reference's
``python train.py --config <file> [--resume <ckpt>]``
(/root/reference/train.py:29-36). Accepts unmodified reference config files.
On resume, the checkpoint's ``model_type`` overrides the config
(train.py:67-72)."""

from __future__ import annotations

import argparse

from nerf_jax.config import parse_config_file
from nerf_jax.train.loop import fit
from nerf_jax.utils.checkpoint import read_metadata


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Train NeRF on a given dataset using volumetric rendering."
    )
    parser.add_argument("--config", type=str, required=True,
                        help="Path to configuration file")
    parser.add_argument("--resume", type=str, default=None,
                        help="Path to a checkpoint directory to resume from")
    parser.add_argument("--max-steps", type=int, default=None,
                        help="Override num_iters (smoke tests)")
    args = parser.parse_args(argv)

    from nerf_jax.utils.platform import setup_compilation_cache

    setup_compilation_cache()
    cfg = parse_config_file(args.config)
    if args.resume is not None:
        meta = read_metadata(args.resume)
        cfg.model_type = meta.get("model_type", cfg.model_type).lower()
        print(f"Resuming training with model type from checkpoint: {cfg.model_type}")
        if "grid_res" in meta:
            # the checkpoint's grid may have moved under upsample_steps;
            # its recorded resolution wins so the restored shapes match
            cfg.grid_res = int(meta["grid_res"])

    fit(cfg, resume_path=args.resume, max_steps=args.max_steps)


if __name__ == "__main__":
    main()
