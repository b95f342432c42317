"""Multi-scene training CLI:

    python -m nerf_jax.cli.multiscene_cli --config base.txt \
        --scenes ./datasets/lego ./datasets/chair ./datasets/drums ./datasets/ship

Trains one model per scene concurrently (scene axis sharded over the mesh;
BASELINE.json config 5)."""

from __future__ import annotations

import argparse

from nerf_jax.config import parse_config_file
from nerf_jax.train.multiscene_loop import fit_multiscene


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Train NeRF on several scenes concurrently."
    )
    parser.add_argument("--config", type=str, required=True,
                        help="Shared config (schedule/model)")
    parser.add_argument("--scenes", type=str, nargs="+", required=True,
                        help="Dataset paths, one per scene")
    parser.add_argument("--resume", type=str, default=None,
                        help="Stacked multi-scene checkpoint to resume from")
    parser.add_argument("--max-steps", type=int, default=None)
    args = parser.parse_args(argv)

    from nerf_jax.utils.platform import setup_compilation_cache

    setup_compilation_cache()
    cfg = parse_config_file(args.config)
    fit_multiscene(cfg, args.scenes, resume_path=args.resume,
                   max_steps=args.max_steps)


if __name__ == "__main__":
    main()
