#!/usr/bin/env python
"""Root entry point: ``python train.py --config <file> [--resume <ckpt>]`` —
same usage as the reference trainer (/root/reference/train.py)."""

from nerf_jax.cli.train_cli import main

if __name__ == "__main__":
    main()
