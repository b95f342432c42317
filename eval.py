#!/usr/bin/env python
"""Root entry point: ``python eval.py --config <file> --checkpoint <ckpt>
[--output <dir>]`` — same usage as the reference (/root/reference/eval.py)."""

from nerf_jax.cli.eval_cli import main

if __name__ == "__main__":
    main()
