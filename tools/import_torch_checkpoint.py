#!/usr/bin/env python
"""Convert a reference-framework PyTorch checkpoint (.pth) into a native
nerf_jax checkpoint that eval.py / train.py --resume accept:

    python tools/import_torch_checkpoint.py \
        --config config_lego.txt --checkpoint nerf_model_300000.pth \
        --out ./models

The config file must be the one the torch run trained with (same
architecture keys); the checkpoint's own model_type/step win, exactly
like native resume semantics.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", required=True, help=".pth file")
    parser.add_argument("--out", default="./models")
    args = parser.parse_args(argv)

    from nerf_jax.utils.platform import setup_compilation_cache

    setup_compilation_cache()
    from nerf_jax.config import parse_config_file
    from nerf_jax.utils.torch_import import import_torch_checkpoint

    cfg = parse_config_file(args.config)
    os.makedirs(args.out, exist_ok=True)
    path = import_torch_checkpoint(args.checkpoint, cfg, args.out)
    print(f"Imported {args.checkpoint} -> {path}")
    print("Use it like any native checkpoint: "
          f"python eval.py --config {args.config} --checkpoint {path}")


if __name__ == "__main__":
    main()
