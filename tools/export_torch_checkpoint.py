#!/usr/bin/env python
"""Convert a native nerf_jax checkpoint into a reference-framework
PyTorch checkpoint (.pth) the reference's own eval.py / train.py --resume
accept (inverse of tools/import_torch_checkpoint.py):

    python tools/export_torch_checkpoint.py \
        --config config_lego.txt --checkpoint ./models/nerf_model_300000 \
        --out nerf_model_300000.pth

The config must describe the trained architecture; the checkpoint's own
model_type/step win, exactly like native resume semantics. Only the two
reference families (nerf, siren) can travel. ``--fine`` exports the
hierarchical fine network instead of the coarse one.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", required=True,
                        help="native checkpoint directory")
    parser.add_argument("--out", required=True, help=".pth output path")
    parser.add_argument("--fine", action="store_true",
                        help="export the fine network instead of the coarse")
    args = parser.parse_args(argv)

    from nerf_jax.utils.platform import setup_compilation_cache

    setup_compilation_cache()
    from nerf_jax.config import parse_config_file
    from nerf_jax.utils.torch_export import export_torch_checkpoint

    cfg = parse_config_file(args.config)
    path = export_torch_checkpoint(args.checkpoint, cfg, args.out,
                                   use_fine=args.fine)
    print(f"Exported {args.checkpoint} -> {path}")
    print("Load it with the reference's own tooling: "
          f"python eval.py --config <ref config> --checkpoint {path}")


if __name__ == "__main__":
    main()
