"""Import the reference's PyTorch checkpoints (switching path).

The reference saves ``{step, model_type, model_state_dict, ...}`` to
``{model_type}_model_{step:06d}.pth`` (reference: nerf/utils.py:50-63).
A user switching frameworks brings those files along; this module maps
the state dicts onto nerf_jax's parameter pytrees and re-saves them as a
native (.npz) checkpoint that ``eval.py`` / ``train.py --resume`` accept
unchanged.

Weight convention: torch ``nn.Linear`` stores (out, in); this repo stores
(in, out) — every matrix transposes (models/common.py docstring). Layer
maps mirror the reference modules exactly:

  NeRF  (models.py:9-75):   block1.{0,2,4,6,8}, block2.{0,2,4,6,8},
                            rgb_head.{0,2}            -> block1/block2/rgb
  Siren (models.py:93-203): block1.{i}.layer, density_branch.0,
                            feature_remap.0, rgb_head.0.layer, rgb_head.1
                            -> base/sigma/remap/rgb0/rgb1

Optimizer MOMENTS are not ported (fresh Adam), but the imported ``step``
is written into the TrainState and the optimizer's count leaves, so a
``--resume`` fine-tune continues the LR schedule (and the step-keyed PRNG
stream) from where the torch run left off instead of re-applying the
step-0 learning rate to converged weights.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def _lin(sd: dict, prefix: str) -> dict:
    w = np.asarray(sd[f"{prefix}.weight"], np.float32)
    b = np.asarray(sd[f"{prefix}.bias"], np.float32)
    return {"w": jnp.asarray(w.T), "b": jnp.asarray(b)}


def nerf_params_from_state_dict(sd: dict) -> dict:
    """Reference ``NeRF.state_dict()`` -> ``NeRFModel`` param pytree."""
    return {
        "block1": [_lin(sd, f"block1.{i}") for i in (0, 2, 4, 6, 8)],
        "block2": [_lin(sd, f"block2.{i}") for i in (0, 2, 4, 6, 8)],
        "rgb": [_lin(sd, f"rgb_head.{i}") for i in (0, 2)],
    }


def siren_params_from_state_dict(sd: dict, num_layers: int = 8) -> dict:
    """Reference ``Siren.state_dict()`` -> ``SirenModel`` param pytree."""
    return {
        "base": [_lin(sd, f"block1.{i}.layer") for i in range(num_layers)],
        "sigma": _lin(sd, "density_branch.0"),
        "remap": _lin(sd, "feature_remap.0"),
        "rgb0": _lin(sd, "rgb_head.0.layer"),
        "rgb1": _lin(sd, "rgb_head.1"),
    }


_CONVERTERS = {
    "nerf": nerf_params_from_state_dict,
    "siren": siren_params_from_state_dict,
}


def params_from_state_dict(model_type: str, sd: dict) -> dict:
    model_type = model_type.lower()
    if model_type not in _CONVERTERS:
        raise ValueError(
            f"cannot import model_type '{model_type}' from a torch "
            f"checkpoint (reference families: {sorted(_CONVERTERS)})"
        )
    return _CONVERTERS[model_type](sd)


def import_torch_checkpoint(pth_path: str, cfg, save_path: str) -> str:
    """Convert a reference ``.pth`` into a native checkpoint directory
    under ``save_path`` (returns its path). ``cfg`` must describe the same
    architecture the torch run used (the reference reads the same config
    keys), because the restored pytree must match ``create_train_state``'s
    shapes — mismatches raise with the offending layer."""
    import torch

    from nerf_jax.train.state import create_train_state
    from nerf_jax.utils.checkpoint import save_checkpoint

    ckpt = torch.load(pth_path, map_location="cpu", weights_only=True)
    model_type = str(ckpt.get("model_type", cfg.model_type)).lower()
    step = int(ckpt.get("step", 0))
    sd = {k: v.numpy() for k, v in ckpt["model_state_dict"].items()}
    params = params_from_state_dict(model_type, sd)

    import dataclasses
    import jax

    cfg = dataclasses.replace(cfg, model_type=model_type)
    model, _, state = create_train_state(cfg, jax.random.key(cfg.seed))
    ref = jax.tree.map(lambda a: (a.shape, a.dtype), state.params)
    got = jax.tree.map(lambda a: (a.shape, a.dtype), params)
    if ref != got:
        raise ValueError(
            "imported parameters do not match the configured architecture:\n"
            f"  config expects: {ref}\n  checkpoint has: {got}"
        )
    state = state._replace(params=params)
    if state.fine_params:
        # the reference has no hierarchical fine network; start the fine
        # pass from the imported coarse weights (better than random)
        state = state._replace(fine_params=params)
    # continue the run where torch left it: step drives the PRNG/epoch
    # stream, and Adam's 0-d int32 count leaves drive the LR schedule
    state = state._replace(
        step=jnp.asarray(step, jnp.int32),
        opt_state=jax.tree.map(
            lambda x: (jnp.full_like(x, step)
                       if (hasattr(x, "dtype") and x.dtype == jnp.int32
                           and x.ndim == 0) else x),
            state.opt_state,
        ),
    )
    return save_checkpoint(state, save_path, model_type, step)
