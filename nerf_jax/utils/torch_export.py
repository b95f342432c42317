"""Export native checkpoints to the reference's ``.pth`` format.

Inverse of :mod:`nerf_jax.utils.torch_import` — lets a user take a
JAX-trained nerf/siren model BACK into the reference's torch tooling.
The exported file carries the exact five-key layout the reference writes
(reference: nerf/utils.py:50-63) and loads through both reference paths:

  * ``eval.py:108-109`` — ``torch.load(..., weights_only=True)`` then
    ``model.load_state_dict(checkpoint["model_state_dict"])``;
  * ``train.py:143-149`` — resume, which additionally restores
    ``optimizer_state_dict`` / ``scheduler_state_dict`` and ``step``.

Weight convention: this repo stores (in, out); torch ``nn.Linear`` stores
(out, in) — every matrix transposes (mirror of torch_import). Key maps
reproduce the reference module layout exactly:

  NeRF  (models.py:9-75):   block1/block2/rgb -> block1.{0,2,4,6,8},
                            block2.{0,2,4,6,8}, rgb_head.{0,2}
  Siren (models.py:93-203): base/sigma/remap/rgb0/rgb1 ->
                            block1.{i}.layer, density_branch.0,
                            feature_remap.0, rgb_head.0.layer, rgb_head.1

Adam MOMENTS are exported too when the native optimizer state is present:
optax's ``scale_by_adam`` keeps the same raw EMAs torch Adam does
(mu = exp_avg, nu = exp_avg_sq, count = step), so a reference resume
continues optimization exactly rather than restarting the moments. The
state dict is built around a real ``torch.optim.Adam`` instance so its
``param_groups`` carry every hyperparameter key a reference
``load_state_dict`` + ``step()`` needs.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def nerf_state_dict_entries(params: dict):
    """Yield (torch_key_prefix, layer) pairs in reference ``NeRF``
    registration order (reference: nerf/models.py:25-57)."""
    for blk, idxs in (("block1", (0, 2, 4, 6, 8)),
                      ("block2", (0, 2, 4, 6, 8))):
        for lyr, i in zip(params[blk], idxs):
            yield f"{blk}.{i}", lyr
    for lyr, i in zip(params["rgb"], (0, 2)):
        yield f"rgb_head.{i}", lyr


def siren_state_dict_entries(params: dict):
    """Reference ``Siren`` registration order (nerf/models.py:163-183)."""
    for i, lyr in enumerate(params["base"]):
        yield f"block1.{i}.layer", lyr
    yield "density_branch.0", params["sigma"]
    yield "feature_remap.0", params["remap"]
    yield "rgb_head.0.layer", params["rgb0"]
    yield "rgb_head.1", params["rgb1"]


_ENTRY_MAPS = {
    "nerf": nerf_state_dict_entries,
    "siren": siren_state_dict_entries,
}


def state_dict_from_params(model_type: str, params: dict) -> dict:
    """Native param pytree -> reference-keyed torch state_dict
    (transposed to torch's (out, in) Linear layout)."""
    import torch

    model_type = model_type.lower()
    if model_type not in _ENTRY_MAPS:
        raise ValueError(
            f"cannot export model_type '{model_type}' to a reference "
            f".pth (reference families: {sorted(_ENTRY_MAPS)})"
        )
    sd = {}
    for prefix, lyr in _ENTRY_MAPS[model_type](params):
        sd[f"{prefix}.weight"] = torch.from_numpy(_np(lyr["w"]).T.copy())
        sd[f"{prefix}.bias"] = torch.from_numpy(_np(lyr["b"]).copy())
    return sd


def _find_adam_state(opt_state) -> Optional[Any]:
    """Locate the ScaleByAdamState (count/mu/nu) inside an optax state."""
    import optax

    found = []

    def walk(node):
        if isinstance(node, optax.ScaleByAdamState):
            found.append(node)
            return
        if isinstance(node, (tuple, list)):
            for x in node:
                walk(x)

    walk(opt_state)
    return found[0] if found else None


def _adam_state_dict(model_type: str, params: dict, step: int, cfg,
                     opt_state=None, params_index: int = 0) -> dict:
    """Build a torch ``Adam.state_dict()`` for the reference's optimizer
    (train.py:123: Adam(model.parameters(), lr=learning_rate)).

    ``param_groups`` come from a real Adam over shape-dummy leaves so every
    hyperparameter key is present and valid; per-param moments are filled
    from the optax state when given (param order = torch registration
    order = the state-dict entry order above, weights then biases)."""
    import torch

    flat = []
    for _, lyr in _ENTRY_MAPS[model_type](params):
        flat.append(("w", lyr))
        flat.append(("b", lyr))
    dummies = [torch.nn.Parameter(torch.zeros(1)) for _ in flat]
    opt = torch.optim.Adam(dummies, lr=float(cfg.learning_rate))
    sd = opt.state_dict()

    adam = _find_adam_state(opt_state) if opt_state is not None else None
    if adam is not None:
        mu, nu = adam.mu, adam.nu
        # the native optimizer runs over (params, fine_params); pick the
        # tree being exported
        if isinstance(mu, tuple) and len(mu) == 2:
            mu, nu = mu[params_index], nu[params_index]
        state = {}
        moment_entries = list(zip(_ENTRY_MAPS[model_type](mu),
                                  _ENTRY_MAPS[model_type](nu)))
        for i, ((_, m_lyr), (_, n_lyr)) in enumerate(moment_entries):
            for j, leaf in enumerate(("w", "b")):
                m = _np(m_lyr[leaf])
                n = _np(n_lyr[leaf])
                m = m.T.copy() if leaf == "w" else m.copy()
                n = n.T.copy() if leaf == "w" else n.copy()
                state[2 * i + j] = {
                    "step": torch.tensor(float(step)),
                    "exp_avg": torch.from_numpy(m),
                    "exp_avg_sq": torch.from_numpy(n),
                }
        sd["state"] = state
    return sd


def _scheduler_state_dict(step: int, cfg) -> dict:
    """A torch ``LambdaLR.state_dict()`` continuing the reference schedule
    (train.py:126-131) at ``step``. Built from a real LambdaLR so the key
    set matches what ``load_state_dict`` expects; LambdaLR excludes the
    lambda itself from its state, so only counters/base_lrs travel."""
    import torch

    gamma = float(cfg.lr_decay_factor) ** (1.0 / (float(cfg.lr_decay) * 1000.0))
    floor = float(cfg.lr_min) / float(cfg.learning_rate)
    dummy = [torch.nn.Parameter(torch.zeros(1))]
    opt = torch.optim.Adam(dummy, lr=float(cfg.learning_rate))
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lr_lambda=lambda s: max(gamma ** s, floor)
    )
    sd = sched.state_dict()
    sd["last_epoch"] = int(step)
    sd["_step_count"] = int(step) + 1
    sd["_last_lr"] = [float(cfg.learning_rate) * max(gamma ** step, floor)]
    return sd


def export_torch_checkpoint(ckpt_path: str, cfg, out_path: str,
                            use_fine: bool = False) -> str:
    """Convert a native checkpoint directory into a reference-format
    ``.pth`` at ``out_path`` (returns it). ``cfg`` must describe the
    architecture (same keys the checkpoint was trained with); the
    checkpoint's own ``model_type``/``step`` win, like native resume.

    ``use_fine=True`` exports the hierarchical fine network instead of the
    coarse one (the reference is coarse-only, so only one can travel)."""
    import dataclasses

    import jax
    import torch

    from nerf_jax.train.state import create_train_state
    from nerf_jax.utils.checkpoint import load_checkpoint, read_metadata

    meta = read_metadata(ckpt_path)
    model_type = str(meta.get("model_type", cfg.model_type)).lower()
    if model_type not in _ENTRY_MAPS:
        raise ValueError(
            f"cannot export model_type '{model_type}' to a reference "
            f".pth (reference families: {sorted(_ENTRY_MAPS)})"
        )
    cfg = dataclasses.replace(cfg, model_type=model_type)
    _, _, template = create_train_state(cfg, jax.random.key(cfg.seed))
    state = load_checkpoint(ckpt_path, template)
    step = int(state.step)

    params = state.fine_params if use_fine else state.params
    if use_fine and not state.fine_params:
        raise ValueError("checkpoint has no fine network to export")
    params_index = 1 if use_fine else 0

    ckpt = {
        "step": step,
        "model_type": model_type,
        "model_state_dict": state_dict_from_params(model_type, params),
        "optimizer_state_dict": _adam_state_dict(
            model_type, params, step, cfg, state.opt_state, params_index
        ),
        "scheduler_state_dict": _scheduler_state_dict(step, cfg),
    }
    torch.save(ckpt, out_path)
    return out_path
