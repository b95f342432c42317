"""Training state pytree.

The whole state — step counter, coarse/fine params, optimizer state — is a
single pytree, so one jitted step function threads it with buffer donation
(in-place updates in device memory) and one call checkpoints it.
``fine_params`` is an empty dict when hierarchical sampling is off, keeping
the pytree structure static across configurations.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from nerf_jax.models.registry import model_from_config
from nerf_jax.train.optim import make_optimizer


class TrainState(NamedTuple):
    step: jax.Array          # int32 scalar
    params: Any              # coarse (or only) model params
    fine_params: Any         # fine model params, or {} when coarse-only
    opt_state: Any           # optax state over (params, fine_params)


def create_train_state(cfg, key: jax.Array):
    """Build (model, optimizer, initial TrainState) from a Config."""
    model = model_from_config(cfg)
    k1, k2 = jax.random.split(key)
    params = model.init(k1)
    if cfg.num_fine_samples > 0 and cfg.separate_fine_model:
        fine_params = model.init(k2)
    else:
        fine_params = {}
    tx = make_optimizer(cfg)
    opt_state = tx.init((params, fine_params))
    state = TrainState(
        step=jnp.zeros((), jnp.int32),
        params=params,
        fine_params=fine_params,
        opt_state=opt_state,
    )
    return model, tx, state
