from nerf_jax.train.state import TrainState, create_train_state
from nerf_jax.train.optim import make_optimizer, lr_schedule
from nerf_jax.train.step import make_train_step, make_eval_render
from nerf_jax.train.loop import fit

__all__ = [
    "TrainState",
    "create_train_state",
    "make_optimizer",
    "lr_schedule",
    "make_train_step",
    "make_eval_render",
    "fit",
]
