from nerf_jax.utils.metrics import mse_to_psnr
from nerf_jax.utils.timer import format_elapsed_time
from nerf_jax.utils.logging import MetricLogger
from nerf_jax.utils.checkpoint import (
    save_checkpoint,
    load_checkpoint,
    latest_checkpoint,
)

__all__ = [
    "mse_to_psnr",
    "format_elapsed_time",
    "MetricLogger",
    "save_checkpoint",
    "load_checkpoint",
    "latest_checkpoint",
]
