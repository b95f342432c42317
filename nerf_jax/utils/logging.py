"""Metric logging: console + TensorBoard.

Preserves the reference's observable behavior
(/root/reference/nerf/utils.py:66-77, train.py:133-138):
  * console line ``[HH:MM:SS] [Iter 0000000] LR: x MSE: y PSNR: z``
  * TB scalars ``loss``, ``psnr``, ``learning_rate`` plus ``val/psnr`` and
    the ``val/render`` image
  * log dir ``{log_dir}/{model_type}_{dataset}_{timestamp}`` with the config
    dumped as TB text

The TensorBoard writer is optional (train/test environments without
TensorBoard fall back to console-only) and metric values are fetched from
device asynchronously by the caller — this module only formats and writes.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np

from nerf_jax.utils.metrics import mse_to_psnr
from nerf_jax.utils.timer import format_elapsed_time


class MetricLogger:
    def __init__(
        self,
        log_dir: Optional[str] = None,
        model_type: str = "nerf",
        dataset_name: str = "scene",
        config_text: str = "",
        enable_tensorboard: bool = True,
        quiet: bool = False,
    ) -> None:
        self.start_time = datetime.datetime.now()
        self.writer = None
        self.log_path = None
        self.quiet = quiet  # non-primary processes: no console, no TB
        if log_dir is not None and enable_tensorboard and not quiet:
            timestamp = self.start_time.strftime("%Y-%m-%d_%H-%M-%S")
            self.log_path = os.path.join(
                log_dir, f"{model_type}_{dataset_name}_{timestamp}"
            )
            os.makedirs(self.log_path, exist_ok=True)
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.writer = SummaryWriter(log_dir=self.log_path)
                if config_text:
                    self.writer.add_text("config", config_text)
            except Exception as e:  # pragma: no cover - env without TB
                print(f"TensorBoard unavailable ({e}); console logging only.")

    def log_train(self, step: int, lr: float, mse: float) -> None:
        psnr = float(mse_to_psnr(float(mse)))
        elapsed = format_elapsed_time(self.start_time)
        self._write(
            f"[{elapsed}] [Iter {step:07d}] LR: {lr:.6f} "
            f"MSE: {float(mse):.4f} PSNR: {psnr:.2f}"
        )
        if self.writer is not None:
            self.writer.add_scalar("loss", float(mse), step)
            self.writer.add_scalar("psnr", psnr, step)
            self.writer.add_scalar("learning_rate", float(lr), step)

    def log_validation(self, step: int, psnr: float, image: np.ndarray) -> None:
        self._write(f"[Validation Step] Iter {step}  PSNR: {psnr:.2f}")
        if self.writer is not None:
            self.writer.add_scalar("val/psnr", float(psnr), step)
            img = np.clip(image, 0.0, 1.0).transpose(2, 0, 1)  # CHW
            self.writer.add_image("val/render", img, step)

    def log_scalar(self, tag: str, value: float, step: int) -> None:
        if self.writer is not None:
            self.writer.add_scalar(tag, float(value), step)

    def log_image(self, tag: str, image: np.ndarray, step: int) -> None:
        """TB image under an arbitrary tag (e.g. per-scene validation
        renders); same clip/CHW convention as ``log_validation``."""
        if self.writer is not None:
            img = np.clip(image, 0.0, 1.0).transpose(2, 0, 1)
            self.writer.add_image(tag, img, step)

    def _write(self, msg: str) -> None:
        if not self.quiet:
            print(msg)

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
