"""Tracing / profiling (SURVEY.md §5: the reference has none — only
wall-clock formatting at utils.py:37-47; this build adds real tooling).

- ``trace(logdir)``: capture a jax.profiler trace viewable in
  TensorBoard / Perfetto.
- ``Throughput``: a rays/sec (and points/sec) counter with warmup skip,
  the BASELINE.json primary metric, suitable for the training loop.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block: ``with trace('./logs/profile'): step()``."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclass
class Throughput:
    """Streaming rays/s counter. Call ``update(num_rays)`` once per step;
    read ``rays_per_sec``. The first ``warmup`` steps (compile) are skipped.

    Host work that is not training (validation renders, checkpoint saves)
    must be wrapped in ``with throughput.exclude():`` so the logged rays/s
    reflects train-step throughput only, not the event schedule.
    """

    warmup: int = 2
    _steps: int = 0
    _rays: int = 0
    _t0: float = field(default=0.0)
    _excluded: float = field(default=0.0)

    def update(self, num_rays: int) -> None:
        self._steps += 1
        if self._steps == self.warmup:
            self._t0 = time.perf_counter()
            self._rays = 0
            self._excluded = 0.0
        elif self._steps > self.warmup:
            self._rays += num_rays

    @contextlib.contextmanager
    def exclude(self):
        """Stop the clock for the enclosed block (validation/checkpoint)."""
        t = time.perf_counter()
        try:
            yield
        finally:
            if self._steps >= self.warmup:
                self._excluded += time.perf_counter() - t

    @property
    def rays_per_sec(self) -> float:
        if self._steps <= self.warmup or self._t0 == 0.0:
            return 0.0
        dt = time.perf_counter() - self._t0 - self._excluded
        return self._rays / dt if dt > 0 else 0.0
