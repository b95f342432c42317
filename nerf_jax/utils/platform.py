"""Persistent compilation cache for the CLIs and scripts.

One rule: when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it and this
module sets no directory; otherwise the cache lives at the fixed
``<repo>/.jax_compile_cache``. The path is part of every cache key, so a
directory that moved between runs would never hit.

The backend is JAX's own choice (``JAX_PLATFORMS=cpu`` forces the CPU).
"""

from __future__ import annotations

import os

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_compile_cache",
)


def setup_compilation_cache() -> None:
    """Enable JAX's persistent compilation cache (on-disk, keyed by program
    + compile options + backend version). Call before the first compile;
    the CLIs call it first thing in ``main``."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    # default min_compile_time is 1s; keep it (sub-second programs are
    # cheaper to recompile than to hash+stat), but cache every size
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
