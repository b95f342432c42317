"""The compile-cache rule (utils/platform.py): JAX_COMPILATION_CACHE_DIR
wins and the code sets no directory; unset, the cache is the fixed
<repo>/.jax_compile_cache."""

import os

import jax
import pytest

from nerf_jax.utils import platform


@pytest.fixture
def updates(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.__setitem__(name, value))
    return calls


def test_env_dir_is_left_to_jax(monkeypatch, updates, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    platform.setup_compilation_cache()
    assert "jax_compilation_cache_dir" not in updates


def test_unset_env_uses_repo_cache(monkeypatch, updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    platform.setup_compilation_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert updates["jax_compilation_cache_dir"] == os.path.join(
        repo, ".jax_compile_cache")
