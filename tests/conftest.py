"""Test environment.

By default the tests run on the CPU backend with 8 virtual devices, so the
multi-device paths (mesh, shard_map, GSPMD) are exercised without a card.

``NERF_JAX_TEST_GPU=1`` leaves the backend to JAX instead; together with
``-m gpu`` it runs the tests that need a CUDA GPU (they take the ``gpu``
fixture, which skips them anywhere else):

    NERF_JAX_TEST_GPU=1 python -m pytest tests/ -m gpu
"""

import os

if os.environ.get("NERF_JAX_TEST_GPU") != "1":
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng_key():
    return jax.random.key(42)


@pytest.fixture(scope="session")
def gpu():
    """The first device, when it is a CUDA GPU; skips the test otherwise."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip("needs a CUDA GPU: NERF_JAX_TEST_GPU=1 pytest -m gpu")
    return device
