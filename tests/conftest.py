"""Test configuration: the JAX CPU backend with 8 virtual devices.

Tests run on the host CPU unless ``JAX_PLATFORMS`` says otherwise, with
a virtual 8-device mesh for the sharding tests.  Tests marked ``gpu``
need the card; on a GPU machine run them with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os
import sys

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
if "--xla_force_host_platform_device_count" not in os.environ["XLA_FLAGS"]:
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REFERENCE_DATA = "/root/reference/tests"


def reference_path(*parts: str) -> str:
    return os.path.join(REFERENCE_DATA, *parts)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided per test, not at import)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda)")
