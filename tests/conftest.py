"""Test config: force CPU with 8 virtual devices for sharding tests.

Must run before any jax import (hence module-top env mutation here).
Tests marked ``gpu`` request the ``gpu_device`` fixture, which skips them
when no CUDA device is present (decided at run time, never at import).
"""

import os
import sys

if not os.environ.get("JAX_PLATFORMS"):
    os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402


@pytest.fixture
def gpu_device():
    """The first CUDA device, or skip (the suite runs on the CPU unless
    JAX_PLATFORMS names cuda, e.g. ``JAX_PLATFORMS=cuda,cpu``)."""
    import jax

    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("no CUDA GPU (on the card: JAX_PLATFORMS=cuda,cpu pytest -m gpu)")
    return devs[0]
