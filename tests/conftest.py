"""Test harness configuration.

Tests run on the CPU with 8 virtual devices, so multi-device sharding paths
are exercised without accelerators. Tests marked ``gpu`` need an NVIDIA GPU:
they skip (inside the ``gpu_device`` fixture) anywhere else, and run with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` on a GPU machine;
``chip_smoke.py`` runs the same checks at full size.

Env vars must be set before jax is first imported anywhere.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax
import numpy as np
import pytest

from singlet_tpu.utils import enable_compilation_cache

enable_compilation_cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips elsewhere")


@pytest.fixture
def rng():
    return np.random.default_rng(999)


@pytest.fixture
def gpu_device():
    """The first CUDA device; skips the test when there is none."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (runs on the card: "
                    "JAX_PLATFORMS=cuda python -m pytest -m gpu tests/)")
    return gpus[0]
