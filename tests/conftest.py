"""Test configuration: hermetic CPU backend with 8 virtual devices.

Tests run on the CPU backend by default, so the suite needs no GPU and the
multi-device sharding paths run on a virtual 8-device mesh
(`--xla_force_host_platform_device_count=8`).  The Pallas GPU kernel runs
in the Pallas interpreter there.  Tests marked ``gpu`` need a card: run
them on one with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``;
elsewhere the ``gpu`` fixture skips them.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import numpy as np
import pytest


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda on a card)")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)
