"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-device sharding is validated without several accelerators via the
standard JAX trick: force the host platform to expose 8 virtual CPU devices.
The XLA flag must be set before jax's backend initializes.

Tests marked ``gpu`` need a card; the ``gpu_device`` fixture decides at run
time whether one is present and skips otherwise.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first GPU, for tests marked ``gpu``; skips where JAX has none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU: JAX sees no gpu platform here")
