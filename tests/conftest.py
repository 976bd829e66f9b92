"""Test configuration: run everything on a virtual 8-device CPU platform.

The JAX-standard way to test multi-device sharding code without a cluster
(SURVEY.md §4.4): the same shard_map/psum code paths run on 8 host devices;
correctness there implies the collectives are wired right.  Must run before
jax is imported anywhere.

Tests that need a GPU carry the ``gpu`` marker and take the ``gpu``
fixture, which skips them when JAX's default device is not a GPU.  On a
card they run with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``
(``chip_smoke.py`` runs them in its last phase).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng_np():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """The default JAX device, when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; default device is {dev.platform}")
    return dev
