"""Test configuration: run everything on a virtual 8-device CPU mesh.

Tests that need the GPU carry the `gpu` marker and take the `gpu`
fixture, which skips them when JAX finds no GPU. They run on the card
with `DASHING2_TPU_TESTS_ON_GPU=1 python -m pytest -m gpu tests/`; every
other run pins JAX to the CPU before any backend initializes.
"""

import os

import pytest

if os.environ.get("DASHING2_TPU_TESTS_ON_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if os.environ.get("DASHING2_TPU_TESTS_ON_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """The first JAX device, when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU (JAX found %s)" % dev.platform)
    return dev
