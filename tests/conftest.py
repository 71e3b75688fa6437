"""Test harness: force the CPU backend with 8 virtual devices so sharding
tests exercise a real multi-device mesh without an accelerator.

Tests that need an NVIDIA card are marked `gpu` and take the `gpu` fixture,
which skips them unless JAX runs on a GPU.  On a machine with a card they
run with `PD_TEST_GPU=1 python -m pytest -m gpu tests/`, which leaves JAX its
default backend.  Whether a card is present is decided inside the fixture,
never while a module is imported.
"""
import os

import pytest

if os.environ.get("PD_TEST_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if os.environ.get("PD_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: PD_TEST_GPU=1 python -m pytest "
                    "-m gpu tests/ on a machine with a card")
