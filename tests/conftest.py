"""Test configuration.

By default JAX is held to a local CPU backend with 8 virtual devices, so the
suite is fast and the multi-device tests run without accelerators, and the
persistent compilation cache is off so runs leave nothing behind.

Tests marked ``gpu`` need a GPU. They skip on the CPU and run, on a GPU
machine, with:

    python -m pytest tests/test_gpu.py -m gpu --gpu
"""

import os

import jax
import pytest


def pytest_addoption(parser):
    parser.addoption("--gpu", action="store_true", default=False,
                     help="leave JAX's platform choice alone (run tests marked gpu)")


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a GPU; run with --gpu on a GPU machine")
    jax.config.update("jax_enable_compilation_cache", False)
    if config.getoption("--gpu"):
        return
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)


@pytest.fixture
def gpu():
    """The first GPU; skips the test where JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX has {dev.platform}); run with --gpu on a GPU machine")
    return dev
