"""Test environment: the CPU with 8 virtual devices, so multi-device sharding
tests run on a single host (SURVEY §4: mesh-over-local-devices test strategy)
and the Pallas kernels run in interpret mode.

`python -m pytest -m gpu tests/test_gpu_hardware.py` keeps JAX's default
platform instead, so the GPU-marked tests see the card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_threefry_partitionable", True)


def pytest_configure(config):
    if config.getoption("markexpr") != "gpu":
        jax.config.update("jax_platforms", "cpu")
