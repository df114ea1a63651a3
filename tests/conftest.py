"""Test config: force CPU with 8 virtual devices so sharding tests run on any
host (SURVEY.md §4 item 6). Tests marked ``gpu`` need an NVIDIA GPU and skip
here; see the README for the command that runs them on the card."""

import os

# Must be set before jax backends initialize; the config update below also
# covers a jax that was imported before this file.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (runs chip_smoke.py on the card)"
    )


@pytest.fixture
def rng():
    return np.random.default_rng(0)
