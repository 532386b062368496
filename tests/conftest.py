"""Test config: run on a virtual 8-device CPU mesh.

The suite runs on the CPU: sharding tests use
--xla_force_host_platform_device_count=8 (SURVEY.md's multi-chip test
strategy: both ends in one process, like the reference's ipcpipeline tests).
Tests marked `gpu` need the card and skip here; `chip_smoke.py` runs them
on a GPU with `--gpu`, which leaves the platform alone.
"""

import os

import jax
import numpy as np
import pytest


def pytest_addoption(parser):
    parser.addoption("--gpu", action="store_true",
                     help="keep JAX's default platform (run on the GPU) "
                          "instead of forcing the CPU")


def pytest_configure(config):
    if config.getoption("--gpu"):
        return
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (a kernel compiled for the card has
    no CPU form); chip_smoke.py runs these tests on the card."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: chip_smoke.py runs this on the card")


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
