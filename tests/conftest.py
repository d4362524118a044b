"""Run the tests on the XLA CPU backend with an 8-device virtual mesh (the
POCL-on-CI analog, SURVEY.md §4): the same code paths as the GPU, with
Pallas kernels in interpret mode.

A run that selects the ``gpu`` marker (``pytest -m gpu``, as chip_smoke.py
does on the card) keeps JAX's own platform."""

import os

import pytest


def pytest_configure(config):
    if (config.getoption("markexpr", "") or "").strip() == "gpu":
        return
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run via chip_smoke.py on the card)")
    return dev
