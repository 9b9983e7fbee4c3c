"""Test env: force the CPU backend with 8 virtual devices — the "fake
backend" (SURVEY §4): multi-chip sharding tests run on any host, and
unit tests are hermetic.

jax may already be imported when this file runs, so the platform is
also set through jax.config.update, which works as long as no backend
has been initialized yet.

Tests marked ``gpu`` need the card; the ``gpu_device`` fixture decides
at run time whether one exists and skips them here. The card's checks
run in ``python chip_smoke.py``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip where there is none (decided at run
    time, never at import, so every xdist worker collects the same
    tests)."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU; runs in `python chip_smoke.py` on the card")
    return gpus[0]
