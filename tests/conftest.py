"""Test configuration: force an 8-virtual-device CPU platform so that
multi-device sharding paths are exercised without accelerator hardware
(SURVEY.md §4: the reference has no distributed tests; we simulate a mesh
on CPU).  Tests marked ``gpu`` need a CUDA device and run on the GPU
machine with ``DS_TEST_GPU=1 python -m pytest tests -m gpu``; elsewhere
their ``gpu`` fixture skips them.
"""

import os

if os.environ.get("DS_TEST_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if os.environ.get("DS_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: multi-minute tests (skipped by default; run with "
        "DS_RUN_SLOW=1 or -m slow)",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device (run with DS_TEST_GPU=1 -m gpu on the "
        "GPU machine; the gpu fixture skips it elsewhere)",
    )


def pytest_collection_modifyitems(config, items):
    """Default runs skip @pytest.mark.slow so the suite stays under ~5 min
    on a small CPU box; DS_RUN_SLOW=1 (or an explicit -m selection) runs
    everything."""
    if os.environ.get("DS_RUN_SLOW") == "1" or config.getoption("-m"):
        return
    skip = pytest.mark.skip(reason="slow (set DS_RUN_SLOW=1 or -m slow)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture()
def rng():
    return np.random.RandomState(11)


@pytest.fixture()
def gpu():
    """The first CUDA device; skips the test when JAX has none."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA device (DS_TEST_GPU=1 on the GPU machine)")
    return jax.devices()[0]
