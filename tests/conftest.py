"""Test environment: the CPU backend with 8 virtual devices, so that
sharding/collective tests run on any machine (SURVEY.md §4's
distributed-testing stand-in). Must run before jax is imported anywhere.

`JAX_PLATFORMS=cuda` keeps the GPU instead; that is how the
`gpu`-marked tests run on a card:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/

Whether a card is present is decided inside the `gpu_device` fixture,
never at import or collection time.
"""

import os
import sys

import pytest

ON_CUDA = os.environ.get("JAX_PLATFORMS") == "cuda"
if not ON_CUDA:
    # pin the CPU even where a GPU plugin is installed
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: run `JAX_PLATFORMS=cuda python "
                    "-m pytest -m gpu tests/` on the card")
    return dev


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: reference-scale soak tests (30k-iteration fuzz, ~100MB "
        "corpus gates); run with -m slow")
    config.addinivalue_line(
        "markers",
        "gpu: runs the device path at real size on an NVIDIA GPU; skips "
        "without one (see the gpu_device fixture)")


def pytest_collection_modifyitems(config, items):
    if config.getoption("-m"):
        return
    skip = pytest.mark.skip(reason="slow soak; run with -m slow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
