"""Test configuration: the CPU backend with 8 virtual devices (unless
JAX_PLATFORMS names another), so the multi-device sharding paths run
without accelerators.  Tests that need the card carry the `gpu` marker
and skip elsewhere (see the `gpu_device` fixture); on the card run them
with `JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`.  Their checks
also run there as chip_smoke.py phase (b).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# Segmented scenario execution: membership and index share the similarity
# and compare jit segments (and approaches with equal shapes share compare
# compilations), so the suite compiles far less than with one monolithic
# XLA program per scenario.
os.environ.setdefault("IMTPU_FORCE_SEGMENTS", "1")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax
import pytest

from image_matching.utils.jaxcfg import enable_compilation_cache

enable_compilation_cache()


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip: decided when the test runs, never at
    import, so every xdist worker collects the same tests."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run on the card: python chip_smoke.py)")
    return devs[0]
