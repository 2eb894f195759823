"""Test bootstrap: force an 8-device CPU simulator (SURVEY.md §4.4).

The suite runs on the CPU, with Pallas kernels in interpret mode. Tests that
need the GPU carry the `gpu` marker and take the `gpu` fixture, which skips
them with a reason when JAX has no GPU; that is decided inside the fixture,
never at import, so every xdist worker collects the same tests. On the GPU
machine, `JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu` runs them (and
`python chip_smoke.py` the whole chip path; see README).
"""

import os

import jax
import pytest

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

# persistent compile cache: the suite is compile-bound; jitted programs
# (render_banded bands, grad programs, …) reload across runs. Its own fixed
# directory (unless JAX_COMPILATION_CACHE_DIR is set), apart from the CLI's.
from raytracer.utils.cache import CHECKOUT, setup_compile_cache  # noqa: E402

setup_compile_cache(os.path.join(CHECKOUT, ".jax_cache_tests"))


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs an NVIDIA GPU")
    config.addinivalue_line("markers", "slow: long-running test")


@pytest.fixture
def gpu():
    """The GPU, or a skip with the reason when JAX has none."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX has {devices[0].platform}")
    return devices[0]
