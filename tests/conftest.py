"""Test configuration: CPU backend with 8 virtual devices by default.

Multi-device code paths (Mesh/shard_map/collectives) run on
XLA-force-host-platform devices, the standard JAX trick for testing
distributed code without several cards (SURVEY.md section 4 item 5).
Tests marked ``gpu`` need the card; they take the ``gpu`` fixture,
skip elsewhere, and run on the card with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# x64 enabled so gradient-vs-finite-difference checks can run in f64
# (the 1e-3 BASELINE tolerance is unreachable in f32 FD).  Renderer
# code derives dtypes from scene arrays, so f32 scenes still exercise
# the f32 path.
jax.config.update("jax_enable_x64", True)

from solstice.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache(min_compile_secs=0.5)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided per test,
    never while modules are imported)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda "
                    "python -m pytest -m gpu tests/")
