"""Test harness config: the suite runs on the CPU with a virtual 8-device
mesh, so sharding paths are exercised without several cards (SURVEY.md §4
multi-host-without-a-cluster recipe). Tests marked `gpu` need a card: run
them with `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`; elsewhere
their `gpu` fixture skips them."""

import os

# Must be set before jax initializes backends.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from orbslam2_tpu.utils import compile_cache  # noqa: E402

# persistent compile cache: repeated test runs skip XLA compilation
compile_cache.enable()
# full f32 matmuls, as `System` pins them (a GPU defaults to TF32)
jax.config.update("jax_default_matmul_precision", "highest")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided at run time, not import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda -m gpu)")
