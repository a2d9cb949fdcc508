"""Test configuration: 8 virtual CPU devices for the sharding tests.

Mirrors the reference test strategy (SURVEY.md §4): unit tests run on a fake
multi-device CPU mesh so multi-device sharding is exercised without a
cluster.  Run the suite with ``JAX_PLATFORMS=cpu``.  Tests marked ``gpu``
need a GPU; on a GPU machine run them with ``python -m pytest -m gpu``
(the ``gpu_device`` fixture skips them elsewhere).
"""
import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

from kaolin_tpu.utils import enable_compile_cache  # noqa: E402

# the suite is XLA-compile-bound on small hosts; reruns hit the cache
enable_compile_cache()


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where JAX has none."""
    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs a GPU (run: python -m pytest -m gpu)")
    return devices[0]
