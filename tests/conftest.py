"""Test configuration: the CPU backend with an 8-device virtual mesh and x64.

The tests run on the host (``JAX_PLATFORMS=cpu``); golden-value parity with
the Float64 reference needs x64. The sharding tests use a virtual 8-device
CPU mesh. Tests marked ``chip`` need a GPU and skip elsewhere.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
if "xla_cpu_use_fusion_emitters" not in flags:
    # jaxlib 0.9.0 XLA:CPU fusion emitters infinite-loop on the df64 barrier
    # graphs (see mgbtpu/_config.py)
    flags = (flags + " --xla_cpu_use_fusion_emitters=false").strip()
os.environ["XLA_FLAGS"] = flags
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", True)

# persistent compile cache: the dd Newton/ramp programs take minutes of
# XLA:CPU compile; cache them across test processes (JAX_COMPILATION_CACHE_DIR
# wins, else the checkout's fixed cache directory).
from mgbtpu._config import enable_compile_cache  # noqa: E402

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX finds none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU (run on the card with "
                    "`python -m pytest -m chip tests/`)")
