"""Test configuration: run everything on a virtual 8-device CPU mesh.

Sharding correctness is validated on XLA's host platform with 8 virtual
devices.  JAX_PLATFORMS picks the platform; unset, the tests run on the
CPU.  Tests that need the GPU carry the ``gpu`` marker and skip on the CPU
(the ``gpu`` fixture decides at run time); on a GPU machine run them with

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from hcmvs_tpu.utils.compile_cache import enable_compile_cache

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
# persistent compilation cache: the dense sweeps compile in tens of
# seconds on CPU and dominate suite time; cached executables survive
# across test processes and runs
enable_compile_cache()

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where none is present."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU (JAX_PLATFORMS=cuda,cpu pytest -m gpu)")
    return devs[0]


@pytest.fixture
def eight_devices():
    """Skips unless 8 devices exist (the virtual CPU mesh provides them)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    return jax.devices()[:8]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Free compiled executables between test modules: a single pytest
    process accumulates every module's jit programs (hundreds of MB of
    CPU executables + 8-device arrays) and starts thrashing; with the
    persistent compilation cache, re-loading is cheap."""
    yield
    jax.clear_caches()

