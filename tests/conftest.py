"""Test configuration: CPU backend with an 8-device virtual mesh and x64.

Tests validate numerics against float64 NumPy/SciPy golden models and check
multi-chip sharding on a forced 8-device CPU mesh; the GPU path is exercised
by chip_smoke.py and bench.py on the card (tests marked ``gpu`` skip here).
"""

import os

# CPU unless the caller picked a platform (the GPU tests: -m gpu on the card)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
if "xla_cpu_collective_call_terminate_timeout_seconds" not in flags:
    # Virtualized CI hosts stall threads for tens of seconds (observed: an
    # all-reduce rendezvous "stuck" for 47 s that then completed fine).  The
    # default termination timeout turns such stalls into a hard process
    # abort inside the 8-virtual-device collective tests ("Termination
    # timeout for `all reduce` exceeded. Exiting to ensure a consistent
    # program state") — raise both collective timeouts far above any
    # plausible stall.
    flags += (" --xla_cpu_collective_call_terminate_timeout_seconds=1200"
              " --xla_cpu_collective_timeout_seconds=1200")
os.environ["XLA_FLAGS"] = flags

import jax

jax.config.update("jax_enable_x64", True)
# entry points called by the tests set a compile-cache directory
# (utils.setup_runtime); the suite itself caches nothing
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.RandomState(1234)


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default backend is a GPU (decided here,
    at run time, never while modules are imported)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: run python -m pytest tests/ -m gpu on the card")
    return jax.devices()[0]
