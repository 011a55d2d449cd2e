"""General utilities: channel selection, audio coercion, wall-clock
benchmarking, pipeline tracing, runtime set-up.

(The host-side file helpers live in ``io.utils``; the tracing machinery in
``runtime.tracing`` — re-exported here as the framework's utility surface,
mirroring the reference's ``local/utils.py``.)
"""

from __future__ import annotations

import logging
import os
import struct

from ..io.utils import benchmark, in_offline_mode, select_channels, squeeze_audio_to_float64  # noqa: F401
from ..runtime.tracing import StageTracer, activate_timing, timing_active  # noqa: F401

logger = logging.getLogger("utils")


# Persistent compile cache used when JAX_COMPILATION_CACHE_DIR is unset: one
# fixed directory in the checkout (listed in .gitignore).  The path is part of
# the cache key, so it must not move between runs.
_DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def compile_cache_dir(environ=None) -> str:
    """The compile-cache directory in use: ``JAX_COMPILATION_CACHE_DIR`` when
    set, else the fixed in-checkout default."""
    environ = os.environ if environ is None else environ
    return environ.get("JAX_COMPILATION_CACHE_DIR") or _DEFAULT_CACHE_DIR


def setup_runtime() -> str:
    """Runtime set-up shared by every entry point (CLIs, bench, smoke, demo).

    Platform selection is left to JAX (``JAX_PLATFORMS``); the CPU backend
    stays reachable beside an accelerator for the code that stages on it on
    purpose.  The persistent compile cache goes where
    ``JAX_COMPILATION_CACHE_DIR`` says (JAX reads it; nothing is set here),
    otherwise to the fixed in-checkout directory.  Call before the first
    compilation.  Returns the cache directory in use.
    """
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path


def check_if_python_shell_is_x64() -> bool:
    """Warn on 32-bit interpreters (reference utils.py:78-84)."""
    mode = struct.calcsize("P") * 8
    if mode != 64:
        logger.warning("Python shell is running in x%d, not x64; large "
                       "recordings may exhaust memory.", mode)
        return False
    return True


def dtw_warping(query_spec, reference):
    """Re-export of the DTW warping helper (reference utils.py:124-138)."""
    from ..eval.dtw import dtw_warping as _dtw

    return _dtw(query_spec, reference)
