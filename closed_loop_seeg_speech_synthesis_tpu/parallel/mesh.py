"""Device mesh construction and shardings.

The reference has no multi-device compute (SURVEY.md §2: its only transports
are LSL between machines and multiprocessing pipes on one host).  This
framework scales two ways:

* ``data`` axis — embarrassingly parallel replay/evaluation fan-out: CV
  folds, chance-level randomization runs (the reference serializes these in a
  ThreadPool(1), exp1.py:111,142), multi-session training.
* ``model`` axis — sEEG channel sharding: the filter chain, log-power and
  context stacking are channel-independent, so features compute with zero
  communication; the single cross-shard edge is the all-gather of stacked
  features before feature selection / the LDA matmul (stacked features are
  channel-major, so a channel shard owns a contiguous feature block).
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, model_axis: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    if len(devs) < n:
        raise ValueError(
            f"make_mesh: requested {n} devices but only {len(devs)} exist "
            f"(backend={jax.default_backend()!r}). For a virtual multi-device "
            "CPU mesh, set XLA_FLAGS=--xla_force_host_platform_device_count=N "
            "and jax.config.update('jax_platforms', 'cpu') before any jax use."
        )
    devs = devs[:n]
    if model_axis is None:
        model_axis = 2 if n % 2 == 0 and n > 1 else 1
    if n % model_axis != 0:
        raise ValueError(f"make_mesh: model_axis={model_axis} does not divide n={n}")
    data_axis = n // model_axis
    grid = np.asarray(devs).reshape(data_axis, model_axis)
    return Mesh(grid, ("data", "model"))


def session_sharding(mesh: Mesh) -> NamedSharding:
    """(B, T, C) sessions: batch over data, channels over model."""
    return NamedSharding(mesh, P("data", None, "model"))


def feature_sharding(mesh: Mesh) -> NamedSharding:
    """(B, N, F) stacked features: channel-major F shards over model."""
    return NamedSharding(mesh, P("data", None, "model"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
