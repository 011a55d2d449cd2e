"""Pipeline tracing (equivalent of the reference's opt-in DAG timing).

The reference hangs hidden timestamping Receivers off every node when
``Node.activate_timing()`` is set and collects them with
``get_timing_info()`` (Node.py:11-19,52-69,133-140).  This pipeline has
no node graph, so tracing hangs off named stages of the online loop instead:
packet arrival, device step dispatch/return, audio handoff.  Same public
shape: ``activate_timing()`` / ``get_timing_info() -> {stage: [(t, meta)]}``,
plus latency percentiles for the closed-loop budget (BASELINE.md p99 < 10ms).
"""

from __future__ import annotations

import collections
import time

import numpy as np

_ACTIVE = False


def activate_timing() -> None:
    global _ACTIVE
    _ACTIVE = True


def timing_active() -> bool:
    return _ACTIVE


class StageTracer:
    def __init__(self, enabled: bool | None = None):
        self.enabled = _ACTIVE if enabled is None else enabled
        self.events = collections.OrderedDict()

    def mark(self, stage: str, meta=None) -> float:
        t = time.perf_counter()
        if self.enabled:
            self.events.setdefault(stage, []).append((t, meta))
        return t

    def get_timing_info(self):
        return self.events

    def latencies(self, start_stage: str, end_stage: str) -> np.ndarray:
        a = np.asarray([t for t, _ in self.events.get(start_stage, [])])
        b = np.asarray([t for t, _ in self.events.get(end_stage, [])])
        n = min(len(a), len(b))
        return b[:n] - a[:n]

    def percentiles(self, start_stage: str, end_stage: str, qs=(50, 95, 99)):
        lat = self.latencies(start_stage, end_stage)
        if len(lat) == 0:
            return {q: float("nan") for q in qs}
        return {q: float(np.percentile(lat, q)) for q in qs}
