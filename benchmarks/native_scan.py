"""Native C++ XDF sample scanner vs the pure-Python parser.

The CI test (tests/test_io.py) only guards bit-identical output plus a very
loose wall-clock sanity bound, because identical work varies up to ~80x on
the virtualized single-core CI host.  The throughput claim lives here
instead: interleaved min-of-N timings of both parsers on the
same in-memory file, emitting the ratio where regressions are visible.

Run:  python benchmarks/native_scan.py [n_seconds] [reps]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "tests"))


def main(n_seconds=120.0, reps=5):
    from closed_loop_seeg_speech_synthesis_tpu.utils import setup_runtime
    setup_runtime()
    from test_io import write_test_xdf  # the spec-conformant fixture writer
    from closed_loop_seeg_speech_synthesis_tpu.io import xdf

    n_seconds, reps = float(n_seconds), int(reps)
    rng = np.random.RandomState(0)
    eeg_sr, audio_sr = 1024, 48000
    eeg = rng.randn(int(eeg_sr * n_seconds), 64).astype(np.float32)
    audio = (0.1 * rng.randn(int(audio_sr * n_seconds))).astype(np.float32)
    path = "/tmp/native_scan_bench.xdf"
    write_test_xdf(path, eeg, eeg_sr, audio, audio_sr,
                   [(100.5, "experimentStarted"), (101.0, "experimentEnded")],
                   [f"c{i}" for i in range(64)])
    size_mb = os.path.getsize(path) / 1e6

    if xdf._native_scanner() is None:
        print(json.dumps({"metric": "xdf_native_scan_speedup", "value": 0.0,
                          "unit": "x (native scanner unavailable)", "vs_baseline": 0.0}))
        return

    def run(use_native):
        t0 = time.perf_counter()
        streams, _ = xdf.load_xdf(path, synchronize_clocks=False,
                                  dejitter_timestamps=False, use_native=use_native)
        assert sum(len(s["time_stamps"]) for s in streams) > 0
        return time.perf_counter() - t0

    run(True), run(False)  # warm the page cache + imports
    t_native, t_py = [], []
    for _ in range(reps):  # interleaved: host noise hits both arms equally
        t_native.append(run(True))
        t_py.append(run(False))

    tn, tp = min(t_native), min(t_py)
    print(json.dumps({"metric": "xdf_native_scan_speedup", "value": round(tp / tn, 2),
                      "unit": "x vs python parser (interleaved min-of-%d)" % reps,
                      "vs_baseline": round(tp / tn, 2),
                      "native_s": round(tn, 3), "python_s": round(tp, 3),
                      "file_mb": round(size_mb, 1),
                      "native_mb_s": round(size_mb / tn, 1)}))


if __name__ == "__main__":
    main(*sys.argv[1:3])
