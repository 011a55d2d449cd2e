"""Training-path benchmark: the JAX trainer vs a reference-architecture CPU twin.

The reference's second entrypoint is offline training (train.py:132-168):
sosfilt the whole recording through the high-gamma chain, windowed
log-power features with context stacking (local/offline.py:12-128), logMel
spectrogram targets, logistic quantization, per-feature Spearman selection
(train.py:96-109), and 40 sklearn LDA fits (train.py:112-118).  The CPU arm
below re-implements exactly that architecture with scipy/sklearn/numpy
(freshly written from the published formulas; the SOS coefficients come
from this repo's own mne-matched designer so both arms filter identically).
The JAX arm is `runtime.trainer.train` — the same math as one JAX program
batch (blocked state-space IIR, batched Gram-eigh LDA).

Both arms run on the same synthetic session; the JAX arm reports the
steady-state wall (second call, fresh data, no recompile) plus the
first-call wall (compile included) and a phase decomposition.

Run:  python benchmarks/train_bench.py [duration_s] [channels]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)


def make_session(duration_s, n_channels, seed):
    rng = np.random.RandomState(seed)
    T = int(1024.0 * duration_s)
    eeg = rng.randn(T, n_channels).astype(np.float32)
    audio = (rng.randn(int(48000.0 * duration_s)) * 0.1).astype(np.float64)
    return eeg, audio


def cpu_reference_train(eeg, audio, eeg_sr=1024.0, nb_mel=40, nb_intervals=9,
                        nb_feats=150, line_noise=50, model_order=4, step_size=5):
    """Reference-architecture training on CPU (scipy + sklearn + numpy)."""
    import scipy.signal as sig
    from scipy.stats import spearmanr
    from sklearn.discriminant_analysis import LinearDiscriminantAnalysis

    from closed_loop_seeg_speech_synthesis_tpu.ops import framing
    from closed_loop_seeg_speech_synthesis_tpu.ops.filter_design import (
        high_gamma_bank, sosfilt_zi)
    from closed_loop_seeg_speech_synthesis_tpu.ops.mel import mel_matrices

    walls = {}
    t0 = time.perf_counter()
    # --- feature extraction (offline.py:12-128 semantics) ---
    x = np.asarray(eeg, np.float64)
    for sos in high_gamma_bank(eeg_sr, line_noise):
        zi = sosfilt_zi(sos)  # (nsec, 2), warm-started on x[0] (offline.py:47-66)
        zi_full = zi[:, :, None] * x[0][None, None, :]
        x, _ = sig.sosfilt(sos, x, axis=0, zi=zi_full)
    win = int(0.05 * eeg_sr)
    ends = framing.streaming_frame_ends(50.0, 10.0, eeg_sr, len(x) + win)
    feats = np.empty((len(ends), x.shape[1]))
    for i, e in enumerate(ends):
        seg = x[max(0, e - win):e]
        feats[i] = np.log(np.sum(seg * seg, axis=0) + 0.01)
    # context stacking: 5 taps spaced step_size frames (ECogFeatCalc.py:99-144)
    n, C = feats.shape
    stacked = np.zeros((n, (model_order + 1) * C))
    for k in range(model_order + 1):
        lag = (model_order - k) * step_size
        stacked[lag:, k * C:(k + 1) * C] = feats[:n - lag]
    walls["features_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    # --- spectrogram targets (offline.py:219-241 semantics) ---
    a16 = sig.decimate(audio, 3)
    M, _ = mel_matrices(129, nb_mel, 16000.0)
    wlen, shift = 256, 160
    n_f = (len(a16) - wlen) // shift + 1
    hann = np.hanning(wlen)
    segs = np.lib.stride_tricks.as_strided(
        a16, (n_f, wlen), (a16.strides[0] * shift, a16.strides[0]))
    spec = np.abs(np.fft.rfft(segs * hann, axis=1))
    y_spec = np.log(spec @ M + 1e-10)[20:-4]  # M is (spec_size, n_mel)
    walls["spectrogram_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    # --- logistic quantization (quantization.py:83-122 semantics) ---
    lo, hi = y_spec.min(0), y_spec.max(0)
    ks = np.linspace(-5, 5, nb_intervals + 1)[1:-1]
    borders = lo[None] + (hi - lo)[None] / (1 + np.exp(-ks))[:, None] * 1.0
    q = np.sum(y_spec[None] > borders[:, None], axis=0)
    walls["quantization_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    # --- Spearman top-k selection (train.py:96-109) ---
    n = min(len(stacked), len(y_spec))
    stacked, y_spec, q = stacked[:n], y_spec[:n], q[:n]
    target = y_spec.mean(axis=1)
    rs = np.array([abs(spearmanr(stacked[:, j], target).statistic)
                   for j in range(stacked.shape[1])])
    select = np.argsort(-rs)[:nb_feats]
    x_sel = stacked[:, select]
    walls["selection_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    # --- 40 LDA fits (train.py:112-118) ---
    estimators = [LinearDiscriminantAnalysis().fit(x_sel, q[:, b])
                  for b in range(nb_mel)]
    walls["lda_s"] = time.perf_counter() - t0
    walls["total_s"] = sum(walls.values())
    return estimators, walls


def main(duration_s=1800.0, n_channels=128):
    from closed_loop_seeg_speech_synthesis_tpu.utils import setup_runtime
    setup_runtime()
    duration_s, n_channels = float(duration_s), int(n_channels)

    from closed_loop_seeg_speech_synthesis_tpu.runtime import trainer

    sessions = [make_session(duration_s, n_channels, s) for s in (0, 1)]

    t0 = time.perf_counter()
    trainer.train(*sessions[0], 1024.0, 48000.0, [])
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = trainer.train(*sessions[1], 1024.0, 48000.0, [])
    steady_s = time.perf_counter() - t0
    # trainer clamps nb_feats to the stacked-feature count (5 taps x C) for
    # small-channel smoke runs; the battery's 128 ch point always has 150
    expected_feats = min(150, 5 * n_channels)
    assert np.all(np.isfinite(res.lda.coef))
    assert res.x_train.shape[1] == expected_feats, res.x_train.shape

    cpu_s = None
    if os.environ.get("CLSS_TRAIN_BENCH_SKIP_CPU", "0") != "1":
        _, cpu_walls = cpu_reference_train(*sessions[1])
        cpu_s = cpu_walls.pop("total_s")

    out = {
        "metric": "train_wall_s", "value": round(steady_s, 2), "unit": "s",
        "vs_baseline": round((cpu_s or 0.0) / steady_s, 2),
        "duration_s": duration_s, "channels": n_channels,
        "first_call_s": round(first_s, 2),
    }
    if cpu_s is not None:
        out["cpu_reference_s"] = round(cpu_s, 2)
        out["cpu_phases"] = {k: round(v, 2) for k, v in cpu_walls.items()}
        out["speedup_vs_cpu_reference"] = round(cpu_s / steady_s, 2)
    print(json.dumps(out))


if __name__ == "__main__":
    main(*sys.argv[1:3])
