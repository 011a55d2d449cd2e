"""Synthetic word-locked recordings, made from a seed (no lab data needed).

Each 3 s trial has 2 s of high-gamma bursts on half of the channels, with a
per-word gain, plus matching voiced audio (a harmonic stack and breath
noise), then 1 s of rest — the trial grid of the reference's experiment
(data_loader.py:196-325).  Used by the demo, the smoke run and benchmarks.
"""

from __future__ import annotations

import numpy as np


def synthetic_session(n_words=20, eeg_sr=1024, audio_sr=48000, n_channels=16,
                      seed=0, with_audio=True) -> dict:
    """Returns dict(eeg (T, C) float64, audio (Ta,) or None, eeg_sr, audio_sr,
    words, markers, ch_names).  ``with_audio=False`` skips the audio track
    (replay sessions); the sEEG is identical either way."""
    rng = np.random.RandomState(seed)
    words = ["w{:02d}".format(i % 10) for i in range(n_words)]
    T = 3 * n_words * eeg_sr
    eeg = rng.randn(T, n_channels)
    burst = np.sin(2 * np.pi * 120 * np.arange(2 * eeg_sr) / eeg_sr)
    audio = np.zeros(3 * n_words * audio_sr) if with_audio else None
    t_a = np.arange(2 * audio_sr) / audio_sr
    voices = {}
    for i, w in enumerate(words):
        # deterministic per-word voice (NOT hash(): PYTHONHASHSEED randomizes
        # str hashes per process) and a broadband harmonic stack + breath
        # noise so every mel bin carries voiced/unvoiced structure — a pure
        # tone only excites two bins once spectral targets are computed
        # exactly (docs/NUMERICS.md precision)
        wid = int(w[1:]) % 5
        gain = 1.0 + wid * 0.4
        eeg[i * 3 * eeg_sr : i * 3 * eeg_sr + 2 * eeg_sr, : n_channels // 2] += gain * burst[:, None]
        if not with_audio:
            continue
        if wid not in voices:
            f0 = 150 + 30 * wid
            voices[wid] = sum((0.4 / h) * np.sin(2 * np.pi * h * f0 * t_a)
                              for h in range(1, 26))
        voiced = voices[wid] + 0.02 * rng.randn(len(t_a))
        audio[i * 3 * audio_sr : i * 3 * audio_sr + 2 * audio_sr] = 0.3 * voiced / np.abs(voiced).max()
    markers = [["experimentStarted"]]
    for w in words:
        markers += [[f"start;{w}"], [f"end;{w}"]]
    markers += [["experimentEnded"]]
    return {"eeg": eeg, "audio": audio, "eeg_sr": eeg_sr, "audio_sr": audio_sr,
            "words": words, "markers": markers,
            "ch_names": [f"LA{i+1}" for i in range(n_channels)]}
