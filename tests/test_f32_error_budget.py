"""float32 device-path error budget on realistic sEEG statistics.

The device decode path runs float32; the golden contract is float64.  The
decode output is discrete (per-bin argmax over LDA scores), so what matters
is the label-flip rate under f32 rounding.  Random white noise understates
realism: this test uses 1/f-shaped background + 50 Hz line noise + word-
locked high-gamma bursts, trains in f64, and decodes the session in both
precisions.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from closed_loop_seeg_speech_synthesis_tpu.runtime import pipeline, trainer


def _pink_noise(rng, T, C, sr):
    """1/f-shaped noise via spectral shaping."""
    spec = np.fft.rfft(rng.randn(T, C), axis=0)
    f = np.fft.rfftfreq(T, 1.0 / sr)
    shaping = 1.0 / np.maximum(f, 1.0)[:, None]
    return np.fft.irfft(spec * shaping, n=T, axis=0)


def test_f32_label_flip_rate():
    rng = np.random.RandomState(17)
    sr, C, n_words = 1024.0, 8, 6
    T = int(3 * n_words * sr)
    eeg = 20.0 * _pink_noise(rng, T, C, sr)
    eeg += 5.0 * np.sin(2 * np.pi * 50.0 * np.arange(T) / sr)[:, None]  # line noise
    hg = np.sin(2 * np.pi * 130.0 * np.arange(int(2 * sr)) / sr)
    t_a = np.arange(int(2 * 48000)) / 48000.0
    audio = np.zeros(3 * n_words * 48000)
    for i in range(n_words):
        gain = 1.0 + (i % 3)
        eeg[int(i * 3 * sr) : int(i * 3 * sr) + len(hg), : C // 2] += gain * hg[:, None]
        audio[i * 3 * 48000 : i * 3 * 48000 + len(t_a)] = 0.3 * np.sin(2 * np.pi * (150 + 40 * (i % 3)) * t_a)

    res = trainer.train(eeg, audio, sr, 48000.0, [], nb_feats=20)

    specs = {}
    for dtype in (jnp.float64, jnp.float32):
        cfg = pipeline.DecoderConfig(sr=sr, n_channels=C, dtype=dtype)
        dec = pipeline.build_decoder_params(cfg, res.lda, res.medians, res.select)
        spec, _ = pipeline.offline_decode(dec, cfg, eeg, key=jax.random.PRNGKey(0))
        specs[dtype] = np.asarray(spec, np.float64)

    # dequantized values are discrete medians: equality == same label
    same = np.isclose(specs[jnp.float64], specs[jnp.float32], rtol=1e-4, atol=1e-5)
    flip_rate = 1.0 - same.mean()
    assert flip_rate < 0.02, f"f32 label flip rate {flip_rate:.4f}"
    # and the flips that do occur barely move the spectrogram
    err = np.abs(specs[jnp.float64] - specs[jnp.float32])
    assert np.percentile(err, 99.5) < 1.0
