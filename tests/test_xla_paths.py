"""The plain XLA decode path the GPU runs, against float64 golden models.

* log-power framing: the periodic window-matrix path against the generic
  sliding path and the literal chunked simulator, at both amplifier rates
  and 64/128/256 channels;
* the vocoder tail (Griffin-Lim, overlap-add, low-pass, int16) against the
  NumPy streaming vocoder, for both phase estimators;
* Spearman feature selection against a float64 NumPy/SciPy ranking;
* the compile-cache rule of ``utils.setup_runtime``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats

from closed_loop_seeg_speech_synthesis_tpu import utils
from closed_loop_seeg_speech_synthesis_tpu.models import lda as lda_mod
from closed_loop_seeg_speech_synthesis_tpu.models import selection
from closed_loop_seeg_speech_synthesis_tpu.ops import framing
from closed_loop_seeg_speech_synthesis_tpu.ops import griffinlim as gl
from closed_loop_seeg_speech_synthesis_tpu.runtime import pipeline

import golden

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _decoder(sr, C, **kw):
    rng = np.random.RandomState(0)
    cfg = pipeline.DecoderConfig(sr=float(sr), n_channels=C, dtype=jnp.float64,
                                 packet_size=64 if sr == 2048 else 32, **kw)
    nf = min(150, 5 * C)
    lda = lda_mod.LDAParams(
        coef=jnp.asarray(rng.randn(40, 9, nf)), intercept=jnp.asarray(rng.randn(40, 9)),
        classes=jnp.broadcast_to(jnp.arange(9, dtype=jnp.int32), (40, 9)),
        valid=jnp.ones((40, 9), bool))
    medians = np.sort(rng.randn(40, 9), axis=1)
    return cfg, pipeline.build_decoder_params(cfg, lda, medians,
                                              rng.permutation(5 * C)[:nf])


@pytest.mark.parametrize("sr", [1024, 2048])
@pytest.mark.parametrize("C", [64, 128, 256])
def test_periodic_framing_matches_generic_and_golden(sr, C):
    cfg, params = _decoder(sr, C)
    T = sr  # 1 s
    eeg = np.random.RandomState(C + sr).randn(T, C)
    ends = framing.streaming_frame_ends(cfg.frame_len_ms, cfg.frame_shift_ms, cfg.sr,
                                        T + cfg.prefill)
    pw = framing.periodic_window_matrix(ends, cfg.win)
    assert pw is not None, "the exact frame grid must be periodic at this rate"
    S, Ls, P, origin = pw
    s_cat, _ = pipeline._streaming_filter_chain(params, cfg, jnp.asarray(eeg))
    F_per = np.asarray(framing.windowed_logpower_periodic(
        s_cat, jnp.asarray(S), Ls, len(ends), origin))
    F_gen = np.asarray(framing.windowed_logpower(s_cat, jnp.asarray(ends), cfg.win))
    np.testing.assert_allclose(F_per, F_gen, rtol=1e-12, atol=1e-12)

    chain = golden.GoldenFeatureChain(float(sr), line_noise=50)
    rows = [r for i in range(0, T, cfg.packet_size)
            for r in chain.process(eeg[i: i + cfg.packet_size])]
    stacked = np.asarray(framing.stack_context(jnp.asarray(F_per), cfg.model_order,
                                               cfg.step_size, zero_pad=True))
    assert len(rows) == len(stacked)
    np.testing.assert_allclose(stacked, np.asarray(rows), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("phase_bug", [True, False])
def test_vocoder_tail_matches_numpy(phase_bug):
    cfg, params = _decoder(1024, 8, phase_bug=phase_bug)
    rng = np.random.RandomState(5)
    n = 40
    mel = np.cumsum(rng.randn(n, 40) * 0.3, axis=0) - 2.0   # smooth log-mels
    rand = np.asarray(gl.default_rand_init(jax.random.PRNGKey(1), n - 1, 0, jnp.float64))
    audio = np.asarray(pipeline.vocoder(params, cfg, jnp.asarray(mel), jnp.asarray(rand)))

    voc = golden.GoldenVocoder(num_iterations=cfg.gl_iterations, norm_factor=cfg.gl_norm,
                               phase_bug=phase_bug, lowpass="sos")
    chunks = [voc.process_frame(mel[i], rand[i - 1] if i else None) for i in range(n)]
    ref = np.concatenate([c for c in chunks if c is not None])
    assert audio.dtype == np.int16 and audio.shape == ref.shape
    assert np.abs(audio.astype(int) - ref.astype(int)).max() <= 1


def test_selection_matches_float64_spearman():
    rng = np.random.RandomState(11)
    n, F, nb = 3000, 80, 30
    y = rng.randn(n, 40)
    target = y.mean(axis=1)
    X = rng.randn(n, F) + np.linspace(0, 1.5, F)[None, :] * target[:, None]
    X[:, 3] = 0.0                                          # forced to rho = 0
    X = X.astype(np.float32)
    got = selection.select_features(jnp.asarray(X), jnp.asarray(y, jnp.float32), nb)
    rho = np.array([scipy.stats.spearmanr(X[:, j].astype(np.float64), target)[0]
                    if np.any(X[:, j]) else 0.0 for j in range(F)])
    np.testing.assert_array_equal(got, np.argsort(np.abs(rho))[-nb:])


def test_compile_cache_dir_from_env(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/cache")
    assert utils.compile_cache_dir() == "/some/cache"
    assert utils.setup_runtime() == "/some/cache"
    assert not [c for c in calls if c[0] == "jax_compilation_cache_dir"]


def test_compile_cache_dir_default_in_checkout(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = utils.setup_runtime()
    assert path == os.path.join(ROOT, ".jax_cache") == utils.compile_cache_dir({})
    assert calls == [("jax_compilation_cache_dir", path)]
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
