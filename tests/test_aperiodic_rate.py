"""Sample rates whose frame grid hits exact .5 rounding ties.

sr=1025 Hz: the exact streaming grid lands on x.5 every 4th frame, so the
reference's float64 evaluation round-half-evens on accumulated representation
error and is effectively aperiodic.  The rebuild defines the grid in exact
rational arithmetic (ops/framing.exact_frame_ends): ties round half-even on
the true value, which makes the shift table exactly periodic (period 2q here)
— so online decoding works at ANY rate and is bit-identical to offline
(earlier versions refused such rates online).  At non-tie
rates (512/1024/2048 Hz) the exact grid equals the reference's float grid
bit-for-bit (match /root/reference/livenodes/FrameBuffer.py:147-177).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from closed_loop_seeg_speech_synthesis_tpu.models import lda as lda_mod
from closed_loop_seeg_speech_synthesis_tpu.ops import framing
from closed_loop_seeg_speech_synthesis_tpu.runtime import pipeline


SR = 1025.0


def _params(rng, C):
    cfg = pipeline.DecoderConfig(sr=SR, n_channels=C, dtype=jnp.float64)
    lda_params = lda_mod.LDAParams(
        coef=jnp.asarray(rng.randn(40, 9, 10), jnp.float64),
        intercept=jnp.asarray(rng.randn(40, 9), jnp.float64),
        classes=jnp.broadcast_to(jnp.arange(9, dtype=jnp.int32), (40, 9)),
        valid=jnp.ones((40, 9), bool),
    )
    dec = pipeline.build_decoder_params(cfg, lda_params, np.sort(rng.randn(40, 9), 1),
                                        rng.permutation(5 * C)[:10])
    return cfg, dec


def test_shift_table_periodic_at_tie_rate():
    # shift = 10.25 samples = 41/4; p odd => parity ties => period 2q = 8
    table = framing.shift_table(50, 10, SR)
    assert table.shape == (8,)
    assert int(table.sum()) == 82  # 8 frames span exactly 82 samples
    # table reproduces the exact ends over a long horizon
    ends = framing.exact_frame_ends(50, 10, SR, 100001)
    d = np.diff(ends)
    np.testing.assert_array_equal(d, np.tile(table, len(d) // 8 + 1)[: len(d)])


def test_exact_grid_matches_float_grid_at_reference_rates():
    for sr in (512.0, 1024.0, 2048.0):
        ends = framing.exact_frame_ends(50, 10, sr, 20000)
        fsize = framing.frame_size(50, sr)
        first_ms = fsize / sr * 1000.0
        ref = np.asarray([round((first_ms + k * 10.0) / 1000.0 * sr)
                          for k in range(20000)], np.int64)
        np.testing.assert_array_equal(ends, ref)


def test_online_matches_offline_at_tie_rate(rng):
    C = 3
    cfg, dec = _params(rng, C)
    assert dec.shift_table.shape[0] == 8
    T = 3 * int(SR)
    # trim to whole packets: the online loop feeds fixed-size packets
    T -= T % cfg.packet_size
    eeg = rng.randn(T, C)
    key = jax.random.PRNGKey(0)
    spec_ref, audio_ref = pipeline.offline_decode(dec, cfg, eeg, key=key)
    spec_ref, audio_ref = np.asarray(spec_ref), np.asarray(audio_ref)
    n = spec_ref.shape[0]
    assert n > 250 and audio_ref.shape == ((n - 1) * 160,)

    # frame ends still match the framework's host grid exactly
    ends = framing.streaming_frame_ends(50, 10, SR, eeg.shape[0] + cfg.prefill)
    assert len(ends) == n

    step = pipeline.make_online_step(dec, cfg, key)
    carry = pipeline.init_online_carry(dec, cfg)
    specs, chunks = [], []
    for i in range(0, T, cfg.packet_size):
        carry, out = step(carry, jnp.asarray(eeg[i : i + cfg.packet_size]))
        specs.append(np.asarray(out["spec"])[np.asarray(out["spec_valid"])])
        chunks.append(np.asarray(out["audio"])[np.asarray(out["audio_valid"])])
    spec_on = np.concatenate(specs)
    audio_on = np.concatenate(chunks).reshape(-1)

    assert spec_on.shape == spec_ref.shape
    np.testing.assert_allclose(spec_on, spec_ref, rtol=1e-9, atol=1e-11)
    assert audio_on.shape == audio_ref.shape
    assert np.abs(audio_on.astype(int) - audio_ref.astype(int)).max() <= 1
