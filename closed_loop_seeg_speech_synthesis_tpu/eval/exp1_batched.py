"""Jitted, vmapped retrain+decode for exp1 chance-level estimation.

One compiled program runs a whole batch of randomization runs at once:
circular-shift the training sEEG, re-extract features, re-select, re-fit all
40 LDAs, decode the held-out sEEG — everything on device.  The reference
executes each of the 10 folds x 100 runs serially through its node graph
(exp1.py:133-160).

Fold data (training sEEG, labels, held-out sEEG) enters as *arguments*, not
closure constants: large constants would be inlined into the compiled
program (slow compiles, oversized executables), and with the uniform KFold the
reference uses (100 words / 10 folds) every fold shares shapes, so all folds
and all runs reuse a single compilation.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import scipy.signal as _sig

from ..models import lda as lda_mod
from ..models.selection import spearman_vs_target
from ..ops import framing, quantization
from ..ops import griffinlim as gl
from ..ops.spectrogram import compute_spectrogram
from ..runtime import pipeline


def fold_targets(y_train_audio, n_mel=40, nb_intervals=9):
    """Fold-constant training targets (audio never shifts, exp1.py:94-99):
    quantized labels, medians, target mean.

    Runs its jnp stages on the IN-PROCESS CPU backend: this is host-side
    staging, and shipping the per-fold ~50 MB audio to the accelerator for
    one small spectrogram costs more than it computes.  Same code, same
    numbers."""
    import contextlib

    audio16 = _sig.decimate(np.asarray(y_train_audio, np.float64), 3)
    try:
        ctx = jax.default_device(jax.local_devices(backend="cpu")[0])
    except RuntimeError:  # cpu backend not initialized in this config
        ctx = contextlib.nullcontext()
    with ctx:
        y_spec = np.asarray(compute_spectrogram(
            jnp.asarray(audio16), 16000, 0.016, 0.01, n_mel))[20:-4]
        medians, borders = quantization.compute_borders_logistic(
            jnp.asarray(y_spec), nb_intervals)
        q = np.asarray(quantization.quantize(jnp.asarray(y_spec), borders)).astype(np.int32)
        return q, np.asarray(medians), y_spec.mean(axis=1)


def _make_one_run(train_len, test_len, n_channels, eeg_sr, norm_factor,
                  nb_feats=150, nb_intervals=9, n_mel=40, line_noise=50,
                  dtype=jnp.float32):
    """Shared retrain+decode body for the given fold SHAPES.

    Returns (one_run, n_frames) with
    ``one_run(xt (Tt,C), xe (T2,C), q (n,40), y_mean (n,), medians (40,k),
    shift, key) -> (spec (n_frames, n_mel), audio ((n_frames-1)*160,))``.
    """
    cfg = pipeline.DecoderConfig(sr=float(eeg_sr), n_channels=n_channels,
                                 gl_norm=float(norm_factor), line_noise=line_noise, dtype=dtype)
    template = pipeline.build_decoder_params(
        cfg,
        lda_mod.LDAParams(
            coef=jnp.zeros((n_mel, nb_intervals, nb_feats), dtype),
            intercept=jnp.zeros((n_mel, nb_intervals), dtype),
            classes=jnp.broadcast_to(jnp.arange(nb_intervals, dtype=jnp.int32), (n_mel, nb_intervals)),
            valid=jnp.ones((n_mel, nb_intervals), bool),
        ),
        np.zeros((n_mel, nb_intervals)), np.arange(nb_feats),
        # fold medians are substituted as TRACED values below; the host-built
        # exact smoothing lattice would be stale — use the arithmetic twin
        # (this eval is correlation-gated, ulps are irrelevant here)
        exact_smooth=False,
    )

    # training-grid framing (offline.py:99-116)
    starts = framing.offline_window_starts(0.05, 0.01, eeg_sr, train_len)
    wlen = framing.offline_window_len(0.05, eeg_sr, starts)
    tr_ends = jnp.asarray(starts + wlen, jnp.int32)

    # decode-grid framing for the held-out sEEG
    te_ends = framing.streaming_frame_ends(cfg.frame_len_ms, cfg.frame_shift_ms, eeg_sr,
                                           test_len + cfg.prefill)
    n_frames = len(te_ends)
    pw = framing.periodic_window_matrix(te_ends, cfg.win)
    if pw is not None:
        S, Ls, P, origin = pw
        plan = (Ls, P, origin, n_frames)
        window_S = jnp.asarray(S, dtype)
    else:
        plan, window_S = None, None
    te_ends_d = jnp.asarray(te_ends, jnp.int32)
    n_stacked = (cfg.model_order + 1) * n_channels

    def train_features_offline(eeg):
        """Offline herff2016_b features of one (shifted) training signal;
        the combined-chain closed-form init applies (offline.py:31-97)."""
        from ..ops import iir as iir_mod

        s0 = template.filt_zi_scale[:, None] * eeg[0][None, :] + template.filt_s_const[:, None]
        y, _ = iir_mod.iir_blocked(template.filt_op, eeg, s0)
        F = framing.windowed_logpower(y, tr_ends, wlen)
        return framing.stack_context(F, cfg.model_order, cfg.step_size, zero_pad=False)

    def one_run(xt, xe, q, y_mean, medians, shift, key):
        eeg = jnp.roll(xt, -shift, axis=0)
        feats = train_features_offline(eeg)
        n = min(feats.shape[0], q.shape[0])
        X = feats[:n]
        rhos = spearman_vs_target(X, y_mean[:n])
        _, select = jax.lax.top_k(jnp.abs(rhos), nb_feats)
        select = select[::-1]
        Xs = jnp.take(X, select, axis=1)
        coef, intercept, present = lda_mod._fit_batched(Xs, q[:n].T, nb_intervals)
        scatter = jax.nn.one_hot(select, n_stacked, dtype=dtype)      # (150, 5C)
        coef_full = jnp.einsum("bkf,fd->bkd", coef, scatter,
                                precision=jax.lax.Precision.HIGHEST)
        params = dataclasses.replace(
            template,
            lda_coef_full=coef_full,
            medians=medians.astype(dtype),
            lda=dataclasses.replace(template.lda, intercept=intercept, valid=present),
        )
        rand = gl.default_rand_init(key, n_frames - 1, 0, dtype)
        return pipeline._offline_decode_jit(params, cfg, xe, te_ends_d, rand, window_S, plan)

    return one_run, n_frames


def make_chance_runner(train_len, test_len, n_channels, eeg_sr, norm_factor,
                       nb_feats=150, nb_intervals=9, n_mel=40, line_noise=50,
                       dtype=jnp.float32):
    """Compile a chance runner for the given fold SHAPES.

    Returns (runner, n_frames) where
    ``runner(xt (Tt,C), xe (T2,C), q (n,40), y_mean (n,), medians (40,k),
    shifts (R,), key) -> reco (R, n_frames, n_mel)``.
    """
    one_run, n_frames = _make_one_run(train_len, test_len, n_channels, eeg_sr,
                                      norm_factor, nb_feats, nb_intervals, n_mel,
                                      line_noise, dtype)

    # lax.map, NOT vmap, over the run axis: one compilation, sequential
    # device execution of the proven-correct unbatched program.  vmapping the
    # whole retrain+decode graph has been miscompiled by XLA at batch>=5 x full-scale
    # shapes (XLA fuses the feature gather into the class-means matmul and
    # produces garbage class means for a leading contiguous range of batch
    # elements — observed 2026-08: lanes 0-1 fully dead, lane 2 partially,
    # while every returned INTERMEDIATE including the gathered features
    # compares bit-exact).  Each lane already saturates the chip (270 s of
    # 64ch IIR + a full decode), so lane-level vmap bought no throughput.
    @jax.jit
    def runner(xt, xe, q, y_mean, medians, shifts, key):
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(shifts.shape[0]))
        return jax.lax.map(
            lambda sk: one_run(xt, xe, q, y_mean, medians, sk[0], sk[1])[0],
            (shifts, keys))

    return runner, n_frames


def make_proposed_runner(train_len, test_len, n_channels, eeg_sr, norm_factor,
                         nb_feats=150, nb_intervals=9, n_mel=40, line_noise=50,
                         dtype=jnp.float32):
    """Compile the proposed-method fold sweep for the given fold SHAPES.

    All retrain+decode folds run as ONE vmapped program (the reference
    serializes them through ThreadPool(1), exp1.py:105-131).  Each fold
    differs from a chance run only by not circularly shifting the training
    sEEG and by its own quantization targets — both enter as arguments.

    Returns (runner, n_frames) where
    ``runner(xts (K,Tt,C), xes (K,T2,C), qs (K,n,40), y_means (K,n),
    medians (K,40,k), keys (K,2)) ->
    (reco (K, n_frames, n_mel), audio (K, (n_frames-1)*160))``.
    """
    one_run, n_frames = _make_one_run(train_len, test_len, n_channels, eeg_sr,
                                      norm_factor, nb_feats, nb_intervals, n_mel,
                                      line_noise, dtype)

    # lax.map over folds for the same reason as make_chance_runner: the
    # fold-axis vmap of the full retrain+decode graph has been miscompiled by
    # XLA at full scale (garbage class means for leading lanes).  Sequential lanes
    # also drop peak HBM to one fold's working set, so all 10 folds fit in
    # one call (the 10-wide vmap used to exhaust HBM).
    @jax.jit
    def runner(xts, xes, qs, y_means, medians, keys):
        zero = jnp.zeros((), jnp.int32)
        return jax.lax.map(
            lambda a: one_run(a[0], a[1], a[2], a[3], a[4], zero, a[5]),
            (xts, xes, qs, y_means, medians, keys))

    return runner, n_frames


def make_fold_chance_runner(x_train, y_train_audio, x_test, eeg_sr, audio_sr,
                            bad_channels, norm_factor, nb_feats=150, nb_intervals=9,
                            n_mel=40, line_noise=50, dtype=jnp.float32):
    """Convenience wrapper binding one fold's data; see make_chance_runner."""
    mask = np.ones(x_train.shape[1], bool)
    if len(bad_channels):
        mask[np.asarray(bad_channels, int)] = False
    xt = jnp.asarray(np.asarray(x_train, np.float64)[:, mask], dtype)
    xe = jnp.asarray(np.asarray(x_test, np.float64)[:, mask], dtype)
    q, medians, y_mean = fold_targets(y_train_audio, n_mel, nb_intervals)
    runner, n_frames = make_chance_runner(
        xt.shape[0], xe.shape[0], xt.shape[1], float(eeg_sr), float(norm_factor),
        nb_feats, nb_intervals, n_mel, line_noise, dtype)

    def bound(shifts, key):
        return runner(xt, xe, jnp.asarray(q), jnp.asarray(y_mean, dtype),
                      jnp.asarray(medians, dtype), shifts, key)

    return bound, n_frames
