"""SPMD training / replay over a device mesh.

``sharded_train_step`` is the framework's multi-chip training program: a
batch of recording sessions is data-sharded, sEEG channels are model-sharded,
and one jit compiles the full pipeline

    filter chain -> log-power -> context stacking    (channel-local, no comm)
    -> all-gather stacked features                   (the one cross-shard edge)
    -> Spearman selection -> batched 40-bin LDA fit  (Gram psum over data)

XLA inserts the collectives from the sharding annotations; there are no
hand-written NCCL-style calls.

``batched_replay`` fans offline decoding out across the mesh — the device
version of exp1's 10 folds x 100 chance-level runs that the reference runs
serially in a ThreadPool(1) (exp1.py:111,142).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..models import lda as lda_mod
from ..models.selection import spearman_vs_target
from ..ops import filter_design as fd
from ..ops import framing, iir, quantization
from ..ops.spectrogram import compute_spectrogram


@dataclasses.dataclass(frozen=True)
class ShardedTrainConfig:
    sr: float = 1024.0
    audio_sr: int = 16000
    line_noise: int = 50
    n_mel: int = 40
    nb_intervals: int = 9
    nb_feats: int = 150
    model_order: int = 4
    step_size: int = 5
    iir_block: int = 128
    dtype: Any = jnp.float32


def _feature_ops(cfg: ShardedTrainConfig):
    chain = fd.high_gamma_bank(cfg.sr, cfg.line_noise)
    prefill = int(0.05 * cfg.sr) - int(0.01 * cfg.sr)
    combined, warm = iir.make_warmstart_chain(chain, prefill)
    op = iir.make_blocked_iir(combined, cfg.iir_block, cfg.dtype)
    return op, (jnp.asarray(warm.zi_scale, cfg.dtype), jnp.asarray(warm.s_const, cfg.dtype))


def _session_features(cfg: ShardedTrainConfig, op, warm, eeg, ends, wlen):
    """One session's offline (training-grid) stacked features; channel-local."""
    zi_scale, s_const = warm
    x = eeg.astype(cfg.dtype)
    s0 = zi_scale[:, None] * x[0][None, :] + s_const[:, None]
    y, _ = iir.iir_blocked(op, x, s0)
    F = framing.windowed_logpower(y, ends, wlen)
    return framing.stack_context(F, cfg.model_order, cfg.step_size, zero_pad=False)


def make_sharded_train_step(mesh, cfg: ShardedTrainConfig, session_len: int, audio_len: int, n_channels: int):
    """Compile the full training step over the mesh.

    Call the result with (eeg (B, T, C), audio (B, Ta)); returns the fitted
    LDAParams plus (select, medians) — a complete decodable model.
    """
    op, warm = _feature_ops(cfg)
    starts = framing.offline_window_starts(0.05, 0.01, cfg.sr, session_len)
    wlen = framing.offline_window_len(0.05, cfg.sr, starts)
    ends = jnp.asarray(starts + wlen, jnp.int32)

    eeg_sh = NamedSharding(mesh, P("data", None, "model"))
    audio_sh = NamedSharding(mesh, P("data", None))

    def step(eeg, audio):
        feats = jax.vmap(lambda e: _session_features(cfg, op, warm, e, ends, wlen))(eeg)
        B, N, F = feats.shape
        specs = jax.vmap(lambda a: compute_spectrogram(a, cfg.audio_sr, 0.016, 0.01, cfg.n_mel, cfg.dtype))(audio)
        specs = specs[:, 20:-4]  # alignment crop (train.py:144-147)
        n = min(N, specs.shape[1])
        X = feats[:, :n].reshape(B * n, F)
        Yspec = specs[:, :n].reshape(B * n, cfg.n_mel)

        medians, borders = quantization.compute_borders_logistic(Yspec, cfg.nb_intervals)
        q = quantization.quantize(Yspec, borders).astype(jnp.int32)

        rhos = spearman_vs_target(X, jnp.mean(Yspec, axis=1))
        _, select = jax.lax.top_k(jnp.abs(rhos), cfg.nb_feats)
        select = select[::-1]  # ascending |rho|, reference ordering convention
        Xs = jnp.take(X, select, axis=1)

        coef, intercept, present = lda_mod._fit_batched(Xs, q.T, cfg.nb_intervals)
        params = lda_mod.LDAParams(
            coef=coef, intercept=intercept,
            classes=jnp.broadcast_to(jnp.arange(cfg.nb_intervals, dtype=jnp.int32), (cfg.n_mel, cfg.nb_intervals)),
            valid=present,
        )
        return params, select, medians

    # Replicated outputs: the fitted model is tiny and every process of a
    # multi-host run must be able to fetch it (non-addressable shards would
    # strand the params on other hosts).
    rep = NamedSharding(mesh, P())
    step = jax.jit(step, in_shardings=(eeg_sh, audio_sh),
                   out_shardings=(lda_mod.LDAParams(coef=rep, intercept=rep,
                                                    classes=rep, valid=rep),
                                  rep, rep))
    return step, (eeg_sh, audio_sh)


def make_sharded_decode(mesh, dec_params, cfg, n_frames: int):
    """Channel-sharded single-session decode over the 'model' axis.

    The filter chain, log-power framing and context stacking are
    channel-local (stacked features are channel-major, so a channel shard
    owns a contiguous feature block); the fused LDA matmul contracts over the
    sharded feature dimension — the pipeline's single cross-shard edge, where
    XLA inserts the reduce (SURVEY.md §2 parallelism notes).
    """
    from ..runtime import pipeline as pl

    eeg_sh = NamedSharding(mesh, P(None, "model"))

    def decode(eeg, ends, rand):
        return pl._offline_decode_jit(dec_params, cfg, eeg, ends, rand)

    return jax.jit(decode, in_shardings=(eeg_sh, None, None)), eeg_sh


def make_batched_replay(mesh, decode_jit, cfg, n_frames: int):
    """Shard a batch of sessions over the mesh and decode them all at once.

    decode_jit: the pipeline's jitted single-session decode; vmapped over the
    leading batch axis, batch sharded over 'data', channels over 'model'.
    """
    eeg_sh = NamedSharding(mesh, P("data", None, "model"))
    rand_sh = NamedSharding(mesh, P("data"))

    def replay(params, eeg_batch, ends, rand_batch):
        return jax.vmap(lambda e, r: decode_jit(params, cfg, e, ends, r))(eeg_batch, rand_batch)

    return jax.jit(replay, in_shardings=(None, eeg_sh, None, rand_sh))
