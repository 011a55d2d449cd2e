"""Mesh-vs-one-device parity of the two sharded programs.

``sharded_parity`` runs the sharded training step and the batched replay on
a (data, model) mesh and on a one-device mesh over the same inputs, checks
that they agree, and returns the comparison numbers.  It is shared by the
CPU dryrun (``__graft_entry__.dryrun_multichip``, virtual devices) and the
four-card path of ``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np


def _require(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def sharded_parity(mesh, seconds: float = 30.0, channels: int = 128,
                   replay_seconds: float = 4.0, seed: int = 0) -> dict:
    """Raises AssertionError when the mesh and one device disagree.

    Training: the reference's channel count and feature budget
    (decode.py:115-116, train.py:97), two sessions per data shard; feature
    selection and medians must match exactly, LDA coefficients to 1e-3
    relative.  Replay: float64 decode of a session batch sharded over
    (data, model) against a one-device decode of session 0; spectrogram to
    1e-9 relative, audio to 1 LSB.  (float64 because in float32 the
    cross-shard LDA reduce's different summation order can flip near-tie
    argmaxes — a numerics-of-f32 story, not a sharding bug.)
    """
    import jax
    import jax.numpy as jnp

    from ..ops import framing
    from ..ops import griffinlim as gl
    from ..runtime import pipeline
    from . import mesh as mesh_lib
    from . import sharded

    dp = mesh.shape["data"]
    tp = mesh.shape["model"]
    cfg = sharded.ShardedTrainConfig(dtype=jnp.float32, nb_feats=150, iir_block=128)
    B = dp * 2
    T = int(seconds * cfg.sr)
    C = channels
    _require(C % tp == 0, f"{C} channels do not split over a model axis of {tp}")
    Ta = int(T / cfg.sr * cfg.audio_sr)

    step, (eeg_sh, audio_sh) = sharded.make_sharded_train_step(mesh, cfg, T, Ta, C)
    rng = np.random.RandomState(seed)
    eeg_h = rng.randn(B, T, C).astype(np.float32)
    audio_h = (rng.randn(B, Ta) * 0.1).astype(np.float32)
    eeg = jax.device_put(jnp.asarray(eeg_h), eeg_sh)
    audio = jax.device_put(jnp.asarray(audio_h), audio_sh)
    params, select, medians = step(eeg, audio)
    jax.block_until_ready((params.coef, select, medians))
    _require(params.coef.shape == (cfg.n_mel, cfg.nb_intervals, cfg.nb_feats),
             f"sharded coef shape {params.coef.shape}")

    mesh1 = mesh_lib.make_mesh(1)
    step1, _ = sharded.make_sharded_train_step(mesh1, cfg, T, Ta, C)
    p1, s1, m1 = step1(jnp.asarray(eeg_h), jnp.asarray(audio_h))
    jax.block_until_ready(p1.coef)
    _require(np.array_equal(np.asarray(select), np.asarray(s1)),
             "sharded feature selection != single-device selection")
    med_err = float(np.max(np.abs(np.asarray(medians) - np.asarray(m1))))
    coef_err = float(np.max(np.abs(np.asarray(params.coef) - np.asarray(p1.coef))))
    coef_scale = float(np.max(np.abs(np.asarray(p1.coef))))
    rel = coef_err / max(coef_scale, 1e-30)
    _require(rel < 1e-3, f"sharded coef rel err {rel} (max abs {coef_err}, scale {coef_scale})")
    _require(med_err == 0.0, f"sharded medians diverged: max_abs_err={med_err}")

    jax.config.update("jax_enable_x64", True)
    dcfg = pipeline.DecoderConfig(sr=cfg.sr, n_channels=C, dtype=jnp.float64)
    dec = pipeline.build_decoder_params(dcfg, params, np.asarray(medians),
                                        np.asarray(select))
    Td = int(replay_seconds * cfg.sr)
    ends = framing.streaming_frame_ends(dcfg.frame_len_ms, dcfg.frame_shift_ms,
                                        cfg.sr, Td + dcfg.prefill)
    nf = len(ends)
    eeg_b = jnp.asarray(rng.randn(B, Td, C), jnp.float64)
    rand_b = jnp.stack([gl.default_rand_init(jax.random.PRNGKey(i), nf - 1, 0,
                                             jnp.float64) for i in range(B)])
    replay = sharded.make_batched_replay(mesh, pipeline._offline_decode_jit,
                                         dcfg, nf)
    specs, audios = replay(dec, eeg_b, jnp.asarray(ends, jnp.int32), rand_b)
    jax.block_until_ready((specs, audios))
    _require(specs.shape == (B, nf, cfg.n_mel) and audios.shape == (B, (nf - 1) * 160),
             f"batched replay shapes {specs.shape} {audios.shape}")
    s0, a0 = pipeline._offline_decode_jit(dec, dcfg, eeg_b[0],
                                          jnp.asarray(ends, jnp.int32), rand_b[0])
    spec_err = float(np.max(np.abs(np.asarray(specs[0]) - np.asarray(s0))))
    audio_lsb = int(np.max(np.abs(np.asarray(audios[0], np.int64)
                                  - np.asarray(a0, np.int64))))
    spec_scale = float(np.max(np.abs(np.asarray(s0))))
    _require(spec_err <= 1e-9 * max(spec_scale, 1.0),
             f"batched replay spec err {spec_err} (scale {spec_scale})")
    _require(audio_lsb <= 1, f"batched replay audio off by {audio_lsb} LSB")
    return {"mesh": (dp, tp), "B": B, "T": T, "C": C, "n_frames": nf,
            "coef_shape": tuple(params.coef.shape), "coef_max_abs_err": coef_err,
            "coef_rel_err": rel, "medians_max_abs_err": med_err,
            "replay_spec_max_abs_err": spec_err, "replay_spec_scale": spec_scale,
            "replay_audio_max_lsb": audio_lsb}
