"""THE acceptance gate: the reference *system*, executed verbatim, as oracle.

tests/test_reference_oracle.py proves node-level equivalence; this module
goes the last mile and runs the reference's composed programs — ``train.train``
(train.py:132-168) and ``decode.perform_offline_decoding``/``setup_decoder``
(decode.py:71-96,152-183) — UNMODIFIED (import harness: tests/refsys.py) on a
62 s synthetic session, and asserts against the rebuild:

* artifact interchange: a repo-written ``params.h5`` drives the reference
  decoder, and a reference-layout ``params.h5`` (pickled sklearn estimator
  blob only) drives the repo decoder;
* with the reference's ``np.random.rand(480)`` phase draws injected
  deterministically on both sides: decoded spectrograms agree BIT-FOR-BIT
  and the exact-host vocoder audio agrees BYTE-FOR-BYTE (0 LSB) over the
  whole session — stronger than the <=1-LSB gate;
* the production jnp vocoder (a different FFT/rounding path feeding the
  chaotic exp(angle) iteration, see docs/NUMERICS.md) is quality-gated:
  >=95% byte-identical samples and r >= 0.999 against the reference stream;
* the 60 Hz line-noise feature chain matches the reference's executing
  ``herff2016_b`` (local/offline.py:12) — the composed reference programs
  themselves hardcode 50 Hz (train.py:122 and decode.py:155-156 never pass
  ``line_noise``), so 60 Hz is only reachable at this layer.

Wall-clock note: the reference decode replays the full DAG in forked
processes (~50 s); everything is computed once in a module-scoped fixture.
"""

from __future__ import annotations

import os
import pickle
import sys

import h5py
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

import refsys  # noqa: E402

pytestmark = pytest.mark.skipif(
    not os.path.isdir(os.path.join(refsys.REF_DIR, "local")),
    reason="reference repo not available",
)

EEG_SR, AUDIO_SR = 1024, 48000
SECONDS = 62.0


@pytest.fixture(scope="module")
def sys_ab(tmp_path_factory):
    """Run reference train+decode and repo train+decode once, shared params."""
    import jax
    import jax.numpy as jnp

    from closed_loop_seeg_speech_synthesis_tpu.models import lda as lda_mod
    from closed_loop_seeg_speech_synthesis_tpu.runtime import params as params_mod
    from closed_loop_seeg_speech_synthesis_tpu.runtime import pipeline, trainer

    ref = refsys.import_reference_system()
    eeg, audio = refsys.synth_session(seconds=SECONDS, eeg_sr=EEG_SR,
                                      audio_sr=AUDIO_SR)

    # --- both trainers on the identical session -------------------------
    ref_train = ref.train.train(eeg.copy(), audio.copy(), EEG_SR, AUDIO_SR, [])
    rx, ry, ref_medians, ref_estimators, ref_select = ref_train
    res = trainer.train(eeg.copy(), audio.copy(), float(EEG_SR),
                        float(AUDIO_SR), [], dtype=jnp.float64)

    # --- repo-trained artifacts through the repo's own store path -------
    session_dir = str(tmp_path_factory.mktemp("session"))
    params_path = params_mod.store_training(session_dir, res, [])

    # --- reference decode, repo-trained params, injected phase draws ----
    # load the h5 exactly the way decode.py:299-306 does
    with h5py.File(params_path, "r") as hf:
        blob = hf["estimators"][...].tobytes()
        medians_h5 = hf["medians_array"][:]
        bad_h5 = hf["bad_channels"][:]
        select_h5 = hf["select"][:]
    rows = refsys.deterministic_rand_rows(int(SECONDS * 110))
    undo = refsys.install_np_rand_rows(rows)
    try:
        spec_ref, audio_ref, seeg_ref, _ = ref.decode.perform_offline_decoding(
            (blob, medians_h5, bad_h5, select_h5), eeg.copy(), EEG_SR, 10)
    finally:
        undo()

    # --- repo decode, the same params and the same draws -----------------
    cfg = pipeline.DecoderConfig(sr=float(EEG_SR), n_channels=eeg.shape[1],
                                 dtype=jnp.float64)
    dec = pipeline.build_decoder_params(cfg, res.lda, res.medians, res.select)
    spec, audio_jnp = pipeline.offline_decode(
        dec, cfg, eeg, rand_init=rows[: spec_ref.shape[0] - 1])

    return dict(ref=ref, eeg=eeg, audio=audio, rows=rows,
                ref_medians=ref_medians, ref_estimators=ref_estimators,
                ref_select=ref_select, ref_x=rx,
                res=res, cfg=cfg, params_path=params_path,
                spec_ref=np.asarray(spec_ref), audio_ref=np.asarray(audio_ref),
                seeg_ref=np.asarray(seeg_ref),
                spec=np.asarray(spec), audio_jnp=np.asarray(audio_jnp),
                lda_mod=lda_mod, pipeline=pipeline, params_mod=params_mod)


def test_train_parity(sys_ab):
    """train.train vs runtime.trainer.train on the identical session."""
    s = sys_ab
    np.testing.assert_allclose(s["res"].medians, s["ref_medians"],
                               rtol=0, atol=5e-12)
    assert np.array_equal(np.sort(s["res"].select), np.sort(s["ref_select"]))
    # the fitted models agree as predictors: identical labels on the
    # training features (sklearn svd solver vs batched Gram-eigh)
    import jax.numpy as jnp

    from closed_loop_seeg_speech_synthesis_tpu.models.lda import predict

    x = np.asarray(s["res"].x_train, np.float64)
    ours = np.asarray(predict(s["lda_mod"].from_sklearn_estimators(
        s["ref_estimators"], dtype=jnp.float64), jnp.asarray(x)))
    theirs = np.stack([e.predict(x) for e in s["ref_estimators"]], axis=1)
    assert np.array_equal(ours, theirs)


def test_spectrogram_bit_exact(sys_ab):
    """Composed-system decoded spectrograms agree BIT-FOR-BIT (shared
    params.h5, repo-trained): the exact-lattice smoothing (ops/smoothing)
    removes the last ulp of divergence."""
    s = sys_ab
    assert s["spec"].shape == s["spec_ref"].shape
    assert np.array_equal(s["spec"], s["spec_ref"])


def test_audio_byte_exact_host_vocoder(sys_ab):
    """Exact-host vocoder on the repo spectrogram == reference stream audio
    to the BYTE (includes the reference's FP-jittered 159/161-sample
    emission grid, GriffinLim.py:115-120)."""
    from closed_loop_seeg_speech_synthesis_tpu.ops.host_vocoder import (
        decode_audio_exact,
    )

    s = sys_ab
    got = decode_audio_exact(s["spec"], s["rows"], norm_factor=10.0)
    assert got.shape == s["audio_ref"].shape
    assert got.dtype == s["audio_ref"].dtype == np.int16
    assert np.array_equal(got, s["audio_ref"])


def test_audio_jnp_vocoder_quality(sys_ab):
    """The production jnp vocoder against the reference stream: its
    direct-DFT matmuls round differently from np.fft, and the exp(angle)
    recursion is chaotic, so byte-parity is a host-vocoder property; the
    waveforms still agree on >=95% of samples byte-for-byte with
    r >= 0.999 overall (measured: 98.3% / 0.99992)."""
    s = sys_ab
    a, b = s["audio_jnp"], s["audio_ref"]
    n = min(len(a), len(b))
    assert abs(len(a) - len(b)) <= 160
    exact = (a[:n] == b[:n]).mean()
    r = np.corrcoef(a[:n].astype(np.float64), b[:n].astype(np.float64))[0, 1]
    assert exact >= 0.95 and r >= 0.999


def test_params_interchange_ref_to_repo(sys_ab, tmp_path):
    """A reference-layout params.h5 (train.py:190-196 keys only, pickled
    sklearn blob) loads into the repo and decodes: the repo decode of the
    reference-trained model matches the repo decode path that used
    reference estimator objects directly."""
    import jax.numpy as jnp

    s = sys_ab
    path = os.path.join(str(tmp_path), "params.h5")
    with h5py.File(path, "w") as hf:  # exactly the reference's writer layout
        hf.create_dataset("bad_channels", data=np.array([], np.int64))
        hf.create_dataset("medians_array", data=s["ref_medians"])
        hf.create_dataset("estimators",
                          data=np.void(pickle.dumps(s["ref_estimators"])))
        hf.create_dataset("select", data=np.asarray(s["ref_select"]))
    loaded = s["params_mod"].load_params(path, dtype=jnp.float64)
    assert np.array_equal(loaded["select"], s["ref_select"])
    dec = s["pipeline"].build_decoder_params(s["cfg"], loaded["lda"],
                                             loaded["medians"],
                                             loaded["select"])
    n = 6 * EEG_SR
    spec, _ = s["pipeline"].offline_decode(dec, s["cfg"], s["eeg"][:n])
    spec = np.asarray(spec)
    assert np.isfinite(spec).all()
    # and against the reference system itself at the matching prefix: the
    # pipeline is causal, so the first frames of the full-session reference
    # run are comparable.  Params differ here (ref-trained vs the fixture's
    # repo-trained) by ~1e-12 in medians/coefs, so near-tie argmax flips are
    # possible in principle — gate on "essentially all" frames within the
    # medians' own tolerance rather than bit-equality.
    m = min(spec.shape[0], s["spec_ref"].shape[0])
    d = np.abs(spec[:m] - s["spec_ref"][:m])
    assert (d < 1e-10).mean() >= 0.999


def test_decode_writes_replayable_seeg(sys_ab):
    """decode.py's replay artifact contract: the sEEG the reference decoder
    received (and would persist to sEEG.hdf) is the input stream."""
    s = sys_ab
    assert np.array_equal(s["seeg_ref"], s["eeg"])


def test_system_parity_2048hz(tmp_path):
    """The composed system at the SECOND amplifier rate: the reference's own
    exp2 drives ``perform_offline_decoding(..., sfreq=2048, ...)``
    (eval_steps/exp2.py:56), so 2048 Hz is a supported composed path — run
    it verbatim on a 30 s session and assert the same gates as 1024 Hz:
    spectrograms bit-equal, exact-host audio byte-equal."""
    import jax.numpy as jnp

    from closed_loop_seeg_speech_synthesis_tpu.ops.host_vocoder import (
        decode_audio_exact,
    )
    from closed_loop_seeg_speech_synthesis_tpu.runtime import pipeline, trainer

    ref = refsys.import_reference_system()
    eeg, audio = refsys.synth_session(seconds=30.0, eeg_sr=2048,
                                      audio_sr=AUDIO_SR, n_channels=4)
    res = trainer.train(eeg, audio, 2048.0, float(AUDIO_SR), [],
                        dtype=jnp.float64)

    import pickle as _pickle

    blob = _pickle.dumps(
        __import__("closed_loop_seeg_speech_synthesis_tpu.models.lda",
                   fromlist=["to_sklearn_estimators"]).to_sklearn_estimators(res.lda))
    rows = refsys.deterministic_rand_rows(3300)
    undo = refsys.install_np_rand_rows(rows)
    try:
        spec_ref, audio_ref, _, _ = ref.decode.perform_offline_decoding(
            (blob, res.medians, np.array([], int), res.select), eeg.copy(),
            2048, 10)
    finally:
        undo()

    cfg = pipeline.DecoderConfig(sr=2048.0, n_channels=eeg.shape[1],
                                 packet_size=64, dtype=jnp.float64)
    dec = pipeline.build_decoder_params(cfg, res.lda, res.medians, res.select)
    spec, _ = pipeline.offline_decode(dec, cfg, eeg,
                                      rand_init=rows[: spec_ref.shape[0] - 1])
    spec = np.asarray(spec)
    assert spec.shape == spec_ref.shape
    assert np.array_equal(spec, np.asarray(spec_ref))

    got = decode_audio_exact(spec, rows, norm_factor=10.0)
    assert np.array_equal(got, np.asarray(audio_ref))


def test_line_noise_60_feature_chain(sys_ab):
    """60 Hz US chain vs the reference's executing herff2016_b.  The
    composed reference programs hardcode 50 Hz (train.py:122,
    decode.py:155-156 pass no line_noise), so 60 Hz parity is only
    reachable at the offline feature layer — executed verbatim here."""
    import jax.numpy as jnp

    from closed_loop_seeg_speech_synthesis_tpu.runtime import trainer

    s = sys_ab
    sys.path.insert(0, refsys.REF_DIR)
    try:
        from local.offline import herff2016_b
    finally:
        sys.path.remove(refsys.REF_DIR)
    eeg = s["eeg"][: 8 * EEG_SR]
    want = herff2016_b(eeg.copy(), EEG_SR, 0.05, 0.01, line_noise=60)
    got = np.asarray(trainer.offline_features(eeg, float(EEG_SR),
                                              line_noise=60,
                                              dtype=jnp.float64))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=5e-9, atol=5e-11)
