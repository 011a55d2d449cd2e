"""Batched chance-level runner vs the sequential per-run path."""

import configparser

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from closed_loop_seeg_speech_synthesis_tpu.eval import exp1 as exp1_mod
from closed_loop_seeg_speech_synthesis_tpu.eval.exp1_batched import make_fold_chance_runner
from closed_loop_seeg_speech_synthesis_tpu.io import loaders
from closed_loop_seeg_speech_synthesis_tpu.runtime import params as params_io, trainer


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    rng = np.random.RandomState(5)
    tmp = tmp_path_factory.mktemp("bsess")
    eeg_sr, audio_sr, n_words = 1024, 48000, 4
    eeg = rng.randn(3 * n_words * eeg_sr, 4)
    t = np.arange(3 * n_words * audio_sr) / audio_sr
    audio = 0.3 * np.sin(2 * np.pi * 210 * t)
    markers = [["experimentStarted"]]
    for w in ["aa", "bb", "cc", "dd"]:
        markers += [[f"start;{w}"], [f"end;{w}"]]
    markers += [["experimentEnded"]]
    loaders.save_hdf5(str(tmp / "speech1.hdf"), eeg, eeg_sr, audio, audio_sr, markers=markers)
    res = trainer.train(eeg, audio, eeg_sr, audio_sr, bad_channels=[], nb_feats=10)
    params_io.store_training(str(tmp), res, bad_channels=[])
    return str(tmp)


def test_batched_matches_sequential_single_run(session, tmp_path):
    cfg = configparser.ConfigParser()
    cfg["Experiment1"] = {"griffin_lim_norm": "10"}
    e = exp1_mod.Experiment1(cfg, session, str(tmp_path), rng=np.random.RandomState(2))
    args = e._construct_datasets_for_run(nb_folds=2, randomize=False)
    k, x_train, y_train, x_test, y_test, eeg_sr, audio_sr, bad, norm = args[0]

    runner, n_frames = make_fold_chance_runner(
        x_train, y_train, x_test, float(eeg_sr), float(audio_sr),
        np.asarray(bad, int), float(norm), nb_feats=10, dtype=jnp.float64)
    shift = 777
    key = jax.random.PRNGKey(9)
    reco_b = np.asarray(runner(jnp.asarray([shift], jnp.int32), key))[0]
    assert reco_b.shape == (n_frames, 40)

    # sequential: same shift through the host trainer + decoder
    x_shifted = np.vstack([x_train[shift:], x_train[:shift]])
    fold_key = jax.random.fold_in(key, 0)
    _, reco_s, _, _ = exp1_mod.train_decode_fold(
        1, x_shifted, y_train, x_test, y_test, eeg_sr, audio_sr, bad, norm,
        dtype=jnp.float64, key=fold_key, nb_feats=10)

    assert reco_b.shape == reco_s.shape
    # feature ORDER differs (top_k vs argsort) but the selected SET and the
    # resulting predictions should agree except at exact score ties
    agree = (np.isclose(reco_b, reco_s, rtol=1e-6, atol=1e-9)).mean()
    assert agree > 0.99, f"agreement {agree}"


def test_chance_level_batched_api(session, tmp_path):
    cfg = configparser.ConfigParser()
    cfg["Experiment1"] = {"griffin_lim_norm": "10"}
    e = exp1_mod.Experiment1(cfg, session, str(tmp_path), rng=np.random.RandomState(3))
    means, stds = e.chance_level_batched(nb_runs=3, nb_folds=2, batch_size=2,
                                         dtype=jnp.float64, save=False, nb_feats=10)
    assert means.shape == (40,) and stds.shape == (40,)
    assert np.isfinite(means).any()


def test_chance_level_checkpoint_resume(session, tmp_path, monkeypatch):
    """Crash-resume parity of the protocol checkpointing: a run that dies
    mid-fold (a crashed process, benchmarks/exp1_protocol.py) resumes from
    the per-chunk checkpoints and returns EXACTLY the clean run's result
    (the shift stream is drawn upfront from the seeded rng, so a fresh
    process re-derives identical chunks)."""
    from closed_loop_seeg_speech_synthesis_tpu.eval import exp1_batched

    cfg = configparser.ConfigParser()
    cfg["Experiment1"] = {"griffin_lim_norm": "10"}

    def run(ck=None, fail_after=None):
        e = exp1_mod.Experiment1(cfg, session, str(tmp_path),
                                 rng=np.random.RandomState(7))
        if fail_after is not None:
            real_make = exp1_batched.make_chance_runner
            calls = {"n": 0}

            def flaky_make(*a, **kw):
                runner, n_frames = real_make(*a, **kw)

                def flaky_runner(*ra):
                    calls["n"] += 1
                    if calls["n"] > fail_after:
                        raise RuntimeError("simulated device worker crash")
                    return runner(*ra)

                return flaky_runner, n_frames

            monkeypatch.setattr(exp1_batched, "make_chance_runner", flaky_make)
            try:
                return e.chance_level_batched(nb_runs=4, nb_folds=2, batch_size=2,
                                              dtype=jnp.float64, save=False,
                                              nb_feats=10, checkpoint_dir=ck)
            finally:
                monkeypatch.setattr(exp1_batched, "make_chance_runner", real_make)
        return e.chance_level_batched(nb_runs=4, nb_folds=2, batch_size=2,
                                      dtype=jnp.float64, save=False,
                                      nb_feats=10, checkpoint_dir=ck)

    clean_means, clean_stds = run()

    ck = str(tmp_path / "ckpt")
    with pytest.raises(RuntimeError, match="simulated device worker crash"):
        run(ck=ck, fail_after=1)  # dies after 1 of 4 chunk calls
    import os

    assert any(f.startswith("chance_fold_00_c") for f in os.listdir(ck))

    means, stds = run(ck=ck)  # resume: restores chunk 0, computes the rest
    np.testing.assert_array_equal(means, clean_means)
    np.testing.assert_array_equal(stds, clean_stds)
    # completed folds collapse to per-fold files; chunk files are cleaned
    names = os.listdir(ck)
    assert sorted(n for n in names if "_c" not in n) == [
        "chance_fold_00_r4.npy", "chance_fold_01_r4.npy"]
    assert not any("_c0" in n for n in names)

    means3, _ = run(ck=ck)  # pure restore, no device work
    np.testing.assert_array_equal(means3, clean_means)


def test_batched_proposed_matches_sequential(session, tmp_path):
    """Vmapped proposed-fold sweep == sequential per-fold retrain+decode
    (spectrograms; GL audio uses independent keys and is checked for shape)."""
    cfg = configparser.ConfigParser()
    cfg["Experiment1"] = {"griffin_lim_norm": "10"}
    e = exp1_mod.Experiment1(cfg, session, str(tmp_path), rng=np.random.RandomState(4))
    args = e._construct_datasets_for_run(nb_folds=2, randomize=False)

    reco_b, orig_b, audio_b = e._run_folds_batched(args, dtype=jnp.float64, nb_feats=10)
    results = [exp1_mod.train_decode_fold(*a, dtype=jnp.float64, nb_feats=10)
               for a in args]
    reco_s = np.vstack([r[1] for r in results])
    orig_s = np.vstack([r[2] for r in results])
    audio_s = np.hstack([r[3] for r in results])

    assert reco_b.shape == reco_s.shape
    np.testing.assert_array_equal(orig_b, orig_s)
    assert audio_b.shape == audio_s.shape
    agree = np.isclose(reco_b, reco_s, rtol=1e-6, atol=1e-9).mean()
    assert agree > 0.99, f"agreement {agree}"


def test_proposed_method_batched_end_to_end(session, tmp_path):
    cfg = configparser.ConfigParser()
    cfg["Experiment1"] = {"griffin_lim_norm": "10"}
    e = exp1_mod.Experiment1(cfg, session, str(tmp_path), rng=np.random.RandomState(6))
    corrs = e.proposed_method(nb_folds=2)
    assert np.isfinite(np.asarray(corrs)).any()
    import os
    assert os.path.exists(os.path.join(str(tmp_path), "pm_reco.npy"))
    assert os.path.exists(os.path.join(str(tmp_path), "reco_wavs"))
