"""Full eval-suite recorded run: exp1 + exp2 + exp3 + exp4 + all figures.

benchmarks/exp1_full.py times the heaviest workload (exp1); this harness
records ONE timed end-to-end pass of the REST of the paper's evaluation on
the same full-scale synthetic session (100 words, 64 channels), the way the
reference's eval_steps/ are run over a real study session
(exp2.py:115-134, exp3.py:47-67, exp4.py:119-211, figure_3.py, figure_4.py).

Phases, each emitting a JSON line with wall seconds and a quality stat:
  train          -> params.h5 (skipped when cached)
  decode_runs    -> fabricate "whisper"/"imagine" decoding runs by decoding
                    the session sEEG through the trained model (run
                    artifacts: audio.wav, sEEG.hdf, markers.csv,
                    first_timestamp.npy — decode.py:186-211)
  exp1_mini      -> batched 10-fold proposed + 2 chance runs (figure_3 input)
  exp2           -> matched-trial DTW r + batched chance per run
  exp3           -> VAD speech proportion inside/outside trials
  exp4           -> activation matrix + paper-style activation map
  figure_3/4     -> the paper figures

Quality asserts in the style of exp1_full's fold guard: exp2 matched >>
chance, exp3 finds speech inside trials, exp4 activations finite.

Run:  python benchmarks/eval_full.py [workdir]
"""

from __future__ import annotations

import configparser
import json
import os
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "examples"))
sys.path.insert(0, os.path.join(_ROOT, "tests"))


def _emit(**kw):
    print(json.dumps(kw), flush=True)


def _phase(name):
    class _T:
        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.wall = time.perf_counter() - self.t0

    return _T()


def _fabricate_run(run_dir, session_rec, spec, audio, words, eeg, eeg_sr):
    """Write the decode-run artifact set a live session would leave behind
    (decode.py:186-211)."""
    import h5py
    from scipy.io.wavfile import write as wavwrite

    os.makedirs(run_dir, exist_ok=True)
    wavwrite(os.path.join(run_dir, "audio.wav"), 16000, np.asarray(audio, np.int16))
    np.save(os.path.join(run_dir, "spectrogram.npy"), np.asarray(spec))
    np.save(os.path.join(run_dir, "first_timestamp.npy"), np.array(100.0))
    with open(os.path.join(run_dir, "markers.csv"), "w") as f:
        for i, w in enumerate(words):
            f.write(f"wall,{100.0 + 3 * i:.2f},start;{w}\n")
            f.write(f"wall,{100.0 + 3 * i + 2:.2f},end;{w}\n")
    with h5py.File(os.path.join(run_dir, "sEEG.hdf"), "w") as hf:
        hf.create_dataset("sEEG", data=eeg)
        hf.create_dataset("sEEG_sr", data=eeg_sr, dtype=np.int32)


def main(workdir="/tmp/eval_full", n_words=100, n_channels=64):
    from closed_loop_seeg_speech_synthesis_tpu.utils import setup_runtime
    setup_runtime()
    import h5py
    import jax
    import jax.numpy as jnp
    from demo import make_synthetic_session
    from test_io import write_test_xdf
    from closed_loop_seeg_speech_synthesis_tpu.eval import exp1 as exp1_mod
    from closed_loop_seeg_speech_synthesis_tpu.eval.exp2 import Experiment2
    from closed_loop_seeg_speech_synthesis_tpu.eval.exp3 import run_experiment3
    from closed_loop_seeg_speech_synthesis_tpu.eval.exp4 import Experiment4
    from closed_loop_seeg_speech_synthesis_tpu.eval.figures import figure_3, figure_4
    from closed_loop_seeg_speech_synthesis_tpu.runtime import params as params_io
    from closed_loop_seeg_speech_synthesis_tpu.runtime import pipeline, trainer

    os.makedirs(workdir, exist_ok=True)
    rec = os.path.join(workdir, "speech1.hdf")
    if not os.path.exists(rec):
        make_synthetic_session(rec, n_words=n_words, n_channels=n_channels)
    with h5py.File(rec) as hf:
        eeg, audio = hf["sEEG"][:], hf["Audio"][:]
        eeg_sr, audio_sr = int(hf["sEEG_sr"][()]), int(hf["Audio_sr"][()])
        ch_names = [c.decode() if isinstance(c, bytes) else c for c in hf["ch_names"][:]]
    words = ["w{:02d}".format(i % 10) for i in range(n_words)]

    if not os.path.exists(os.path.join(workdir, "params.h5")):
        with _phase("train") as t:
            res = trainer.train(eeg, audio, eeg_sr, audio_sr, bad_channels=[])
            params_io.store_training(workdir, res, bad_channels=[])
        _emit(metric="eval_full_train_s", value=round(t.wall, 1), unit="s")

    # other-task XDF for exp2's chance segments (load_only_eeg surface)
    other = os.path.join(workdir, "othertask.xdf")
    if not os.path.exists(other):
        rng = np.random.RandomState(3)
        ot_eeg = rng.randn(120 * eeg_sr, n_channels).astype(np.float32)
        ot_audio = (0.05 * rng.randn(120 * 8000)).astype(np.float32)
        write_test_xdf(other, ot_eeg, eeg_sr, ot_audio, 8000,
                       [(100.5, "experimentStarted"), (219.0, "experimentEnded")],
                       ch_names)

    # ---- decode runs (whisper / imagine) -----------------------------
    loaded = params_io.load_params(os.path.join(workdir, "params.h5"))
    cfg = pipeline.DecoderConfig(sr=float(eeg_sr), n_channels=n_channels, gl_norm=10.0,
                                 dtype=jnp.float32)
    dec = pipeline.build_decoder_params(cfg, loaded["lda"], loaded["medians"], loaded["select"])
    with _phase("runs") as t:
        for i, run in enumerate(("whisper", "imagine")):
            run_dir = os.path.join(workdir, run)
            if os.path.exists(os.path.join(run_dir, "audio.wav")):
                continue
            spec, wav = pipeline.offline_decode(dec, cfg, eeg, key=jax.random.PRNGKey(i))
            _fabricate_run(run_dir, rec, spec, wav, words, eeg, eeg_sr)
    _emit(metric="eval_full_decode_runs_s", value=round(t.wall, 1), unit="s")

    temp_root = os.path.join(workdir, "eval_out")
    cfgp = configparser.ConfigParser()
    cfgp["Experiment1"] = {"griffin_lim_norm": "10"}
    cfgp["Experiment2"] = {"griffin_lim_norm": "10"}
    cfgp["Experiment3"] = {"decoding_runs": "whisper,imagine",
                           "vad_energy_threshold": "0.5", "vad_energy_mean_scale": "1",
                           "vad_frames_context": "5", "vad_proportion_threshold": "0.6"}

    # ---- exp1 (mini: figure_3 inputs; full timing in exp1_full) ------
    exp1_dir = os.path.join(temp_root, "exp1")
    os.makedirs(exp1_dir, exist_ok=True)
    if not os.path.exists(os.path.join(exp1_dir, "pm_reco.npy")):
        with _phase("exp1") as t:
            e1 = exp1_mod.Experiment1(cfgp, workdir, exp1_dir, rng=np.random.RandomState(0))
            # Decompose the wall: the host fold staging (mask cuts, float64
            # copies, per-fold audio decimate + spectrogram) is one-time work
            # shared by the proposed and chance arms; device time for the
            # batched 10-fold program is measured separately in exp1_ab.
            t0 = time.perf_counter()
            fold_args = e1._construct_datasets_for_run(10)
            staging_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            pm_mean, _ = e1.proposed_method(args=fold_args)
            proposed_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            rc_mean, _ = e1.chance_level_batched(nb_runs=2, save=True,
                                                 base_args=fold_args)
            chance_s = time.perf_counter() - t0
        # "mini" in the metric name: 2 chance runs as a regression gate /
        # figure_3 input only — the protocol-scale 100-run number is
        # benchmarks/exp1_protocol.py's
        _emit(metric="eval_full_exp1_mini_s", value=round(t.wall, 1), unit="s",
              staging_s=round(staging_s, 1), proposed_s=round(proposed_s, 1),
              chance_s=round(chance_s, 1), chance_runs=2,
              mean_r=round(float(np.mean(pm_mean)), 3),
              chance_r=round(float(np.mean(rc_mean)), 3))

    # ---- exp2 --------------------------------------------------------
    exp2_dir = os.path.join(temp_root, "exp2")
    for run in ("whisper", "imagine"):
        with _phase("exp2") as t:
            e2 = Experiment2(cfgp, workdir, os.path.join(workdir, run),
                             ["othertask.xdf"], exp2_dir, rng=np.random.RandomState(1))
            e2.run(runs=20, which="both")
        pm = np.load(os.path.join(exp2_dir, f"exp2_{run}_pm.npy"))
        ch = np.load(os.path.join(exp2_dir, f"exp2_{run}_chance.npy"))
        _emit(metric=f"eval_full_exp2_{run}_s", value=round(t.wall, 1), unit="s",
              matched_median_r=round(float(np.median(pm)), 3),
              chance_median_r=round(float(np.median(ch)), 3))
        assert np.median(pm) > 3 * max(np.median(ch), 0.01), (np.median(pm), np.median(ch))

    # ---- exp3 --------------------------------------------------------
    with _phase("exp3") as t:
        res3 = run_experiment3(cfgp, workdir, os.path.join(temp_root, "exp3"))
    stats = {run: (round(float(a), 1), round(float(b), 1)) for run, (a, b) in res3.items()}
    _emit(metric="eval_full_exp3_s", value=round(t.wall, 1), unit="s",
          speech_s_inside_outside=stats)
    assert all(a > 0 for a, _b in res3.values()), res3

    # ---- exp4 --------------------------------------------------------
    with _phase("exp4") as t:
        e4 = Experiment4(workdir, ch_names)
        matrix = e4.compute_activations()
        exp4_dir = os.path.join(temp_root, "exp4")
        os.makedirs(exp4_dir, exist_ok=True)
        np.save(os.path.join(exp4_dir, "activations.npy"), matrix)
        e4.plot(matrix, os.path.join(exp4_dir, "activations.png"))
        e4.plot_activation_map(matrix, os.path.join(exp4_dir, "activation_map.png"))
    _emit(metric="eval_full_exp4_s", value=round(t.wall, 1), unit="s",
          act_max=round(float(np.nanmax(matrix)), 4))
    assert np.isfinite(matrix).any() and np.nanmax(np.abs(matrix)) > 0

    # ---- figures -----------------------------------------------------
    with _phase("figs") as t:
        figure_3(exp1_dir, os.path.join(temp_root, "figure_3.png"), n_chance_runs=2)
        figure_4(workdir, temp_root, os.path.join(temp_root, "figure_4.png"))
    _emit(metric="eval_full_figures_s", value=round(t.wall, 1), unit="s")
    for f in ("figure_3.png", "figure_4.png"):
        assert os.path.exists(os.path.join(temp_root, f)), f


if __name__ == "__main__":
    main(*sys.argv[1:2])
