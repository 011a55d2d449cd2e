"""Full-scale exp1 benchmark: 100-word synthetic session, 64 channels.

Times the evaluation suite's heaviest workload at the reference's scale
(eval_steps/exp1.py runs 10 CV folds of full retrain+decode serially through
a ThreadPool(1), exp1.py:111,142).  Here the proposed-method folds run as
batched device programs (eval/exp1_batched.make_proposed_runner, lax.map
over folds) and the chance level as a batched shift run.

Prints one JSON line per phase: wall seconds + mean per-bin Pearson r
(sanity: proposed >> chance on word-locked synthetic data).

Run:  python benchmarks/exp1_full.py [workdir]
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


def main(workdir="/tmp/exp1_full", n_words=100, n_channels=64, chance_runs=3):
    from closed_loop_seeg_speech_synthesis_tpu.utils import setup_runtime
    setup_runtime()
    from demo import make_synthetic_session
    from closed_loop_seeg_speech_synthesis_tpu.eval import exp1 as exp1_mod
    from closed_loop_seeg_speech_synthesis_tpu.runtime import params as params_io
    from closed_loop_seeg_speech_synthesis_tpu.runtime import trainer

    os.makedirs(workdir, exist_ok=True)
    rec = os.path.join(workdir, "speech1.hdf")
    if not os.path.exists(rec):
        make_synthetic_session(rec, n_words=n_words, n_channels=n_channels)
    if not os.path.exists(os.path.join(workdir, "params.h5")):
        import h5py

        with h5py.File(rec) as hf:
            eeg, audio = hf["sEEG"][:], hf["Audio"][:]
            eeg_sr, audio_sr = int(hf["sEEG_sr"][()]), int(hf["Audio_sr"][()])
        t0 = time.perf_counter()
        res = trainer.train(eeg, audio, eeg_sr, audio_sr, bad_channels=[])
        params_io.store_training(workdir, res, bad_channels=[])
        print(json.dumps({"metric": "exp1_full_train_s",
                          "value": round(time.perf_counter() - t0, 1), "unit": "s"}))

    cfg = configparser.ConfigParser()
    cfg["Experiment1"] = {"griffin_lim_norm": "10"}
    dest = os.path.join(workdir, "eval")
    os.makedirs(dest, exist_ok=True)
    e = exp1_mod.Experiment1(cfg, workdir, dest, rng=np.random.RandomState(0))

    t0 = time.perf_counter()
    pm_mean, _pm_std = e.proposed_method()
    t_prop = time.perf_counter() - t0
    r_prop = float(np.mean(pm_mean))

    # per-fold quality guard: a mean-only check once hid an XLA vmap
    # miscompile that zeroed entire folds' models (lanes 0-1 of each chunk)
    # while later folds stayed perfect — every fold must decode well.
    reco = np.load(os.path.join(dest, "pm_reco.npy"))
    orig = np.load(os.path.join(dest, "orig.npy"))
    frames_per_fold = len(reco) // 10
    fold_rs = []
    for f in range(10):
        o = orig[f * frames_per_fold : (f + 1) * frames_per_fold]
        r = reco[f * frames_per_fold : (f + 1) * frames_per_fold]
        rs = [np.corrcoef(o[:, b], r[:, b])[0, 1] for b in range(o.shape[1])]
        fold_rs.append(float(np.nanmean(rs)))
    print(json.dumps({"metric": "exp1_full_proposed_10fold_s",
                      "value": round(t_prop, 1), "unit": "s",
                      "mean_r": round(r_prop, 3),
                      "per_fold_r": [round(r, 3) for r in fold_rs],
                      "vs_baseline": round(305.0 / t_prop, 2)}))
    assert min(fold_rs) > 0.5, f"fold-level decode quality collapse: {fold_rs}"

    t0 = time.perf_counter()
    rc_mean, _rc_std = e.chance_level_batched(nb_runs=chance_runs, save=False)
    t_chance = time.perf_counter() - t0
    r_chance = float(np.mean(rc_mean))
    print(json.dumps({"metric": f"exp1_full_chance_{chance_runs}x10fold_s",
                      "value": round(t_chance, 1), "unit": "s",
                      "mean_r": round(r_chance, 3),
                      "vs_baseline": round(313.0 / t_chance, 2)}))
    assert r_prop > 5 * max(r_chance, 0.02), (r_prop, r_chance)


if __name__ == "__main__":
    main(*sys.argv[1:2])
