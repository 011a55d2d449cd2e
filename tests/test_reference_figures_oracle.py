"""Figure-layer oracle: the reference's figure_3.py / figure_4.py executed
VERBATIM on artifact trees the rebuild produced.

This covers the last reference programs otherwise never run as composed
oracles.  The recipe matches the other oracle modules:
import the actual reference sources via tests/refsys.py, shim only
*runtime configuration* (Agg backend; ``matplotlib.rcParams['text.usetex'] =
False`` — figure_3.py:28 sets a TeX rcParam this image has no TeX for), feed
directories written exclusively by the rebuild's own writers, and assert the
statistics the reference computes equal the rebuild twins'
(``eval/figures.figure_3`` / ``figure_4``) on the same artifacts.

figure_3 consumes the FULL exp1 protocol artifact set — ``orig.npy``,
``pm_reco.npy`` and all 100 ``rc_reco_i=001..100.npy`` chance repeats
(figure_3.py:120-136 loads exactly ``range(1, 101)``) — so the fixture runs
the rebuild's ``Experiment1.chance_level_batched(nb_runs=100)`` at CI scale
(6 words / 3 folds / 4 channels; the protocol-scale run lives in
benchmarks/exp1_protocol.py).  figure_4 consumes the whisper/imagine decode
runs, the exp2 DTW artifacts, and runs the reference's Experiment3 in place.
"""

from __future__ import annotations

import configparser
import importlib.util
import logging
import os
import re
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

import refsys  # noqa: E402

pytestmark = pytest.mark.skipif(
    not os.path.isdir(os.path.join(refsys.REF_DIR, "eval_steps")),
    reason="reference repo not available",
)

WORDS_WHISPER = ["maantje", "sok", "meisjes", "tak", "sprong"]  # figure_4.py:70
WORDS_IMAGINE = ["groen", "vloog", "geen", "zonlicht", "zou"]   # figure_4.py:71


def _import_ref_figure(name):
    refsys.import_reference_system()
    import matplotlib

    matplotlib.use("Agg")
    sys.path.insert(0, refsys.REF_DIR)
    try:
        spec = importlib.util.spec_from_file_location(
            f"ref_{name}", os.path.join(refsys.REF_DIR, "eval_steps", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(refsys.REF_DIR)
    # runtime configuration, not a source edit: the module sets
    # rc('text', usetex=True) at import; this image has no TeX toolchain
    matplotlib.rcParams["text.usetex"] = False
    return mod


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__(level=logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _capture_logger(name):
    lg = logging.getLogger(name)
    h = _Capture()
    lg.addHandler(h)
    lg.setLevel(logging.INFO)
    return lg, h


def _make_session(sess_dir, words, eeg_sr=1024, audio_sr=48000, n_channels=4,
                  seed=0):
    """A word-locked training session on the fixed 3 s grid, written by the
    rebuild's save_hdf5 (already proven reference-Session-compatible by
    tests/test_reference_run_interchange.py)."""
    from closed_loop_seeg_speech_synthesis_tpu.io import loaders

    rng = np.random.RandomState(seed)
    T = 3 * len(words) * eeg_sr
    Ta = 3 * len(words) * audio_sr
    eeg = rng.randn(T, n_channels)
    audio = np.zeros(Ta)
    t_a = np.arange(2 * audio_sr) / audio_sr
    burst = np.sin(2 * np.pi * 120 * np.arange(2 * eeg_sr) / eeg_sr)
    for i, w in enumerate(words):
        f0 = 140 + 25 * (i % 5)
        eeg[i * 3 * eeg_sr : i * 3 * eeg_sr + 2 * eeg_sr, : max(1, n_channels // 2)] += \
            (1.0 + (i % 5) * 0.4) * burst[:, None]
        voiced = sum((0.4 / h) * np.sin(2 * np.pi * h * f0 * t_a) for h in range(1, 12))
        voiced += 0.02 * rng.randn(len(t_a))
        audio[i * 3 * audio_sr : i * 3 * audio_sr + 2 * audio_sr] = \
            0.3 * voiced / np.abs(voiced).max()
    markers = [["experimentStarted"]]
    for w in words:
        markers += [[f"start;{w}"], [f"end;{w}"]]
    markers += [["experimentEnded"]]
    os.makedirs(sess_dir, exist_ok=True)
    loaders.save_hdf5(os.path.join(sess_dir, "speech1.hdf"), eeg, eeg_sr, audio,
                      audio_sr, ch_names=[f"A{i}" for i in range(n_channels)],
                      markers=markers)
    return eeg, audio


# --------------------------------------------------------------------------
# figure_3 — needs the exp1 artifact tree (pm + 100 chance repeats)
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def exp1_tree(tmp_path_factory):
    import h5py

    from closed_loop_seeg_speech_synthesis_tpu.eval import exp1 as exp1_mod
    from closed_loop_seeg_speech_synthesis_tpu.runtime import params as params_io
    from closed_loop_seeg_speech_synthesis_tpu.runtime import trainer

    tmp = tmp_path_factory.mktemp("fig3")
    sess_dir = str(tmp / "sess")
    words = ["avond", "gevaar", "woord", "maan", "zon", "ster"]
    _make_session(sess_dir, words)

    with h5py.File(os.path.join(sess_dir, "speech1.hdf")) as hf:
        eeg, audio = hf["sEEG"][:], hf["Audio"][:]
        eeg_sr, audio_sr = int(hf["sEEG_sr"][()]), int(hf["Audio_sr"][()])
    res = trainer.train(eeg, audio, eeg_sr, audio_sr, bad_channels=[], nb_feats=16)
    params_io.store_training(sess_dir, res, bad_channels=[])

    cfg = configparser.ConfigParser()
    cfg["Experiment1"] = {"griffin_lim_norm": "10"}
    dest = str(tmp / "dest")
    exp1_dir = os.path.join(dest, "exp1")
    os.makedirs(exp1_dir, exist_ok=True)
    e = exp1_mod.Experiment1(cfg, sess_dir, exp1_dir, rng=np.random.RandomState(0))
    fold_args = e._construct_datasets_for_run(3)
    e.proposed_method(nb_folds=3, args=fold_args)
    e.chance_level_batched(nb_runs=100, nb_folds=3, batch_size=25,
                           base_args=fold_args, nb_feats=16, save=True)

    orig = np.load(os.path.join(exp1_dir, "orig.npy"))
    for i in (1, 50, 100):
        rc = np.load(os.path.join(exp1_dir, f"rc_reco_i={i:03}.npy"))
        assert len(rc) >= len(orig), (len(rc), len(orig))
    return sess_dir, dest, exp1_dir


def test_reference_figure3_verbatim(exp1_tree):
    """plot_figure_3 (figure_3.py:35-183) runs UNMODIFIED on the rebuild's
    exp1 artifacts + session dir: renders the PNG and computes per-bin
    Mann-Whitney statistics equal to the rebuild twin's."""
    sess_dir, dest, exp1_dir = exp1_tree
    mod = _import_ref_figure("figure_3")
    lg, cap = _capture_logger("figure_3.py")
    try:
        np.random.seed(11)  # reference Session dithers via global np.random
        mod.plot_figure_3(session_dir=sess_dir, dest_dir=dest)
    finally:
        lg.removeHandler(cap)

    png = os.path.join(dest, "figure_3.png")
    assert os.path.exists(png) and os.path.getsize(png) > 10_000

    # the reference logs one line per spec bin: U statistic + raw/Bonferroni p
    ref_stats = {}
    for m in cap.messages:
        g = re.match(r"Spec Bin: (\d+), Stat: ([\d.eE+-]+|nan), p: ([\d.eE+-]+|nan), "
                     r"p \(Bonferoni\): ([\d.eE+-]+|nan)", m)
        if g:
            ref_stats[int(g.group(1))] = (float(g.group(2)), float(g.group(3)))
    assert len(ref_stats) == 40, f"expected 40 per-bin stats, got {len(ref_stats)}"

    top = [m for m in cap.messages if m.startswith("Top five words:")]
    assert len(top) == 1

    from closed_loop_seeg_speech_synthesis_tpu.eval import figures

    twin_stats = figures.figure_3(exp1_dir, os.path.join(dest, "figure_3_twin.png"),
                                  n_chance_runs=100)
    assert len(twin_stats) == 40
    for b, stat, p, _pb in twin_stats:
        ref_u, ref_p = ref_stats[b]
        np.testing.assert_allclose(stat, ref_u, rtol=1e-9,
                                   err_msg=f"U mismatch at bin {b}")
        np.testing.assert_allclose(p, ref_p, rtol=1e-6,
                                   err_msg=f"p mismatch at bin {b}")

    # the proposed method must separate from chance even at CI scale on the
    # word-locked synthetic session (sanity that the artifacts are real)
    sig = sum(1 for _b, _s, p, _pb in twin_stats if p < 0.05)
    assert sig > 20, f"only {sig}/40 bins significant"


# --------------------------------------------------------------------------
# figure_4 — whisper/imagine run dirs + exp2 artifacts + in-place exp3
# --------------------------------------------------------------------------


def _make_run_dir(sess_dir, run_name, words, train_words, seed):
    """Decode a synthetic run and write it with the rebuild's run writers
    (store_decoding_to_file + the online marker-logger row format).

    The run sEEG carries the SAME word-locked 120 Hz bursts the training
    session encodes (amplitude keyed by the word's training index), so the
    trained LDA decodes audible speech in the trial windows — otherwise the
    decode is silence, exp3 amounts are 0 and exp2 DTW scores are NaN
    (constant log-mels)."""
    import jax.numpy as jnp

    from closed_loop_seeg_speech_synthesis_tpu.cli import decode as decode_cli
    from closed_loop_seeg_speech_synthesis_tpu.runtime import params as params_io

    rng = np.random.RandomState(seed)
    eeg_sr = 1024
    T0 = 1000.0
    secs = 3 * len(words) + 2
    eeg = rng.randn(secs * eeg_sr, 4)
    burst = np.sin(2 * np.pi * 120 * np.arange(2 * eeg_sr) / eeg_sr)
    for i, w in enumerate(words):
        ti = train_words.index(w)
        s0 = int((0.5 + 3.0 * i) * eeg_sr)
        eeg[s0 : s0 + 2 * eeg_sr, :2] += (1.0 + (ti % 5) * 0.4) * burst[:, None]
    loaded = params_io.load_params(os.path.join(sess_dir, "params.h5"),
                                   dtype=jnp.float64)
    spec, audio, received, sr = decode_cli.perform_offline_decoding(
        loaded, eeg, eeg_sr, 10)
    run_dir = os.path.join(sess_dir, run_name)
    os.makedirs(run_dir, exist_ok=True)
    cfg = configparser.ConfigParser()
    cfg["General"] = {"storage_dir": os.path.dirname(sess_dir),
                      "session": run_name}
    decode_cli.store_decoding_to_file(run_dir, cfg, spec, audio, received, sr)
    np.save(os.path.join(run_dir, "first_timestamp.npy"), np.float64(T0))
    with open(os.path.join(run_dir, "markers.csv"), "w") as f:
        f.write(f"2026-08-19 12:00:00.100000,{T0 + 0.1!r},experimentStarted\n")
        for i, w in enumerate(words):
            s = 0.5 + 3.0 * i
            f.write(f"2026-08-19 12:00:{s:09.6f},{T0 + s!r},start;{w}\n")
            f.write(f"2026-08-19 12:00:{s + 2:09.6f},{T0 + s + 2!r},end;{w}\n")
        f.write(f"2026-08-19 12:00:{secs - 0.5:09.6f},{T0 + secs - 0.5!r},experimentEnded\n")
    return run_dir


@pytest.fixture(scope="module")
def fig4_tree(tmp_path_factory):
    from test_io import write_test_xdf

    from closed_loop_seeg_speech_synthesis_tpu.eval.exp2 import Experiment2
    from closed_loop_seeg_speech_synthesis_tpu.runtime import params as params_io
    from closed_loop_seeg_speech_synthesis_tpu.runtime import trainer

    tmp = tmp_path_factory.mktemp("fig4")
    sess_dir = str(tmp / "sess")
    # the training session carries BOTH word sets so exp2's matched-trials
    # intersection is the run's full word list
    words = WORDS_WHISPER + WORDS_IMAGINE
    eeg, audio = _make_session(sess_dir, words)
    import h5py

    with h5py.File(os.path.join(sess_dir, "speech1.hdf")) as hf:
        eeg_sr, audio_sr = int(hf["sEEG_sr"][()]), int(hf["Audio_sr"][()])
    res = trainer.train(eeg, audio, eeg_sr, audio_sr, bad_channels=[], nb_feats=16)
    params_io.store_training(sess_dir, res, bad_channels=[])

    rng = np.random.RandomState(3)
    ot_eeg = rng.randn(6 * eeg_sr, 4).astype(np.float32)
    ot_audio = (0.1 * rng.randn(6 * audio_sr)).astype(np.float32)
    write_test_xdf(os.path.join(sess_dir, "othertask.xdf"), ot_eeg, eeg_sr,
                   ot_audio, audio_sr,
                   [(100.2, "experimentStarted"), (105.8, "experimentEnded")],
                   [f"A{i}" for i in range(4)])

    _make_run_dir(sess_dir, "whisper", WORDS_WHISPER, words, seed=21)
    _make_run_dir(sess_dir, "imagine", WORDS_IMAGINE, words, seed=22)

    dest = str(tmp / "dest")
    exp2_dir = os.path.join(dest, "exp2")
    cfg = configparser.ConfigParser()
    cfg["Experiment2"] = {"griffin_lim_norm": "10"}
    for run in ("whisper", "imagine"):
        e2 = Experiment2(cfg, sess_dir, os.path.join(sess_dir, run),
                         ["othertask.xdf"], exp2_dir, rng=np.random.RandomState(5))
        e2.run(runs=8, which="both")
    for run in ("whisper", "imagine"):
        assert os.path.exists(os.path.join(exp2_dir, f"exp2_{run}_pm.npy"))
        assert os.path.exists(os.path.join(exp2_dir, f"exp2_{run}_chance.npy"))
    return sess_dir, dest


def test_reference_figure4_verbatim(fig4_tree, monkeypatch):
    """plot_figure_4 (figure_4.py:31-231) runs UNMODIFIED on the rebuild's
    session tree: reference DecodingRun consumes both run dirs, the
    reference's Experiment3 runs in place, the PNG renders, and every
    statistic it logs equals the rebuild's on the same artifacts."""
    sess_dir, dest = fig4_tree
    mod = _import_ref_figure("figure_4")

    cfg = configparser.ConfigParser()
    cfg["Experiment3"] = {  # reference config/evaluation.ini values
        "vad_energy_threshold": "0.5", "vad_energy_mean_scale": "1",
        "vad_frames_context": "5", "vad_proportion_threshold": "0.6",
    }
    mod.config = cfg  # the module global __main__ would have set

    # hold the VAD dither equal between the reference's in-place Experiment3
    # and the rebuild twin regardless of call order: dither depends only on
    # the audio length (same technique as the seeded streams in
    # test_reference_run_interchange.py, robust to interleaving)
    orig_normal = np.random.normal

    def pinned_normal(loc=0.0, scale=1.0, size=None):
        if np.isscalar(size) and scale == 0.0001:
            return np.random.RandomState(4242 + int(size) % 9973).normal(loc, scale, size)
        return orig_normal(loc, scale, size)

    monkeypatch.setattr(np.random, "normal", pinned_normal)

    lg, cap = _capture_logger("figure_4.py")
    try:
        mod.plot_figure_4(session_dir=sess_dir, dest_dir=dest)
    finally:
        lg.removeHandler(cap)

    png = os.path.join(dest, "figure_4.png")
    assert os.path.exists(png) and os.path.getsize(png) > 10_000

    # --- statistics parity vs the artifacts + rebuild twins ---------------
    from closed_loop_seeg_speech_synthesis_tpu.eval.metrics import mann_whitney_u

    logs = "\n".join(cap.messages)
    for run in ("whisper", "imagine"):
        pm = np.load(os.path.join(dest, "exp2", f"exp2_{run}_pm.npy"))
        ch = np.load(os.path.join(dest, "exp2", f"exp2_{run}_chance.npy"))
        ch = ch[~np.isnan(ch)]
        m = re.search(rf"Median DTW scores \({run}\) ([\d.eE+-]+)", logs)
        np.testing.assert_allclose(float(m.group(1)), np.median(pm), rtol=1e-12)
        m = re.search(rf"Chance DTW scores \({run}\) ([\d.eE+-]+)", logs)
        np.testing.assert_allclose(float(m.group(1)), np.median(ch), rtol=1e-12)
        m = re.search(rf"Mann-Whitney U Test {run}: MannwhitneyuResult\("
                      rf"statistic=(?:np\.float64\()?([\d.eE+-]+)\)?, "
                      rf"pvalue=(?:np\.float64\()?([\d.eE+-]+)\)?\)", logs)
        assert m, f"no MW log for {run}:\n{logs}"
        u, p = mann_whitney_u(pm, ch)
        np.testing.assert_allclose(float(m.group(1)), u, rtol=1e-12)
        np.testing.assert_allclose(float(m.group(2)), p, rtol=1e-9)
    # (the in-place Experiment3 amounts go through print(), not the logger —
    # compared in test_reference_figure4_exp3_amounts)


def test_reference_figure4_exp3_amounts(fig4_tree, monkeypatch, capsys):
    """The exp3 speech amounts the reference computes INSIDE plot_figure_4
    (figure_4.py:186-199, via print()) equal the rebuild's Experiment3 on the
    same repo-written run dirs with the dither stream held equal."""
    sess_dir, dest = fig4_tree
    mod = _import_ref_figure("figure_4")
    cfg = configparser.ConfigParser()
    cfg["Experiment3"] = {
        "vad_energy_threshold": "0.5", "vad_energy_mean_scale": "1",
        "vad_frames_context": "5", "vad_proportion_threshold": "0.6",
    }
    mod.config = cfg

    orig_normal = np.random.normal

    def pinned_normal(loc=0.0, scale=1.0, size=None):
        if np.isscalar(size) and scale == 0.0001:
            return np.random.RandomState(4242 + int(size) % 9973).normal(loc, scale, size)
        return orig_normal(loc, scale, size)

    monkeypatch.setattr(np.random, "normal", pinned_normal)
    mod.plot_figure_4(session_dir=sess_dir, dest_dir=dest)
    out = capsys.readouterr().out

    from closed_loop_seeg_speech_synthesis_tpu.eval.exp3 import Experiment3

    found = 0
    for run in ("whisper", "imagine"):
        m = re.search(rf"^{run} ([\d.]+) ([\d.]+)$", out, re.M)
        assert m, f"exp3 print for {run} missing:\n{out}"
        ours = Experiment3(cfg, os.path.join(sess_dir, run), rng=np.random)
        in_trials, in_rest = ours.run()
        assert (float(m.group(1)), float(m.group(2))) == (in_trials, in_rest)
        assert in_trials > 0  # the decode produced audible energy in trials
        found += 1
    assert found == 2
