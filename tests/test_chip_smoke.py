"""chip_smoke.py at tiny sizes on the CPU.

The script itself refuses to run without a GPU (phase 0); its phases take
their sizes as arguments, so here they run at 8 channels, seconds-long
sessions and 100 packets, through the CLIs (h5py installed) and through the
functions the CLIs call (the no-h5py route).
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

POINTS = ((8, 1024), (8, 2048))


@pytest.fixture(scope="module", params=[True, False], ids=["cli", "direct"])
def smoke_run(request, tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("smoke"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NSX_REGISTRY_DIR", os.path.join(wd, "nsx"))
        models = chip_smoke.phase1_train(wd, 0, POINTS, n_words=6, use_cli=request.param)
        sessions = chip_smoke.phase2_replay(wd, models, 0, minutes=0.25, golden_seconds=5,
                                            use_cli=request.param)
        yield wd, models, sessions, mp


def test_phase0_raises_without_gpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.phase0_device("unused")


@pytest.mark.parametrize("argv", [[], ["--four-cards"]], ids=["one-card", "four-cards"])
def test_main_fails_and_prints_no_result_without_gpu(argv, capsys):
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.main(argv)
    assert '"ok"' not in capsys.readouterr().out


def test_phase1_trains_each_point(smoke_run):
    _, models, _, _ = smoke_run
    assert set(models) == set(POINTS)
    for m in models.values():
        assert np.asarray(m["loaded"]["lda"].coef).shape == (40, 9, 40)
        assert len(m["loaded"]["select"]) == 40


def test_phase2_replays_each_point(smoke_run):
    _, _, sessions, _ = smoke_run
    for (C, sr), eeg in sessions.items():
        assert eeg.shape == (15 * sr, C) and eeg.dtype == np.float32


def test_phase3_closed_loop(smoke_run, capsys):
    wd, models, sessions, _ = smoke_run
    chip_smoke.phase3_closed_loop(wd, models, sessions, n_packets=100)
    out = capsys.readouterr().out
    for mode in ("per-packet", "persistent"):
        assert out.count(f"{mode}, 100 packets, online vs offline") == len(POINTS)


def test_compare_and_check_limits():
    rng = np.random.RandomState(0)
    spec = rng.randn(200, 40)
    audio = (rng.randn(199 * 160) * 1000).astype(np.int16)
    same = chip_smoke.compare(spec, spec, audio, audio)
    assert same["flip_rate"] == 0.0 and same["p995_err"] == 0.0
    assert same["envelope_r"] == pytest.approx(1.0)
    chip_smoke.check("identical", same)
    flipped = spec.copy()
    flipped[:10] += 5.0                       # 5% of the frames on other labels
    bad = chip_smoke.compare(spec, flipped, audio, audio)
    assert bad["flip_rate"] == pytest.approx(0.05)
    with pytest.raises(AssertionError, match="outside its limits"):
        chip_smoke.check("flipped", bad)
