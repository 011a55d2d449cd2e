"""The package without its optional dependencies (the GPU machine has no
h5py, scikit-learn or matplotlib)."""

import os
import subprocess
import sys

import numpy as np

from closed_loop_seeg_speech_synthesis_tpu.cli import decode as decode_cli
from closed_loop_seeg_speech_synthesis_tpu.models import lda as lda_mod
from closed_loop_seeg_speech_synthesis_tpu.runtime import params as params_io
from closed_loop_seeg_speech_synthesis_tpu.runtime import trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_modules_import_without_h5py_sklearn_matplotlib():
    code = ("import sys\n"
            "for m in ('h5py', 'sklearn', 'matplotlib'):\n"
            "    sys.modules[m] = None\n"
            "import closed_loop_seeg_speech_synthesis_tpu.cli.decode\n"
            "import closed_loop_seeg_speech_synthesis_tpu.cli.train\n"
            "import closed_loop_seeg_speech_synthesis_tpu.io.session\n"
            "import closed_loop_seeg_speech_synthesis_tpu.runtime.params\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True, timeout=300)


def test_store_training_without_sklearn_writes_plain_arrays(tmp_path, monkeypatch, caplog):
    rng = np.random.RandomState(3)
    eeg = rng.randn(4096, 6)
    t = np.arange(4 * 48000) / 48000.0
    audio = 0.4 * np.sin(2 * np.pi * 220 * t) + 0.1 * rng.randn(len(t))
    res = trainer.train(eeg, audio, 1024.0, 48000.0, [], nb_feats=20)

    def no_sklearn(params):
        raise ImportError("No module named 'sklearn'")

    monkeypatch.setattr(lda_mod, "to_sklearn_estimators", no_sklearn)
    path = params_io.store_training(str(tmp_path), res, [1])
    assert "scikit-learn is not installed" in caplog.text
    assert not (tmp_path / "LDAs.pkl").exists()
    import h5py

    with h5py.File(path) as hf:
        assert "estimators" not in hf and "lda_coef" in hf
    loaded = params_io.load_params(path, dtype=np.float64)
    ref = params_io.as_loaded(res, [1])
    np.testing.assert_array_equal(loaded["select"], ref["select"])
    np.testing.assert_array_equal(loaded["bad_channels"], ref["bad_channels"])
    np.testing.assert_allclose(np.asarray(loaded["lda"].coef), np.asarray(res.lda.coef))


def test_figures_skipped_without_matplotlib(tmp_path, monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = tmp_path / "decoding.png"
    decode_cli.plot_streamed_data(np.zeros((10, 40)), np.zeros(1440, np.int16), str(out))
    assert not out.exists()
    assert "matplotlib is not installed" in caplog.text
