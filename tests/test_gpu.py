"""Tests that need the card (marker ``gpu``; they skip elsewhere).

Run on the GPU:  python -m pytest tests/ -m gpu
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

from closed_loop_seeg_speech_synthesis_tpu.io.synthetic import synthetic_session  # noqa: E402
from closed_loop_seeg_speech_synthesis_tpu.models import selection  # noqa: E402


@pytest.mark.gpu
def test_selection_float32_on_gpu_matches_float64(gpu):
    """The Spearman matmul is pinned to HIGHEST: in TF32 near-tied features
    reorder against the float64 ranking."""
    rng = np.random.RandomState(11)
    n, F, nb = 20000, 640, 150
    y = rng.randn(n, 40)
    target = y.mean(axis=1)
    X = (rng.randn(n, F) + np.linspace(0, 0.05, F)[None, :] * target[:, None]).astype(np.float32)
    got = selection.select_features(jax.device_put(jnp.asarray(X), gpu),
                                    jax.device_put(jnp.asarray(y, jnp.float32), gpu), nb)
    rho = np.array([scipy.stats.spearmanr(X[:, j].astype(np.float64), target)[0]
                    for j in range(F)])
    np.testing.assert_array_equal(got, np.argsort(np.abs(rho))[-nb:])


@pytest.mark.gpu
def test_offline_decode_float32_on_gpu_within_budget_of_float64(gpu, tmp_path):
    """A short trained session decoded in float32 on the card against the
    float64 golden path on the CPU device (chip_smoke phase 2 at 16 ch)."""
    models = chip_smoke.phase1_train(str(tmp_path), 0, ((16, 1024),), n_words=20,
                                     use_cli=False)
    eeg = synthetic_session(10, 1024, 48000, 16, seed=1, with_audio=False)["eeg"]
    c = chip_smoke._golden_compare(models[(16, 1024)]["loaded"],
                                   eeg.astype(np.float32), 1024, seed=0)
    chip_smoke.check("gpu float32 vs cpu float64", c)


@pytest.mark.gpu
def test_bench_trace_attributes_device_time_to_every_stage(gpu, tmp_path):
    """bench.py --trace in a child process (its own share of the card): every
    named decode stage gets device time, and most of it is attributed."""
    import bench

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, XLA_PYTHON_CLIENT_MEM_FRACTION="0.1")
    out = subprocess.run([sys.executable, os.path.join(root, "bench.py"), "--channels", "16",
                          "--minutes", "1", "--trace", str(tmp_path)],
                         capture_output=True, text=True, env=env, timeout=600, check=True)
    st = json.loads(out.stdout.strip().splitlines()[-1])["stage_device_s"]
    assert all(st[s] > 0 for s in bench.STAGES), st
    assert st["other"] < 0.5 * st["total"], st
