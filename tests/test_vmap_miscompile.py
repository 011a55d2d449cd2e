"""Regression guards for the retrain-graph vmap miscompile.

Vmapping the whole exp1 retrain+decode program over the fold/run axis has
been miscompiled by XLA at >=5 full-scale lanes (garbage LDA class means for
leading lanes; see tools/vmap_miscompile_repro.py for the story and the
search harness).  Production batching therefore uses ``lax.map``
(exp1_batched.py:132-144,170-178).

These tests pin the contract that makes that safe: the batched runners must
produce exactly what per-lane execution of the unbatched program produces.
If a future change re-vmaps the lane axis, this test (or, at full scale,
benchmarks/exp1_full.py's per-fold r assert) trips by name instead of
surfacing as a silent r~=0 fold.
"""

import os
import sys

import numpy as np


def _run_case(lanes=5, train_s=8.0, test_s=4.0, channels=8):
    import jax
    import jax.numpy as jnp
    from closed_loop_seeg_speech_synthesis_tpu.eval.exp1_batched import (
        _make_one_run, make_proposed_runner)
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    from vmap_miscompile_repro import build_case

    nb_feats = min(150, 5 * channels)
    staged, sr = build_case(lanes, train_s, test_s, channels, nb_feats)
    xts, xes, qs, yms, meds, keys = staged

    runner, _nf = make_proposed_runner(xts.shape[1], xes.shape[1], channels,
                                       sr, 10.0, nb_feats=nb_feats)
    reco, _audio = runner(xts, xes, qs, yms, meds, keys)

    one_run, _ = _make_one_run(xts.shape[1], xes.shape[1], channels, sr, 10.0,
                               nb_feats=nb_feats)
    zero = jnp.zeros((), jnp.int32)
    single = jax.jit(lambda a: one_run(a[0], a[1], a[2], a[3], a[4], zero, a[5])[0])
    ref = np.stack([np.asarray(single(tuple(x[i] for x in staged)))
                    for i in range(lanes)])
    return np.asarray(reco), ref


def test_production_runner_matches_perlane():
    """The lax.map batched proposed runner == per-lane unbatched program.

    Runs on whatever backend the suite uses (CPU here); guards semantic
    drift of the batched runner on every CI run.
    """
    out, ref = _run_case()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    # every lane must actually decode (a dead lane correlates at ~0)
    for i in range(len(out)):
        r = np.corrcoef(out[i].ravel(), ref[i].ravel())[0, 1]
        assert r > 0.999, f"lane {i} diverged: r={r}"
