"""Repro harness for an XLA vmap miscompile in the exp1 retrain graph.

Vmapping the whole retrain+decode program (`eval.exp1_batched._make_one_run`)
over the fold/run axis at full scale (>=5 lanes x ~270 s train x 64 ch) has
been seen to produce garbage LDA class means for a leading contiguous range
of lanes — lanes 0-1 fully dead (decode r ~= 0), lane 2 partial — while

* every returned INTERMEDIATE (shifted eeg, filtered signal, features,
  selected features, quantized labels) compares bit-exact against the
  unbatched program, and
* every narrower vmap (decode-only, class-means-only, gather+means,
  batched eigh on extracted matrices) is clean.

The corruption follows lane POSITION, not fold identity (permuting the fold
order moves which folds die).  The CPU backend is always clean.  The
production code therefore uses ``lax.map`` over lanes
(exp1_batched.py:132-144,170-178); this script checks whether the active
backend is affected, and whether the lanes could be batched there.

Run on the accelerator under test:
    python tools/vmap_miscompile_repro.py [--lanes 6] [--train-s 270]
        [--test-s 30] [--channels 64] [--mode vmap]

Emits one JSON line per lane: ``{"lane": i, "max_abs_err": ..., "r": ...}``
where ``r`` is the Pearson correlation of the lane's decoded spectrogram
against the same lane run through the UNBATCHED program (r ~= 1.0 healthy,
r ~= 0 dead).  Final verdict line reports whether the batching mode under
test matches per-lane execution.  ``--mode map`` runs the production
``lax.map`` path instead, which must always be clean (the regression test
``tests/test_vmap_miscompile.py`` pins that).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)


def build_case(lanes, train_s, test_s, channels, nb_feats, seed=0):
    """Synthetic per-lane fold data with decodable word-locked structure.

    The corruption manifests as garbage class means -> the per-lane decode
    correlates at ~0 with the healthy decode, so the eeg must carry signal
    the LDA can latch onto (pure noise would give r ~= 0 everywhere and hide
    the bug).  Sine bursts keyed to the quantization targets suffice.
    """
    import jax
    import jax.numpy as jnp
    from closed_loop_seeg_speech_synthesis_tpu.eval.exp1_batched import fold_targets

    rng = np.random.RandomState(seed)
    sr = 1024.0
    tt, te = int(train_s * sr), int(test_s * sr)
    audio_sr = 48000

    xts, xes, qs, yms, meds = [], [], [], [], []
    for lane in range(lanes):
        t = np.arange(tt) / sr
        carrier = np.sin(2 * np.pi * (80 + 7 * lane) * t)
        gate = (np.sin(2 * np.pi * 0.7 * t) > 0).astype(np.float64)
        base = carrier * gate
        xt = (base[:, None] * rng.uniform(0.5, 1.5, channels)[None, :]
              + 0.3 * rng.randn(tt, channels))
        xe = xt[:te].copy()
        audio = np.repeat(base, int(audio_sr // sr))[: int(train_s * audio_sr)]
        audio = audio + 0.01 * rng.randn(audio.size)
        q, medians, y_mean = fold_targets(audio)
        xts.append(xt); xes.append(xe); qs.append(q); yms.append(y_mean)
        meds.append(medians)

    n = min(q.shape[0] for q in qs)
    dt = jnp.float32
    staged = (jnp.asarray(np.stack(xts), dt), jnp.asarray(np.stack(xes), dt),
              jnp.asarray(np.stack([q[:n] for q in qs]), jnp.int32),
              jnp.asarray(np.stack([y[:n] for y in yms]), dt),
              jnp.asarray(np.stack(meds), dt),
              jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(seed), i))(
                  jnp.arange(lanes)))
    return staged, sr


def main(argv=None):
    from closed_loop_seeg_speech_synthesis_tpu.utils import setup_runtime
    setup_runtime()
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=6)
    ap.add_argument("--train-s", type=float, default=270.0)
    ap.add_argument("--test-s", type=float, default=30.0)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--nb-feats", type=int, default=150)
    ap.add_argument("--mode", choices=["vmap", "map"], default="vmap")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    from closed_loop_seeg_speech_synthesis_tpu.eval.exp1_batched import _make_one_run

    nb_feats = min(args.nb_feats, 5 * args.channels)
    staged, sr = build_case(args.lanes, args.train_s, args.test_s,
                            args.channels, nb_feats)
    xts, xes, qs, yms, meds, keys = staged
    one_run, _nf = _make_one_run(xts.shape[1], xes.shape[1], args.channels,
                                 sr, 10.0, nb_feats=nb_feats)
    zero = jnp.zeros((), jnp.int32)
    body = lambda a: one_run(a[0], a[1], a[2], a[3], a[4], zero, a[5])[0]

    # ground truth: each lane through the UNBATCHED jitted program
    single = jax.jit(body)
    ref = np.stack([np.asarray(single(tuple(x[i] for x in staged)))
                    for i in range(args.lanes)])

    if args.mode == "vmap":
        batched = jax.jit(jax.vmap(body))
    else:
        batched = jax.jit(lambda a: jax.lax.map(body, a))
    out = np.asarray(batched(staged))

    worst = 0.0
    for i in range(args.lanes):
        err = float(np.max(np.abs(out[i] - ref[i])))
        r = float(np.corrcoef(out[i].ravel(), ref[i].ravel())[0, 1])
        worst = max(worst, err)
        print(json.dumps({"lane": i, "max_abs_err": round(err, 6),
                          "r_vs_perlane": round(r, 4)}), flush=True)
    clean = worst < 1e-3
    print(json.dumps({"mode": args.mode, "lanes": args.lanes,
                      "train_s": args.train_s, "channels": args.channels,
                      "backend": jax.default_backend(),
                      "verdict": "clean" if clean else "CORRUPTED",
                      "worst_max_abs_err": round(worst, 6)}), flush=True)
    return 0 if clean else 1


if __name__ == "__main__":
    sys.exit(main())
