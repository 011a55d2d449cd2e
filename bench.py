"""Offline replay throughput and closed-loop step latency on one NVIDIA GPU.

    python bench.py [--channels 128] [--sr 1024] [--minutes 30] [--trace DIR]

Operating point of the reference (decode.py:115-164, config/experiment.ini):
1024 Hz sEEG in 32-sample packets (2048 Hz in 64-sample packets), 128
channels, 10 ms frames, 40 mel bins, 8 Griffin-Lim iterations, norm 10.
Weights are random from a fixed seed; sessions are generated on the device.

* offline replay: wall of ``_offline_decode_jit`` on a fresh session per
  repetition, timed to ``block_until_ready`` on both outputs; median over
  5 repetitions; xRT = session seconds / wall.
* closed loop: wall of each ``make_online_step`` dispatch from a host packet
  to ``block_until_ready`` on its outputs, over 500 packets.
* ``--trace DIR``: instead of the timings, one replay under
  ``jax.profiler.trace`` and the device time of each named decode stage
  (``stage_times``).  XLA's command buffers (CUDA graphs) are turned off in
  this mode: inside a graph a kernel event does not say which HLO op, and
  so which stage, it belongs to.

Prints the card's nvidia-smi name and power limit, then one JSON line.
Fails when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

REPS, STEPS = 5, 500
# jax.named_scope names in runtime.pipeline._offline_decode_jit, in order
STAGES = ("filter_chain", "framing", "context_lda_dequant_smooth", "griffin_lim",
          "ola_lowpass_int16")


def make_decoder(n_channels: int, sr: float, seed: int = 0):
    import jax.numpy as jnp

    from closed_loop_seeg_speech_synthesis_tpu.models import lda as lda_mod
    from closed_loop_seeg_speech_synthesis_tpu.runtime import pipeline

    rng = np.random.RandomState(seed)
    cfg = pipeline.DecoderConfig(sr=sr, n_channels=n_channels,
                                 packet_size=64 if sr == 2048 else 32,
                                 dtype=jnp.float32)
    nf = min(150, 5 * n_channels)
    lda_params = lda_mod.LDAParams(
        coef=jnp.asarray(rng.randn(40, 9, nf) * 0.1, jnp.float32),
        intercept=jnp.asarray(rng.randn(40, 9), jnp.float32),
        classes=jnp.broadcast_to(jnp.arange(9, dtype=jnp.int32), (40, 9)),
        valid=jnp.ones((40, 9), bool),
    )
    medians = np.sort(rng.randn(40, 9), axis=1)
    select = rng.permutation(5 * n_channels)[:nf]
    return cfg, pipeline.build_decoder_params(cfg, lda_params, medians, select)


def stage_times(trace_dir: str, stages=STAGES) -> dict:
    """Device seconds per named stage from the newest ``.xplane.pb`` under
    ``trace_dir``: the summed durations of the device-plane events whose
    op name (the ``name`` stat of a kernel event) carries the stage's
    ``jax.named_scope``.  Events under no stage — chiefly layout transposes
    XLA inserts, which carry no op name — are summed as ``other``, all
    device events as ``total``, and ``span`` is first start to last end on
    the device (so 1 - total/span is the device's idle share)."""
    import jax

    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True),
                   key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    prof = jax.profiler.ProfileData.from_file(paths[-1])
    out = dict.fromkeys(stages, 0.0)
    out["other"] = 0.0
    out["total"] = 0.0
    first, last = None, None
    for plane in prof.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            for ev in line.events:
                op = next((str(v) for k, v in ev.stats if k == "name"), "")
                stage = next((s for s in stages if f"/{s}/" in op or op.endswith(f"/{s}")),
                             "other")
                out[stage] += ev.duration_ns * 1e-9
                out["total"] += ev.duration_ns * 1e-9
                first = ev.start_ns if first is None else min(first, ev.start_ns)
                last = max(last or 0, ev.start_ns + ev.duration_ns)
    out["span"] = (last - first) * 1e-9 if first is not None else 0.0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--channels", type=int, default=128)
    ap.add_argument("--sr", type=int, default=1024, choices=[1024, 2048])
    ap.add_argument("--minutes", type=float, default=30.0)
    ap.add_argument("--trace", metavar="DIR", default=None)
    args = ap.parse_args(argv)
    if args.trace:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_gpu_enable_command_buffer=").strip()

    from closed_loop_seeg_speech_synthesis_tpu.utils import setup_runtime

    setup_runtime()
    import jax
    import jax.numpy as jnp

    from closed_loop_seeg_speech_synthesis_tpu.runtime import pipeline

    if jax.default_backend() != "gpu":
        raise RuntimeError(f"no GPU: JAX's default backend is {jax.default_backend()!r}")
    dev = jax.devices()[0]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}", flush=True)

    sr, C = float(args.sr), args.channels
    cfg, params = make_decoder(C, sr)
    T = int(sr * args.minutes * 60)
    make_eeg = jax.jit(lambda k: jax.random.normal(k, (T, C), jnp.float32))
    dec_args = list(pipeline.offline_decode_args(params, cfg, np.zeros((T, C), np.float32)))

    def replay(i):
        dec_args[2] = make_eeg(jax.random.PRNGKey(i))
        jax.block_until_ready(dec_args[2])
        t0 = time.perf_counter()
        jax.block_until_ready(pipeline._offline_decode_jit(*dec_args))
        return time.perf_counter() - t0

    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices()), "card": card}
    config = {"channels": C, "sr": int(sr), "packet_size": cfg.packet_size,
              "minutes": args.minutes, "gl_iterations": cfg.gl_iterations}
    t0 = time.perf_counter()
    replay(0)
    cold_s = time.perf_counter() - t0
    if args.trace:
        dec_args[2] = make_eeg(jax.random.PRNGKey(10_000))
        jax.block_until_ready(dec_args[2])
        with jax.profiler.trace(args.trace):
            jax.block_until_ready(pipeline._offline_decode_jit(*dec_args))
        print(json.dumps({"device": device, "config": config, "command_buffers": False,
                          "stage_device_s": stage_times(args.trace)}), flush=True)
        return 0
    walls = [replay(i + 1) for i in range(REPS)]
    wall = float(np.median(walls))
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use")

    step = pipeline.make_online_step(params, cfg, jax.random.PRNGKey(7))
    carry = pipeline.init_online_carry(params, cfg)
    pkts = np.random.RandomState(1).randn(64, cfg.packet_size, C).astype(np.float32)
    for i in range(8):  # compile + warm
        carry, out = step(carry, pkts[i % len(pkts)])
        jax.block_until_ready((carry, out))
    lat = []
    for i in range(STEPS):
        t0 = time.perf_counter()
        carry, out = step(carry, pkts[i % len(pkts)])
        jax.block_until_ready((carry, out))
        lat.append(time.perf_counter() - t0)
    lat_ms = np.asarray(lat) * 1e3

    print(json.dumps({
        "device": device, "config": config,
        "replay_wall_s": walls, "replay_wall_median_s": wall,
        "replay_xrt": args.minutes * 60 / wall, "replay_cold_s": cold_s,
        "peak_device_bytes": peak,
        "step_ms": {"p50": float(np.percentile(lat_ms, 50)),
                    "p99": float(np.percentile(lat_ms, 99)),
                    "max": float(lat_ms.max()), "mean": float(lat_ms.mean()),
                    "n": len(lat)},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
