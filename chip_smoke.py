"""Smoke run of the main path on one NVIDIA GPU: train -> offline replay ->
closed loop, at the reference operating points and full width.

    python chip_smoke.py [--seed N]          # one card
    python chip_smoke.py --four-cards        # sharded parity on a 4-card mesh only

Phases, in order; any failure raises and the script exits non-zero:

0. device: fail unless JAX's default backend is the GPU; print the card,
   JAX, the compile-cache directory and which optional packages import.
1. train: a synthetic word-locked session from ``--seed`` (100 words, 5 min)
   at 128 ch / 1024 Hz and at 256 ch / 2048 Hz, through ``cli.train`` when
   h5py is installed, else through the function it calls
   (``runtime.trainer.train``).
2. offline replay: a 30-minute session per operating point through
   ``cli.decode --seeg_file`` (or ``perform_offline_decoding`` without
   h5py): wall time, peak device memory, the compiled program's memory
   analysis; then the first 60 s decoded in float32 on the card against the
   float64 golden path on the CPU device of the same process.
3. closed loop: 2,000 packets streamed over the bundled NSX transport into
   ``cli.decode.perform_online_decoding``, per-packet and persistent
   (one device dispatch) mode, each compared with an offline decode of the
   received packets.

The last line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import configparser
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

POINTS = ((128, 1024), (256, 2048))   # (channels, sEEG rate), BASELINE.md
GL_NORM = 10
# float32-vs-float64 budget (tests/test_f32_error_budget.py) and the vocoder
# measure of docs/NUMERICS.md (the exp(angle) recursion makes waveform LSBs
# the wrong yardstick)
MAX_FLIP_RATE = 0.02
MAX_P995_ERR = 1.0
MIN_ENVELOPE_R = 0.99


def have(module: str) -> bool:
    return importlib.util.find_spec(module) is not None


def _say(*parts):
    print(*parts, flush=True)


def _packet_size(sr: int) -> int:
    return 64 if sr == 2048 else 32


def _peak_gib(device) -> str:
    stats = device.memory_stats()
    if not stats or "peak_bytes_in_use" not in stats:
        return "n/a"
    return f"{stats['peak_bytes_in_use'] / 2**30:.3f} GiB"


def compare(spec_ref, spec, audio_ref, audio) -> dict:
    """Dequantized-label flip rate, 99.5th-percentile spectrogram error and
    per-hop (160-sample) energy-envelope Pearson r of ``spec``/``audio``
    against the reference pair, over their common length."""
    n = min(len(spec_ref), len(spec))
    a, b = np.asarray(spec_ref[:n], np.float64), np.asarray(spec[:n], np.float64)
    # dequantized values are discrete medians: equality == same label
    flip = 1.0 - float(np.isclose(a, b, rtol=1e-4, atol=1e-5).mean())
    p995 = float(np.percentile(np.abs(a - b), 99.5))
    m = min(len(audio_ref), len(audio)) // 160 * 160
    env = [(np.asarray(x[:m], np.float64).reshape(-1, 160) ** 2).sum(axis=1)
           for x in (audio_ref, audio)]
    r = float(np.corrcoef(env[0], env[1])[0, 1])
    return {"frames": n, "flip_rate": flip, "p995_err": p995, "envelope_r": r}


def check(tag: str, c: dict):
    _say(f"{tag}: frames={c['frames']} label_flip_rate={c['flip_rate']:.5f} "
         f"(limit < {MAX_FLIP_RATE}), p99.5 spec err={c['p995_err']:.5f} "
         f"(limit < {MAX_P995_ERR}), audio envelope r={c['envelope_r']:.6f} "
         f"(limit >= {MIN_ENVELOPE_R})")
    if not (c["flip_rate"] < MAX_FLIP_RATE and c["p995_err"] < MAX_P995_ERR
            and c["envelope_r"] >= MIN_ENVELOPE_R):
        raise AssertionError(f"{tag} outside its limits: {c}")


# ---------------------------------------------------------------------------
# Phase 0
# ---------------------------------------------------------------------------


def phase0_device(cache_dir: str, min_devices: int = 1) -> dict:
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(f"no GPU: JAX's default backend is {backend!r}")
    devices = jax.devices()
    if len(devices) < min_devices:
        raise RuntimeError(f"{min_devices} GPUs needed, {len(devices)} found")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    _say(f"phase 0: nvidia-smi: {smi}")
    _say(f"phase 0: jax {jax.__version__}, platform={devices[0].platform}, "
         f"device_kind={devices[0].device_kind!r}, devices={len(devices)}")
    _say(f"phase 0: compile cache: {cache_dir}")
    _say("phase 0: imports: " + ", ".join(
        f"{m}={'yes' if have(m) else 'no'}" for m in ("h5py", "sklearn", "matplotlib")))
    _say("phase 0: main path through " + (
        "the CLIs (cli.train.main, cli.decode.main)" if have("h5py") else
        "the functions the CLIs call (no h5py: runtime.trainer.train, "
        "cli.decode.perform_offline_decoding)"))
    return {"platform": devices[0].platform, "kind": devices[0].device_kind,
            "count": len(devices)}


# ---------------------------------------------------------------------------
# Phase 1: train
# ---------------------------------------------------------------------------


def _write_config(workdir: str, session: str, rec: str, stream_name: str) -> str:
    cfg = configparser.ConfigParser()
    cfg["General"] = {"storage_dir": workdir, "session": session}
    cfg["Training"] = {"file": rec, "power_line": "50", "channels": "LA[0-9]*",
                       "overwrite_on_rerun": "True", "draw_plots": "False"}
    cfg["Decoding"] = {"stream_name": stream_name,
                       "marker_stream_name": stream_name + "_markers",
                       "griffin_lim_norm": str(GL_NORM), "run": "replay",
                       "overwrite_on_rerun": "True"}
    path = os.path.join(workdir, session + ".ini")
    with open(path, "w") as f:
        cfg.write(f)
    return path


def phase1_train(workdir: str, seed: int = 0, points=POINTS, n_words: int = 100,
                 use_cli: bool | None = None) -> dict:
    """Trains one model per (channels, rate) point.  Returns
    {point: {"loaded": <load_params dict>, "config": path}}."""
    from closed_loop_seeg_speech_synthesis_tpu.io.synthetic import synthetic_session
    from closed_loop_seeg_speech_synthesis_tpu.io.utils import squeeze_audio_to_float64
    from closed_loop_seeg_speech_synthesis_tpu.runtime import params as params_io
    from closed_loop_seeg_speech_synthesis_tpu.runtime import pipeline, trainer

    use_cli = have("h5py") if use_cli is None else use_cli
    models = {}
    for C, sr in points:
        s = synthetic_session(n_words, sr, 48000, C, seed)
        session = f"s{C}ch_{sr}hz"
        rec = os.path.join(workdir, session + ".hdf")
        cfg_path = _write_config(workdir, session, rec, f"smoke_{session}")
        t0 = time.perf_counter()
        if use_cli:
            from closed_loop_seeg_speech_synthesis_tpu.cli import train as train_cli
            from closed_loop_seeg_speech_synthesis_tpu.io import loaders

            loaders.save_hdf5(rec, s["eeg"], sr, s["audio"], s["audio_sr"],
                              ch_names=s["ch_names"], markers=s["markers"])
            train_cli.main([cfg_path])
            loaded = params_io.load_params(os.path.join(workdir, session, "params.h5"),
                                           dtype=pipeline.default_compute_dtype())
            how = "cli.train.main"
        else:
            result = trainer.train(s["eeg"], squeeze_audio_to_float64(s["audio"]),
                                   sr, s["audio_sr"], [])
            loaded = params_io.as_loaded(result, [])
            how = "runtime.trainer.train"
        wall = time.perf_counter() - t0
        coef = np.asarray(loaded["lda"].coef)
        n_feats = min(150, 5 * C)
        if not (np.all(np.isfinite(coef)) and coef.shape == (40, 9, n_feats)
                and len(loaded["select"]) == n_feats
                and np.asarray(loaded["medians"]).shape == (40, 9)):
            raise AssertionError(f"phase 1 {session}: malformed model "
                                 f"(coef {coef.shape}, select {len(loaded['select'])})")
        _say(f"phase 1 train {C} ch @ {sr} Hz ({how}): {len(s['eeg']) / sr / 60:.1f} min "
             f"session, wall {wall:.2f} s (incl. compile), coef {coef.shape} finite, "
             f"{n_feats} features")
        models[(C, sr)] = {"loaded": loaded, "config": cfg_path}
    return models


# ---------------------------------------------------------------------------
# Phase 2: offline replay + float64 golden comparison
# ---------------------------------------------------------------------------


def _golden_compare(loaded, eeg, sr, seed) -> dict:
    """First ``len(eeg)`` samples decoded in float32 on the default device
    against the float64 golden path on the CPU device, same model, same
    Griffin-Lim inits."""
    import jax
    import jax.numpy as jnp

    from closed_loop_seeg_speech_synthesis_tpu.ops import framing
    from closed_loop_seeg_speech_synthesis_tpu.ops import griffinlim as gl
    from closed_loop_seeg_speech_synthesis_tpu.runtime import pipeline

    host = {k: (jax.tree.map(np.asarray, v) if k == "lda" else np.asarray(v))
            for k, v in loaded.items()}

    def config(dtype):
        return pipeline.DecoderConfig(sr=float(sr), n_channels=eeg.shape[1],
                                      packet_size=_packet_size(sr),
                                      gl_norm=float(GL_NORM), dtype=dtype)

    def decode(cfg, rand):
        dec = pipeline.build_decoder_params(cfg, host["lda"], host["medians"], host["select"])
        spec, audio = pipeline.offline_decode(dec, cfg, eeg, rand_init=rand)
        return np.asarray(spec), np.asarray(audio)

    cfg64 = config(jnp.float64)
    ends = framing.streaming_frame_ends(cfg64.frame_len_ms, cfg64.frame_shift_ms,
                                        cfg64.sr, len(eeg) + cfg64.prefill)
    with jax.enable_x64(), jax.default_device(jax.local_devices(backend="cpu")[0]):
        rand = np.asarray(gl.default_rand_init(jax.random.PRNGKey(seed), len(ends) - 1,
                                               0, jnp.float64))
        spec64, audio64 = decode(cfg64, rand)
    spec32, audio32 = decode(config(jnp.float32), rand.astype(np.float32))
    return compare(spec64, spec32, audio64, audio32)


def phase2_replay(workdir: str, models: dict, seed: int = 0, minutes: float = 30.0,
                  golden_seconds: float = 60.0, use_cli: bool | None = None) -> dict:
    """Replays a ``minutes``-long session per trained point.  Returns
    {point: float32 sEEG of the session} for phase 3."""
    import jax

    from closed_loop_seeg_speech_synthesis_tpu.cli import decode as decode_cli
    from closed_loop_seeg_speech_synthesis_tpu.io.synthetic import synthetic_session
    from closed_loop_seeg_speech_synthesis_tpu.runtime import pipeline

    use_cli = have("h5py") if use_cli is None else use_cli
    device = jax.devices()[0]
    sessions = {}
    for (C, sr), model in models.items():
        s = synthetic_session(int(round(minutes * 20)), sr, 48000, C, seed + 1,
                              with_audio=False)
        eeg = s["eeg"].astype(np.float32)
        del s
        dur = len(eeg) / sr
        t0 = time.perf_counter()
        if use_cli:
            import h5py
            from scipy.io import wavfile

            path = os.path.join(workdir, f"replay_{C}ch_{sr}hz.hdf")
            with h5py.File(path, "w") as hf:
                hf.create_dataset("sEEG", data=eeg)
                hf.create_dataset("sEEG_sr", data=sr, dtype=np.int32)
            run_dir = decode_cli.main([model["config"], "--seeg_file", path,
                                       "--run", "replay"])
            spec = np.load(os.path.join(run_dir, "spectrogram.npy"))
            audio = wavfile.read(os.path.join(run_dir, "audio.wav"))[1]
            how = "cli.decode.main --seeg_file"
        else:
            spec, audio, _, _ = decode_cli.perform_offline_decoding(
                model["loaded"], eeg, sr, GL_NORM)
            how = "cli.decode.perform_offline_decoding"
        wall = time.perf_counter() - t0
        if not (spec.ndim == 2 and spec.shape[1] == 40 and np.all(np.isfinite(spec))
                and audio.dtype == np.int16 and len(audio) == (len(spec) - 1) * 160):
            raise AssertionError(f"phase 2 {C} ch @ {sr} Hz: malformed output "
                                 f"spec {spec.shape} audio {audio.shape} {audio.dtype}")
        _say(f"phase 2 replay {C} ch @ {sr} Hz ({how}): {dur / 60:.1f} min session, "
             f"wall {wall:.3f} s (cold: incl. compile and I/O), spec {spec.shape}, "
             f"audio {len(audio)} samples, peak device memory {_peak_gib(device)}")

        cfg = pipeline.DecoderConfig(sr=float(sr), n_channels=C, packet_size=_packet_size(sr),
                                     gl_norm=float(GL_NORM),
                                     dtype=pipeline.default_compute_dtype())
        loaded = model["loaded"]
        dec = pipeline.build_decoder_params(cfg, loaded["lda"], loaded["medians"], loaded["select"])
        ma = pipeline._offline_decode_jit.lower(
            *pipeline.offline_decode_args(dec, cfg, eeg)).compile().memory_analysis()
        if ma is not None:
            _say(f"phase 2 memory_analysis {C} ch @ {sr} Hz: "
                 f"arguments {ma.argument_size_in_bytes / 2**20:.1f} MiB, "
                 f"outputs {ma.output_size_in_bytes / 2**20:.1f} MiB, "
                 f"temporaries {ma.temp_size_in_bytes / 2**20:.1f} MiB, "
                 f"code {ma.generated_code_size_in_bytes / 2**20:.2f} MiB")

        n = int(golden_seconds * sr)
        check(f"phase 2 golden {C} ch @ {sr} Hz, first {golden_seconds:g} s, "
              f"float32 {device.platform} vs float64 cpu",
              _golden_compare(loaded, eeg[:n], sr, seed))
        sessions[(C, sr)] = eeg
    return sessions


# ---------------------------------------------------------------------------
# Phase 3: closed loop over the NSX transport
# ---------------------------------------------------------------------------


def phase3_closed_loop(workdir: str, models: dict, sessions: dict,
                       n_packets: int = 2000) -> None:
    from closed_loop_seeg_speech_synthesis_tpu.cli import decode as decode_cli
    from closed_loop_seeg_speech_synthesis_tpu.cli import dev_streamer
    from closed_loop_seeg_speech_synthesis_tpu.runtime.tracing import StageTracer

    for (C, sr), model in models.items():
        P = _packet_size(sr)
        src = np.ascontiguousarray(sessions[(C, sr)][: n_packets * P])
        loaded = model["loaded"]
        for persistent in (False, True):
            mode = "persistent" if persistent else "per-packet"
            name = f"smoke_{C}ch_{sr}hz_{'p' if persistent else 'k'}"
            config = configparser.ConfigParser()
            config["Decoding"] = {"stream_name": name,
                                  "marker_stream_name": name + "_markers"}
            run_dir = os.path.join(workdir, name)
            os.makedirs(run_dir, exist_ok=True)
            tracer = StageTracer(enabled=True)
            out, err = {}, []

            def run():
                try:
                    out["r"] = decode_cli.perform_online_decoding(
                        config, loaded, GL_NORM, run_dir, max_packets=n_packets,
                        backend="nsx", persistent=persistent, tracer=tracer)
                except BaseException as e:  # re-raised below, in this thread
                    err.append(e)

            t = threading.Thread(target=run)
            t.start()
            dev_streamer.stream_eeg(src, sr, name, asap=True, backend="nsx",
                                    wait_for_consumers=120.0)
            t.join()
            if err:
                raise err[0]
            spec_on, audio_on, received, _ = out["r"]
            if received.shape != src.shape or not np.array_equal(received, src):
                raise AssertionError(f"phase 3 {name}: received {received.shape} "
                                     f"!= streamed {src.shape}")
            spec_off, audio_off, _, _ = decode_cli.perform_offline_decoding(
                loaded, received, sr, GL_NORM)
            if abs(len(spec_off) - len(spec_on)) > 4:
                raise AssertionError(f"phase 3 {name}: {len(spec_on)} online frames "
                                     f"vs {len(spec_off)} offline")
            check(f"phase 3 closed loop {C} ch @ {sr} Hz {mode}, {n_packets} packets, "
                  f"online vs offline", compare(spec_off, spec_on, audio_off, audio_on))
            p = tracer.percentiles("packet_in", "step_done")
            _say(f"phase 3 latency {C} ch @ {sr} Hz {mode}: p50 {p[50] * 1e3:.3f} ms, "
                 f"p99 {p[99] * 1e3:.3f} ms (packet_in -> step_done; first "
                 f"reading, no benchmark)")


# ---------------------------------------------------------------------------
# Four cards: sharded train step + batched replay vs one card
# ---------------------------------------------------------------------------


def four_cards(seed: int = 0) -> None:
    """60-second sessions, 128 channels, on a (2 data x 2 model) mesh."""
    from closed_loop_seeg_speech_synthesis_tpu.parallel import mesh as mesh_lib
    from closed_loop_seeg_speech_synthesis_tpu.parallel.parity import sharded_parity

    t0 = time.perf_counter()
    r = sharded_parity(mesh_lib.make_mesh(4), seconds=60.0, channels=128, seed=seed)
    _say(f"four cards: mesh (data x model) = {r['mesh']}, {r['B']} sessions x "
         f"{r['T']} samples x {r['C']} ch; train vs one card: coef rel err "
         f"{r['coef_rel_err']:.3e} (limit < 1e-3), medians max abs err "
         f"{r['medians_max_abs_err']:.3e} (limit 0), selection identical; "
         f"batched replay vs one card (float64): spec max abs err "
         f"{r['replay_spec_max_abs_err']:.3e} (limit {1e-9 * max(r['replay_spec_scale'], 1.0):.1e}), "
         f"audio max {r['replay_audio_max_lsb']} LSB (limit 1); "
         f"wall {time.perf_counter() - t0:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded train step and batched replay on a "
                         "4-GPU mesh against one card")
    args = ap.parse_args(argv)

    from closed_loop_seeg_speech_synthesis_tpu.utils import setup_runtime

    cache_dir = setup_runtime()
    device = phase0_device(cache_dir, min_devices=4 if args.four_cards else 1)
    if args.four_cards:
        four_cards(args.seed)
    else:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as wd:
            os.environ.setdefault("NSX_REGISTRY_DIR", os.path.join(wd, "nsx"))
            models = phase1_train(wd, args.seed)
            sessions = phase2_replay(wd, models, args.seed)
            phase3_closed_loop(wd, models, sessions)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
