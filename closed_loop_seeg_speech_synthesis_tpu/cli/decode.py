"""Decoding CLI (public surface of reference ``decode.py``).

Usage: python -m closed_loop_seeg_speech_synthesis_tpu.cli.decode config.ini
         [--stream_name ...] [--gl_norm ...] [--run ...] [--session ...]
         [--seeg_file ...] ...

Offline mode (Development->seeg_file or --seeg_file): batch replay of a
recorded sEEG file.  Online mode: pull the named stream (LSL or native NSX)
and run the closed loop, logging markers in a side process.  Artifacts per
run: decoding.png, audio.wav, sEEG.hdf, spectrogram.npy, decode.ini,
first_timestamp.npy, markers.csv (decode.py:186-219).
"""

from __future__ import annotations

import argparse
import logging
import os
import threading

import numpy as np
from scipy.io.wavfile import write as wavwrite

import jax
import jax.numpy as jnp

from ..io import config as config_mod
from ..io.utils import in_offline_mode
from ..runtime import online, params as params_io, pipeline
from ..runtime.audio import make_sink
from ..utils import setup_runtime

logger = logging.getLogger("cli.decode")


def plot_streamed_data(spectrogram, audio, filename):
    try:
        import matplotlib
    except ImportError:
        logger.warning("matplotlib is not installed; skipping %s", filename)
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax_spec, ax_audio) = plt.subplots(2, 1, figsize=(9, 5), height_ratios=[2, 1])
    if len(spectrogram):
        m = ax_spec.imshow(np.asarray(spectrogram).T, aspect="auto", origin="lower")
        fig.colorbar(m, ax=ax_spec)
    ax_spec.set_title("Decoded speech signal")
    ax_spec.set_ylabel("logMels (dequantized)")
    ax_audio.plot(audio, linewidth=1)
    ax_audio.set_ylabel("Amplitude (int16)")
    ax_audio.set_xlabel("Samples @16 kHz")
    fig.tight_layout()
    fig.savefig(filename, dpi=300)
    plt.close(fig)


def _build_decoder(loaded, sr, n_channels_total, gl_norm, packet_size=32, dtype=jnp.float32):
    n_used = n_channels_total - len(loaded["bad_channels"])
    cfg = pipeline.DecoderConfig(sr=float(sr), n_channels=n_used, packet_size=packet_size,
                                 gl_norm=float(gl_norm), dtype=dtype)
    dec = pipeline.build_decoder_params(cfg, loaded["lda"], loaded["medians"], loaded["select"])
    return cfg, dec


def perform_offline_decoding(loaded, eeg, sfreq, gl_norm, dtype=None, key=None,
                             vocoder="device"):
    """Batch replay (decode.py:71-96).

    ``vocoder="exact-host"`` re-synthesizes the audio with
    ops/host_vocoder.ReferenceExactVocoder — byte-reproducible against
    recordings made with the reference system (same np.random.rand draws
    required; here the repo's default deterministic inits are used, so the
    output is byte-stable across machines rather than byte-equal to a
    particular reference run).  The decoded spectrogram — the scientific
    output — is identical either way."""
    dtype = dtype or pipeline.default_compute_dtype()
    mask = np.ones(eeg.shape[1], bool)
    mask[np.asarray(loaded["bad_channels"], int)] = False
    cfg, dec = _build_decoder(loaded, sfreq, eeg.shape[1], gl_norm, dtype=dtype)
    spec, audio = pipeline.offline_decode(dec, cfg, eeg[:, mask], key=key or jax.random.PRNGKey(0))
    if vocoder == "exact-host":
        from jax import enable_x64

        from ..ops import griffinlim as gl_ops
        from ..ops.host_vocoder import decode_audio_exact

        spec_np = np.asarray(spec, np.float64)
        # Byte-stability across backends: without x64 an accelerator session
        # silently downcasts these phase inits to f32, making the "exact"
        # output machine-dependent.  Force f64 generation on the CPU backend
        # regardless of the session's global x64 state — identical bits to
        # the documented CPU/x64 path.
        with enable_x64():
            with jax.default_device(jax.local_devices(backend="cpu")[0]):
                rows = np.asarray(gl_ops.default_rand_init(
                    key or jax.random.PRNGKey(0), spec_np.shape[0] - 1, 0,
                    jnp.float64))
        assert rows.dtype == np.float64
        audio = decode_audio_exact(spec_np, rows, norm_factor=float(gl_norm))
        logger.info("Exact-host vocoder: %d samples (reference-exact "
                    "emission grid)", len(audio))
    logger.info("Decoding completed.")
    return np.asarray(spec), np.asarray(audio), eeg, sfreq


def perform_online_decoding(config, loaded, gl_norm, run_dir, stop_event=None,
                            max_packets=None, backend=None, dtype=None,
                            persistent=False, chunk_steps=1, tracer=None):
    """Closed loop against a live stream (decode.py:99-149).

    ``persistent=True`` runs the whole session as one device dispatch
    (lax.while_loop + io_callback I/O edges) instead of one dispatch per
    packet.

    ``chunk_steps=K`` (per-packet mode only) decodes K buffered packets per
    dispatch, amortizing dispatch overhead; adds (K-1) packet periods of
    playout latency.  ``tracer`` (a ``StageTracer``) receives the
    per-packet stage marks behind ``latency_report``."""
    from ..runtime.streams import StreamInlet, resolve_stream

    dtype = dtype or pipeline.default_compute_dtype()
    stream_name = config["Decoding"]["stream_name"]
    n_channels, srate = resolve_stream(stream_name, backend=backend)
    sfreq = int(srate)
    packet_size = 64 if sfreq == 2048 else 32
    logger.info("Using a sampling rate of %s, packet size %d.", sfreq, packet_size)
    cfg, dec = _build_decoder(loaded, sfreq, n_channels, gl_norm, packet_size, dtype)

    sink = make_sink("auto", wav_path=None, sample_rate=cfg.audio_sr)
    if persistent:
        decoder = online.PersistentOnlineDecoder(
            cfg, dec, bad_channels=loaded["bad_channels"], sink=sink, tracer=tracer)
        if chunk_steps > 1:
            logger.warning("--dispatch-chunk is a per-packet-mode knob; the "
                           "persistent loop already amortizes dispatch overhead")
    else:
        decoder = online.OnlineDecoder(cfg, dec, bad_channels=loaded["bad_channels"],
                                       sink=sink, chunk_steps=chunk_steps, tracer=tracer)
    # compile BEFORE subscribing: the first compilation takes seconds, and a
    # subscriber that stops reading that long is dropped by its transport
    # (NSX after a 1 s stall) or falls seconds behind the amplifier
    decoder.warmup()
    inlet = StreamInlet(stream_name, backend=backend)

    stop = stop_event or threading.Event()
    # Marker logging off the hot path.  The reference forks a process
    # (decode.py:128-137); forking a JAX-threaded process deadlocks, and the
    # logger is IO-bound with poll timeouts, so a daemon thread suffices.
    marker_stop = threading.Event()
    marker_thread = threading.Thread(
        target=online.read_markers,
        args=(run_dir, config["Decoding"].get("marker_stream_name", "SingleWordsMarkerStream")),
        kwargs={"stop_event": marker_stop, "backend": backend},
        daemon=True,
    )
    marker_thread.start()
    logger.info("Started marker logger thread")

    try:
        if stop_event is None and max_packets is None:
            waiter = threading.Thread(target=lambda: (input("Press Enter to stop decoding...\n"), stop.set()))
            waiter.daemon = True
            waiter.start()
        spectrogram, audio, received = decoder.run_stream(
            inlet, stop_event=stop, max_packets=max_packets,
            store_first_timestamp_to=os.path.join(run_dir, "first_timestamp.npy"), backend=backend)
    finally:
        marker_stop.set()
        marker_thread.join(timeout=3)
    decoder.latency_report()
    logger.info("Decoding completed.")
    return spectrogram, audio, received, sfreq


def store_decoding_to_file(run_dir, config, spectrogram, output_audio, received_sEEG, sfreq):
    import h5py

    plot_streamed_data(spectrogram, output_audio, os.path.join(run_dir, "decoding.png"))
    wavwrite(os.path.join(run_dir, "audio.wav"), 16000, np.asarray(output_audio, np.int16))
    with h5py.File(os.path.join(run_dir, "sEEG.hdf"), "w") as hf:
        hf.create_dataset("sEEG", data=received_sEEG)
        hf.create_dataset("sEEG_sr", data=sfreq, dtype=np.int32)
    np.save(os.path.join(run_dir, "spectrogram.npy"), spectrogram)
    with open(os.path.join(run_dir, "decode.ini"), "w") as f:
        config.write(f)
    logger.info("Artifacts written to %s", run_dir)


def main(argv=None):
    parser = argparse.ArgumentParser("Decode an sEEG stream with a pretrained model.")
    parser.add_argument("config", help="Path to config file.")
    parser.add_argument("--storage_dir")
    parser.add_argument("--stream_name")
    parser.add_argument("--marker_stream_name")
    parser.add_argument("--gl_norm")
    parser.add_argument("--run")
    parser.add_argument("--session")
    parser.add_argument("--seeg_file", help="Decode from file instead of the live stream.")
    parser.add_argument("--backend", choices=["lsl", "nsx"], default=None)
    parser.add_argument("--max_packets", type=int, default=None)
    parser.add_argument("--persistent", action="store_true",
                        help="Run the online loop as one persistent device "
                             "dispatch (io_callback I/O edges).")
    parser.add_argument("--dispatch-chunk", type=int, default=1, metavar="K",
                        help="Decode K buffered packets per device dispatch "
                             "(per-packet mode): ~K x less dispatch overhead, "
                             "(K-1) packet periods more playout latency.")
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="Capture a jax.profiler trace of the decode into "
                             "DIR (XLA op timeline, viewable with "
                             "tensorboard/xprof or perfetto).")
    parser.add_argument("--vocoder", choices=["device", "exact-host"],
                        default="device",
                        help="Offline mode: 'device' (batched Griffin-Lim on "
                             "the accelerator, the fast path) or 'exact-host' (NumPy vocoder "
                             "byte-reproducing the reference GriffinLim node "
                             "incl. its FP-jittered emission grid).")
    args = parser.parse_args(argv)
    setup_runtime()

    config = config_mod.load_config(args.config)
    config_mod.merge_args(config, {
        ("General", "storage_dir"): args.storage_dir,
        ("Decoding", "stream_name"): args.stream_name,
        ("Decoding", "marker_stream_name"): args.marker_stream_name,
        ("Decoding", "griffin_lim_norm"): args.gl_norm,
        ("Decoding", "run"): args.run,
        ("General", "session"): args.session,
        ("Development", "seeg_file"): args.seeg_file,
    })

    session_dir = config_mod.session_dir(config)
    if not os.path.isdir(session_dir):
        raise FileNotFoundError(f"session directory does not exist: {session_dir}")
    run_dir = config_mod.run_dir(config)
    config_mod.make_output_dir(run_dir, config.getboolean("Decoding", "overwrite_on_rerun", fallback=True))
    config_mod.setup_logging(os.path.join(run_dir, "decode.log"))

    loaded = params_io.load_params(os.path.join(session_dir, "params.h5"),
                                   dtype=pipeline.default_compute_dtype())
    logger.info("Ignoring channel indices: [%s]", " ".join(map(str, loaded["bad_channels"])))
    gl_norm = config.getint("Decoding", "griffin_lim_norm")

    import contextlib

    profile_ctx = contextlib.nullcontext()
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        profile_ctx = jax.profiler.trace(args.profile)
        logger.info("Profiling decode into %s", args.profile)

    with profile_ctx:
        if in_offline_mode(config):
            import h5py

            with h5py.File(config["Development"]["seeg_file"], "r") as hf:
                eeg = hf["sEEG"][:]
                sfreq = int(np.asarray(hf["sEEG_sr"]).reshape(-1)[0])
            spectrogram, audio, received, sfreq = perform_offline_decoding(
                loaded, eeg, sfreq, gl_norm, vocoder=args.vocoder)
        else:
            spectrogram, audio, received, sfreq = perform_online_decoding(
                config, loaded, gl_norm, run_dir, backend=args.backend,
                max_packets=args.max_packets, persistent=args.persistent,
                chunk_steps=args.dispatch_chunk)

    store_decoding_to_file(run_dir, config, spectrogram, audio, received, sfreq)
    return run_dir


if __name__ == "__main__":
    main()
