"""End-to-end demo on synthetic data: record -> train -> closed loop -> eval.

Creates a synthetic 100-word session (sEEG with word-locked high-gamma bursts
+ matching audio), trains the full model through the CLI, runs the closed
loop over the native loopback transport with a fake amplifier, and evaluates
reconstruction quality — the whole reference workflow (README.md:69-134)
without any lab hardware.

Run:  python examples/demo.py [workdir]
"""

import configparser
import os
import sys
import tempfile
import threading

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_synthetic_session(path, n_words=20, eeg_sr=1024, audio_sr=48000, n_channels=16, seed=0):
    """Word-locked data written as an HDF5 recording (io.synthetic): each 3 s
    trial has 2 s of correlated high-gamma activity + voiced audio, then 1 s
    of rest."""
    from closed_loop_seeg_speech_synthesis_tpu.io import loaders
    from closed_loop_seeg_speech_synthesis_tpu.io.synthetic import synthetic_session

    s = synthetic_session(n_words, eeg_sr, audio_sr, n_channels, seed)
    loaders.save_hdf5(path, s["eeg"], eeg_sr, s["audio"], audio_sr,
                      ch_names=s["ch_names"], markers=s["markers"])
    return s["eeg"], s["words"]


def main(workdir=None):
    workdir = workdir or os.path.join(tempfile.gettempdir(), "seeg_demo")
    os.environ.setdefault("NSX_REGISTRY_DIR", os.path.join(workdir, "nsx"))
    os.makedirs(workdir, exist_ok=True)
    from closed_loop_seeg_speech_synthesis_tpu.utils import setup_runtime

    setup_runtime()

    from closed_loop_seeg_speech_synthesis_tpu.cli import decode as decode_cli
    from closed_loop_seeg_speech_synthesis_tpu.cli import dev_streamer
    from closed_loop_seeg_speech_synthesis_tpu.cli import train as train_cli
    from closed_loop_seeg_speech_synthesis_tpu.eval.metrics import pearson_correlation
    from closed_loop_seeg_speech_synthesis_tpu.ops.spectrogram import compute_spectrogram
    from closed_loop_seeg_speech_synthesis_tpu.runtime import params as params_io
    import jax.numpy as jnp
    import scipy.signal as sig

    rec = os.path.join(workdir, "speech1.hdf")
    print("== creating synthetic session ==")
    eeg, words = make_synthetic_session(rec)

    cfg = configparser.ConfigParser()
    cfg["General"] = {"storage_dir": workdir, "session": "demo"}
    cfg["Training"] = {"file": rec, "power_line": "50", "channels": "LA[0-9]*",
                       "show_interactive_channel_view": "False",
                       "overwrite_on_rerun": "True", "draw_plots": "True"}
    cfg["Decoding"] = {"stream_name": "demo_sEEG", "marker_stream_name": "DemoMk",
                       "griffin_lim_norm": "10", "run": "loopback", "overwrite_on_rerun": "True"}
    cfg["Development"] = {"file": rec}
    cfg_path = os.path.join(workdir, "experiment.ini")
    with open(cfg_path, "w") as f:
        cfg.write(f)

    print("== training (cli.train) ==")
    train_cli.main([cfg_path])

    print("== closed loop over the native loopback transport ==")
    config = configparser.ConfigParser()
    config.read(cfg_path)
    loaded = params_io.load_params(os.path.join(workdir, "demo", "params.h5"))
    run_dir = os.path.join(workdir, "demo", "loopback")
    os.makedirs(run_dir, exist_ok=True)

    n_packets = min(len(eeg) // 32, 2000)
    streamed = eeg[: n_packets * 32].astype(np.float32)
    results = {}

    def run_decoder():
        results["out"] = decode_cli.perform_online_decoding(
            config, loaded, 10, run_dir, max_packets=n_packets, backend="nsx")

    dec = threading.Thread(target=run_decoder)
    dec.start()
    dev_streamer.stream_eeg(streamed, 1024, "demo_sEEG", asap=True,
                            backend="nsx", wait_for_consumers=120.0)
    dec.join()
    spectrogram, audio_out, received, sfreq = results["out"]
    decode_cli.store_decoding_to_file(run_dir, config, spectrogram, audio_out, received, sfreq)
    print(f"decoded {len(spectrogram)} frames, {len(audio_out)/16000:.1f}s of audio -> {run_dir}")

    print("== quality: decoded logMels vs original audio spectrogram ==")
    import h5py
    with h5py.File(rec) as hf:
        orig_audio = hf["Audio"][:]
    audio16 = sig.decimate(orig_audio.astype(np.float64), 3)
    orig_spec = np.asarray(compute_spectrogram(jnp.asarray(audio16), 16000, 0.016, 0.01))
    n = min(len(orig_spec), len(spectrogram))
    mean_r, std_r = pearson_correlation(orig_spec[:n], np.asarray(spectrogram)[:n])
    print(f"mean per-bin Pearson r = {mean_r:.3f} (+- {std_r:.3f}) over {n} frames")
    assert mean_r > 0.15, "synthetic decode should beat chance comfortably"
    print("demo OK")


if __name__ == "__main__":
    main(*sys.argv[1:2])
