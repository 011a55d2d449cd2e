"""Trial accessors over recorded sessions and decoding runs
(twin of reference ``local/data_loader.py:196-325``).

``Session``: the training recording, words on a fixed 3 s grid (2 s word +
1 s cross), audio decimated to 16 kHz with dither.  ``DecodingRun``: the
artifacts a decode run stores (audio.wav, sEEG.hdf, markers.csv,
first_timestamp.npy), trial starts recovered from marker wall-clock minus the
stream's first timestamp.
"""

from __future__ import annotations

import logging
import os

import numpy as np
from scipy.io import wavfile
from scipy.signal import decimate

from .loaders import load_hdf5

logger = logging.getLogger("io.session")


class _TrialMixin:
    def get_trial_by_index(self, index, include_rest=False):
        dur = 3 if include_rest else 2
        es, as_ = self.word_starts_indices_eeg[index], self.word_starts_indices_audio[index]
        return (
            self.words[index],
            self.eeg[es : es + dur * self.eeg_sr],
            self.audio[as_ : as_ + dur * self.audio_sr],
        )

    def get_trial_by_word(self, word, include_rest=False):
        return self.get_trial_by_index(self.words.index(word), include_rest)

    def get_trial_generator(self, duration=2):
        for i in range(len(self.words)):
            es, as_ = self.word_starts_indices_eeg[i], self.word_starts_indices_audio[i]
            yield (
                self.words[i],
                self.eeg[es : es + duration * self.eeg_sr],
                self.audio[as_ : as_ + duration * self.audio_sr],
            )


class Session(_TrialMixin):
    """Training-session trials on the fixed per-word grid
    (data_loader.py:196-251)."""

    def __init__(self, session_dir, complete_trial_duration=3, downsample_audio=True,
                 recording="speech1.hdf", rng=None):
        self.session_dir = session_dir
        path = os.path.join(session_dir, recording)
        self.eeg, self.eeg_sr, audio, self.audio_sr, self.ch_names, self.markers = load_hdf5(path, return_markers=True)
        if downsample_audio:
            audio = decimate(audio, 3)
            self.audio_sr = 16000
        rng = rng or np.random
        self.audio = audio + rng.normal(0, 0.0001, len(audio))
        self.words = [m[0][6:].strip() for m in self.markers if m[0].startswith("start;")]
        if len(self.words) != 100:
            logger.warning("Number of words does not match 100 (got %d).", len(self.words))
        self.word_starts_indices_eeg = [t * complete_trial_duration * self.eeg_sr for t in range(len(self.words))]
        self.word_starts_indices_audio = [t * complete_trial_duration * self.audio_sr for t in range(len(self.words))]


class DecodingRun(_TrialMixin):
    """Artifacts of one decode run (data_loader.py:253-325)."""

    def __init__(self, run_dir):
        self.run_dir = run_dir
        self.audio_sr, self.audio = wavfile.read(os.path.join(run_dir, "audio.wav"))
        first_timestamp = np.load(os.path.join(run_dir, "first_timestamp.npy"))

        starts, words = [], []
        with open(os.path.join(run_dir, "markers.csv")) as f:
            for line in f:
                parts = line.rstrip("\n").split(",", 2)
                if len(parts) != 3:
                    continue
                _, mono, label = parts
                if label.startswith("start;"):
                    starts.append(round(float(mono) - float(first_timestamp), 2))
                    words.append(label[6:])
        self.trial_starts_in_sec = np.asarray(starts)
        self.words = words
        self.word_starts_indices_audio = (self.trial_starts_in_sec * self.audio_sr).astype(int)

        import h5py

        with h5py.File(os.path.join(run_dir, "sEEG.hdf"), "r") as f:
            self.eeg = f["sEEG"][...]
            self.eeg_sr = int(np.asarray(f["sEEG_sr"]).reshape(-1)[0])
        self.word_starts_indices_eeg = (self.trial_starts_in_sec * self.eeg_sr).astype(int)
