"""Griffin-Lim vocoders, batched over blocks.

Two variants, matching the reference's two implementations:

* ``streaming_gl_blocks`` — the online vocoder
  (``livenodes/GriffinLim.py:64-174``): per 10 ms logMel frame, an 8-iteration
  Griffin-Lim on a 3-frame/480-sample block built from the last TWO mel
  frames (blockLen - contextWidth = 2 STFT frames of 256 samples, hop 160),
  Blackman windows, then overlap-add with window-sum normalization, emitting
  160 samples per frame.  The reference's phase term is ``exp(angle(x))`` —
  missing the ``1j`` (GriffinLim.py:93) — reproduced behind
  ``phase_bug=True`` (the offline twin has the correct ``exp(1j*angle)``,
  offline.py:168).
  All blocks are independent given their random inits, so the whole session
  runs as one batch of tiny DFT matmuls; overlap-add across blocks reduces to
  three shifted segment adds.

* ``offline_griffin_lim`` — the evaluation vocoder
  (``local/offline.py:131-192``): 800-point periodic-Hann STFT, 8 iterations
  over the full spectrogram, unnormalized ISTFT, random tail quirks kept.

Random inits are injected (``(B, 480)`` / full-signal arrays) so tests can
share them with a NumPy golden model, and online/offline decoding produce
identical audio from the same key.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import mel as mel_ops
from .stft import RDFT, make_rdft, blackman, hann_periodic


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class StreamingGLOps:
    """Precomputed constants for the streaming vocoder."""

    rdft: RDFT
    window: jnp.ndarray      # (fft_size,) blackman
    ola_window: jnp.ndarray  # (block_samples,) blackman over the 480 block
    Minv: jnp.ndarray        # (n_mel, spec_size)

    def tree_flatten(self):
        return ((self.rdft, self.window, self.ola_window, self.Minv), None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


# Fixed reference geometry: 16 ms frames / 10 ms shift @ 16 kHz.
FFT_SIZE = 256
HOP = 160
BLOCK_FRAMES = 3          # blockLen = contextWidth*2 + 1, contextWidth=1
STFT_FRAMES = 2           # blockLen - contextWidth
BLOCK_SAMPLES = BLOCK_FRAMES * HOP  # 480


def make_streaming_gl_ops(n_mel: int = 40, sample_rate: float = 16000.0, dtype=jnp.float32) -> StreamingGLOps:
    spec_size = FFT_SIZE // 2 + 1
    _, Minv = mel_ops.mel_matrices(spec_size, n_mel, sample_rate)
    return StreamingGLOps(
        rdft=make_rdft(FFT_SIZE, dtype),
        window=jnp.asarray(blackman(FFT_SIZE), dtype),
        ola_window=jnp.asarray(blackman(BLOCK_SAMPLES), dtype),
        Minv=jnp.asarray(Minv, dtype),
    )


def _gl_iteration(wav: jnp.ndarray, spec: jnp.ndarray, ops: StreamingGLOps, phase_bug: bool) -> jnp.ndarray:
    """One Griffin-Lim iteration on (B, 480) given target |spec| (B, 2, 129)."""
    f0 = wav[:, 0:FFT_SIZE] * ops.window
    f1 = wav[:, HOP : HOP + FFT_SIZE] * ops.window
    frames = jnp.stack([f0, f1], axis=1)  # (B, 2, N)
    xr, xi = ops.rdft.rfft(frames)        # (B, 2, K)
    if phase_bug:
        # Reference: z = spec * exp(angle(x)) — real-valued (GriffinLim.py:93).
        ang = jnp.arctan2(xi, xr)
        # Bins 0 and N/2 are mathematically real: np.angle gives exactly 0 or
        # +pi there; atan2 on a -0.0 roundoff imag would flip pi -> -pi and
        # blow exp(angle) from e^pi to e^-pi.  Force the exact values.
        pi = jnp.asarray(np.pi, ang.dtype)
        edge = jnp.where(xr[..., [0, -1]] < 0, pi, 0.0)
        ang = ang.at[..., 0].set(edge[..., 0]).at[..., -1].set(edge[..., 1])
        zr = spec * jnp.exp(ang)
        zi = jnp.zeros_like(zr)
    else:
        r = jnp.sqrt(xr * xr + xi * xi)
        safe = r > 0
        inv = jnp.where(safe, 1.0 / jnp.where(safe, r, 1.0), 0.0)
        zr = spec * jnp.where(safe, xr * inv, 1.0)
        zi = spec * (xi * inv)
    t = ops.rdft.irfft(zr, zi) * ops.window  # (B, 2, N)
    # overlap-add inside the block; samples [416:480) stay zero (istft covers
    # range(0, 480-256, 160) -> offsets 0 and 160 only; GriffinLim.py:69-74).
    re = jnp.pad(t[:, 0, :], ((0, 0), (0, BLOCK_SAMPLES - FFT_SIZE))) + jnp.pad(
        t[:, 1, :], ((0, 0), (HOP, BLOCK_SAMPLES - HOP - FFT_SIZE))
    )
    return re


@partial(jax.jit, static_argnames=("num_iterations", "phase_bug"))
def streaming_gl_blocks(
    log_mels: jnp.ndarray,
    rand_init: jnp.ndarray,
    ops: StreamingGLOps,
    num_iterations: int = 8,
    phase_bug: bool = True,
) -> jnp.ndarray:
    """Reconstruct per-block waveforms for a stream of logMel frames.

    log_mels: (N, n_mel) dequantized frames; block b uses frames [b, b+1].
    rand_init: (N-1, 480) uniform [0,1) initial waveforms.
    Returns re: (N-1, 480) reconstructed block waveforms (pre-OLA).
    """
    spec_frames = mel_ops.from_log_mels(log_mels, ops.Minv)  # (N, K)
    spec = jnp.stack([spec_frames[:-1], spec_frames[1:]], axis=1)  # (B, 2, K)
    wav = rand_init.astype(spec.dtype)
    for _ in range(num_iterations):
        wav = _gl_iteration(wav, spec, ops, phase_bug)
    return wav


def overlap_add_stream(re: jnp.ndarray, ops: StreamingGLOps) -> jnp.ndarray:
    """Cross-block overlap-add with window-sum normalization.

    Emitted chunk b = (re[b][0:160] + re[b-1][160:320] + re[b-2][320:480])
    normalized by the matching Blackman segment sums where nonzero
    (GriffinLim.py:144-166).  re: (B, 480) -> audio (B*160,) float.
    """
    B = re.shape[0]
    w = ops.ola_window
    s0, s1, s2 = re[:, :HOP], re[:, HOP : 2 * HOP], re[:, 2 * HOP :]
    z = jnp.zeros((1, HOP), re.dtype)
    acc = s0 + jnp.concatenate([z, s1[:-1]], 0) + jnp.concatenate([z, z, s2[:-2]], 0)
    w0, w1, w2 = w[:HOP], w[HOP : 2 * HOP], w[2 * HOP :]
    ones = jnp.ones((B, 1), re.dtype)
    has1 = (jnp.arange(B) >= 1).astype(re.dtype)[:, None]
    has2 = (jnp.arange(B) >= 2).astype(re.dtype)[:, None]
    wsum = ones * w0[None, :] + has1 * w1[None, :] + has2 * w2[None, :]
    out = jnp.where(wsum != 0, acc / jnp.where(wsum != 0, wsum, 1.0), acc)
    return out.reshape(-1)


def to_int16(audio: jnp.ndarray, norm_factor: float) -> jnp.ndarray:
    """np.int16(clip(x / (norm*1.01), -0.99, 0.99) * 32767) — GriffinLim.py:174."""
    x = jnp.clip(audio / (norm_factor * 1.01), -0.99, 0.99) * (2**15 - 1)
    return x.astype(jnp.int16)


def default_rand_init(key: jax.Array, num_blocks: int, first_block_index: int = 0, dtype=jnp.float32) -> jnp.ndarray:
    """Deterministic per-block uniform inits; block identity is its global
    index, so online and offline decoding of the same session agree."""
    idx = first_block_index + jnp.arange(num_blocks)
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(idx)
    return jax.vmap(lambda k: jax.random.uniform(k, (BLOCK_SAMPLES,), dtype))(keys)


# ---------------------------------------------------------------------------
# Offline evaluation vocoder (local/offline.py:131-192)
# ---------------------------------------------------------------------------


def offline_griffin_lim(
    spectrogram: np.ndarray,
    rand_init: np.ndarray | None = None,
    win_length: float = 0.05,
    hop_size: float = 0.01,
    num_iterations: int = 8,
    sample_rate: int = 16000,
    dtype=jnp.float32,
):
    """Batch Griffin-Lim over a full logMel spectrogram; returns int16 audio.

    Faithful to the reference quirks: ``lenWaveFile = frames * bins``; the
    working buffer is twice that and its random tail beyond the ISTFT output
    persists across iterations; ISTFT is unnormalized; final scaling to full
    int16 range by the max absolute value.
    """
    spectrogram = np.asarray(spectrogram)
    win = int(win_length * sample_rate)
    hop = int(win / (win_length / hop_size))
    n_bins = win // 2 + 1
    _, Minv = mel_ops.mel_matrices(n_bins, spectrogram.shape[1], sample_rate)
    spec = np.asarray(mel_ops.from_log_mels(jnp.asarray(spectrogram, jnp.float64 if dtype == jnp.float64 else dtype), jnp.asarray(Minv, dtype)))

    n_spec = spec.shape[0]
    len_wave = n_spec * spec.shape[1]
    total = len_wave * 2
    if rand_init is None:
        rand_init = np.random.rand(total)
    wav = jnp.asarray(rand_init, dtype)

    rdft = make_rdft(win, dtype)
    w = jnp.asarray(hann_periodic(win), dtype)
    frame_idx = jnp.asarray(np.arange(n_spec)[:, None] * hop + np.arange(win)[None, :])
    re_len = n_spec * hop
    # ISTFT only adds frames whose window fits strictly before re_len - win
    # (``range(0, len(x) - fftsize, hop)``, offline.py:158) — trailing spec
    # rows are silently unused, a reference quirk we keep.
    n_add = len(range(0, re_len - win, hop))
    spec_j = jnp.asarray(spec, dtype)

    @jax.jit
    def iteration(wav):
        frames = jnp.take(wav, frame_idx, axis=0) * w  # (n_spec, win)
        xr, xi = rdft.rfft(frames)
        r = jnp.sqrt(xr * xr + xi * xi)
        safe = r > 0
        inv = jnp.where(safe, 1.0 / jnp.where(safe, r, 1.0), 0.0)
        zr = spec_j * jnp.where(safe, xr * inv, 1.0)
        zi = spec_j * (xi * inv)
        t = rdft.irfft(zr, zi) * w  # (n_spec, win)
        pos = np.arange(n_add) * hop
        re = jnp.zeros(re_len, dtype)
        re = re.at[(pos[:, None] + np.arange(win)[None, :]).reshape(-1)].add(t[:n_add].reshape(-1))
        return wav.at[:re_len].set(re)

    for _ in range(num_iterations):
        wav = iteration(wav)
    rec = np.asarray(wav[:re_len])
    return np.int16(rec / np.max(np.abs(rec)) * 32767)
