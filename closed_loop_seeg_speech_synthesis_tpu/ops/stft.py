"""Small-FFT STFT as matmuls.

The vocoder works on 256-point FFTs of 2-frame blocks
(``livenodes/GriffinLim.py:50,64-74``).  An FFT library is fine for large
transforms, but at size 256 an explicit real DFT as two (N, N/2+1) matmuls
batches perfectly over thousands of frames and fuses with the surrounding
elementwise work, so that is the default; matrices are built host-side in
float64 and cast to the compute dtype.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import scipy.signal.windows as _win


_HI = jax.lax.Precision.HIGHEST  # full float32 products (no TF32/bf16 passes)

@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class RDFT:
    """Real DFT operator of size N (N even). rfft: x(...,N) -> (Xr, Xi)(...,N/2+1)."""

    F_cos: jnp.ndarray  # (N, K)
    F_sin: jnp.ndarray  # (N, K)
    I_cos: jnp.ndarray  # (K, N)
    I_sin: jnp.ndarray  # (K, N)

    def tree_flatten(self):
        return ((self.F_cos, self.F_sin, self.I_cos, self.I_sin), None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def n(self) -> int:
        return self.F_cos.shape[0]

    def rfft(self, x: jnp.ndarray):
        """x: (..., N) real -> (real, imag) each (..., N//2+1)."""
        return (jnp.matmul(x, self.F_cos, precision=_HI),
                -jnp.matmul(x, self.F_sin, precision=_HI))

    def irfft(self, xr: jnp.ndarray, xi: jnp.ndarray) -> jnp.ndarray:
        """(real, imag): (..., N//2+1) -> x: (..., N), matching np.fft.irfft."""
        return (jnp.matmul(xr, self.I_cos, precision=_HI)
                + jnp.matmul(xi, self.I_sin, precision=_HI))


def make_rdft(n: int, dtype=jnp.float32) -> RDFT:
    k = n // 2 + 1
    nn, kk = np.meshgrid(np.arange(n), np.arange(k), indexing="ij")
    ang = 2.0 * np.pi * nn * kk / n
    cos = np.cos(ang)  # (N, K)
    sin = np.sin(ang)
    # Bins 0 and N/2 are exactly real for real input; kill the ~1e-13 sin
    # residue so downstream angle computations see a true zero (np.fft.irfft
    # likewise ignores the imaginary part at these bins).
    sin[:, 0] = 0.0
    if n % 2 == 0:
        sin[:, -1] = 0.0
    w = np.full(k, 2.0)
    w[0] = 1.0
    if n % 2 == 0:
        w[-1] = 1.0
    icos = (w[:, None] * cos.T) / n          # (K, N)
    isin = -(w[:, None] * sin.T) / n
    to = lambda a: jnp.asarray(a, dtype)
    return RDFT(F_cos=to(cos), F_sin=to(sin), I_cos=to(icos), I_sin=to(isin))


def blackman(n: int) -> np.ndarray:
    """scipy.blackman (symmetric) — GriffinLim.py:50,154."""
    return _win.blackman(n, sym=True).astype(np.float64)


def hann_sym(n: int) -> np.ndarray:
    """scipy.signal.windows.hann(n) — offline compute_spectrogram window."""
    return _win.hann(n, sym=True).astype(np.float64)


def hann_periodic(n: int) -> np.ndarray:
    """scipy.hanning(n+1)[:-1] — offline griffin_lim's 'better reconstruction
    trick' window (local/offline.py:148)."""
    return _win.hann(n + 1, sym=True)[:-1].astype(np.float64)


def frame_signal(x: jnp.ndarray, frame_len: int, hop: int, num_frames: int) -> jnp.ndarray:
    """Strided framing: out[i] = x[i*hop : i*hop + frame_len].  x: (..., T)."""
    idx = (np.arange(num_frames)[:, None] * hop + np.arange(frame_len)[None, :])
    return jnp.take(x, jnp.asarray(idx), axis=-1)
