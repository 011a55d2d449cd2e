"""Frame schedules, windowed log-power features, and context stacking.

The reference frames a continuous stream into 50 ms windows every 10 ms on an
absolute-time grid: frame k ends at sample
``round((first_frame_ms + k * shift_ms) / 1000 * sr)`` with Python/banker's
rounding (``livenodes/FrameBuffer.py:177``), which at 1024 Hz gives the
fractional 10.24-sample shift pattern [10,10,11,10,...].  Offline training
uses the sibling grid ``start = int(round(k * shift * sr))``,
``stop = int(round(start + win * sr))`` (``local/offline.py:99-109``).

Schedules are computed host-side in EXACT rational arithmetic
(round-half-even on ``fsize + k * shift_samples`` with
``shift_samples = shift_ms * sr / 1000`` as a Fraction) and handed to the
device as integer arrays.  This matches the reference's float64 grid bit-for-
bit at every rate where that grid is well-defined (no exact .5 ties — in
particular 512/1024/2048 Hz, verified over 100k frames), and gives a
well-defined periodic grid at tie rates where the reference's float
evaluation round-half-evens on accumulated representation error (e.g.
1025 Hz: exact ends hit x.5 every 4th frame).  Shift sequences are exactly
periodic — period q (the reduced denominator of shift_samples; 10 ms @
1024 Hz: 25 frames = exactly 256 samples) or 2q when ties make the rounding
depend on integer parity — which the online step exploits to track frame
positions in pure integer arithmetic for unbounded sessions at ANY rate.

Features: ``log(sum(x^2) + 0.01)`` per window and channel
(``livenodes/ECogFeatCalc.py:118-124``, ``local/offline.py:99-109``), then
context stacking of 5 taps spaced 5 frames (200 ms lookback), flattened
channel-major (``ECogFeatCalc.py:137-144``, ``offline.py:111-116``).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Host-side schedules (exact reference arithmetic)
# ---------------------------------------------------------------------------

_HI = jax.lax.Precision.HIGHEST  # full float32 products (no TF32/bf16 passes)



def frame_size(frame_ms: float, sr: float) -> int:
    """int((frame_ms / 1000) * sr) — FrameBuffer.py:27."""
    return int((float(frame_ms) / 1000.0) * float(sr))


def warm_start_prefill(frame_ms: float, shift_ms: float, sr: float) -> int:
    """Zero-fill length for warm-started buffers — FrameBuffer.py:96."""
    return frame_size(frame_ms, sr) - int((float(shift_ms) / 1000.0) * float(sr))


def _exact_shift(shift_ms: float, sr: float):
    """shift_ms * sr / 1000 as an exact Fraction (decimal reading of the
    float reprs, so e.g. 10 ms @ 1024 Hz is exactly 256/25)."""
    from fractions import Fraction

    return Fraction(str(float(shift_ms))) * Fraction(str(float(sr))) / 1000


def exact_frame_ends(frame_ms: float, shift_ms: float, sr: float, n: int) -> np.ndarray:
    """The first ``n`` frame ends on the exact streaming grid.

    e_k = round_half_even(fsize + k * shift_samples), evaluated in integer
    arithmetic: with shift_samples = p/q reduced, e_k = N_k + tie(k) where
    N_k = fsize + (k*p)//q and the x.5 tie (2*(k*p mod q) == q) rounds up
    exactly when N_k is odd.  Equals the reference's float grid
    (FrameBuffer.py:29,177) wherever that grid never lands on a tie.
    """
    fsize = frame_size(frame_ms, sr)
    shift = _exact_shift(shift_ms, sr)
    p, q = shift.numerator, shift.denominator
    k = np.arange(n, dtype=np.int64)
    N = fsize + (k * p) // q
    rem = (k * p) % q
    up = (2 * rem > q) | ((2 * rem == q) & (N % 2 == 1))
    return N + up.astype(np.int64)


def streaming_frame_ends(frame_ms: float, shift_ms: float, sr: float, total_len: int) -> np.ndarray:
    """All frame end positions e_k <= total_len on the streaming grid.

    e_0 = frame_size; e_k = round(fsize + k * shift_samples) in exact
    rational arithmetic (see ``exact_frame_ends``; identical to the
    reference's float grid FrameBuffer.py:29,177 at every non-tie rate).
    ``total_len`` counts samples *including* any warm-start prefill.
    """
    fsize = frame_size(frame_ms, sr)
    if total_len < fsize:
        return np.zeros(0, dtype=np.int64)
    shift = _exact_shift(shift_ms, sr)
    n_max = int((total_len - fsize) / shift) + 2
    ends = exact_frame_ends(frame_ms, shift_ms, sr, n_max)
    return ends[ends <= total_len]


def shift_table(frame_ms: float, shift_ms: float, sr: float, check_horizon: int = 64) -> np.ndarray:
    """Exact periodic diff table for the streaming grid of this buffer.

    d[i] = e_{k+1} - e_k for k ≡ i (mod period).  On the exact grid the
    diff sequence is always periodic: with shift_samples = p/q reduced, the
    fractional parts repeat with period q, and the parity term that breaks
    x.5 ties repeats with period 2q (N_{k+q} = N_k + p flips parity when p
    is odd).  The candidate periods are verified against ``check_horizon``
    full cycles; every rate yields a table, so online decoding is supported
    at ANY sample rate (the refusal this function used to raise for
    tie rates is gone — the grid itself is now exact).
    """
    shift = _exact_shift(shift_ms, sr)
    q = shift.denominator
    n = 2 * q * check_horizon + 4
    ends = exact_frame_ends(frame_ms, shift_ms, sr, n + 1)
    d = np.diff(ends)
    for P in (q, 2 * q):
        reps = np.tile(d[:P], len(d) // P + 1)[: len(d)]
        if np.array_equal(d, reps):
            return d[:P].astype(np.int32)
    raise AssertionError(
        f"exact frame schedule at sr={sr}, shift={shift_ms} ms did not repeat "
        f"with period {q} or {2*q}; this should be mathematically impossible")


def offline_window_starts(win_s: float, shift_s: float, sr: float, total_len: int) -> np.ndarray:
    """Training grid (local/offline.py:100-106): start_k = int(round(k*shift*sr)),
    window [start, int(round(start + win*sr))); count = floor((T - win*sr)/(shift*sr)) + 1."""
    num = int(np.floor((total_len - win_s * sr) / (shift_s * sr))) + 1
    starts = np.asarray([int(round((k * shift_s) * sr)) for k in range(max(num, 0))], dtype=np.int64)
    return starts


def offline_window_len(win_s: float, sr: float, starts: np.ndarray | None = None) -> int:
    """stop - start on the training grid: int(round(start + win*sr)) - start.

    The fractional part of win*sr is constant across integer starts (51.2 @
    1024 Hz -> always +51), except exactly-.5 fractions where banker's
    rounding depends on parity; we verify constancy against the actual
    starts and reject the pathological case."""
    if starts is None or len(starts) == 0:
        return int(round(win_s * sr))
    lens = {int(round(float(s) + win_s * sr)) - int(s) for s in starts}
    if len(lens) != 1:
        raise ValueError(f"non-constant offline window length: {sorted(lens)}")
    return lens.pop()


# ---------------------------------------------------------------------------
# Device ops
# ---------------------------------------------------------------------------


def sliding_sumsq(x: jnp.ndarray, win: int) -> jnp.ndarray:
    """Sliding window sum of squares along axis 0.  x: (T, C) -> (T-win+1, C);
    out[t] = sum(x[t:t+win]**2)."""
    w = x * x
    return jax.lax.reduce_window(
        w, jnp.zeros((), w.dtype), jax.lax.add,
        window_dimensions=(win, 1), window_strides=(1, 1), padding="VALID",
    )


def windowed_logpower(x: jnp.ndarray, ends: jnp.ndarray, win: int) -> jnp.ndarray:
    """log(sum(x[e-win:e]**2, axis=0) + 0.01) for each frame end e.

    x: (T, C); ends: (N,) int32 frame end positions (exclusive). -> (N, C)
    """
    sums = sliding_sumsq(x, win)  # (T-win+1, C); sums[s] covers [s, s+win)
    starts = ends - win
    gathered = jnp.take(sums, starts, axis=0)
    return jnp.log(gathered + jnp.asarray(0.01, x.dtype))


def periodic_window_matrix(ends: np.ndarray, win: int):
    """Host-side selection matrix for periodic frame schedules.

    The streaming grid repeats every P frames spanning exactly Ls samples
    (shift_table): e_{i+P} = e_i + Ls.  Window sums then become ONE matmul
    per period against a (P, Ls + win) 0/1 matrix — a dense matmul instead of a 48 GB
    sliding reduce_window.

    Returns (S (P, 2*Ls), Ls, P) or None if the schedule isn't usable
    (requires win <= Ls and at least one full period).
    """
    ends = np.asarray(ends)
    if len(ends) < 2:
        return None
    d = np.diff(ends)
    # detect period: smallest P whose diff pattern repeats over the schedule
    for P in range(1, min(len(d), 4096) + 1):
        cand = d[:P]
        reps = np.tile(cand, len(d) // P + 1)[: len(d)]
        if np.array_equal(reps, d):
            Ls = int(cand.sum())
            if win > Ls:
                return None
            S = np.zeros((P, 2 * Ls), dtype=np.float64)
            origin = int(ends[0]) - win  # start of window 0 == period-0 start
            for i in range(P):
                lo = int(ends[i]) - win - origin
                S[i, lo : lo + win] = 1.0
            return S, Ls, P, origin
    return None


def windowed_logpower_periodic(x: jnp.ndarray, S: jnp.ndarray, Ls: int, n_frames: int,
                               origin: int) -> jnp.ndarray:
    """log(window sum of squares + 0.01) on a periodic grid via matmuls.

    x: (T, C); S: (P, 2*Ls) selection matrix from periodic_window_matrix;
    origin = e_0 - win.  Output (n_frames, C); exact same sums as
    windowed_logpower, evaluated as (P, 2*Ls) @ (2*Ls, C) per period.
    """
    P = S.shape[0]
    w = x * x
    T, C = w.shape
    n_periods = -(-n_frames // P)
    need = origin + (n_periods + 1) * Ls
    wp = jnp.pad(w, ((0, max(0, need - T)), (0, 0)))[origin : origin + (n_periods + 1) * Ls]
    a = wp[: n_periods * Ls].reshape(n_periods, Ls, C)
    b = wp[Ls:].reshape(n_periods, Ls, C)
    span = jnp.concatenate([a, b], axis=1)  # (K, 2*Ls, C)
    sums = jnp.einsum("pt,ktc->kpc", S.astype(x.dtype), span, precision=_HI)
    sums = sums.reshape(n_periods * P, C)[:n_frames]
    return jnp.log(sums + jnp.asarray(0.01, x.dtype))


def stack_context(F: jnp.ndarray, model_order: int = 4, step_size: int = 5, zero_pad: bool = True) -> jnp.ndarray:
    """Context stacking: out[j] = [F[j - m*step] for m = model_order..0] per
    channel, channel-major flattened (taps oldest-first within a channel).

    zero_pad=True  -> streaming warm start: j ranges over all rows, missing
                      history is zeros (ECogFeatCalc stack buffer prefill).
    zero_pad=False -> offline: j starts at model_order*step_size
                      (offline.py:111-116).
    Returns (N_out, (model_order+1) * C).
    """
    depth = model_order * step_size
    if zero_pad:
        Fp = jnp.concatenate([jnp.zeros((depth,) + F.shape[1:], F.dtype), F], axis=0)
    else:
        Fp = F
    n_out = Fp.shape[0] - depth
    taps = [Fp[m * step_size : m * step_size + n_out] for m in range(model_order + 1)]
    stacked = jnp.stack(taps, axis=1)  # (N, taps, C) oldest-first
    # channel-major flatten: (N, C, taps) -> (N, C*taps)
    return jnp.transpose(stacked, (0, 2, 1)).reshape(n_out, -1)
