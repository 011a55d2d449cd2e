"""Causal IIR filtering as block-parallel linear state-space operators.

The reference streams every sEEG chunk through cascades of order-8
Butterworth second-order sections with persistent state
(``livenodes/FrameBuffer.py:139-143`` via ``scipy.signal.sosfilt``), and the
vocoder output through an order-5 low-pass ``lfilter``
(``livenodes/GriffinLim.py:169-170``).  A literal per-sample translation
would serialize the accelerator; instead we exploit that an LTI filter is a linear
recurrence:

    s[t+1] = A s[t] + B u[t]        y[t] = C s[t] + D u[t]

* ``sos_to_statespace`` / ``ba_to_statespace`` build (A, B, C, D) whose state
  coordinates are exactly scipy's direct-form-II-transposed ``zi`` layout, so
  scipy-computed warm-start states drop straight in.
* ``cascade_statespace`` composes several filters into one system (the
  reference's three-filter high-gamma chain becomes a single 48-dim system).
* ``iir_scan``: per-sample ``lax.scan`` (used for small online packets).
* ``make_blocked_iir`` + ``iir_blocked``: block processing.  Within a block
  of L samples the output is the sum of (i) the zero-input response
  ``Cpow @ s0`` and (ii) a causal convolution with the truncated impulse
  response, expressed as an (L, L) lower-triangular Toeplitz matmul.  Block boundary states propagate through an associative scan
  of (A^L, q_k) pairs — O(log K) depth instead of O(T) sequential steps.

All block operators are precomputed on the host in float64 and cast to the
compute dtype, so no matrix powers are taken in low precision.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# State-space construction (host-side, float64 numpy)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StateSpace:
    """x[t] scalar-in scalar-out LTI system; state dim S."""

    A: np.ndarray  # (S, S)
    B: np.ndarray  # (S,)
    C: np.ndarray  # (S,)
    D: float

    @property
    def dim(self) -> int:
        return self.A.shape[0]


def biquad_to_statespace(section: np.ndarray) -> StateSpace:
    """One SOS row [b0 b1 b2 a0 a1 a2] -> DF2T state-space.

    scipy.signal.sosfilt recurrence (a0 normalized to 1):
        y    = b0*x + z0
        z0'  = b1*x + z1 - a1*y
        z1'  = b2*x      - a2*y
    State s = [z0, z1] == scipy's per-section ``zi`` layout.
    """
    b0, b1, b2, a0, a1, a2 = [float(v) for v in section]
    if a0 != 1.0:
        b0, b1, b2, a1, a2 = b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0
    A = np.array([[-a1, 1.0], [-a2, 0.0]], dtype=np.float64)
    B = np.array([b1 - a1 * b0, b2 - a2 * b0], dtype=np.float64)
    C = np.array([1.0, 0.0], dtype=np.float64)
    return StateSpace(A, B, C, b0)


def series(first: StateSpace, second: StateSpace) -> StateSpace:
    """Feed ``first``'s output into ``second`` (same-sample cascade)."""
    s1, s2 = first.dim, second.dim
    A = np.zeros((s1 + s2, s1 + s2), dtype=np.float64)
    A[:s1, :s1] = first.A
    A[s1:, s1:] = second.A
    A[s1:, :s1] = np.outer(second.B, first.C)
    B = np.concatenate([first.B, second.B * first.D])
    C = np.concatenate([second.D * first.C, second.C])
    return StateSpace(A, B, C, second.D * first.D)


def sos_to_statespace(sos: np.ndarray) -> StateSpace:
    """Cascade of SOS rows -> one state-space; state = zi.reshape(-1)."""
    ss = biquad_to_statespace(sos[0])
    for row in sos[1:]:
        ss = series(ss, biquad_to_statespace(row))
    return ss


def ba_to_statespace(b: np.ndarray, a: np.ndarray) -> StateSpace:
    """(b, a) transfer function -> DF2T state-space matching scipy.lfilter.

    State coordinates equal scipy's ``lfiltic``/``lfilter`` zi layout:
        y    = b0*x + z0
        zi'  = b[i+1]*x + z[i+1] - a[i+1]*y      (z[n] treated as 0)
    """
    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    n = max(len(a), len(b)) - 1
    b = np.pad(b, (0, n + 1 - len(b)))
    a = np.pad(a, (0, n + 1 - len(a)))
    if a[0] != 1.0:
        b, a = b / a[0], a / a[0]
    A = np.zeros((n, n), dtype=np.float64)
    A[:, 0] = -a[1:]
    A[: n - 1, 1:] += np.eye(n - 1)
    B = b[1:] - a[1:] * b[0]
    C = np.zeros(n, dtype=np.float64)
    C[0] = 1.0
    return StateSpace(A, B, C, float(b[0]))


def cascade_statespace(systems) -> StateSpace:
    """Series composition of several StateSpace systems."""
    out = systems[0]
    for nxt in systems[1:]:
        out = series(out, nxt)
    return out


# ---------------------------------------------------------------------------
# Per-sample scan (online packets; also the numerics reference on device)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("unroll",))
def iir_scan(A, B, C, D, x, s0, unroll: int = 8):
    """Sequential filtering.  x: (T, C) in, s0: (S, C) state, returns (y, sT)."""

    def step(s, u):
        y = C @ s + D * u
        s_next = A @ s + B[:, None] * u[None, :]
        return s_next, y

    sT, y = jax.lax.scan(step, s0, x, unroll=unroll)
    return y, sT


# ---------------------------------------------------------------------------
# Blocked (parallel-in-time) filtering
# ---------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class BlockedIIR:
    """Precomputed block operators for one LTI system at block length L."""

    Cpow: jnp.ndarray  # (L, S)    row t = C @ A^t
    Tmat: jnp.ndarray  # (L, L)    lower-tri Toeplitz of impulse response
    Pmat: jnp.ndarray  # (S, L)    col j = A^(L-1-j) @ B
    A_L: jnp.ndarray   # (S, S)    A^L
    Apow: jnp.ndarray  # (L+1, S, S) all powers (for partial tails / prefills)
    B: jnp.ndarray     # (S,)
    C: jnp.ndarray     # (S,)
    D: jnp.ndarray     # ()
    A: jnp.ndarray     # (S, S)

    def tree_flatten(self):
        return (
            (self.Cpow, self.Tmat, self.Pmat, self.A_L, self.Apow, self.B, self.C, self.D, self.A),
            None,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def block(self) -> int:
        return self.Cpow.shape[0]

    @property
    def dim(self) -> int:
        return self.Cpow.shape[1]


def _prefix_powers(A: np.ndarray, L: int) -> np.ndarray:
    """(L+1, S, S) table of A^0 .. A^L via log-doubling.

    A naive ``Apow[t] = Apow[t-1] @ A`` loop issues L tiny GEMMs whose
    fixed per-call overhead (BLAS threadpool wakeup) dominates at the
    block sizes used here (L up to 4096) — observed ~10 ms/call on a
    contended 1-core host, i.e. ~40 s per table.  Doubling builds the same
    table in ceil(log2 L) batched einsums: A^(m+1..m+k) = A^(1..k) @ A^m.
    """
    S = A.shape[0]
    Apow = np.empty((L + 1, S, S), dtype=np.float64)
    Apow[0] = np.eye(S)
    if L >= 1:
        Apow[1] = A
    m = 1
    while m < L:
        k = min(m, L - m)
        np.einsum("tsu,uv->tsv", Apow[1 : k + 1], Apow[m],
                  out=Apow[m + 1 : m + k + 1], optimize=True)
        m += k
    return Apow


def make_blocked_iir(ss: StateSpace, block: int, dtype=jnp.float32) -> BlockedIIR:
    """Host-side (float64) construction of the block operators."""
    S = ss.dim
    L = int(block)
    Apow = _prefix_powers(ss.A, L)
    Cpow = np.einsum("s,tsu->tu", ss.C, Apow[:L], optimize=True)  # (L, S)
    h = np.empty(L, dtype=np.float64)
    h[0] = ss.D
    if L > 1:
        h[1:] = Cpow[: L - 1] @ ss.B  # C A^(t-1) B for t = 1..L-1
    # Lower-triangular Toeplitz: Tmat[t, j] = h[t - j] for j <= t.  Built by
    # striding a (2L-1) padded vector — a masked fancy-index materializes
    # ~5 L^2 temporaries (~600 MB at L=4096), which thrashes small hosts.
    hp = np.concatenate([np.zeros(L - 1), h])
    st = hp.strides[0]
    Tmat = np.ascontiguousarray(np.lib.stride_tricks.as_strided(
        hp[L - 1 :], shape=(L, L), strides=(st, -st)))
    Pmat = np.ascontiguousarray(  # (S, L): column j holds A^(L-1-j) B
        np.einsum("tsu,u->ts", Apow[L - 1 :: -1], ss.B, optimize=True).T)
    to = lambda a: jnp.asarray(a, dtype=dtype)
    return BlockedIIR(
        Cpow=to(Cpow), Tmat=to(Tmat), Pmat=to(Pmat), A_L=to(Apow[L]), Apow=to(Apow),
        B=to(ss.B), C=to(ss.C), D=jnp.asarray(ss.D, dtype=dtype), A=to(ss.A),
    )


_HI = jax.lax.Precision.HIGHEST  # full float32 products: the IIR
# recurrence and boundary scan are feedback paths where reduced-precision
# products (TF32 / bf16 passes) inject ~1e-3..1e-2 relative noise
# (docs/NUMERICS.md)


def _boundary_states(A_L, q, s0):
    """States before each block. q: (K, S, C); s0: (S, C) -> (K, S, C)."""
    K = q.shape[0]
    M = jnp.broadcast_to(A_L, (K,) + A_L.shape)

    def combine(a, b):
        Ma, va = a
        Mb, vb = b
        return (jnp.matmul(Mb, Ma, precision=_HI),
                jnp.einsum("kst,ktc->ksc", Mb, va, precision=_HI) + vb)

    Mpref, vpref = jax.lax.associative_scan(combine, (M, q))
    s_after = jnp.einsum("kst,tc->ksc", Mpref, s0, precision=_HI) + vpref  # state after block k
    return jnp.concatenate([s0[None], s_after[:-1]], axis=0), s_after[-1]


@jax.jit
def iir_blocked(op: BlockedIIR, x: jnp.ndarray, s0: jnp.ndarray):
    """Filter x: (T, C) from state s0: (S, C).  Returns (y (T, C), sT (S, C)).

    Equivalent to scipy.signal.sosfilt / lfilter with zi=s0 (same state
    coordinates), evaluated block-parallel as matmuls.  For single-channel
    signals (the vocoder's audio low-pass) the Toeplitz contraction is
    expressed with the block index as the matmul M dimension — (K, L) @
    (L, L) — instead of K batched skinny matmuls.
    """
    T, C = x.shape
    L = op.block
    K = -(-T // L)
    pad = K * L - T
    xp = jnp.pad(x, ((0, pad), (0, 0))) if pad else x
    u = xp.reshape(K, L, C)

    if C == 1:
        u2 = u[:, :, 0]                                   # (K, L)
        q = jnp.matmul(u2, op.Pmat.T, precision=_HI)[:, :, None]                  # (K, S, 1)
        s_before, _ = _boundary_states(op.A_L, q, s0)
        y = (jnp.matmul(s_before[:, :, 0], op.Cpow.T, precision=_HI)
             + jnp.matmul(u2, op.Tmat.T, precision=_HI))  # (K, L)
        y = y.reshape(K * L, 1)[:T]
    else:
        q = jnp.einsum("sl,klc->ksc", op.Pmat, u, precision=_HI)
        s_before, _ = _boundary_states(op.A_L, q, s0)
        y = (jnp.einsum("ls,ksc->klc", op.Cpow, s_before, precision=_HI)
             + jnp.einsum("tj,kjc->ktc", op.Tmat, u, precision=_HI))
        y = y.reshape(K * L, C)[:T]

    # Exact state at sample T (padding zeros must not advance the state).
    r = T - (K - 1) * L  # samples of the final (possibly partial) block
    s_last = s_before[K - 1]
    sT = (jnp.matmul(op.Apow[r], s_last, precision=_HI)
          + jnp.einsum("sl,lc->sc", op.Pmat[:, L - r:], u[K - 1, :r], precision=_HI))
    return y, sT


def zero_input_response(op: BlockedIIR, s0: jnp.ndarray, n: int):
    """y[t] = C @ A^t @ s0 for t < n, plus the state after n zero samples.

    Used for the reference's warm-start zero-fill
    (``livenodes/FrameBuffer.py:94-98``): filtering ``n`` zeros from state s0
    emits the zero-input response into the ring buffer.
    """
    parts = []
    s = s0
    for off in range(0, n, op.block):
        m = min(op.block, n - off)
        parts.append(jnp.matmul(op.Cpow[:m], s, precision=_HI))
        s = jnp.matmul(op.Apow[m], s, precision=_HI)
    y = jnp.concatenate(parts, axis=0) if parts else jnp.zeros((0,) + s0.shape[1:], s0.dtype)
    return y, s


def scale_zi_by_first_sample(zi_flat: jnp.ndarray, x0: jnp.ndarray) -> jnp.ndarray:
    """Reference cold-start: zi scaled per channel by the first input sample
    (``livenodes/FrameBuffer.py:90-92``).  zi_flat: (S,), x0: (C,) -> (S, C)."""
    return zi_flat[:, None] * x0[None, :]


@dataclasses.dataclass(frozen=True)
class WarmStartChain:
    """The reference's full filter chain as ONE state-space system with
    closed-form warm-start initialization.

    The chain (ECogFeatCalc.py:40-104): filters 1..n-1 cold-start with
    ``zi * first input sample``; since filter i's first input sample is
    ``alpha_{i-1} * x0`` (alpha = product of first-sample gains
    C_j@zi_j + D_j), the whole cascade's initial state is linear in x0:
    ``s0 = zi_scale (x) x0 + s_const``.  The last filter warm-starts from
    unscaled zi advanced over ``prefill`` zeros — a channel-independent
    constant — and the zeros' output prefix (which the reference keeps in the
    ring buffer, FrameBuffer.py:94-98) is likewise a precomputed vector.
    """

    zi_scale: np.ndarray   # (S,) -> s0 contribution proportional to x0
    s_const: np.ndarray    # (S,) -> constant s0 part (warm-started last filter)
    zf_prefix: np.ndarray  # (prefill,) zero-fill output prefix (all channels)
    dim: int
    prefill: int


def make_warmstart_chain(chain_sos, prefill: int) -> tuple[StateSpace, WarmStartChain]:
    """Compose a filter chain (list of SOS arrays) with reference warm-start
    semantics.  Returns (combined StateSpace, WarmStartChain constants)."""
    import scipy.signal as _sig

    systems = [sos_to_statespace(s) for s in chain_sos]
    combined = cascade_statespace(systems)
    zis = [_sig.sosfilt_zi(s).reshape(-1) for s in chain_sos]

    zi_scale = np.zeros(combined.dim)
    s_const = np.zeros(combined.dim)
    alpha = 1.0
    off = 0
    for ss, zi in zip(systems[:-1], zis[:-1]):
        zi_scale[off : off + ss.dim] = zi * alpha
        alpha *= float(ss.C @ zi + ss.D)
        off += ss.dim
    last, zi_last = systems[-1], zis[-1]
    # advance the last filter's unscaled zi over `prefill` zero samples and
    # record the emitted zero-input response (float64, once)
    Apow = _prefix_powers(last.A, prefill)
    zf = np.einsum("s,tsu,u->t", last.C, Apow[:prefill], zi_last, optimize=True)
    s_const[off : off + last.dim] = Apow[prefill] @ zi_last

    return combined, WarmStartChain(zi_scale=zi_scale, s_const=s_const,
                                    zf_prefix=zf, dim=combined.dim, prefill=prefill)
