"""The decoder as a statically-compiled frame program.

Replaces the reference's push-callback DAG (``decode.py:152-183`` wiring
LSL_Socket -> ChannelSelector -> ECogFeatCalc -> LDASynthesis ->
Dequantization -> GriffinLimSynthesis -> sinks) with two code paths sharing
the same parameters and numerics:

* ``offline_decode`` — whole-session batch decode.  The reference's streaming
  output is provably chunk-size invariant (filters carry state, frames sit on
  an absolute-time grid), so file replay (``decode.py:71-96``) needs no
  packet simulation at all: blocked state-space IIR -> sliding log-power ->
  one LDA einsum -> batched Griffin-Lim (north star: >1000x real time,
  BASELINE.md).

* ``OnlineDecoder`` — one jitted ``step(carry, packet)`` whose carry holds
  every piece of streaming state (filter states, sample history, feature
  stack, Griffin-Lim OLA tails, low-pass state, integer frame schedule).
  This is the <10 ms closed-loop path; it produces bit-identical output to
  ``offline_decode`` given the same random key.

Decoded spectrogram frames correspond to the reference's 'Spectrogram'
Receiver taps (dequantized+smoothed logMels), audio to the int16 stream the
reference feeds its soundcard sink.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models import lda as lda_mod
from ..ops import filter_design as fd
from ..ops import framing, iir, quantization, smoothing
from ..ops import griffinlim as gl


_HI = jax.lax.Precision.HIGHEST  # full float32 products (no TF32/bf16 passes)


def default_compute_dtype():
    """float32 on accelerators; float64 on CPU, enabling x64 so the golden
    numerics are actually computed — without this, float64 requests silently
    truncate to float32 (JAX default)."""
    if jax.default_backend() == "cpu":
        jax.config.update("jax_enable_x64", True)
        return jnp.float64
    return jnp.float32


def max_frames_per_packet(packet_size: int, shift_table: np.ndarray) -> int:
    """Worst-case frames emitted per packet: floor((P-1)/min_shift) + 1
    (4 for 32@1024 Hz and 64@2048 Hz; larger for slower amplifiers)."""
    return int((packet_size - 1) // int(np.min(shift_table))) + 1


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Static decode-time configuration (reference decode.py:152-164)."""

    sr: float                       # sEEG sampling rate (1024 / 2048)
    n_channels: int                 # channels after bad-channel exclusion
    packet_size: int = 32           # amplifier chunk (decode.py:115-116)
    line_noise: int = 50
    frame_len_ms: float = 50.0
    frame_shift_ms: float = 10.0
    model_order: int = 4
    step_size: int = 5
    n_mel: int = 40
    gl_iterations: int = 8
    gl_norm: float = 10.0
    phase_bug: bool = True          # GriffinLim.py:93 exp(angle) quirk
    audio_sr: int = 16000
    iir_block: int = 256
    dtype: Any = jnp.float32

    @property
    def win(self) -> int:
        return framing.frame_size(self.frame_len_ms, self.sr)

    @property
    def prefill(self) -> int:
        return framing.warm_start_prefill(self.frame_len_ms, self.frame_shift_ms, self.sr)

    @property
    def n_stacked(self) -> int:
        return (self.model_order + 1) * self.n_channels


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DecoderParams:
    """Device-resident decoder parameters (everything trained or designed)."""

    filt_op: iir.BlockedIIR                    # combined high-gamma chain (one pass)
    filt_op_pkt: iir.BlockedIIR                # same system at packet-block length
    filt_zi_scale: jnp.ndarray                 # (S,) x0-proportional init part
    filt_s_const: jnp.ndarray                  # (S,) warm-start constant init part
    zf_prefix: jnp.ndarray                     # (prefill,) zero-fill output prefix
    select: jnp.ndarray                        # (150,) int32 feature indices
    lda: lda_mod.LDAParams
    lda_coef_full: jnp.ndarray                 # (n_bins, k, n_stacked): coef scattered to
                                               # full stacked width — select-gather becomes
                                               # part of one matmul
    medians: jnp.ndarray                       # (n_mel, n_intervals)
    gauss_kernel: jnp.ndarray                  # (5,)
    gl_ops: gl.StreamingGLOps
    lowpass_op: iir.BlockedIIR                 # vocoder output low-pass (block=160, online)
    lowpass_op_batch: iir.BlockedIIR           # same filter at block=4096 (offline audio)
    shift_table: jnp.ndarray                   # (period,) int32 frame shifts
    smooth_pos: Any = None                     # (n_mel, 5) int32 reflect positions
    smooth_table: Any = None                   # (n_mel, K^5) f64 exact smoothing
                                               # lattice (bit-exact golden path)

    def tree_flatten(self):
        return (
            (self.filt_op, self.filt_op_pkt, self.filt_zi_scale, self.filt_s_const,
             self.zf_prefix, self.select, self.lda, self.lda_coef_full, self.medians,
             self.gauss_kernel, self.gl_ops, self.lowpass_op, self.lowpass_op_batch,
             self.shift_table, self.smooth_pos, self.smooth_table),
            None,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def build_decoder_params(
    cfg: DecoderConfig,
    lda_params: lda_mod.LDAParams,
    medians: np.ndarray,
    select: np.ndarray,
    exact_smooth: bool = True,
) -> DecoderParams:
    """Design-time construction (host, float64) of all device operators.

    ``exact_smooth=False`` skips the host-precomputed bit-exact smoothing
    lattice (float64 path only; see ``_exact_smooth_fields``) — required when
    the caller substitutes *traced* medians into the returned params (e.g.
    the batched fold runner), where a stale host table would be wrong.
    """
    dt = cfg.dtype
    chain = fd.high_gamma_bank(cfg.sr, cfg.line_noise)
    combined, warm = iir.make_warmstart_chain(chain, cfg.prefill)
    # block length = one schedule period when sane (256 samples @1024 Hz,
    # 512 @2048 Hz); the exact grid yields a periodic table at EVERY rate
    # (ops/framing.shift_table)
    table = framing.shift_table(cfg.frame_len_ms, cfg.frame_shift_ms, cfg.sr)
    Ls = int(table.sum()) if len(table) else 0
    block = Ls if 64 <= Ls <= 2048 else cfg.iir_block
    filt_op = iir.make_blocked_iir(combined, block, dt)
    filt_op_pkt = iir.make_blocked_iir(combined, cfg.packet_size, dt)
    lowpass_ss = iir.sos_to_statespace(fd.gl_output_lowpass_sos(cfg.audio_sr, cfg.frame_shift_ms))
    lda_cast = jax.tree.map(lambda x: x.astype(dt) if jnp.issubdtype(x.dtype, jnp.floating) else x, lda_params)
    sel = np.asarray(select, int)
    coef_full = np.zeros(lda_params.coef.shape[:2] + (cfg.n_stacked,), np.float64)
    coef_full[:, :, sel] = np.asarray(lda_params.coef, np.float64)
    return DecoderParams(
        filt_op=filt_op,
        filt_op_pkt=filt_op_pkt,
        filt_zi_scale=jnp.asarray(warm.zi_scale, dt),
        filt_s_const=jnp.asarray(warm.s_const, dt),
        zf_prefix=jnp.asarray(warm.zf_prefix, dt),
        select=jnp.asarray(sel, jnp.int32),
        lda=lda_cast,
        lda_coef_full=jnp.asarray(coef_full, dt),
        medians=jnp.asarray(medians, dt),
        gauss_kernel=jnp.asarray(smoothing.gaussian_kernel1d(0.5), dt),
        gl_ops=gl.make_streaming_gl_ops(cfg.n_mel, float(cfg.audio_sr), dt),
        lowpass_op=iir.make_blocked_iir(lowpass_ss, 160, dt),
        lowpass_op_batch=iir.make_blocked_iir(lowpass_ss, 4096, dt),
        shift_table=jnp.asarray(table, jnp.int32),
        **(_exact_smooth_fields(medians, dt) if exact_smooth else {}),
    )


def _exact_smooth_fields(medians, dt) -> dict:
    """Bit-exact smoothing lattice for the float64 golden path (see
    ops/smoothing.exact_smooth_table).  Built only when the decode dtype is
    float64 and the lattice is small (default 40 x 9^5 = 18.9 MB); the f32
    accelerator paths keep the fused arithmetic smoothing."""
    med = np.asarray(medians)
    if dt != jnp.float64 or med.shape[1] ** 5 > 100_000:
        return {}
    pos, tbl = smoothing.exact_smooth_table(med)
    return {"smooth_pos": jnp.asarray(pos), "smooth_table": jnp.asarray(tbl)}


# ---------------------------------------------------------------------------
# Shared stages
# ---------------------------------------------------------------------------


def _streaming_filter_chain(params: DecoderParams, cfg: DecoderConfig, eeg: jnp.ndarray, packet: bool = False):
    """Raw eeg (T, C) -> the framed signal (prefill + filtered, (T+prefill, C))
    plus the final combined filter state.

    The whole warm-started chain (FrameBuffer.py:86-98) is one state-space
    pass: initial state is closed-form linear in the first sample
    (ops/iir.make_warmstart_chain), and the last filter's zero-fill output
    prefix is a precomputed channel-independent vector.
    """
    op = params.filt_op_pkt if packet else params.filt_op
    x = eeg.astype(cfg.dtype)
    s0 = params.filt_zi_scale[:, None] * x[0][None, :] + params.filt_s_const[:, None]
    y, sT = iir.iir_blocked(op, x, s0)
    zf = jnp.broadcast_to(params.zf_prefix[:, None], (cfg.prefill, eeg.shape[1]))
    return jnp.concatenate([zf, y], axis=0), sT


def _frames_to_mel(params: DecoderParams, stacked: jnp.ndarray) -> jnp.ndarray:
    """Stacked features (N, 5C) -> dequantized+smoothed logMel frames (N, n_mel).

    LDASynthesis.py:19-28 (select + per-bin predict) and
    Dequantization.py:15-17 (median lookup + gaussian sigma 0.5).

    The feature-select gather is folded into the LDA weights
    (``lda_coef_full``) so prediction is one (N, 5C) @ (5C, bins*k) matmul;
    the median lookup runs as a one-hot contraction — dense contractions,
    no gathers on the hot path.
    """
    scores = jnp.einsum("td,bkd->tbk", stacked, params.lda_coef_full,
                        precision=_HI) + params.lda.intercept[None]
    neg = jnp.asarray(-jnp.inf, scores.dtype)
    scores = jnp.where(params.lda.valid[None], scores, neg)
    slot = jnp.argmax(scores, axis=-1)                      # (N, n_mel) class slots
    if params.smooth_table is not None:
        # bit-exact float64 path: integer labels -> precomputed exactly-
        # rounded lattice; the gather involves no float arithmetic, so the
        # output matches the reference system (scipy gaussian_filter over
        # median lookups) bit-for-bit
        B = params.lda.classes.shape[0]
        label = params.lda.classes.astype(jnp.int32)[jnp.arange(B)[None, :], slot]
        return smoothing.smooth_by_table(label, params.smooth_pos,
                                         params.smooth_table,
                                         params.medians.shape[1])
    # classes are the slot's original label; medians indexed by original label
    onehot_slot = jax.nn.one_hot(slot, params.lda.classes.shape[1], dtype=stacked.dtype)
    label = jnp.einsum("tbk,bk->tb", onehot_slot, params.lda.classes.astype(stacked.dtype))
    onehot_lab = jax.nn.one_hot(label.astype(jnp.int32), params.medians.shape[1], dtype=stacked.dtype)
    deq = jnp.einsum("tbk,bk->tb", onehot_lab, params.medians, precision=_HI)
    return smoothing.gaussian_smooth(deq, params.gauss_kernel)


# ---------------------------------------------------------------------------
# Offline (batch) decode — the replay / evaluation path
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("cfg", "frame_plan"))
def _offline_decode_jit(params: DecoderParams, cfg: DecoderConfig, eeg: jnp.ndarray,
                        ends: jnp.ndarray, rand_init: jnp.ndarray,
                        window_S: jnp.ndarray | None = None, frame_plan=None):
    with jax.named_scope("filter_chain"):
        s_cat, _ = _streaming_filter_chain(params, cfg, eeg)
    with jax.named_scope("framing"):
        if frame_plan is not None:
            Ls, P, origin, n_frames = frame_plan
            F = framing.windowed_logpower_periodic(s_cat, window_S, Ls, n_frames, origin)
        else:
            F = framing.windowed_logpower(s_cat, ends, cfg.win)
    with jax.named_scope("context_lda_dequant_smooth"):
        stacked = framing.stack_context(F, cfg.model_order, cfg.step_size, zero_pad=True)
        mel_frames = _frames_to_mel(params, stacked)
    return mel_frames, vocoder(params, cfg, mel_frames, rand_init)


def vocoder(params: DecoderParams, cfg: DecoderConfig, mel_frames: jnp.ndarray,
            rand_init: jnp.ndarray) -> jnp.ndarray:
    """Batch vocoder: mel frames (N, n_mel) -> int16 audio ((N-1)*160,).
    Griffin-Lim on every 2-frame block at once, then the cross-block
    overlap-add, the output low-pass and the int16 conversion."""
    with jax.named_scope("griffin_lim"):
        re = gl.streaming_gl_blocks(mel_frames, rand_init, params.gl_ops,
                                    cfg.gl_iterations, cfg.phase_bug)
    with jax.named_scope("ola_lowpass_int16"):
        raw = gl.overlap_add_stream(re, params.gl_ops)
        lp, _ = iir.iir_blocked(params.lowpass_op_batch, raw[:, None],
                                jnp.zeros((params.lowpass_op_batch.dim, 1), cfg.dtype))
        return gl.to_int16(lp[:, 0], cfg.gl_norm)


def offline_decode_args(params: DecoderParams, cfg: DecoderConfig, eeg,
                        key: Optional[jax.Array] = None,
                        rand_init: Optional[np.ndarray] = None) -> tuple:
    """Positional arguments of ``_offline_decode_jit`` for one session: the
    host-side frame schedule, Griffin-Lim inits and (for periodic schedules)
    the window-selection matrix.  Also used to lower/compile the program."""
    T = eeg.shape[0]
    ends = framing.streaming_frame_ends(cfg.frame_len_ms, cfg.frame_shift_ms, cfg.sr, T + cfg.prefill)
    n_frames = len(ends)
    if rand_init is None:
        key = key if key is not None else jax.random.PRNGKey(0)
        rand_init = gl.default_rand_init(key, n_frames - 1, 0, cfg.dtype)
    window_S, frame_plan = None, None
    pw = framing.periodic_window_matrix(ends, cfg.win)
    if pw is not None:
        S, Ls, P, origin = pw
        window_S = jnp.asarray(S, cfg.dtype)
        frame_plan = (Ls, P, origin, n_frames)
    return (params, cfg, jnp.asarray(eeg, cfg.dtype), jnp.asarray(ends, jnp.int32),
            jnp.asarray(rand_init, cfg.dtype), window_S, frame_plan)


def offline_decode(params: DecoderParams, cfg: DecoderConfig, eeg: np.ndarray,
                   key: Optional[jax.Array] = None,
                   rand_init: Optional[np.ndarray] = None):
    """Decode a full recorded session.

    eeg: (T, n_channels) raw sEEG (bad channels already excluded).
    Returns (spectrogram (N, n_mel), audio int16 ((N-1)*160,)).
    Equivalent to the reference's file-replay decode (decode.py:71-96).
    """
    return _offline_decode_jit(*offline_decode_args(params, cfg, eeg, key, rand_init))


# ---------------------------------------------------------------------------
# Online step — the closed-loop path
# ---------------------------------------------------------------------------


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class OnlineCarry:
    """All streaming state of the decoder, donated across steps."""

    filt_state: jnp.ndarray               # combined chain state (S, C)
    started: jnp.ndarray                  # bool — first packet initializes zi scaling
    hist: jnp.ndarray                     # (win, C) last framed-signal samples
    sample_count: jnp.ndarray             # int32, includes prefill
    frame_k: jnp.ndarray                  # int32 frames emitted so far
    next_e: jnp.ndarray                   # int32 next frame end position
    stack_ring: jnp.ndarray               # (stack_len, C) chronological
    prev_mel: jnp.ndarray                 # (n_mel,)
    ola_acc: jnp.ndarray                  # (2, 160) pending OLA contributions
    ola_wacc: jnp.ndarray                 # (2, 160)
    lowpass_state: jnp.ndarray            # (S_lp, 1)

    def tree_flatten(self):
        return (
            (self.filt_state, self.started, self.hist, self.sample_count, self.frame_k,
             self.next_e, self.stack_ring, self.prev_mel, self.ola_acc, self.ola_wacc,
             self.lowpass_state),
            None,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def init_online_carry(params: DecoderParams, cfg: DecoderConfig) -> OnlineCarry:
    dt = cfg.dtype
    C = cfg.n_channels
    win = cfg.win
    stack_len = cfg.model_order * cfg.step_size + 1
    # The last filter's prefill zero-response forms the initial history (the
    # frame buffer's zero-fill, FrameBuffer.py:94-98); the x0-dependent part
    # of the chain state is applied on the first packet.
    zf = jnp.broadcast_to(params.zf_prefix[:, None], (cfg.prefill, C))
    hist = jnp.zeros((win, C), dt).at[win - cfg.prefill :, :].set(zf)
    return OnlineCarry(
        filt_state=jnp.zeros((params.filt_op_pkt.dim, C), dt),
        started=jnp.asarray(False),
        hist=hist,
        sample_count=jnp.asarray(cfg.prefill, jnp.int32),
        frame_k=jnp.asarray(0, jnp.int32),
        next_e=jnp.asarray(win, jnp.int32),
        stack_ring=jnp.zeros((stack_len, C), dt),
        prev_mel=jnp.zeros((cfg.n_mel,), dt),
        ola_acc=jnp.zeros((2, gl.HOP), dt),
        ola_wacc=jnp.zeros((2, gl.HOP), dt),
        lowpass_state=jnp.zeros((params.lowpass_op.dim, 1), dt),
    )


def make_online_step(params: DecoderParams, cfg: DecoderConfig, key: jax.Array):
    """Returns a jitted ``step(carry, packet) -> (carry, outputs)``.

    packet: (packet_size, n_channels) raw sEEG chunk.
    outputs: dict with 'spec' (4, n_mel), 'spec_valid' (4,),
             'audio' (4, 160) int16, 'audio_valid' (4,).
    """
    dt = cfg.dtype
    win = cfg.win
    P = cfg.packet_size
    period = int(params.shift_table.shape[0])
    if period == 0:
        raise ValueError("decoder params carry an empty shift table; rebuild "
                         "them with build_decoder_params (the exact grid is "
                         "periodic at every rate, see ops.framing.shift_table)")
    n_slots = max_frames_per_packet(P, np.asarray(params.shift_table))
    w_ola = params.gl_ops.ola_window
    taps = np.arange(0, cfg.model_order * cfg.step_size + 1, cfg.step_size)

    def step(carry: OnlineCarry, packet: jnp.ndarray):
        x = packet.astype(dt)
        # --- combined filter chain (closed-form init on the first packet) ---
        s_init = params.filt_zi_scale[:, None] * x[0][None, :] + params.filt_s_const[:, None]
        s0 = jnp.where(carry.started, carry.filt_state, s_init)
        y, s_new = iir.iir_blocked(params.filt_op_pkt, x, s0)

        buf = jnp.concatenate([carry.hist, y], axis=0)  # (win + P, C)
        cnt = carry.sample_count

        frame_k0 = carry.frame_k
        frame_k = carry.frame_k
        next_e = carry.next_e
        stack_ring = carry.stack_ring
        prev_mel = carry.prev_mel
        ola_acc, ola_wacc = carry.ola_acc, carry.ola_wacc
        lp_state = carry.lowpass_state

        # --- phase 1 (sequential, cheap): framing + feature stack per slot ---
        stacked_rows = []
        valids = []
        for slot in range(n_slots):
            valid = next_e <= cnt + P
            # window [next_e - win, next_e): buf[p] holds sample index (cnt - win) + p
            start = jnp.clip(next_e - cnt, 0, P)
            window = jax.lax.dynamic_slice(buf, (start, jnp.zeros((), start.dtype)), (win, buf.shape[1]))
            f_row = jnp.log(jnp.sum(window * window, axis=0) + jnp.asarray(0.01, dt))
            new_ring = jnp.concatenate([stack_ring[1:], f_row[None, :]], axis=0)
            stack_ring = jnp.where(valid, new_ring, stack_ring)
            stacked_rows.append(stack_ring[taps].T.reshape(-1))  # channel-major
            valids.append(valid)
            next_e = jnp.where(valid, next_e + params.shift_table[frame_k % period], next_e)
            frame_k = jnp.where(valid, frame_k + 1, frame_k)
        stacked_all = jnp.stack(stacked_rows)          # (S, 5C)
        spec_valid = jnp.stack(valids)                 # (S,) prefix-monotone

        # --- phase 2 (batched): LDA + dequantization for all slots at once ---
        mels = _frames_to_mel(params, stacked_all)     # (S, n_mel)
        out_spec = mels

        # --- phase 3 (batched vocoder): blocks from consecutive mel pairs ---
        n_valid = jnp.sum(spec_valid.astype(jnp.int32))
        mel_seq = jnp.concatenate([prev_mel[None], mels], axis=0)  # (S+1, n_mel)
        block_ids = frame_k0 + jnp.arange(n_slots) - 1
        has_block = jnp.logical_and(spec_valid, block_ids >= 0)
        rand = jax.vmap(
            lambda i: jax.random.uniform(jax.random.fold_in(key, jnp.maximum(i, 0)), (gl.BLOCK_SAMPLES,), dt)
        )(block_ids)
        re_all = gl.streaming_gl_blocks(mel_seq, rand, params.gl_ops,
                                        cfg.gl_iterations, cfg.phase_bug)  # (S, 480)

        # --- phase 4 (sequential, cheap): OLA + low-pass per emitted chunk ---
        out_audio = jnp.zeros((n_slots, gl.HOP), jnp.int16)
        for slot in range(n_slots):
            re = re_all[slot]
            hb = has_block[slot]
            acc = ola_acc[0] + re[: gl.HOP]
            wsum = ola_wacc[0] + w_ola[: gl.HOP]
            chunk = jnp.where(wsum != 0, acc / jnp.where(wsum != 0, wsum, 1.0), acc)
            lp, lp_state_new = iir.iir_blocked(params.lowpass_op, chunk[:, None], lp_state)
            out_audio = out_audio.at[slot].set(gl.to_int16(lp[:, 0], cfg.gl_norm))
            new_acc = jnp.stack([ola_acc[1] + re[gl.HOP : 2 * gl.HOP], re[2 * gl.HOP :]])
            new_wacc = jnp.stack([ola_wacc[1] + w_ola[gl.HOP : 2 * gl.HOP], w_ola[2 * gl.HOP :]])
            ola_acc = jnp.where(hb, new_acc, ola_acc)
            ola_wacc = jnp.where(hb, new_wacc, ola_wacc)
            lp_state = jnp.where(hb, lp_state_new, lp_state)
        audio_valid = has_block
        prev_mel = jnp.where(n_valid > 0, mel_seq[n_valid], prev_mel)

        new_carry = OnlineCarry(
            filt_state=s_new,
            started=jnp.asarray(True),
            hist=buf[-win:],
            sample_count=cnt + P,
            frame_k=frame_k,
            next_e=next_e,
            stack_ring=stack_ring,
            prev_mel=prev_mel,
            ola_acc=ola_acc,
            ola_wacc=ola_wacc,
            lowpass_state=lp_state,
        )
        outputs = {"spec": out_spec, "spec_valid": spec_valid,
                   "audio": out_audio, "audio_valid": audio_valid}
        return new_carry, outputs

    return jax.jit(step, donate_argnums=(0,))


def make_online_multi_step(params: DecoderParams, cfg: DecoderConfig, key: jax.Array,
                           k_steps: int, step=None):
    """K chained online steps as ONE jitted dispatch.

    ``multi(carry, packets (K, packet_size, n_channels)) -> (carry, outputs)``
    where outputs are the per-step dicts stacked on a leading K axis
    (``lax.scan`` over the packet axis of the exact same step body), so the
    decoded stream is bit-identical to K sequential ``make_online_step``
    dispatches.  Use where per-dispatch overhead dominates the step itself
    and the persistent ``io_callback`` loop is not used: overhead amortizes
    ~K x at the price of buffering
    K packets — (K-1) packet periods of added playout latency (the
    reference's own audio queue already tolerates ~4 packets / 128 ms,
    JackAudioSink.py:111-118).
    """
    # reuse the caller's single-step program when given: the K=1 and K>1
    # paths then share the exact same step body by construction, not by
    # convention (OnlineDecoder passes self.step)
    if step is None:
        step = make_online_step(params, cfg, key)
    raw = step.__wrapped__

    def multi(carry: OnlineCarry, packets: jnp.ndarray):
        return jax.lax.scan(raw, carry, packets)

    return jax.jit(multi, donate_argnums=(0,))
