"""Online closed-loop decoding: the host event loop around the device step.

Replaces the reference's feeder-process DAG execution
(decode.py:99-149 + lsl_socket.py:54-70): a stream inlet is re-blocked into
fixed ``packet_size`` packets, each packet makes exactly ONE device call
(the jitted ``pipeline.make_online_step`` with donated carry), decoded
spectrogram frames and int16 audio chunks come back, audio is handed to the
sink through the bounded-drop queue.  Per-packet latency is traced for the
p99-under-10ms closed-loop budget (BASELINE.md).
"""

from __future__ import annotations

import functools
import logging
import threading

import jax
import jax.numpy as jnp
import numpy as np

from . import pipeline
from .audio import BufferSink
from .streams import StreamInlet
from .tracing import StageTracer

logger = logging.getLogger("runtime.online")


class PacketRebuffer:
    """Accumulates arbitrary inlet chunks into exact packet_size packets
    (the amplifier nominally sends whole packets; LSL may split/merge)."""

    def __init__(self, packet_size: int, n_channels: int):
        self.packet_size = packet_size
        # preallocated: no per-chunk np.concatenate on the 10 ms hot path
        self._buf = np.zeros((max(8 * packet_size, 1024), n_channels), np.float32)
        self._n = 0

    def push(self, chunk: np.ndarray):
        chunk = np.asarray(chunk, np.float32)
        if chunk.size:
            need = self._n + len(chunk)
            if need > len(self._buf):  # oversized burst: grow once, stays rare
                grown = np.zeros((max(2 * len(self._buf), need), self._buf.shape[1]),
                                 np.float32)
                grown[: self._n] = self._buf[: self._n]
                self._buf = grown
            self._buf[self._n : need] = chunk
            self._n = need
        out = []
        ps = self.packet_size
        k = 0
        while self._n - k >= ps:
            out.append(self._buf[k : k + ps].copy())
            k += ps
        if k:
            rem = self._n - k
            if rem:
                self._buf[:rem] = self._buf[k : self._n]
            self._n = rem
        return out


def _pump_stream(inlet: StreamInlet, rebuf: PacketRebuffer, packet_size: int,
                 on_packet, stop_event, max_packets, store_first_timestamp_to,
                 idle_timeout: float) -> int:
    """Shared inlet loop of both online decoders: pull chunks, re-block into
    packets, invoke ``on_packet`` per packet.  The ``max_packets`` cutoff is
    chunk-granular (the whole rebuffered chunk is processed before checking)
    so both dispatch modes decode identical packet sets from the same stream.
    Returns the packet count."""
    first_ts = None
    idle = 0.0
    n = 0
    while not (stop_event and stop_event.is_set()):
        try:
            chunk, ts = inlet.pull_chunk(max_samples=max(packet_size, 64), timeout=0.25)
        except ConnectionError:
            # stream producer went away (amplifier restart): stop cleanly
            # with everything decoded so far (lsl_socket.py:44-49 policy)
            logger.warning("stream closed; stopping decode with %d packets", n)
            break
        if chunk.shape[0] == 0:
            idle += 0.25
            if max_packets is not None and idle > idle_timeout:
                break
            continue
        idle = 0.0
        if first_ts is None and ts:
            first_ts = ts
            if store_first_timestamp_to:
                np.save(store_first_timestamp_to, np.asarray(first_ts))
        for packet in rebuf.push(chunk):
            on_packet(packet)
            n += 1
        if max_packets is not None and n >= max_packets:
            break
    return n


class OnlineDecoder:
    """Per-packet device decoding.

    ``pipelined=True`` enables double-buffered host pipelining: each packet's
    ``step`` is dispatched asynchronously and its outputs are materialized
    when the NEXT packet arrives, so device compute and device->host readback
    overlap the inter-packet interval instead of blocking the loop (the
    host-side twin of the amplifier's own 31 ms cadence).  Costs one packet
    period of added playout latency; leave off when device latency per step
    is far below the packet cadence (a locally attached chip).

    ``chunk_steps=K`` (K > 1) buffers K packets and decodes them in ONE
    device dispatch (``pipeline.make_online_multi_step``), amortizing
    per-dispatch overhead ~K x.  Decoded output is bit-identical to K=1; the
    price is (K-1) packet periods of added playout latency — with the
    Micromed cadence (31.25 ms) K=4 stays within the reference's own ~128 ms
    audio-queue tolerance (JackAudioSink.py:111-118).  Composes with
    ``pipelined``.  The stream tail (< K packets at stop) drains through the
    single-step program."""

    def __init__(self, cfg: pipeline.DecoderConfig, dec_params, bad_channels=(),
                 key=None, sink=None, tracer=None, pipelined: bool = False,
                 chunk_steps: int = 1):
        self.cfg = cfg
        self.params = dec_params
        self.bad_channels = np.asarray(bad_channels, int)
        self.key = key if key is not None else jax.random.PRNGKey(0)
        self.sink = sink or BufferSink()
        self.tracer = tracer or StageTracer(enabled=True)
        self.step = pipeline.make_online_step(dec_params, cfg, self.key)
        self.carry = pipeline.init_online_carry(dec_params, cfg)
        self.pipelined = pipelined
        self.chunk_steps = int(chunk_steps)
        if self.chunk_steps < 1:
            raise ValueError("chunk_steps must be >= 1")
        self.multi_step = (pipeline.make_online_multi_step(dec_params, cfg, self.key,
                                                           self.chunk_steps,
                                                           step=self.step)
                           if self.chunk_steps > 1 else None)
        self._chunk_buf = []   # packets awaiting a full K-chunk dispatch
        self._pending = None   # un-materialized device outputs of the last step
        self.spec_frames = []
        self.audio_chunks = []
        self.received = []
        self._warm = False

    def _select(self, packet: np.ndarray) -> np.ndarray:
        if len(self.bad_channels):
            return np.delete(packet, self.bad_channels, axis=1)
        return packet

    def warmup(self):
        """Compile the step program(s) outside the realtime path."""
        dummy = jnp.zeros((self.cfg.packet_size, self.cfg.n_channels), self.cfg.dtype)
        carry, _ = self.step(self.carry, dummy)
        jax.block_until_ready(carry.sample_count)
        self.carry = pipeline.init_online_carry(self.params, self.cfg)
        if self.multi_step is not None:
            dummies = jnp.zeros((self.chunk_steps, self.cfg.packet_size,
                                 self.cfg.n_channels), self.cfg.dtype)
            carry, _ = self.multi_step(self.carry, dummies)
            jax.block_until_ready(carry.sample_count)
            self.carry = pipeline.init_online_carry(self.params, self.cfg)
        # re-init: warmup must not advance state
        self._warm = True

    def reset(self):
        """Reset all streaming state — the equivalent of the reference's
        cross-process ``FrameBuffer.reset_buffer()`` flag for feeder restarts
        (FrameBuffer.py:52-57): call when the input process/stream changed."""
        self.carry = pipeline.init_online_carry(self.params, self.cfg)
        self._pending = None
        self._chunk_buf = []
        self.spec_frames, self.audio_chunks, self.received = [], [], []

    def _emit(self, out):
        """Materialize step outputs (single or K-stacked) and hand audio to
        the sink.  Leading axes beyond the slot axis are flattened — scan
        stacks steps in order and slots are ordered within a step, so the
        flattened valid-masked sequence is the decoded stream."""
        spec = np.asarray(out["spec"])
        sv = np.asarray(out["spec_valid"]).reshape(-1)
        spec = spec.reshape(-1, spec.shape[-1])
        audio = np.asarray(out["audio"])
        av = np.asarray(out["audio_valid"]).reshape(-1)
        audio = audio.reshape(-1, audio.shape[-1])
        self.tracer.mark("step_done")
        for i in np.nonzero(sv)[0]:
            self.spec_frames.append(spec[i])
        for i in np.nonzero(av)[0]:
            self.audio_chunks.append(audio[i])
            self.sink.write(audio[i])
        self.tracer.mark("audio_out")

    def _dispatch(self, out):
        if self.pipelined:
            # async dispatch: emit the PREVIOUS outputs (already computed
            # during the inter-packet interval), leave these on device
            prev, self._pending = self._pending, out
            if prev is not None:
                self._emit(prev)
        else:
            self._emit(out)

    def process_packet(self, packet: np.ndarray):
        """One fixed-size raw packet (packet_size, all_channels) -> outputs."""
        if not self._warm:
            self.warmup()
        self.received.append(packet)
        sel = self._select(packet)
        if self.multi_step is not None:
            self._chunk_buf.append(sel)
            if len(self._chunk_buf) < self.chunk_steps:
                return
            pkts = np.stack(self._chunk_buf)
            self._chunk_buf = []
            self.tracer.mark("packet_in")
            self.carry, out = self.multi_step(self.carry, jnp.asarray(pkts, self.cfg.dtype))
            self._dispatch(out)
            return
        self.tracer.mark("packet_in")
        self.carry, out = self.step(self.carry, jnp.asarray(sel, self.cfg.dtype))
        self._dispatch(out)

    def flush(self):
        """Drain the pipelined/chunked tail (call at stream end)."""
        if self._pending is not None:
            out, self._pending = self._pending, None
            self._emit(out)
        # tail packets short of a full K-chunk: single-step program
        for sel in self._chunk_buf:
            self.carry, out = self.step(self.carry, jnp.asarray(sel, self.cfg.dtype))
            self._emit(out)
        self._chunk_buf = []

    def run_stream(self, stream, stop_event: threading.Event | None = None,
                   max_packets: int | None = None, store_first_timestamp_to: str | None = None,
                   backend=None, idle_timeout: float = 30.0):
        """Pull from a live stream until stopped (decode.py:99-149).

        ``stream``: a StreamInlet or a stream name to resolve."""
        if not self._warm:
            self.warmup()
        inlet = StreamInlet(stream, backend=backend) if isinstance(stream, str) else stream
        rebuf = PacketRebuffer(self.cfg.packet_size, inlet.channels)
        _pump_stream(inlet, rebuf, self.cfg.packet_size, self.process_packet,
                     stop_event, max_packets, store_first_timestamp_to, idle_timeout)
        return self.results()

    def results(self):
        self.flush()
        spectrogram = np.asarray(self.spec_frames) if self.spec_frames else np.zeros((0, self.cfg.n_mel))
        audio = np.concatenate(self.audio_chunks) if self.audio_chunks else np.zeros(0, np.int16)
        received = np.vstack(self.received) if self.received else np.zeros((0, 0))
        return spectrogram, audio, received

    def latency_report(self):
        p = self.tracer.percentiles("packet_in", "step_done")
        logger.info("per-packet device latency: p50=%.3fms p95=%.3fms p99=%.3fms",
                    p[50] * 1e3, p[95] * 1e3, p[99] * 1e3)
        return p


class PersistentOnlineDecoder(OnlineDecoder):
    """Whole-session decoding as ONE device dispatch.

    A ``lax.while_loop`` runs the online step on device; packets enter and
    decoded outputs leave through ordered ``io_callback``s — the host touches
    the loop only at the two I/O edges (sEEG ingest, audio emit), the
    BASELINE.md design stance.  Per-packet dispatch overhead (program launch,
    argument marshalling, result future setup) disappears from the hot path;
    what remains per packet is the callback transfer itself.

    Feed with ``feed_packet``/``feed_stop`` (from another thread, or enqueue
    the whole session beforehand — the queue is unbounded by default) and
    execute with ``run_until_stopped``; or use ``run_stream``.  Outputs are
    bit-identical to ``OnlineDecoder`` on the same backend: the loop body is
    the same un-jitted step function.
    """

    _STOP = 0
    _DATA = 1

    def __init__(self, cfg: pipeline.DecoderConfig, dec_params, bad_channels=(),
                 key=None, sink=None, tracer=None, queue_size: int = 0):
        import queue as queue_mod

        super().__init__(cfg, dec_params, bad_channels=bad_channels, key=key,
                         sink=sink, tracer=tracer)
        self._queue = queue_mod.Queue(maxsize=queue_size)
        # guards the warmup queue swap against concurrent feed_packet calls
        # (packets fed mid-warmup must land on the real queue, not the
        # discarded warmup sentinel queue)
        self._queue_lock = threading.Lock()
        self._build_loop()

    def _build_loop(self):
        from jax.experimental import io_callback

        cfg = self.cfg
        P, C = cfg.packet_size, cfg.n_channels
        raw_step = self.step.__wrapped__
        np_dt = np.dtype(jnp.zeros((), cfg.dtype).dtype)

        def host_pull():
            pkt, flag = self._queue.get()
            if flag == self._DATA:
                self.tracer.mark("packet_in")
            return np.asarray(pkt, np_dt), np.int32(flag)

        def host_emit(spec, sv, audio, av, flag):
            if int(flag) != self._DATA:
                return
            self.tracer.mark("step_done")
            spec, audio = np.asarray(spec), np.asarray(audio)
            for i in np.nonzero(np.asarray(sv))[0]:
                self.spec_frames.append(spec[i])
            for i in np.nonzero(np.asarray(av))[0]:
                self.audio_chunks.append(audio[i])
                self.sink.write(audio[i])
            self.tracer.mark("audio_out")

        pull_shape = (jax.ShapeDtypeStruct((P, C), cfg.dtype),
                      jax.ShapeDtypeStruct((), jnp.int32))

        def body(state):
            carry, _ = state
            packet, flag = io_callback(host_pull, pull_shape, ordered=True)
            new_carry, out = raw_step(carry, packet)
            is_data = flag == self._DATA
            new_carry = jax.tree_util.tree_map(
                lambda a, b: jnp.where(is_data, a, b), new_carry, carry)
            io_callback(host_emit, None, out["spec"], out["spec_valid"],
                        out["audio"], out["audio_valid"], flag, ordered=True)
            return new_carry, flag

        def cond(state):
            return state[1] == self._DATA

        # donate the carry: the loop rewrites every carry buffer in place
        # instead of allocating a second copy per dispatch (same policy as
        # the per-packet step's donate_argnums)
        @functools.partial(jax.jit, donate_argnums=0)
        def run(carry):
            carry, _ = jax.lax.while_loop(cond, body, (carry, jnp.int32(self._DATA)))
            return carry

        self._run = run

    # -- feeding -----------------------------------------------------------
    def feed_packet(self, packet: np.ndarray):
        """Enqueue one fixed-size raw packet (packet_size, all_channels)."""
        self.received.append(packet)
        # hold the lock only to read the live queue reference (warmup swaps
        # it); put() OUTSIDE the lock — a bounded queue's blocking put while
        # holding the lock would deadlock warmup/feed_stop against a feeder
        with self._queue_lock:
            q = self._queue
        q.put((self._select(packet), self._DATA))

    def feed_stop(self):
        with self._queue_lock:
            q = self._queue
        q.put((np.zeros((self.cfg.packet_size, self.cfg.n_channels),
                        np.float32), self._STOP))

    def process_packet(self, packet: np.ndarray):
        raise NotImplementedError(
            "PersistentOnlineDecoder decodes inside one device dispatch: use "
            "feed_packet()/feed_stop() + run_until_stopped() (or run_stream).")

    # -- running -----------------------------------------------------------
    def warmup(self):
        """Compile the loop program outside the realtime path.

        Runs one stop-sentinel iteration against a private queue, so packets
        already enqueued stay untouched; the warmup carry is discarded, so
        streaming state is not advanced and nothing is emitted.  The queue
        lock is held for the duration, so concurrent ``feed_packet`` /
        ``feed_stop`` callers block until the real queue is restored instead
        of silently losing packets to the discarded warmup queue."""
        import queue as queue_mod

        with self._queue_lock:
            real, tmp = self._queue, queue_mod.Queue()
            tmp.put((np.zeros((self.cfg.packet_size, self.cfg.n_channels),
                              np.float32), self._STOP))
            self._queue = tmp
            try:
                # _run donates its argument; warm up on a copy so the live
                # carry's buffers stay valid for the real session
                scratch = jax.tree_util.tree_map(jnp.copy, self.carry)
                jax.block_until_ready(self._run(scratch))
            finally:
                self._queue = real
        self._warm = True

    def run_until_stopped(self):
        """Execute the device loop; blocks until a stop sentinel is consumed.
        Call ``feed_packet`` / ``feed_stop`` from another thread, or enqueue
        everything beforehand (replay; the queue is unbounded by default)."""
        self.carry = self._run(self.carry)
        jax.block_until_ready(self.carry.sample_count)
        return self.results()

    def reset(self):
        super().reset()
        # stale queued packets must not leak into the next session
        while not self._queue.empty():
            try:
                self._queue.get_nowait()
            except Exception:
                break

    def run_stream(self, stream, stop_event: threading.Event | None = None,
                   max_packets: int | None = None,
                   store_first_timestamp_to: str | None = None,
                   backend=None, idle_timeout: float = 30.0):
        """Pull from a live stream until stopped — persistent-loop twin of
        ``OnlineDecoder.run_stream``: a feeder thread re-blocks inlet chunks
        into packets and enqueues them; the device loop runs in this thread."""
        if not self._warm:
            self.warmup()
        inlet = StreamInlet(stream, backend=backend) if isinstance(stream, str) else stream
        rebuf = PacketRebuffer(self.cfg.packet_size, inlet.channels)
        feeder_error = []

        def feeder():
            try:
                _pump_stream(inlet, rebuf, self.cfg.packet_size, self.feed_packet,
                             stop_event, max_packets, store_first_timestamp_to,
                             idle_timeout)
            except BaseException as e:  # surface in the caller after join
                feeder_error.append(e)
            finally:
                # ALWAYS release the device loop — a feeder crash must not
                # leave run_until_stopped blocked inside the dispatch
                self.feed_stop()

        t = threading.Thread(target=feeder, daemon=True)
        t.start()
        out = self.run_until_stopped()
        t.join()
        if feeder_error:
            raise feeder_error[0]
        return out


def read_markers(run_dir: str, stream_name: str = "SingleWordsMarkerStream",
                 stop_event=None, backend=None, timeout: float = 10.0):
    """Marker logger (twin of local/marker.py): appends
    ``walltime,stream_timestamp,label`` rows to markers.csv, flushing each
    sample; run in a side process/thread to stay off the decode hot path
    (decode.py:128-137)."""
    import datetime
    import os

    try:
        inlet = StreamInlet(stream_name, timeout=timeout, backend=backend)
    except TimeoutError:
        logger.warning("marker stream %r not found; marker logging disabled", stream_name)
        return
    path = os.path.join(run_dir, "markers.csv")
    # truncate like the reference (local/marker.py opens "w"): reruns into the
    # same run_dir must not mix stale markers into DecodingRun trial starts
    with open(path, "w") as f:
        while not (stop_event and stop_event.is_set()):
            try:
                label, ts = inlet.pull_string(timeout=0.25)
            except ConnectionError:
                logger.info("marker stream closed; marker logging done")
                break
            if label is None:
                continue
            wall = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S.%f")
            f.write(f"{wall},{ts},{label}\n")
            f.flush()
