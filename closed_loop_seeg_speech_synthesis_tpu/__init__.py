"""Closed-loop sEEG speech synthesis framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
cognitive-systems-lab/closed-loop-seeg-speech-synthesis (the code behind
"Real-time Synthesis of Imagined Speech Processes from Minimally Invasive
Recordings of Neural Activity"): a closed-loop brain-computer interface that
streams stereotactic-EEG, extracts high-gamma band-power features every 10 ms,
predicts quantized logMel coefficients with 40 per-bin LDA classifiers and
reconstructs audio with a streaming Griffin-Lim vocoder.

Architecture (batched programs, not a port of the node graph):

* The reference's push-callback node DAG (``livenodes/Node.py``) is replaced
  by a single jitted frame program: ``runtime.pipeline`` builds one pure
  ``step(carry, packet)`` function whose carry holds every piece of streaming
  state (IIR filter states, feature stack, Griffin-Lim OLA tails, schedules).
* Offline replay (``decode.py`` file mode in the reference) is a fully
  batched pipeline: blocked state-space IIR as matmuls, framing as sliding
  window reductions, LDA as one einsum, Griffin-Lim as batched DFT matmuls.
  The reference output is chunk-size invariant, so batch == stream exactly.
* Multi-chip scaling (channel sharding / batched evaluation fan-out) lives in
  ``parallel`` using ``jax.sharding`` meshes; no NCCL-style code.

Subpackages:
  ops       numerics kernels (IIR, framing, mel, STFT, Griffin-Lim, quantization)
  models    LDA fit/predict, Spearman feature selection
  runtime   decoder/trainer pipelines, online host loop, params store
  parallel  device-mesh sharding for replay/eval/training
  io        HDF5/XDF loaders, config system, session artifacts
  eval      metrics, VAD, DTW, experiments 1-4, figures
  cli       train / decode / dev_streamer entry points
"""

__version__ = "0.1.0"
