"""Multi-host (DCN) data-parallel evaluation fan-out.

The reference's heaviest workloads — exp1's 10 folds x 100 chance runs,
exp2's chance decodes, multi-session sweeps — are embarrassingly parallel
over sessions (it serializes them in a ThreadPool(1), exp1.py:111,142).
Across hosts the only communication is the data-parallel sharding itself:
sessions shard over a ``data`` axis that rides DCN, channels shard over
``model`` inside each host's chips (ICI), exactly the layout SURVEY.md §2
prescribes.  No gradients, no cross-host reductions on the decode path —
each host computes its addressable shard of the output batch.

Dry-runnable without hardware: ``dryrun_dcn`` spawns N real processes, each
exposing a virtual CPU device set, connects them through
``jax.distributed.initialize`` and runs the sharded replay over the global
mesh (the driver-style validation of the multi-host path).
"""

from __future__ import annotations

import os
import subprocess
import sys


def initialize(coordinator_address: str, num_processes: int, process_id: int):
    """Connect this process to the jax.distributed coordination service.

    Call before any jax computation.  The three arguments are explicit
    (nothing in the environment announces a cluster), so CPU dryruns and
    heterogeneous lab hosts work the same way.
    """
    import jax

    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh(model_axis: int = 1):
    """(data, model) mesh over ALL processes' devices, data axis outermost so
    consecutive data shards live on one host (DCN only crosses between data
    groups, never inside a channel shard)."""
    import jax
    from jax.sharding import Mesh
    import numpy as np

    devs = jax.devices()  # global, ordered process-major
    n = len(devs)
    if n % model_axis != 0:
        raise ValueError(f"model_axis={model_axis} does not divide {n} devices")
    grid = np.asarray(devs).reshape(n // model_axis, model_axis)
    return Mesh(grid, ("data", "model"))


def distributed_replay(mesh, decode_jit, cfg, params, local_eeg, ends, local_rand):
    """Data-parallel offline decode of a globally sharded session batch.

    ``local_eeg`` (B_local, T, C) / ``local_rand`` (B_local, ...) are THIS
    process's sessions; the global batch is their process-major
    concatenation.  Returns this process's decoded shard
    (spec (B_local, N, n_mel), audio (B_local, L)) as host numpy arrays.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    eeg_sh = NamedSharding(mesh, P("data", None, "model"))
    rand_sh = NamedSharding(mesh, P("data"))

    eeg_g = jax.make_array_from_process_local_data(eeg_sh, np.asarray(local_eeg))
    rand_g = jax.make_array_from_process_local_data(rand_sh, np.asarray(local_rand))

    def replay(p, eeg_batch, e, rand_batch):
        return jax.vmap(lambda x, r: decode_jit(p, cfg, x, e, r))(eeg_batch, rand_batch)

    out_sh = NamedSharding(mesh, P("data"))
    replay_jit = jax.jit(replay, in_shardings=(None, eeg_sh, None, rand_sh),
                         out_shardings=(out_sh, out_sh))
    spec_g, audio_g = replay_jit(params, eeg_g, jnp.asarray(ends, jnp.int32), rand_g)

    def local_part(garr):
        shards = sorted(garr.addressable_shards, key=lambda s: s.index[0].start or 0)
        return np.concatenate([np.asarray(s.data) for s in shards], axis=0)

    return local_part(spec_g), local_part(audio_g)


def distributed_train(mesh, cfg, local_eeg, local_audio):
    """Fit ONE model from a globally sharded multi-session training batch.

    The reference trains on the concatenation of all recording files in one
    process (train.py:284-311).  Here sessions shard over the ``data`` axis
    (across hosts, riding DCN) and channels over ``model`` (ICI); the pooled
    Gram/covariance reductions inside the batched LDA fit are the only
    cross-host collectives, inserted by XLA from the sharding annotations.

    ``local_eeg`` (B_local, T, C) / ``local_audio`` (B_local, Ta) are THIS
    process's sessions; the global batch is their process-major
    concatenation.  Returns (LDAParams, select, medians) as host arrays —
    identical on every process (outputs are replicated).
    """
    import jax
    import numpy as np

    from . import sharded

    local_eeg = np.asarray(local_eeg)
    local_audio = np.asarray(local_audio)
    _, T, C = local_eeg.shape
    step, (eeg_sh, audio_sh) = sharded.make_sharded_train_step(
        mesh, cfg, T, local_audio.shape[1], C)
    eeg_g = jax.make_array_from_process_local_data(eeg_sh, local_eeg)
    audio_g = jax.make_array_from_process_local_data(audio_sh, local_audio)
    params, select, medians = step(eeg_g, audio_g)
    return (jax.tree_util.tree_map(lambda a: np.asarray(a), params),
            np.asarray(select), np.asarray(medians))


# --------------------------------------------------------------------------
# CPU multi-process dryrun (driver-style validation without a pod)
# --------------------------------------------------------------------------

_WORKER = r"""
import os, sys
import numpy as np

n_proc = int(sys.argv[1]); pid = int(sys.argv[2]); port = sys.argv[3]
n_local = int(sys.argv[4]); out_path = sys.argv[5]

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + f" --xla_force_host_platform_device_count={n_local}"
                           + " --xla_cpu_collective_call_terminate_timeout_seconds=1200"
                           + " --xla_cpu_collective_timeout_seconds=1200").strip()
import jax
jax.config.update("jax_platforms", "cpu")
from closed_loop_seeg_speech_synthesis_tpu.parallel import distributed as dist
dist.initialize(f"localhost:{port}", n_proc, pid)

import jax.numpy as jnp
from closed_loop_seeg_speech_synthesis_tpu.models import lda as lda_mod
from closed_loop_seeg_speech_synthesis_tpu.ops import framing, griffinlim as gl
from closed_loop_seeg_speech_synthesis_tpu.runtime import pipeline

assert len(jax.devices()) == n_proc * n_local, (len(jax.devices()), n_proc, n_local)

rng = np.random.RandomState(0)
C, T, sr = 8, 2048, 1024.0
cfg = pipeline.DecoderConfig(sr=sr, n_channels=C, dtype=jnp.float32)
lda = lda_mod.LDAParams(
    coef=jnp.asarray(rng.randn(40, 9, 20) * 0.1, jnp.float32),
    intercept=jnp.asarray(rng.randn(40, 9), jnp.float32),
    classes=jnp.broadcast_to(jnp.arange(9, dtype=jnp.int32), (40, 9)),
    valid=jnp.ones((40, 9), bool))
medians = np.sort(rng.randn(40, 9), axis=1)
params = pipeline.build_decoder_params(cfg, lda, medians, rng.permutation(5 * C)[:20])
ends = framing.streaming_frame_ends(50, 10, sr, T + cfg.prefill)
nf = len(ends)

B_global = 2 * n_proc * n_local           # 2 sessions per device
B_local = B_global // n_proc
eeg_all = rng.randn(B_global, T, C).astype(np.float32)   # same seed everywhere
rand_all = np.stack([np.asarray(gl.default_rand_init(jax.random.PRNGKey(i), nf - 1, 0, jnp.float32))
                     for i in range(B_global)])
lo, hi = pid * B_local, (pid + 1) * B_local

mesh = dist.global_mesh(model_axis=1)
spec, audio = dist.distributed_replay(mesh, pipeline._offline_decode_jit, cfg, params,
                                      eeg_all[lo:hi], ends, rand_all[lo:hi])
assert spec.shape == (B_local, nf, 40), spec.shape
np.save(out_path, spec)
print(f"dcn worker {pid}: ok, spec shard {spec.shape}")
"""


_TRAIN_WORKER = r"""
import os, sys
import numpy as np

n_proc = int(sys.argv[1]); pid = int(sys.argv[2]); port = sys.argv[3]
n_local = int(sys.argv[4]); out_path = sys.argv[5]

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + f" --xla_force_host_platform_device_count={n_local}"
                           + " --xla_cpu_collective_call_terminate_timeout_seconds=1200"
                           + " --xla_cpu_collective_timeout_seconds=1200").strip()
import jax
jax.config.update("jax_platforms", "cpu")
from closed_loop_seeg_speech_synthesis_tpu.parallel import distributed as dist
dist.initialize(f"localhost:{port}", n_proc, pid)

import jax.numpy as jnp
from closed_loop_seeg_speech_synthesis_tpu.parallel import sharded

assert len(jax.devices()) == n_proc * n_local, (len(jax.devices()), n_proc, n_local)

# deterministic global session batch, same seed on every process
rng = np.random.RandomState(7)
cfg = sharded.ShardedTrainConfig(dtype=jnp.float32, nb_feats=16, iir_block=128)
T, C = 2048, 8
Ta = int(T / cfg.sr * cfg.audio_sr)
B_global = 2 * n_proc * n_local
B_local = B_global // n_proc
eeg_all = rng.randn(B_global, T, C).astype(np.float32)
audio_all = (rng.randn(B_global, Ta) * 0.1).astype(np.float32)
lo, hi = pid * B_local, (pid + 1) * B_local

mesh = dist.global_mesh(model_axis=1)
params, select, medians = dist.distributed_train(mesh, cfg,
                                                 eeg_all[lo:hi], audio_all[lo:hi])
assert params.coef.shape == (cfg.n_mel, cfg.nb_intervals, cfg.nb_feats)
np.savez(out_path, coef=params.coef, intercept=params.intercept,
         select=select, medians=medians)
print(f"dcn train worker {pid}: ok, coef {params.coef.shape}")
"""


def _spawn_dryrun(worker_src: str, out_prefix: str, n_processes: int,
                  n_local_devices: int, port: int, workdir: str, timeout: float,
                  suffix: str = ".npy"):
    procs, outs = [], []
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                    env.get("PYTHONPATH", "")) if p)
    for pid in range(n_processes):
        out_path = os.path.join(workdir, f"{out_prefix}_{pid}{suffix}")
        outs.append(out_path)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", worker_src, str(n_processes), str(pid), str(port),
             str(n_local_devices), out_path],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(out)
        if p.returncode != 0:
            raise RuntimeError("dcn worker failed:\n" + out[-4000:])
    return outs, logs


def dryrun_dcn(n_processes: int = 2, n_local_devices: int = 4, port: int = 51217,
               workdir: str = "/tmp", timeout: float = 600.0):
    """Spawn N processes x M virtual CPU devices, run the distributed replay,
    and return the per-process spectrogram shards (process order)."""
    import numpy as np

    outs, logs = _spawn_dryrun(_WORKER, "dcn_shard", n_processes, n_local_devices,
                               port, workdir, timeout)
    return [np.load(o) for o in outs], logs


def dryrun_dcn_train(n_processes: int = 2, n_local_devices: int = 4,
                     port: int = 51219, workdir: str = "/tmp",
                     timeout: float = 600.0):
    """Spawn N processes x M virtual CPU devices and fit ONE model from the
    globally sharded session batch; returns each process's fetched replica of
    (coef, intercept, select, medians) — they must all be identical."""
    import numpy as np

    outs, logs = _spawn_dryrun(_TRAIN_WORKER, "dcn_train", n_processes,
                               n_local_devices, port, workdir, timeout,
                               suffix=".npz")
    return [dict(np.load(o)) for o in outs], logs
