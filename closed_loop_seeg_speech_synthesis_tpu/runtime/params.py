"""Checkpoint / artifact store, byte-compatible with the reference formats.

The reference persists (train.py:171-205):
  * ``params.h5``  — bad_channels, medians_array, pickled sklearn estimator
                     list as an ``np.void`` blob, select indices
  * ``LDAs.pkl``   — the pickled estimator list again
  * ``training_features.npy`` — selected feature matrix (for exp4)
  * ``train.ini``  — the merged config used

We write/read the same files so reference checkpoints and ours are mutually
loadable, and additionally store plain-array LDA tensors (``lda_*`` datasets)
so decoding never *requires* unpickling sklearn objects.  Without
scikit-learn only the plain arrays are written: ``LDAs.pkl`` and the pickled
estimator blob are skipped with a warning.
"""

from __future__ import annotations

import logging
import os
import pickle

import numpy as np

from ..models import lda as lda_mod

logger = logging.getLogger("runtime.params")


def store_training(session_dir: str, result, bad_channels, config=None, x_train_full=None) -> str:
    """Persist a runtime.trainer.TrainResult to the reference layout."""
    import h5py

    os.makedirs(session_dir, exist_ok=True)
    try:
        estimators = lda_mod.to_sklearn_estimators(result.lda)
    except ImportError:
        logger.warning("scikit-learn is not installed: writing the plain lda_* "
                       "arrays only (no LDAs.pkl, no pickled estimators)")
        estimators = None
    if estimators is not None:
        with open(os.path.join(session_dir, "LDAs.pkl"), "wb") as f:
            pickle.dump(estimators, f)

    np.save(os.path.join(session_dir, "training_features.npy"),
            result.x_train if x_train_full is None else x_train_full)

    path = os.path.join(session_dir, "params.h5")
    with h5py.File(path, "w") as hf:
        hf.create_dataset("bad_channels", data=np.asarray(bad_channels, np.int64))
        hf.create_dataset("medians_array", data=result.medians)
        if estimators is not None:
            hf.create_dataset("estimators", data=np.void(pickle.dumps(estimators)))
        hf.create_dataset("select", data=np.asarray(result.select, np.int64))
        # plain-array twin of the pickled blob (framework-native load path)
        hf.create_dataset("lda_coef", data=np.asarray(result.lda.coef, np.float64))
        hf.create_dataset("lda_intercept", data=np.asarray(result.lda.intercept, np.float64))
        hf.create_dataset("lda_classes", data=np.asarray(result.lda.classes))
        hf.create_dataset("lda_valid", data=np.asarray(result.lda.valid))
        hf.create_dataset("borders_array", data=result.borders)

    if config is not None:
        with open(os.path.join(session_dir, "train.ini"), "w") as f:
            config.write(f)
    return path


def as_loaded(result, bad_channels) -> dict:
    """The dict ``load_params`` returns, built from an in-memory
    runtime.trainer.TrainResult (no artifact round trip)."""
    return {"medians": np.asarray(result.medians),
            "bad_channels": np.asarray(bad_channels, int),
            "select": np.asarray(result.select).astype(int),
            "lda": result.lda}


def load_params(path: str, dtype=None):
    """Load a ``params.h5`` (ours or the reference's).

    Returns dict with medians, bad_channels, select, and an LDAParams built
    from plain arrays when present, else from the pickled estimators
    (decode.py:298-306 semantics).
    """
    import h5py
    import jax.numpy as jnp

    dtype = dtype or jnp.float32
    with h5py.File(path, "r") as hf:
        out = {
            "medians": np.asarray(hf["medians_array"]),
            "bad_channels": np.asarray(hf["bad_channels"]).astype(int),
            "select": np.asarray(hf["select"]).astype(int),
        }
        if "lda_coef" in hf:
            out["lda"] = lda_mod.LDAParams(
                coef=jnp.asarray(np.asarray(hf["lda_coef"]), dtype),
                intercept=jnp.asarray(np.asarray(hf["lda_intercept"]), dtype),
                classes=jnp.asarray(np.asarray(hf["lda_classes"])),
                valid=jnp.asarray(np.asarray(hf["lda_valid"])),
            )
        else:
            blob = hf["estimators"][...].tobytes()
            estimators = pickle.loads(blob)
            out["lda"] = lda_mod.from_sklearn_estimators(estimators, dtype=dtype)
    return out
