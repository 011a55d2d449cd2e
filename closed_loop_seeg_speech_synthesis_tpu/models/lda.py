"""Linear Discriminant Analysis, batched across mel bins.

The reference fits 40 independent sklearn ``LinearDiscriminantAnalysis()``
models (default svd solver), one per mel bin, on the same 150-dim feature
matrix with different 9-class quantization labels (``train.py:156-166``), and
predicts one class per bin per frame (``livenodes/LDASynthesis.py:19-28``).

Batched redesign:

* fit: all 40 bins in one pass.  The per-bin labels differ but X is shared,
  so per-class sums/counts are segment reductions, and the svd of the scaled
  within-class scatter is computed from the (150, 150) Gram matrix — one big
  matmul per bin batch — followed by a vmapped eigendecomposition.  This
  reproduces sklearn's svd-solver ``coef_``/``intercept_`` within numerical
  tolerance (the final discriminant is invariant to the internal sign/basis
  choices because it only uses ``scalings_ @ scalings_.T``).
* bins may lose classes (the quantizer can produce <9 distinct labels for a
  bin — see reference train.py:86-91, exp4.py:75-83): handled with static
  9-class padding and -inf masking, no ragged shapes.
* predict: a single ``(T, 150) @ (150, 40*9)`` matmul + per-bin argmax,
  mapped through each bin's present-class table.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class LDAParams:
    """Batched per-bin LDA decision functions.

    coef:       (n_bins, n_classes_max, n_features)
    intercept:  (n_bins, n_classes_max)
    classes:    (n_bins, n_classes_max) int32 — original label per slot
    valid:      (n_bins, n_classes_max) bool — slot corresponds to a present class
    """

    coef: jnp.ndarray
    intercept: jnp.ndarray
    classes: jnp.ndarray
    valid: jnp.ndarray

    def tree_flatten(self):
        return ((self.coef, self.intercept, self.classes, self.valid), None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def n_bins(self) -> int:
        return self.coef.shape[0]

_HI = jax.lax.Precision.HIGHEST  # full float32 products (no TF32/bf16 passes)



def _fit_one_bin(X, y_onehot, counts, tol=1e-4):
    """sklearn svd-solver LDA for one bin with padded classes.

    X: (n, d); y_onehot: (n, k) one-hot over padded class slots;
    counts: (k,) samples per slot (0 => absent class).
    Returns (coef (k, d), intercept (k,)) with absent slots zeroed.
    """
    n, d = X.shape
    k = y_onehot.shape[1]
    dt = X.dtype
    present = counts > 0
    n_classes = jnp.sum(present)
    safe_counts = jnp.where(present, counts, 1)

    sums = jnp.matmul(y_onehot.T, X, precision=_HI)                                  # (k, d)
    means = sums / safe_counts[:, None]
    priors = jnp.where(present, counts / n, 0.0).astype(dt)
    xbar = jnp.matmul(priors, means, precision=_HI)                                  # (d,)

    # Within-class centering: Xc = X - mean of own class
    Xc = X - jnp.matmul(y_onehot, means, precision=_HI)
    fac = 1.0 / (n - n_classes).astype(dt)
    std = jnp.std(Xc, axis=0)
    std = jnp.where(std == 0, 1.0, std)
    Xs = (jnp.sqrt(fac) * Xc) / std

    # svd(Xs) via eigh of the Gram matrix (d x d): S = sqrt(eigvals), V = vecs.
    G = jnp.matmul(Xs.T, Xs, precision=_HI)
    evals, evecs = jnp.linalg.eigh(G)
    evals = evals[::-1]
    evecs = evecs[:, ::-1]
    S = jnp.sqrt(jnp.clip(evals, 0.0, None))
    rank_mask = S > tol
    inv_S = jnp.where(rank_mask, 1.0 / jnp.where(rank_mask, S, 1.0), 0.0)
    scalings = (evecs / std[:, None]) * inv_S[None, :]     # (d, d), masked cols

    # Between-class projection
    factor = jnp.sqrt(jnp.where(present, (n * priors) * fac, 0.0))
    X2 = factor[:, None] * jnp.matmul(means - xbar, scalings, precision=_HI)     # (k, d)
    G2 = jnp.matmul(X2.T, X2, precision=_HI)
    evals2, evecs2 = jnp.linalg.eigh(G2)
    evals2 = evals2[::-1]
    evecs2 = evecs2[:, ::-1]
    S2 = jnp.sqrt(jnp.clip(evals2, 0.0, None))
    rank2_mask = S2 > tol * S2[0]
    Vt2 = jnp.where(rank2_mask[:, None], evecs2.T, 0.0)    # zero dropped dims
    scalings2 = jnp.matmul(scalings, Vt2.T, precision=_HI)                           # (d, r2-masked)

    coef0 = jnp.matmul(means - xbar, scalings2, precision=_HI)                     # (k, r)
    coef = jnp.matmul(coef0, scalings2.T, precision=_HI)                             # (k, d)
    log_priors = jnp.where(present, jnp.log(jnp.where(present, priors, 1.0)), 0.0)
    intercept = -0.5 * jnp.sum(coef0 * coef0, axis=1) + log_priors
    intercept = intercept - jnp.matmul(coef, xbar, precision=_HI)
    coef = jnp.where(present[:, None], coef, 0.0)
    intercept = jnp.where(present, intercept, 0.0)
    return coef, intercept


@partial(jax.jit, static_argnames=("n_classes_max",))
def _fit_batched(X, labels, n_classes_max):
    """labels: (n_bins, n) int32 compact slot ids in [0, n_classes_max).

    Returns (coef, intercept, present) where present marks slots with at
    least one sample (bins can lose quantization intervals)."""
    def per_bin(y):
        onehot = jax.nn.one_hot(y, n_classes_max, dtype=X.dtype)  # (n, k)
        counts = jnp.sum(onehot, axis=0)
        coef, intercept = _fit_one_bin(X, onehot, counts)
        return coef, intercept, counts > 0

    return jax.vmap(per_bin)(labels)


def fit(X: jnp.ndarray, Y: np.ndarray, n_classes_max: int = 9) -> LDAParams:
    """Fit per-bin LDAs.  X: (n, d) features; Y: (n, n_bins) integer labels.

    Class slots are each bin's sorted unique labels (sklearn's ``classes_``);
    missing intervals are padded and masked.
    """
    Y = np.asarray(Y).astype(np.int64)
    n, d = X.shape
    n_bins = Y.shape[1]
    classes = np.zeros((n_bins, n_classes_max), np.int32)
    valid = np.zeros((n_bins, n_classes_max), bool)
    compact = np.zeros((n, n_bins), np.int32)
    for b in range(n_bins):
        u = np.unique(Y[:, b])
        if len(u) > n_classes_max:
            raise ValueError(f"bin {b} has {len(u)} classes > {n_classes_max}")
        classes[b, : len(u)] = u
        valid[b, : len(u)] = True
        lut = {c: i for i, c in enumerate(u)}
        compact[:, b] = [lut[v] for v in Y[:, b]]

    coef, intercept, _ = _fit_batched(X, jnp.asarray(compact.T), n_classes_max)
    return LDAParams(
        coef=coef, intercept=intercept,
        classes=jnp.asarray(classes), valid=jnp.asarray(valid),
    )


@jax.jit
def predict(params: LDAParams, X: jnp.ndarray) -> jnp.ndarray:
    """X: (T, d) -> predicted original class labels (T, n_bins) int32.

    One einsum over all bins; absent class slots masked to -inf.
    """
    scores = jnp.einsum("td,bkd->tbk", X, params.coef, precision=_HI) + params.intercept[None]
    neg = jnp.asarray(-jnp.inf, scores.dtype)
    scores = jnp.where(params.valid[None], scores, neg)
    idx = jnp.argmax(scores, axis=-1)  # (T, n_bins)
    return jnp.take_along_axis(
        jnp.broadcast_to(params.classes, (X.shape[0],) + params.classes.shape), idx[:, :, None], axis=2
    )[:, :, 0]


def decision_scores(params: LDAParams, X: jnp.ndarray) -> jnp.ndarray:
    """Raw decision-function scores (T, n_bins, n_classes_max), -inf masked."""
    scores = jnp.einsum("td,bkd->tbk", X, params.coef, precision=_HI) + params.intercept[None]
    return jnp.where(params.valid[None], scores, -jnp.inf)


# ---------------------------------------------------------------------------
# sklearn interop (artifact compatibility, host-side, optional dependency)
# ---------------------------------------------------------------------------


def to_sklearn_estimators(params: LDAParams):
    """Materialize sklearn LinearDiscriminantAnalysis objects carrying our
    fitted coef_/intercept_/classes_, for reference-compatible ``LDAs.pkl`` /
    ``params.h5`` artifacts (train.py:180-196)."""
    from sklearn.discriminant_analysis import LinearDiscriminantAnalysis

    coef = np.asarray(params.coef, np.float64)
    intercept = np.asarray(params.intercept, np.float64)
    classes = np.asarray(params.classes)
    valid = np.asarray(params.valid)
    ests = []
    for b in range(params.n_bins):
        m = valid[b]
        est = LinearDiscriminantAnalysis()
        est.classes_ = classes[b][m].astype(np.float64)
        if m.sum() == 2:
            # sklearn binary convention: single row = class1 - class0
            est.coef_ = (coef[b][m][1] - coef[b][m][0])[None, :]
            est.intercept_ = np.atleast_1d(intercept[b][m][1] - intercept[b][m][0])
        else:
            est.coef_ = coef[b][m]
            est.intercept_ = intercept[b][m]
        ests.append(est)
    return ests


def from_sklearn_estimators(estimators, n_classes_max: int = 9, dtype=jnp.float32) -> LDAParams:
    """Build batched params from unpickled sklearn estimators
    (decode.py:298-306 loads these from params.h5)."""
    n_bins = len(estimators)
    d = estimators[0].coef_.shape[-1]
    coef = np.zeros((n_bins, n_classes_max, d))
    intercept = np.zeros((n_bins, n_classes_max))
    classes = np.zeros((n_bins, n_classes_max), np.int32)
    valid = np.zeros((n_bins, n_classes_max), bool)
    for b, est in enumerate(estimators):
        cls = np.asarray(est.classes_).astype(np.int32)
        k = len(cls)
        classes[b, :k] = cls
        valid[b, :k] = True
        if k == 2 and est.coef_.shape[0] == 1:
            coef[b, 1] = est.coef_[0]
            intercept[b, 1] = est.intercept_[0]
        else:
            coef[b, :k] = est.coef_
            intercept[b, :k] = est.intercept_
    return LDAParams(
        coef=jnp.asarray(coef, dtype), intercept=jnp.asarray(intercept, dtype),
        classes=jnp.asarray(classes), valid=jnp.asarray(valid),
    )
