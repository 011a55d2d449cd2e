"""Spearman-correlation feature selection (reference ``train.py:96-109``).

Per feature: Spearman rho against the frame-mean of the target logMels;
features whose column sum is ~0 are forced to rho=0; the 150 largest |rho|
are kept in ``np.argsort`` order (ascending |rho|), which fixes the feature
ordering the LDA models are trained in — we reproduce that ordering exactly.

Ranking (average ties, scipy.stats.rankdata semantics) and the correlation
pass run on device; the final argsort runs host-side with numpy to match the
reference's ordering, including NaN-last placement for zero-variance
(railed) channels.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _rank_average_cols(X: jnp.ndarray) -> jnp.ndarray:
    """scipy.stats.rankdata(col, method='average') for every column of X.

    Scatter-free: with ``lo = #{elements < x}`` and ``hi = #{elements <= x}``
    the average rank of x over its tie group (1-based positions lo+1..hi) is
    ``(lo + hi + 1) / 2`` — evaluated directly at the original positions via
    two searchsorteds into the sorted column, no argsort+scatter round trip.
    (A per-column vmap of argsort + ``.at[order].set`` is far slower at
    (184k, 320) and needs much more device memory at F >= 512.)
    """
    sv = jnp.sort(X, axis=0)

    def per_col(col_sorted, col):
        lo = jnp.searchsorted(col_sorted, col, side="left")
        hi = jnp.searchsorted(col_sorted, col, side="right")
        return (lo + hi + 1).astype(X.dtype) / 2.0

    return jax.vmap(per_col, in_axes=1, out_axes=1)(sv, X)


@jax.jit
def spearman_vs_target(X: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Spearman rho of every feature column of X (n, F) against y (n,)."""
    ry = _rank_average_cols(y[:, None])[:, 0]
    zero_col = jnp.isclose(jnp.sum(X, axis=0), 0.0)

    rx = _rank_average_cols(X)
    rxc = rx - jnp.mean(rx, axis=0)
    ryc = ry - jnp.mean(ry)
    # HIGHEST: a default-precision float32 matmul runs in TF32 on GPUs, which
    # perturbs rho enough to reorder near-tied features
    num = jnp.matmul(rxc.T, ryc, precision=jax.lax.Precision.HIGHEST)
    # zero variance -> NaN, matching scipy.stats.spearmanr: the reference's
    # np.argsort(|cs|) then sorts NaNs LAST, i.e. a constant-but-nonzero
    # (railed) channel lands INSIDE the selected features (train.py:96-109).
    denom = jnp.sqrt(jnp.sum(rxc * rxc, axis=0) * jnp.sum(ryc * ryc))
    rhos = jnp.where(denom > 0, num / jnp.where(denom > 0, denom, 1.0), jnp.nan)
    return jnp.where(zero_col, 0.0, rhos)  # exact-zero columns forced to 0 (train.py:103-105)


def select_features(X: jnp.ndarray, Y: jnp.ndarray, nb_feats: int = 150) -> np.ndarray:
    """Indices of the nb_feats best features, in the reference's order
    (ascending |rho|, numpy argsort tie order).  Y: (n, n_bins) logMels."""
    target = jnp.mean(Y, axis=1)
    cs = np.asarray(spearman_vs_target(X, target))
    return np.argsort(np.abs(cs))[max(-nb_feats, -len(cs)):]
