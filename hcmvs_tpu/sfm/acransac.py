"""A-contrario (NFA) adaptive RANSAC thresholding.

The reference's generic robust-estimation driver is AC-RANSAC (ORSA,
Moisan-Stival) — ref: frame_main/libs/Common/AutoEstimator.h:230 — whose
point is running UNATTENDED across scene scales: instead of a fixed
inlier threshold, each model is scored by the Number of False Alarms

    NFA(model, k) = N_out * C(n, k) * C(k, m) * alpha(r_k)^(k - m)

over every candidate inlier count k (r_k = k-th smallest residual,
alpha(r) = probability a random point lands within r of the model, m =
minimal sample size); the (model, k) minimizing NFA gives both the
model ranking and the data-driven threshold r_k*, significant when
NFA < 1 (log NFA < 0).

Batched formulation: the log-combinatorial tables are precomputed
host-side per problem size; per hypothesis the residuals are sorted
(XLA sort) and the k-scan is a vectorized reduction — the whole
hypothesis batch evaluates as one vmapped graph, no data-dependent
loops.  Epipolar alpha model: a band of half-width r around a line
through the normalized image window, alpha(r) = alpha0 * r with
alpha0 = 2 * diag / area (openMVG's line model); residuals fed as
SQUARED Sampson distances, r = sqrt(d2).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=32)
def _log_comb_tables(n: int, m: int) -> Tuple[np.ndarray, np.ndarray]:
    """(logC(n, k), logC(k, m)) for k = 0..n (float64 host tables)."""
    from scipy.special import gammaln
    k = np.arange(n + 1, dtype=np.float64)
    log_c_n_k = gammaln(n + 1) - gammaln(k + 1) - gammaln(n - k + 1)
    with np.errstate(invalid="ignore"):
        log_c_k_m = gammaln(k + 1) - gammaln(m + 1) - gammaln(k - m + 1)
    log_c_k_m[k < m] = np.inf           # k < m impossible
    return log_c_n_k, log_c_k_m


def nfa_threshold(d2: jax.Array, valid: jax.Array, m: int,
                  alpha0: float = 2.0 * 1.4142 / 1.0,
                  n_outcomes: float = 1.0
                  ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Best log-NFA over inlier counts for ONE model's residuals.

    Args:
      d2: (N,) squared residuals (Sampson, normalized units).
      valid: (N,) mask; invalid slots are excluded (treated as +inf).
      m: minimal sample size (8 for the eight-point E solver).
      alpha0: alpha(r) = alpha0 * r — the geometric probability slope
        (epipolar band in a unit-ish normalized window by default).
      n_outcomes: the N_out multiplicity term (number of model outcomes
        per sample; 1 for eight-point, 4 for seven-point/essential
        decompositions — only shifts log NFA, not the argmin).

    Returns (log_nfa, d2_threshold, k_star): the minimal log NFA, the
    squared-residual threshold realizing it, and its inlier count.
    """
    n = d2.shape[0]
    log_c_n_k, log_c_k_m = _log_comb_tables(n, m)
    d2s = jnp.sort(jnp.where(valid, d2, jnp.inf))       # ascending
    k = jnp.arange(n + 1, dtype=jnp.float32)
    # r_k = sqrt of the k-th smallest residual (k models = first k pts)
    r_k = jnp.sqrt(jnp.maximum(d2s, 1e-24))
    log_alpha = jnp.log(jnp.clip(alpha0 * r_k, 1e-12, 1.0))
    # log NFA for count k (k >= m+1), threshold at residual index k-1
    log_alpha_at_k = jnp.concatenate([jnp.zeros(1), log_alpha])  # idx by k
    # ORSA's multiplicity over candidate inlier counts: NFA carries an
    # (n - m) factor (one trial per possible count).  Constant in k for
    # fixed n — ranking/threshold unchanged — but required for the
    # absolute "significant when log NFA < 0" cutoff to match the
    # AC-RANSAC definition (ref: AutoEstimator.h:230 NFA formulation).
    log_nfa_k = (jnp.log(n_outcomes) + np.log(max(n - m, 1))
                 + jnp.asarray(log_c_n_k, jnp.float32)
                 + jnp.asarray(np.where(np.isfinite(log_c_k_m),
                                        log_c_k_m, 1e30), jnp.float32)
                 + (k - m) * log_alpha_at_k)
    # only counts with finite residuals are admissible
    n_valid = jnp.sum(valid)
    admissible = (k >= m + 1) & (k <= n_valid)
    log_nfa_k = jnp.where(admissible, log_nfa_k, jnp.inf)
    k_star = jnp.argmin(log_nfa_k)
    return (log_nfa_k[k_star], d2s[jnp.maximum(k_star - 1, 0)],
            k_star)


def nfa_threshold_batch(d2: jax.Array, valid: jax.Array, m: int,
                        alpha0: float = 2.0 * 1.4142,
                        n_outcomes: float = 1.0):
    """vmapped nfa_threshold over a hypothesis batch: d2 (H, N)."""
    return jax.vmap(lambda d: nfa_threshold(d, valid, m, alpha0,
                                            n_outcomes))(d2)
