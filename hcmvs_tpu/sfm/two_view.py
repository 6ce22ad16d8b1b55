"""Two-view geometry: essential-matrix RANSAC + pose recovery.

Replaces OpenMVG's robust relative-pose estimation (driven from
frame_main/MvgMvsPipeline.py:190-192 IncrementalSfM).  Accelerator shape:
all H RANSAC hypotheses are solved simultaneously — a vmapped batch of
8-point problems (batched SVD) scored by vectorized Sampson distances —
instead of the CPU's sequential hypothesis loop.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class TwoViewResult(NamedTuple):
    E: jax.Array          # (3, 3) best essential matrix
    inliers: jax.Array    # (N,) bool
    n_inliers: jax.Array  # scalar
    R: jax.Array          # (3, 3) relative rotation (cam1 <- cam0 frame)
    t: jax.Array          # (3,) unit translation
    threshold: jax.Array = jnp.float32(0.0)  # realized squared-Sampson
                          # inlier threshold (the data-driven NFA optimum
                          # in adaptive mode; the input threshold
                          # otherwise) — downstream model-selection
                          # checks (H-vs-E degeneracy guard) must use
                          # THIS scale, not the fixed config value


def _eight_point(pts0: jax.Array, pts1: jax.Array) -> jax.Array:
    """Essential matrix from >= 8 normalized correspondences (one sample).

    pts: (8, 2) normalized camera coordinates (K^-1 applied).
    """
    x0, y0 = pts0[:, 0], pts0[:, 1]
    x1, y1 = pts1[:, 0], pts1[:, 1]
    ones = jnp.ones_like(x0)
    A = jnp.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1,
                   x0, y0, ones], axis=-1)          # (8, 9)
    # null vector via SVD of A
    _, _, vt = jnp.linalg.svd(A, full_matrices=True)
    e = vt[-1]
    E = e.reshape(3, 3)
    # project onto the essential manifold: singular values (s, s, 0)
    u, s, vtE = jnp.linalg.svd(E)
    s_mean = (s[0] + s[1]) / 2
    return u @ jnp.diag(jnp.array([1.0, 1.0, 0.0]) * s_mean) @ vtE


def sampson_distance(E: jax.Array, pts0: jax.Array,
                     pts1: jax.Array) -> jax.Array:
    """(N,) squared Sampson distances in normalized coords."""
    ones = jnp.ones_like(pts0[:, :1])
    p0 = jnp.concatenate([pts0, ones], axis=-1)
    p1 = jnp.concatenate([pts1, ones], axis=-1)
    Ep0 = p0 @ E.T          # (N, 3): E @ p0
    Etp1 = p1 @ E           # (N, 3): E^T @ p1
    num = jnp.sum(p1 * Ep0, axis=-1) ** 2
    den = Ep0[:, 0] ** 2 + Ep0[:, 1] ** 2 + Etp1[:, 0] ** 2 + Etp1[:, 1] ** 2
    return num / jnp.maximum(den, 1e-12)


# threshold/alpha0 stay TRACED: making them static would compile a new
# 512-hypothesis RANSAC graph per distinct float (the executable-explosion
# failure mode this repo hit in CI — see _bucket_pad, sfm/incremental.py);
# in adaptive mode threshold is rebound to a tracer anyway.
@partial(jax.jit, static_argnames=("n_hypotheses", "adaptive"))
def ransac_essential(key: jax.Array, pts0: jax.Array, pts1: jax.Array,
                     valid: jax.Array, threshold: float = 1e-5,
                     n_hypotheses: int = 512,
                     adaptive: bool = True,
                     alpha0: float = 2.83) -> TwoViewResult:
    """Vmapped-hypothesis RANSAC for E on normalized correspondences.

    pts0/pts1: (N, 2) normalized coords; valid: (N,) mask (padded slots).
    ``threshold`` is on squared Sampson distance in normalized units
    (~(1.5px / f)^2).

    ``adaptive``: a-contrario (AC-RANSAC/ORSA) mode — the reference's
    AutoEstimator driver (ref: frame_main/libs/Common/AutoEstimator.h:230):
    hypotheses are ranked by log-NFA over every inlier count, and the
    squared-distance threshold becomes the data-driven r_k* of the best
    (model, count) — no fixed ``threshold`` needed, which is what lets
    the frontend run unattended across scene/noise scales
    (sfm/acransac.py; ``alpha0`` is the epipolar band probability slope).
    """
    n = pts0.shape[0]
    # sample 8 indices per hypothesis, restricted to valid entries
    logits = jnp.where(valid, 0.0, -1e9)
    idx = jax.random.categorical(key, logits, shape=(n_hypotheses, 8))

    def solve(sample_idx):
        return _eight_point(pts0[sample_idx], pts1[sample_idx])

    Es = jax.vmap(solve)(idx)                       # (H, 3, 3)

    if adaptive:
        from hcmvs_tpu.sfm.acransac import nfa_threshold_batch
        ds = jax.vmap(lambda E: sampson_distance(E, pts0, pts1))(Es)
        log_nfa, thr2, k_star = nfa_threshold_batch(ds, valid, m=8,
                                                    alpha0=alpha0)
        # traced data-driven threshold from the most significant model;
        # ranking by significance replaces the fixed-threshold count.
        # The calibrated input threshold acts as a FLOOR: NFA may loosen
        # it when the data is noisier than the calibration assumed (the
        # unattended-operation case AC-RANSAC exists for), but never
        # tighten below it — on planar scenes the E-family degeneracy
        # yields near-zero-residual subsets whose NFA optimum collapses
        # (measured 1e-14 on the dolly-zoom golden, r5), strips the
        # inlier set, and mis-ranks init pairs; sub-calibration precision
        # is keypoint-quantization noise, not signal
        threshold = jnp.maximum(thr2[jnp.argmin(log_nfa)], threshold)
        counts = -log_nfa

        def score(E):
            d = sampson_distance(E, pts0, pts1)
            inl = (d <= threshold) & valid
            return inl.sum(), inl

        _, inls = jax.vmap(score)(Es)
    else:
        def score(E):
            d = sampson_distance(E, pts0, pts1)
            inl = (d < threshold) & valid
            return inl.sum(), inl

        counts, inls = jax.vmap(score)(Es)

    # Sampson inlier COUNT alone cannot discriminate low-parallax twins
    # (several essential matrices fit all matches within threshold, and the
    # minimal-sample solutions can cluster in the wrong basin).  Take the
    # top candidates by count, GN-refine each into its local optimum, and
    # select by the *refined robust Sampson cost* — the true basin bottoms
    # out measurably lower.
    n_top = 4
    _, top_idx = jax.lax.top_k(counts, n_top)
    cap = 4.0 * threshold

    # translation-direction restarts: at low parallax the minimal-sample
    # epipole collapses toward the view axis for EVERY sample, so the true
    # basin may appear in no candidate; the rotation estimate is still
    # good, so re-seed t over a coarse half-sphere and let GN sort it out.
    t_seeds = jnp.asarray(np.array(
        [[1, 0, 0], [0, 1, 0], [0, 0, 1],
         [1, 1, 0], [1, -1, 0], [1, 0, 1], [1, 0, -1],
         [0, 1, 1], [0, 1, -1], [1, 1, 1], [1, -1, 1],
         [-1, 1, 1], [-1, -1, 1]], np.float32))
    t_seeds = t_seeds / jnp.linalg.norm(t_seeds, axis=1, keepdims=True)

    def refined_cost(E, t_seed):
        inl0 = (sampson_distance(E, pts0, pts1) < threshold) & valid
        R0, t0 = recover_pose(E, pts0, pts1, inl0)
        t_init = jnp.where(jnp.isnan(t_seed[0]), t0, t_seed)
        R1, t1 = refine_pose(R0, t_init, pts0, pts1, inl0, n_iters=6)
        d = sampson_distance(skew3(t1) @ R1, pts0, pts1)
        cost = jnp.sum(jnp.minimum(d, cap) * valid)
        return cost, R1, t1

    own = jnp.full((1, 3), jnp.nan)           # sentinel: use recover_pose t
    seeds = jnp.concatenate([own, t_seeds])   # (S, 3)
    cand_E = jnp.repeat(Es[top_idx], seeds.shape[0], axis=0)
    cand_seed = jnp.tile(seeds, (n_top, 1))
    costs, Rs_top, ts_top = jax.vmap(refined_cost)(cand_E, cand_seed)
    best = jnp.argmin(costs)
    R, t = Rs_top[best], ts_top[best]
    E = skew3(t) @ R
    inliers = (sampson_distance(E, pts0, pts1) < threshold) & valid

    # seeded t directions carry no cheirality: re-derive (R, t) from the
    # winning E with the positive-depth test, then polish
    R, t = recover_pose(E, pts0, pts1, inliers)
    R, t = refine_pose(R, t, pts0, pts1, inliers)
    E = skew3(t) @ R
    d = sampson_distance(E, pts0, pts1)
    inliers = (d < threshold) & valid
    R, t = recover_pose(E, pts0, pts1, inliers)
    return TwoViewResult(E=E, inliers=inliers, n_inliers=inliers.sum(),
                         R=R, t=t,
                         threshold=jnp.asarray(threshold, jnp.float32))


def skew3(v: jax.Array) -> jax.Array:
    return jnp.array([[0.0, -v[2], v[1]],
                      [v[2], 0.0, -v[0]],
                      [-v[1], v[0], 0.0]])


def refine_pose(R0: jax.Array, t0: jax.Array, pts0: jax.Array,
                pts1: jax.Array, w: jax.Array, n_iters: int = 8
                ) -> Tuple[jax.Array, jax.Array]:
    """Minimize weighted Sampson error over a local (rvec, dt) chart."""
    from hcmvs_tpu.sfm.ba import rodrigues
    wf = w.astype(jnp.float32)

    def residuals(params):
        rvec, dt = params[:3], params[3:]
        R = rodrigues(rvec) @ R0
        t = t0 + dt
        t = t / jnp.maximum(jnp.linalg.norm(t), 1e-9)
        E = skew3(t) @ R
        d2 = sampson_distance(E, pts0, pts1)
        return jnp.sqrt(jnp.maximum(d2, 1e-18)) * wf

    def cost(p):
        return jnp.sum(residuals(p) ** 2)

    params = jnp.zeros(6)
    for _ in range(n_iters):
        r = residuals(params)
        J = jax.jacfwd(residuals)(params)
        JtJ = J.T @ J + 1e-8 * jnp.eye(6)
        step = jnp.linalg.solve(JtJ, J.T @ r)
        # backtracking: halve until the cost decreases (3 tries)
        c0 = cost(params)
        trial = params - step
        for _ in range(3):
            trial = jnp.where(cost(trial) < c0, trial,
                              params - (trial - params) * -0.5)
        params = jnp.where(cost(trial) < c0, trial, params)
    R = rodrigues(params[:3]) @ R0
    t = t0 + params[3:]
    return R, t / jnp.maximum(jnp.linalg.norm(t), 1e-9)


def _refit(E0: jax.Array, pts0: jax.Array, pts1: jax.Array,
           w: jax.Array) -> jax.Array:
    x0, y0 = pts0[:, 0], pts0[:, 1]
    x1, y1 = pts1[:, 0], pts1[:, 1]
    ones = jnp.ones_like(x0)
    A = jnp.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1,
                   x0, y0, ones], axis=-1)
    Aw = A * w[:, None].astype(A.dtype)
    # direct SVD of the stacked system (normal equations would square the
    # conditioning)
    _, _, vt = jnp.linalg.svd(Aw, full_matrices=False)
    E = vt[-1].reshape(3, 3)
    u, s, vtE = jnp.linalg.svd(E)
    s_mean = (s[0] + s[1]) / 2
    return u @ jnp.diag(jnp.array([1.0, 1.0, 0.0]) * s_mean) @ vtE


def triangulate_midpoint(R: jax.Array, t: jax.Array, pts0: jax.Array,
                         pts1: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """DLT triangulation for relative pose (I|0), (R|t).

    Returns (X (N, 3) in cam0 frame, depth0 (N,)).
    """
    ones = jnp.ones_like(pts0[:, :1])
    r0 = jnp.concatenate([pts0, ones], axis=-1)

    def tri(p0, p1):
        # rows of A X = 0 from x x (P X)
        P1 = jnp.concatenate([R, t[:, None]], axis=1)   # (3, 4)
        A = jnp.stack([
            jnp.array([1.0, 0.0, -p0[0], 0.0]),
            jnp.array([0.0, 1.0, -p0[1], 0.0]),
            p1[0] * P1[2] - P1[0],
            p1[1] * P1[2] - P1[1],
        ])
        _, _, vt = jnp.linalg.svd(A)
        Xh = vt[-1]
        return Xh[:3] / jnp.where(jnp.abs(Xh[3]) < 1e-12, 1e-12, Xh[3])

    X = jax.vmap(tri)(pts0, pts1)
    return X, X[:, 2]


def recover_pose(E: jax.Array, pts0: jax.Array, pts1: jax.Array,
                 inliers: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Choose the (R, t) among the 4 decompositions with max cheirality."""
    u, _, vt = jnp.linalg.svd(E)
    # ensure proper rotations
    u = u * jnp.sign(jnp.linalg.det(u))
    vt = vt * jnp.sign(jnp.linalg.det(vt))
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    t1 = u[:, 2]
    candidates = [(R1, t1), (R1, -t1), (R2, t1), (R2, -t1)]

    def cheirality(Rt):
        R, t = Rt
        X, z0 = triangulate_midpoint(R, t, pts0, pts1)
        z1 = (X @ R.T + t)[:, 2]
        return jnp.sum((z0 > 0) & (z1 > 0) & inliers)

    counts = jnp.stack([cheirality(c) for c in candidates])
    best = jnp.argmax(counts)
    Rs = jnp.stack([c[0] for c in candidates])
    ts = jnp.stack([c[1] for c in candidates])
    return Rs[best], ts[best]


class HomographyResult(NamedTuple):
    H: jax.Array           # (3, 3)
    inliers: jax.Array     # (N,) bool
    n_inliers: jax.Array   # scalar


def _dlt_homography(p0: jax.Array, p1: jax.Array) -> jax.Array:
    """(4+, 2) point pairs -> 3x3 homography via DLT (SVD null vector)."""
    n = p0.shape[0]
    zeros = jnp.zeros((n,))
    ones = jnp.ones((n,))
    x, y = p0[:, 0], p0[:, 1]
    u, v = p1[:, 0], p1[:, 1]
    r1 = jnp.stack([-x, -y, -ones, zeros, zeros, zeros,
                    u * x, u * y, u], axis=1)
    r2 = jnp.stack([zeros, zeros, zeros, -x, -y, -ones,
                    v * x, v * y, v], axis=1)
    A = jnp.concatenate([r1, r2])
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    H = Vt[-1].reshape(3, 3)
    return H / jnp.where(jnp.abs(H[2, 2]) < 1e-12, 1e-12, H[2, 2])


def homography_transfer_error(H: jax.Array, p0: jax.Array,
                              p1: jax.Array) -> jax.Array:
    """Squared forward transfer error |H p0 - p1|^2."""
    q = p0 @ H[:, :2].T + H[:, 2]
    z = jnp.where(jnp.abs(q[:, 2]) < 1e-12, 1e-12, q[:, 2])
    return jnp.sum((q[:, :2] / z[:, None] - p1) ** 2, axis=1)


@partial(jax.jit, static_argnames=("n_hyps",))
def ransac_homography(key: jax.Array, p0: jax.Array, p1: jax.Array,
                      valid: jax.Array, threshold: float = 2e-5,
                      n_hyps: int = 256) -> HomographyResult:
    """Vmapped 4-point homography RANSAC (normalized coordinates).

    Used for the OpenMVG-style AUTO model selection (ref: the '-g e'
    matching mode and init-pair guard, MvgMvsPipeline.py:325-328): a pair
    whose matches are explained as well by a homography as by the
    essential matrix is planar/low-parallax and unsafe to initialize from.
    """
    n = p0.shape[0]
    logits = jnp.where(valid, 0.0, -1e9)
    idx = jax.random.categorical(key, logits, shape=(n_hyps, 4))

    def solve(sample_idx):
        return _dlt_homography(p0[sample_idx], p1[sample_idx])

    Hs = jax.vmap(solve)(idx)
    errs = jax.vmap(lambda H: homography_transfer_error(H, p0, p1))(Hs)
    inl = (errs < threshold) & valid[None]
    scores = inl.sum(axis=1)
    best = jnp.argmax(scores)
    return HomographyResult(H=Hs[best], inliers=inl[best],
                            n_inliers=scores[best])
