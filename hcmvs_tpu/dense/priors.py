"""Planar priors: superpixel segmentation + robust per-segment plane fits.

Data-parallel re-design of the reference's prior stack
(ref: frame_main/libs/MVS/SceneDensify.cpp:4010-4090 LSC_superpixel,
:1171-1545 GenerateSuperDepthPrior, :1550-1950 GenerateDepthPrior,
:1079-1161 GenerateFinalPrior):

- Superpixels: SLIC-style local k-means, fully jittable — centers live on
  a coarse grid and each pixel competes only among its 3x3 neighboring
  centers, which maps to static shifted-array comparisons (the LSC library
  the reference vendors is a sequential CPU loop).
- Plane fits: the reference runs CGAL Efficient_RANSAC per segment; here
  every segment is fit simultaneously with IRLS (iteratively reweighted
  least squares, Tukey weights) over segment-sum moment matrices — the
  vmapped, static-shape replacement for ragged per-segment RANSAC.
- The prior depth map evaluates each pixel's segment plane at the pixel
  ray, masked to segments with enough support and inlier ratio — the
  analog of depthMapPrior consumed by the score blend
  (ref: DepthMap.cpp:940-955, dense/score.py prior_blend).
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class SuperpixelResult(NamedTuple):
    labels: jax.Array    # (H, W) int32 superpixel id
    n_labels: int        # static: grid_h * grid_w


@partial(jax.jit, static_argnames=("grid_step", "n_iters", "m"))
def slic_superpixels(gray: jax.Array, grid_step: int = 16,
                     n_iters: int = 5, m: float = 0.1) -> jax.Array:
    """(H, W) -> (H, W) int32 labels; ~one superpixel per grid cell.

    ``m`` balances color vs spatial distance (SLIC compactness).
    """
    h, w = gray.shape
    gh = max(h // grid_step, 1)
    gw = max(w // grid_step, 1)
    sy = h / gh
    sx = w / gw

    yy, xx = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                          jnp.arange(w, dtype=jnp.float32), indexing="ij")
    # init centers at grid cell centers
    cy = (jnp.arange(gh, dtype=jnp.float32) + 0.5) * sy
    cx = (jnp.arange(gw, dtype=jnp.float32) + 0.5) * sx
    cyy, cxx = jnp.meshgrid(cy, cx, indexing="ij")
    # center intensity: sample image at center
    ci = gray[jnp.clip(cyy.astype(jnp.int32), 0, h - 1),
              jnp.clip(cxx.astype(jnp.int32), 0, w - 1)]
    centers = jnp.stack([cyy, cxx, ci])                   # (3, gh, gw)

    # each pixel's home cell
    py = jnp.clip((yy / sy).astype(jnp.int32), 0, gh - 1)
    px = jnp.clip((xx / sx).astype(jnp.int32), 0, gw - 1)

    inv_s2 = 1.0 / (sy * sx)
    inv_m2 = 1.0 / (m * m)

    def step(centers, _):
        best_d = jnp.full((h, w), jnp.inf)
        best_l = jnp.zeros((h, w), jnp.int32)
        cpad = jnp.pad(centers, ((0, 0), (1, 1), (1, 1)), mode="edge")
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                gy = jnp.clip(py + dy, -1, gh)
                gx = jnp.clip(px + dx, -1, gw)
                c_y = cpad[0, gy + 1, gx + 1]
                c_x = cpad[1, gy + 1, gx + 1]
                c_i = cpad[2, gy + 1, gx + 1]
                d = (((yy - c_y) ** 2 + (xx - c_x) ** 2) * inv_s2
                     + (gray - c_i) ** 2 * inv_m2)
                lbl = (jnp.clip(gy, 0, gh - 1) * gw
                       + jnp.clip(gx, 0, gw - 1))
                better = d < best_d
                best_d = jnp.where(better, d, best_d)
                best_l = jnp.where(better, lbl, best_l)
        # update centers by segment means
        n_seg = gh * gw
        flat = best_l.reshape(-1)
        ones = jnp.ones_like(flat, jnp.float32)
        cnt = jax.ops.segment_sum(ones, flat, n_seg)
        s_y = jax.ops.segment_sum(yy.reshape(-1), flat, n_seg)
        s_x = jax.ops.segment_sum(xx.reshape(-1), flat, n_seg)
        s_i = jax.ops.segment_sum(gray.reshape(-1), flat, n_seg)
        denom = jnp.maximum(cnt, 1.0)
        new_centers = jnp.stack([
            (s_y / denom).reshape(gh, gw),
            (s_x / denom).reshape(gh, gw),
            (s_i / denom).reshape(gh, gw)])
        keep = (cnt > 0).reshape(gh, gw)
        new_centers = jnp.where(keep[None], new_centers, centers)
        return new_centers, best_l

    centers, labels = jax.lax.scan(step, centers, None, length=n_iters)
    return labels[-1]


@partial(jax.jit, static_argnames=("n_labels", "n_irls"))
def fit_segment_planes(labels: jax.Array, depth: jax.Array,
                       rays: jax.Array, n_labels: int,
                       n_irls: int = 3, tukey_c: float = 0.02
                       ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Robust plane fit per segment on the 3D points of valid depths.

    Planes are in the depth-parameterization the prior consumes: for pixel
    ray r and plane (a, b, c): 1/depth = a*u + b*v + c with (u, v) = pixel
    coords — the standard inverse-depth-affine model of a 3D plane under a
    pinhole camera, which keeps the fit linear.

    Returns (planes (L, 3), inlier_frac (L,), count (L,)).
    """
    h, w = depth.shape
    yy, xx = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                          jnp.arange(w, dtype=jnp.float32), indexing="ij")
    valid = (depth > 0).reshape(-1)
    flat = labels.reshape(-1)
    u = xx.reshape(-1)
    v = yy.reshape(-1)
    z = 1.0 / jnp.maximum(depth.reshape(-1), 1e-9)      # inverse depth
    wgt = valid.astype(jnp.float32)

    def solve(wgt):
        # weighted LS of z ~ a u + b v + c per segment
        A = jnp.stack([u, v, jnp.ones_like(u)], axis=-1)     # (P, 3)
        AtA = jnp.einsum("pi,pj->pij", A, A) * wgt[:, None, None]
        Atz = A * (z * wgt)[:, None]
        M = jax.ops.segment_sum(AtA.reshape(-1, 9), flat, n_labels)
        b = jax.ops.segment_sum(Atz, flat, n_labels)
        M = M.reshape(n_labels, 3, 3) + 1e-8 * jnp.eye(3)[None]
        return jnp.linalg.solve(M, b[..., None])[..., 0]     # (L, 3)

    planes = solve(wgt)
    for _ in range(n_irls):
        pred = (planes[flat, 0] * u + planes[flat, 1] * v
                + planes[flat, 2])
        r = (z - pred) / tukey_c
        tw = jnp.where(jnp.abs(r) < 1.0, (1 - r ** 2) ** 2, 0.0)
        planes = solve(wgt * tw)

    # inlier stats on the final fit
    pred = planes[flat, 0] * u + planes[flat, 1] * v + planes[flat, 2]
    inl = (jnp.abs(z - pred) < tukey_c) & valid
    cnt = jax.ops.segment_sum(wgt, flat, n_labels)
    icnt = jax.ops.segment_sum(inl.astype(jnp.float32), flat, n_labels)
    frac = icnt / jnp.maximum(cnt, 1.0)
    return planes, frac, cnt


@partial(jax.jit, static_argnames=("n_labels", "min_support",
                                   "min_inlier_frac"))
def prior_depth_map(labels: jax.Array, planes: jax.Array,
                    inlier_frac: jax.Array, count: jax.Array,
                    n_labels: int, min_support: int = 30,
                    min_inlier_frac: float = 0.6) -> jax.Array:
    """Evaluate each pixel's segment plane -> (H, W) prior depth (0 where
    the segment has no trustworthy plane) — the depthMapPrior analog."""
    h, w = labels.shape
    yy, xx = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                          jnp.arange(w, dtype=jnp.float32), indexing="ij")
    p = planes[labels]                                  # (H, W, 3) small L
    inv_z = p[..., 0] * xx + p[..., 1] * yy + p[..., 2]
    depth = 1.0 / jnp.maximum(inv_z, 1e-6)
    ok = ((inlier_frac[labels] >= min_inlier_frac)
          & (count[labels] >= min_support) & (inv_z > 1e-6))
    return jnp.where(ok, depth, 0.0)


def inv_depth_spacing(depth: jax.Array) -> jax.Array:
    """Data-driven residual scale: median |Δ inverse depth| between
    horizontally adjacent valid pixels — the batched analog of the
    reference's CGAL ``compute_average_spacing`` that anchors every
    fransac* threshold (ref: SceneDensify.cpp:1335,1362 —
    ``epsilon = average_spacing * fransacEpsilonMul``).  Returns a traced
    scalar (so per-view values reuse one executable)."""
    z = jnp.where(depth > 0, 1.0 / jnp.maximum(depth, 1e-9), 0.0)
    both = (depth[:, 1:] > 0) & (depth[:, :-1] > 0)
    d = jnp.abs(z[:, 1:] - z[:, :-1])
    d = jnp.where(both, d, jnp.nan)
    med = jnp.nanmedian(d)
    # fall back to scale-relative floors on constant / (near-)empty maps
    zv = jnp.where(depth > 0, z, jnp.nan)
    rng_scale = (jnp.nanmax(zv) - jnp.nanmin(zv)) * 1e-3
    med_z = jnp.nanmedian(zv)
    floor = jnp.where(jnp.isfinite(med_z), jnp.abs(med_z), 1.0) * 1e-4
    med = jnp.where(jnp.isfinite(med) & (med > 1e-12), med, rng_scale)
    return jnp.where(jnp.isfinite(med) & (med > floor), med, floor)


def hyps_from_probability(probability: float, w_inlier: float = 0.5,
                          m: int = 3, lo: int = 32, hi: int = 256) -> int:
    """Host-side mapping of the reference's ``ransacprobability`` knob
    (probability to miss the largest primitive, SceneDensify.cpp:1353) to
    a static hypothesis count: P(miss) = (1 - w^m)^H  =>
    H = log(P) / log(1 - w^m), clamped to [lo, hi] and rounded up to a
    multiple of 32 (static shape reuse across views)."""
    h = math.log(max(probability, 1e-12)) / math.log(1.0 - w_inlier ** m)
    return int(min(hi, max(lo, 32 * math.ceil(h / 32))))


@partial(jax.jit, static_argnames=("n_labels", "m", "n_r"))
def segment_plane_nfa(labels: jax.Array, depth: jax.Array,
                      planes: jax.Array, n_labels: int,
                      spacing: jax.Array, m: int = 3, n_r: int = 12
                      ) -> Tuple[jax.Array, jax.Array]:
    """A-contrario validation of per-segment planes — the AutoEstimator
    (NFA) discipline of the reference's robust plane estimation
    (ref: frame_main/libs/Common/AutoEstimator.h:230 driving
    EstimatePlane*, DepthMap.h:661-664), vectorized over every segment at
    once instead of a per-region RANSAC loop.

    For each segment and each threshold r on a static ladder (geometric,
    anchored at the data-driven ``spacing``), the inlier count k gives

        log NFA(seg, r) = log n_r + log C(n, k) + log C(k, m)
                          + (k - m) * log alpha(r)

    with alpha(r) the EMPIRICAL background probability: the fraction of
    the view's inverse depths landing within r of an UNRELATED plane
    prediction (the prediction field rolled by half the image — the
    permutation-null analog).  An analytic band model (2r / z-range)
    would assume uniform background and badly underestimates alpha when
    the inverse depths are concentrated (z = 1/d piles mass at small z),
    wrongly blessing noise planes.  The per-segment minimum over the
    ladder is the segment's significance: planes with log NFA >= 0 are
    indistinguishable from chance.

    Returns (log_nfa (L,), fine_frac (L,)) where fine_frac is the
    segment's inlier fraction at r = spacing — the "genuinely planar"
    fast-path statistic (a fronto-parallel segment has zero spread, a
    degenerate null, and an undefined NFA; its fine_frac ~ 1 instead).
    """
    h, w = depth.shape
    flat = labels.reshape(-1)
    valid = (depth > 0).reshape(-1)
    z = 1.0 / jnp.maximum(depth.reshape(-1), 1e-9)
    yy, xx = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                          jnp.arange(w, dtype=jnp.float32), indexing="ij")
    u = xx.reshape(-1)
    v = yy.reshape(-1)
    pred = (planes[flat, 0] * u + planes[flat, 1] * v + planes[flat, 2])
    res = jnp.abs(z - pred)

    # empirical null: residuals of points against spatially-unrelated
    # plane predictions (half-image roll decorrelates point and plane)
    p_tot = res.shape[0]
    pred_null = jnp.roll(pred, p_tot // 2)
    valid_null = valid & jnp.roll(valid, p_tot // 2)
    res_null = jnp.abs(z - pred_null)

    # static geometric threshold ladder around the data scale
    ladder = spacing * jnp.asarray(
        np.geomspace(0.5, 64.0, n_r), jnp.float32)          # (n_r,)
    inl = (res[None, :] < ladder[:, None]) & valid[None, :]  # (n_r, P)
    k_r = jax.vmap(lambda row: jax.ops.segment_sum(
        row.astype(jnp.float32), flat, n_labels))(inl)       # (n_r, L)
    n_seg = jax.ops.segment_sum(valid.astype(jnp.float32), flat,
                                n_labels)                    # (L,)
    n_null = jnp.maximum(jnp.sum(valid_null.astype(jnp.float32)), 1.0)
    alpha = (jnp.sum((res_null[None, :] < ladder[:, None])
                     & valid_null[None, :], axis=1) / n_null)  # (n_r,)

    from jax.scipy.special import gammaln

    def log_c(n, k):
        return gammaln(n + 1.0) - gammaln(k + 1.0) - gammaln(
            jnp.maximum(n - k, 0.0) + 1.0)

    log_alpha = jnp.log(jnp.clip(alpha, 1e-12, 1.0))         # (n_r,)
    nfa = (np.log(n_r)
           + log_c(n_seg[None], k_r) + log_c(k_r, float(m))
           + (k_r - m) * log_alpha[:, None])                 # (n_r, L)
    nfa = jnp.where(k_r > m, nfa, jnp.inf)
    log_nfa = jnp.min(nfa, axis=0)
    fine = (res < spacing) & valid
    fine_frac = (jax.ops.segment_sum(fine.astype(jnp.float32), flat,
                                     n_labels)
                 / jnp.maximum(n_seg, 1.0))
    return log_nfa, fine_frac


@partial(jax.jit, static_argnames=("n_labels", "n_hyps", "radius"))
def ransac_segment_planes(key: jax.Array, labels: jax.Array,
                          depth: jax.Array, n_labels: int,
                          n_hyps: int = 64, radius: int = 12,
                          epsilon: float = 0.01
                          ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Static-shape RANSAC plane fit per segment (the vmapped replacement
    for the reference's CGAL Efficient_RANSAC in GenerateDepthPrior /
    GenerateSuperDepthPrior, SceneDensify.cpp:1171-1950; thresholds follow
    the fransacEpsilonMul family of flags).

    Sampling trick that keeps everything static-shape: each hypothesis
    draws one anchor pixel plus two pixels within ``radius`` of it — the
    triplet is valid iff all three share the anchor's segment and carry
    depth.  Each segment then keeps its best-scoring hypothesis (masked
    inlier counting + segment_max), so segments compete only over their
    own anchored hypotheses.

    Planes use the inverse-depth-affine parameterization of
    fit_segment_planes.  Returns (planes (L,3), inlier_frac (L,),
    count (L,)).
    """
    h, w = depth.shape
    flat_lbl = labels.reshape(-1)
    z_flat = 1.0 / jnp.maximum(depth.reshape(-1), 1e-9)
    valid_flat = depth.reshape(-1) > 0
    yy, xx = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                          jnp.arange(w, dtype=jnp.float32), indexing="ij")
    u_flat = xx.reshape(-1)
    v_flat = yy.reshape(-1)

    k0, k1 = jax.random.split(key)
    anchor = jax.random.randint(k0, (n_hyps,), 0, h * w)
    offs = jax.random.randint(k1, (n_hyps, 2, 2), -radius, radius + 1)
    ay = anchor // w
    ax = anchor % w
    py = jnp.clip(ay[:, None] + offs[:, :, 0], 0, h - 1)
    px = jnp.clip(ax[:, None] + offs[:, :, 1], 0, w - 1)
    idx = jnp.concatenate([anchor[:, None], py * w + px], axis=1)  # (K,3)

    seg = flat_lbl[idx[:, 0]]
    same = ((flat_lbl[idx[:, 1]] == seg) & (flat_lbl[idx[:, 2]] == seg)
            & valid_flat[idx].all(axis=1))
    # plane through the 3 samples: [u v 1] p = 1/d
    A = jnp.stack([u_flat[idx], v_flat[idx],
                   jnp.ones_like(u_flat[idx])], axis=-1)       # (K, 3, 3)
    zz = z_flat[idx]                                            # (K, 3)
    det_ok = jnp.abs(jnp.linalg.det(A)) > 1e-6
    A_safe = jnp.where(det_ok[:, None, None], A, jnp.eye(3)[None])
    hyp_planes = jnp.linalg.solve(A_safe, zz[..., None])[..., 0]
    hyp_valid = same & det_ok

    # masked inlier counting: (K, P) residuals restricted to the segment
    pred = (hyp_planes[:, 0:1] * u_flat[None] + hyp_planes[:, 1:2]
            * v_flat[None] + hyp_planes[:, 2:3])                # (K, P)
    in_seg = (flat_lbl[None] == seg[:, None]) & valid_flat[None]
    inl = (jnp.abs(z_flat[None] - pred) < epsilon) & in_seg
    score = jnp.where(hyp_valid, inl.sum(axis=1), -1)           # (K,)

    # per-segment best hypothesis (segment_max + tie-break by match)
    best = jax.ops.segment_max(score, seg, n_labels)            # (L,)
    is_best = hyp_valid & (score == best[seg]) & (score > 0)
    # resolve ties: lowest hypothesis index wins
    hyp_ids = jnp.arange(n_hyps)
    win = jax.ops.segment_min(jnp.where(is_best, hyp_ids, n_hyps), seg,
                              n_labels)                         # (L,)
    has_plane = win < n_hyps
    planes = jnp.where(has_plane[:, None],
                       hyp_planes[jnp.minimum(win, n_hyps - 1)], 0.0)

    # stats of the winning plane over its segment
    pred_seg = (planes[flat_lbl, 0] * u_flat + planes[flat_lbl, 1] * v_flat
                + planes[flat_lbl, 2])
    inl_seg = (jnp.abs(z_flat - pred_seg) < epsilon) & valid_flat
    cnt = jax.ops.segment_sum(valid_flat.astype(jnp.float32), flat_lbl,
                              n_labels)
    icnt = jax.ops.segment_sum(inl_seg.astype(jnp.float32), flat_lbl,
                               n_labels)
    frac = jnp.where(has_plane, icnt / jnp.maximum(cnt, 1.0), 0.0)
    return planes, frac, cnt


def generate_priors(gray: jax.Array, depth: jax.Array, rays: jax.Array,
                    grid_step: int = 16,
                    semantic: "jax.Array | None" = None,
                    n_semantic_labels: int = 0,
                    key: "jax.Array | None" = None,
                    epsilon_mul: float = 1.4,
                    min_points_div: float = 40.0,
                    probability: float = 0.005,
                    nfa_gate: bool = True) -> jax.Array:
    """Full prior pass for one view (the GenerateSuperDepthPrior +
    GenerateDepthPrior + GenerateFinalPrior analog): superpixels on the
    image, robust planes on the current depth, prior depth where planes
    are trustworthy.  With a ``semantic`` label map (the reference's
    nUseSemantic mask path), RANSAC planes fit per semantic region are
    merged over the superpixel prior (semantic wins where valid — the
    GenerateFinalPrior merge, SceneDensify.cpp:1079-1161).

    Threshold discipline mirrors the reference's a-contrario framework
    (AutoEstimator.h:230 + the CGAL Efficient_RANSAC parameter block,
    SceneDensify.cpp:1350-1375): every inlier threshold derives from the
    measured point spacing (``epsilon = spacing * epsilon_mul``, the
    fransacEpsilonMul semantics), minimum support from
    ``count / min_points_div`` (fransacMinPointsDiv), the hypothesis
    budget from ``probability`` (ransacprobability), and — with
    ``nfa_gate`` — each winning plane must be NFA-significant
    (log NFA < 0, segment_plane_nfa) before it may feed the prior blend.
    """
    h, w = gray.shape
    gh = max(h // grid_step, 1)
    gw = max(w // grid_step, 1)
    spacing = inv_depth_spacing(depth)
    eps = spacing * epsilon_mul
    labels = slic_superpixels(gray, grid_step)
    planes, frac, cnt = fit_segment_planes(labels, depth, rays, gh * gw,
                                           tukey_c=eps)
    if nfa_gate:
        log_nfa, fine = segment_plane_nfa(labels, depth, planes, gh * gw,
                                          spacing)
        frac = jnp.where((log_nfa < 0.0) | (fine >= 0.9), frac, 0.0)
    # fransacMinPointsDiv: a segment plane needs >= count/div inliers
    icnt = frac * cnt
    frac = jnp.where(icnt >= cnt / min_points_div, frac, 0.0)
    prior = prior_depth_map(labels, planes, frac, cnt, gh * gw)
    if semantic is not None and n_semantic_labels > 0:
        if key is None:
            key = jax.random.PRNGKey(0)
        sp, sf, sc = ransac_segment_planes(
            key, semantic, depth, n_semantic_labels,
            n_hyps=hyps_from_probability(probability), epsilon=eps)
        if nfa_gate:
            s_nfa, s_fine = segment_plane_nfa(semantic, depth, sp,
                                              n_semantic_labels, spacing)
            sf = jnp.where((s_nfa < 0.0) | (s_fine >= 0.9), sf, 0.0)
        sem_prior = prior_depth_map(semantic, sp, sf, sc,
                                    n_semantic_labels, min_support=100,
                                    min_inlier_frac=0.5)
        prior = jnp.where(sem_prior > 0, sem_prior, prior)
    return prior


def merge_final_prior(ext_prior: jax.Array,
                      super_prior: jax.Array) -> jax.Array:
    """GenerateFinalPrior merge of the externally-ingested (meanshift
    analog) prior channel with the superpixel/semantic prior channel
    (ref: SceneDensify.cpp:1129-1146): per pixel, both zero -> zero;
    external zero -> superpixel prior; external nonzero -> the external
    prior WINS (the reference's else-branch takes meanshiftpriors over
    superpriors whenever the meanshift value is nonzero)."""
    return jnp.where(ext_prior > 0, ext_prior,
                     jnp.where(super_prior > 0, super_prior, 0.0))
