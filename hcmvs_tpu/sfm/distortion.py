"""Brown radial lens-distortion model for the real-photo SfM frontend.

The reference pipeline starts from photographs: OpenMVG seeds intrinsics
from EXIF (ref: frame_main/MvgMvsPipeline.py:181-183
openMVG_main_SfMInit_ImageListing) with a radial-K3 camera model, refines
the distortion coefficients inside bundle adjustment, and UNDISTORTS the
images at `.mvs` export so the MVS stage sees pinhole cameras (ref:
MvgMvsPipeline.py:208-210 openMVG_main_openMVG2openMVS; OpenMVS's camera
model is distortion-free, Camera.h).

Batched design: the model acts in normalized camera coordinates,
  x_d = x_n * (1 + k1 r^2 + k2 r^4 + k3 r^6),   r^2 = |x_n|^2
with the inverse solved by a fixed-count Newton iteration (jit-friendly —
no data-dependent loops).  Estimation is ALTERNATED with the pose/point
bundle (sfm/ba.py): poses+points fixed -> Gauss-Newton on (k1,k2,k3) over
all observations (a 3-parameter dense solve, vmapped residuals) ->
observations undistorted with the new k -> pose/point BA re-run.  Two
rounds converge for photographic distortion levels (|k1| <= 0.3); this
avoids widening the Schur reduced system with global intrinsic columns
while optimizing the same joint objective.
"""

from __future__ import annotations

from functools import partial
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def distort_normalized(xn: jax.Array, k: jax.Array) -> jax.Array:
    """Apply Brown radial distortion to (..., 2) normalized coords."""
    r2 = jnp.sum(xn ** 2, axis=-1, keepdims=True)
    factor = 1.0 + r2 * (k[0] + r2 * (k[1] + r2 * k[2]))
    return xn * factor


def undistort_normalized(xd: jax.Array, k: jax.Array,
                         n_iters: int = 8) -> jax.Array:
    """Invert the radial model by Newton on the scalar radius.

    With s = |x_n| and g(s) = s (1 + k1 s^2 + k2 s^4 + k3 s^6) = |x_d|,
    solve g(s) = rd per point; the direction of x_n equals x_d's.  Eight
    iterations reach float32 roundoff for |k1| <= 0.5 over the unit disc.
    """
    rd = jnp.linalg.norm(xd, axis=-1, keepdims=True)

    def body(_, s):
        s2 = s * s
        g = s * (1.0 + s2 * (k[0] + s2 * (k[1] + s2 * k[2])))
        dg = 1.0 + s2 * (3.0 * k[0] + s2 * (5.0 * k[1] + s2 * 7.0 * k[2]))
        return s - (g - rd) / jnp.where(jnp.abs(dg) < 1e-6, 1e-6, dg)

    s = jax.lax.fori_loop(0, n_iters, body, rd)
    scale = jnp.where(rd > 1e-12, s / jnp.maximum(rd, 1e-12), 1.0)
    return xd * scale


def distort_points_px(uv: jax.Array, K: jax.Array,
                      k: jax.Array) -> jax.Array:
    """Ideal pixel coords -> observed (distorted) pixel coords."""
    f = jnp.array([K[0, 0], K[1, 1]])
    c = jnp.array([K[0, 2], K[1, 2]])
    return distort_normalized((uv - c) / f, k) * f + c


def undistort_points_px(uv: jax.Array, K: jax.Array, k: jax.Array,
                        n_iters: int = 8) -> jax.Array:
    """Observed (distorted) pixel coords -> ideal pinhole pixel coords."""
    f = jnp.array([K[0, 0], K[1, 1]])
    c = jnp.array([K[0, 2], K[1, 2]])
    return undistort_normalized((uv - c) / f, k, n_iters) * f + c


@partial(jax.jit, static_argnames=())
def _undistort_image_jit(img: jax.Array, K: jax.Array,
                         k: jax.Array) -> jax.Array:
    """Resample a distorted image onto the pinhole grid: the output pixel
    at ideal coords p samples the input at distort(p) (forward model — no
    iteration needed for image undistortion)."""
    h, w = img.shape
    yy, xx = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                          jnp.arange(w, dtype=jnp.float32), indexing="ij")
    uv = jnp.stack([xx, yy], axis=-1).reshape(-1, 2)
    src = distort_points_px(uv, K, k).reshape(h, w, 2)
    x, y = src[..., 0], src[..., 1]
    x0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, w - 2)
    y0 = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, h - 2)
    fx = jnp.clip(x - x0, 0.0, 1.0)
    fy = jnp.clip(y - y0, 0.0, 1.0)
    out = ((img[y0, x0] * (1 - fx) + img[y0, x0 + 1] * fx) * (1 - fy)
           + (img[y0 + 1, x0] * (1 - fx) + img[y0 + 1, x0 + 1] * fx) * fy)
    inside = ((x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1))
    return jnp.where(inside, out, 0.0)


def undistort_image(img: np.ndarray, K: np.ndarray,
                    k: np.ndarray) -> np.ndarray:
    """Host wrapper: undistort a (H, W) grayscale or (H, W, C) image."""
    Kj = jnp.asarray(K, jnp.float32)
    kj = jnp.asarray(k, jnp.float32)
    if img.ndim == 2:
        return np.asarray(_undistort_image_jit(jnp.asarray(img, jnp.float32),
                                               Kj, kj)).astype(img.dtype)
    chans = [np.asarray(_undistort_image_jit(
        jnp.asarray(img[..., c], jnp.float32), Kj, kj))
        for c in range(img.shape[-1])]
    return np.stack(chans, axis=-1).astype(img.dtype)


@partial(jax.jit, static_argnames=("n_iters", "n_coeffs"))
def _fit_k(xn_proj: jax.Array, xd_obs: jax.Array, valid: jax.Array,
           k0: jax.Array, n_iters: int = 10,
           n_coeffs: int = 2) -> jax.Array:
    """Gauss-Newton on the distortion coefficients with geometry fixed.

    ``xn_proj`` (M, 2): ideal normalized projections of the current
    points through the current poses; ``xd_obs`` (M, 2): observed
    (distorted) normalized feature coords.  Solves for k minimizing
    |distort(xn_proj; k) - xd_obs|^2 — linear in k per observation, so GN
    converges in one step per linearization; iterations only re-weight.
    ``n_coeffs`` limits the model order (k1 only / k1,k2 / k1..k3) —
    higher orders need wide-angle coverage to be identifiable.
    """
    r2 = jnp.sum(xn_proj ** 2, axis=-1, keepdims=True)    # (M, 1)
    # residual: xn * (1 + k1 r2 + k2 r4 + k3 r6) - xd  => design matrix in k
    # rows: per obs, per component: [xn*r2, xn*r4, xn*r6] . k = xd - xn
    basis = jnp.concatenate([xn_proj * r2, xn_proj * r2 ** 2,
                             xn_proj * r2 ** 3], axis=-1)  # (M, 6) paired
    A = basis.reshape(-1, 3, 2).transpose(0, 2, 1).reshape(-1, 3)  # (2M, 3)
    b = (xd_obs - xn_proj).reshape(-1)                     # (2M,)
    wv = jnp.repeat(valid.astype(jnp.float32), 2)

    def body(_, k):
        # robust reweighting (Huber in normalized units ~ 4px at f=800)
        pred = A @ k
        res = pred - b
        w = wv * jnp.minimum(1.0, 5e-3 / jnp.maximum(jnp.abs(res), 1e-9))
        AtA = (A * w[:, None]).T @ A + 1e-9 * jnp.eye(3)
        Atb = (A * w[:, None]).T @ b
        # freeze unused higher-order coefficients at zero
        mask = jnp.arange(3) < n_coeffs
        AtA = jnp.where(mask[:, None] & mask[None, :], AtA,
                        jnp.eye(3) * 1.0 + 0.0 * AtA)
        Atb = jnp.where(mask, Atb, 0.0)
        return jnp.linalg.solve(AtA, Atb)

    return jax.lax.fori_loop(0, n_iters, body, k0)


def estimate_distortion(result, K: np.ndarray,
                        n_coeffs: int = 2) -> np.ndarray:
    """Fit Brown radial coefficients from an SfM result's raw (distorted)
    observations with poses/points fixed (the alternation half-step).

    ``result``: sfm.incremental.SfMResult whose keypoints are the RAW
    detections.  Returns k (3,) float32 (unused orders zero).
    """
    obs_xn, obs_xd = [], []
    f = np.array([K[0, 0], K[1, 1]])
    c = np.array([K[0, 2], K[1, 2]])
    for tid, obs in enumerate(result.track_obs):
        X = result.points[tid]
        for (img, kp) in obs:
            if img not in result.poses:
                continue
            R, C = result.poses[img]
            Xc = R @ (X - C)
            if Xc[2] <= 1e-6:
                continue
            obs_xn.append(Xc[:2] / Xc[2])
            obs_xd.append((result.keypoints[img][kp] - c) / f)
    if len(obs_xn) < 50:
        return np.zeros(3, np.float32)
    xn = jnp.asarray(np.stack(obs_xn), jnp.float32)
    xd = jnp.asarray(np.stack(obs_xd), jnp.float32)
    k = _fit_k(xn, xd, jnp.ones(len(obs_xn), bool),
               jnp.zeros(3, jnp.float32), n_coeffs=n_coeffs)
    return np.asarray(k)


def _rebundle(cur, raw_xy: List[np.ndarray], K: np.ndarray,
              k: np.ndarray, n_iters: int = 15):
    """Re-run the pose/point bundle under distortion model ``k``.

    The residual is distortion-aware against the RAW observations
    (sfm/ba.py applies ``k`` to the prediction), so the returned RMS
    lives in the raw measurement space and is comparable ACROSS models —
    undistorting observations first would rescale the measurement space
    (an inward-warping k shrinks every residual) and make the line
    search prefer maximal compression instead of the true model.
    Returns (result', rms_px) with result'.keypoints undistorted for the
    downstream pinhole stages."""
    import dataclasses as _dc

    from hcmvs_tpu.sfm.ba import (BAState, build_problem, rodrigues,
                                  rotation_to_rvec, run_ba)

    reg = sorted(cur.poses)
    cam_of = {img: ci for ci, img in enumerate(reg)}
    obs_cam, obs_pt, obs_uv = [], [], []
    for tid, obs in enumerate(cur.track_obs):
        for (img, kp) in obs:
            if img in cam_of:
                obs_cam.append(cam_of[img])
                obs_pt.append(tid)
                obs_uv.append(raw_xy[img][kp])
    Ks = np.tile(K[None], (len(reg), 1, 1))
    problem = build_problem(Ks, obs_cam, obs_pt, obs_uv, len(cur.points),
                            fixed_cams=[ci == 0 for ci in range(len(reg))],
                            dist=k)
    rvecs = np.stack([rotation_to_rvec(cur.poses[img][0]) for img in reg])
    # poses stored as (R, C); BA state wants t = -R C
    tvecs = np.stack([-cur.poses[img][0] @ cur.poses[img][1]
                      for img in reg])
    state = BAState(rvecs=jnp.asarray(rvecs, jnp.float32),
                    tvecs=jnp.asarray(tvecs, jnp.float32),
                    points=jnp.asarray(cur.points, jnp.float32))
    state, cost = run_ba(problem, state, n_iters)
    poses = {}
    for ci, img in enumerate(reg):
        Rn = np.asarray(rodrigues(state.rvecs[ci]))
        tn = np.asarray(state.tvecs[ci])
        poses[img] = (Rn, -Rn.T @ tn)
    rms = float(np.sqrt(cost / max(len(obs_cam), 1)))
    xy_u = [np.asarray(undistort_points_px(
        jnp.asarray(x, jnp.float32), jnp.asarray(K, jnp.float32),
        jnp.asarray(k, jnp.float32))) for x in raw_xy]
    return _dc.replace(cur, poses=poses, points=np.asarray(state.points),
                       keypoints=xy_u, reproj_rms=rms), rms


# k1 candidates for the bootstrap line search (photographic barrel/
# pincushion range); all candidates share one compiled BA executable.
K1_GRID = (-0.30, -0.20, -0.12, -0.06, 0.0, 0.06, 0.12, 0.20, 0.30)


def refine_with_distortion(result, K: np.ndarray, cfg=None,
                           n_rounds: int = 2, n_coeffs: int = 2,
                           k1_grid=K1_GRID,
                           verbose: bool = False
                           ) -> Tuple[object, np.ndarray]:
    """Estimate radial distortion jointly with the bundle.

    Two phases:
    1. **k1 line search with re-bundling.** SfM run on distorted
       observations absorbs much of the distortion into poses/points, so
       a geometry-fixed fit from that optimum reads k ~ 0 (measured: the
       k1=-0.15 ridge golden fit 0.005 without this phase).  Distortion
       cannot be absorbed *consistently* across views with parallax, so
       re-bundling under each candidate k1 and comparing final RMS
       identifies the model: the grid winner's bundle is the one the
       observations actually satisfy.
    2. **Alternation.** From the winner's geometry: geometry-fixed GN fit
       of (k1, k2) -> undistort observations -> pose/point BA; repeated
       ``n_rounds`` times (coordinate descent on the joint objective —
       the analog of OpenMVG refining radial K3 inside BA, ref:
       MvgMvsPipeline.py:190-192).

    Returns (result_undistorted, k): the result's keypoints are replaced
    by their undistorted coordinates (pinhole geometry — ready for
    sfm_to_scene + dense), poses/points re-bundled against them.
    """
    import dataclasses as _dc

    raw_xy = [np.asarray(x) for x in result.keypoints]
    best_k1, best_rms, best_res = 0.0, np.inf, result
    rms_zero = None
    for k1 in k1_grid:
        cand, rms = _rebundle(result, raw_xy, K,
                              np.array([k1, 0.0, 0.0], np.float32),
                              n_iters=12)
        if verbose:
            print(f"[distortion] grid k1={k1:+.2f}: rms {rms:.4f}px")
        if k1 == 0.0:
            rms_zero = rms
        if rms < best_rms:
            best_k1, best_rms, best_res = k1, rms, cand
    cur = best_res
    k = np.array([best_k1, 0.0, 0.0], np.float32)
    for rnd in range(n_rounds):
        k = estimate_distortion(
            _dc.replace(cur, keypoints=raw_xy), K, n_coeffs)
        cur, rms = _rebundle(cur, raw_xy, K, k, n_iters=15)
        if verbose:
            print(f"[distortion] round {rnd}: k = {k}, rms {rms:.4f}px")
    # significance gate: on genuinely pinhole photos the rms(k) curve is
    # flat and the fit returns a small spurious model (measured -0.06 on
    # undistorted JPEGs at a 0.03% rms gain); warping images with it
    # would only add resampling error — require a real improvement
    if rms_zero is not None and rms > rms_zero * (1.0 - 0.005):
        if verbose:
            print(f"[distortion] improvement {rms_zero:.4f} -> "
                  f"{rms:.4f}px below the 0.5% gate; keeping pinhole")
        cur, _ = _rebundle(result, raw_xy, K, np.zeros(3, np.float32),
                           n_iters=15)
        return cur, np.zeros(3, np.float32)
    return cur, k
