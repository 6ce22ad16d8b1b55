"""Global SfM: rotation averaging + translation averaging + triangulation.

The counterpart of the reference pipeline's GLOBAL preset
(ref: frame_main/MvgMvsPipeline.py:193-195 step 4 openMVG_main_GlobalSfM —
openMVG's global pipeline runs L1 rotation averaging and L-infinity / LS
translation averaging over the epipolar graph, then triangulates tracks
and bundle-adjusts).  Data-parallel formulation:

- Pairwise relative poses come from the vmapped essential-matrix RANSAC
  (sfm/two_view.py) over all candidate pairs.
- Rotation averaging: chordal least squares — stack the linear constraints
  R_j ~ R_ij R_i over all pairs, solve the 3N x 3 eigen/LS system, project
  to SO(3) by SVD, IRLS-reweight by consistency (robust to bad pairs).
- Translation averaging: with rotations fixed, each pair constrains the
  camera centers by the epipolar direction: C_j - C_i ∥ d_ij where
  d_ij = -R_i^T t_ij; solved as least squares on the cross-product
  constraints with gauge fixed (C_ref = 0, mean baseline = 1).
- Tracks: union-find over pairwise matches; triangulation: midpoint over
  the two widest-baseline observations; refinement: the shared LM bundle
  adjustment (sfm/ba.py) over all poses + points.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from hcmvs_tpu.sfm.incremental import (SfMConfig, SfMResult, _normalize,
                                       compute_features_and_matches)
from hcmvs_tpu.sfm.two_view import ransac_essential, triangulate_midpoint


def _project_so3(M: np.ndarray) -> np.ndarray:
    U, _, Vt = np.linalg.svd(M)
    R = U @ Vt
    if np.linalg.det(R) < 0:
        U[:, -1] *= -1
        R = U @ Vt
    return R


def rotation_averaging(n: int, pairs: List[Tuple[int, int]],
                       R_rel: List[np.ndarray], n_irls: int = 4,
                       sigma: float = 0.1) -> np.ndarray:
    """Global rotations from pairwise R_ij (R_j = R_ij R_i), chordal LS
    with IRLS.  Returns (N, 3, 3) with R_0 = I (gauge)."""
    m = len(pairs)
    w = np.ones(m)
    R = np.stack([np.eye(3)] * n)
    for _ in range(n_irls + 1):
        # linear system over the 3x3 blocks: R_j - R_ij R_i = 0; gauge
        # row R_0 = I.  Unknown X is (3N, 3) stacking R_i^T? Use R_i as
        # 3x3 blocks of a (3N, 3) matrix: rows 3i..3i+3 hold R_i.
        A = np.zeros((3 * m + 3, 3 * n))
        B = np.zeros((3 * m + 3, 3))
        for e, (i, j) in enumerate(pairs):
            # R_j = R_ij R_i  ->  rows: -sqrt(w) R_ij @ R_i + sqrt(w) R_j
            sw = np.sqrt(w[e])
            A[3 * e:3 * e + 3, 3 * j:3 * j + 3] = sw * np.eye(3)
            A[3 * e:3 * e + 3, 3 * i:3 * i + 3] = -sw * R_rel[e]
        A[3 * m:, 0:3] = 10.0 * np.eye(3)
        B[3 * m:] = 10.0 * np.eye(3)
        X, *_ = np.linalg.lstsq(A, B, rcond=None)
        R = np.stack([_project_so3(X[3 * i:3 * i + 3]) for i in range(n)])
        # reweight by chordal consistency (Geman-McClure: outlier edges
        # decay quadratically so a grossly wrong pair stops biasing)
        for e, (i, j) in enumerate(pairs):
            r = np.linalg.norm(R[j] - R_rel[e] @ R[i]) / np.sqrt(8.0)
            w[e] = 1.0 / (1.0 + (r / sigma) ** 2) ** 2
    # re-gauge: R_0 exactly identity
    R0 = R[0].copy()
    return np.stack([Ri @ R0.T for Ri in R])


def translation_averaging(n: int, pairs: List[Tuple[int, int]],
                          R_glob: np.ndarray, t_rel: List[np.ndarray],
                          n_irls: int = 4, sigma: float = 0.05
                          ) -> np.ndarray:
    """Camera centers from pairwise translation directions.

    For pair (i, j) with relative translation t_ij (cam_i -> cam_j frame):
    t_ij = -R_j (C_j - C_i), so the world-frame baseline direction is
    d_ij = -R_j^T t_ij (unit).  Constraint: (C_j - C_i) x d_ij = 0.
    LS with gauge C_0 = 0 and the summed baseline projection fixed (scale),
    IRLS for robustness.
    """
    m = len(pairs)
    dirs = np.zeros((m, 3))
    for e, (i, j) in enumerate(pairs):
        d = -(R_glob[j].T @ t_rel[e])
        nd = np.linalg.norm(d)
        dirs[e] = d / max(nd, 1e-12)
    w = np.ones(m)
    C = np.zeros((n, 3))
    for _ in range(n_irls + 1):
        rows, rhs = [], []
        for e, (i, j) in enumerate(pairs):
            d = dirs[e]
            Dx = np.array([[0, -d[2], d[1]], [d[2], 0, -d[0]],
                           [-d[1], d[0], 0]])
            r = np.zeros((3, 3 * n))
            r[:, 3 * j:3 * j + 3] = Dx
            r[:, 3 * i:3 * i + 3] = -Dx
            rows.append(np.sqrt(w[e]) * r)
            rhs.append(np.zeros(3))
        # gauge: C_0 = 0
        g = np.zeros((3, 3 * n))
        g[:, 0:3] = 10.0 * np.eye(3)
        rows.append(g)
        rhs.append(np.zeros(3))
        # scale: sum of baseline projections along dirs = m (avoids the
        # trivial zero solution)
        s = np.zeros((1, 3 * n))
        for e, (i, j) in enumerate(pairs):
            s[0, 3 * j:3 * j + 3] += dirs[e]
            s[0, 3 * i:3 * i + 3] -= dirs[e]
        rows.append(s)
        rhs.append(np.array([float(m)]))
        A = np.concatenate(rows)
        B = np.concatenate(rhs)
        X, *_ = np.linalg.lstsq(A, B, rcond=None)
        C = X.reshape(n, 3)
        for e, (i, j) in enumerate(pairs):
            b = C[j] - C[i]
            nb = np.linalg.norm(b)
            r = np.linalg.norm(np.cross(b / max(nb, 1e-9), dirs[e]))
            w[e] = 1.0 / (1.0 + (r / sigma) ** 2) ** 2
    return C


def _build_tracks(n: int, xy: List[np.ndarray],
                  pair_matches: Dict[Tuple[int, int], np.ndarray]):
    """Union-find over keypoint identities -> track lists."""
    parent: Dict[Tuple[int, int], Tuple[int, int]] = {}

    def find(a):
        while parent.setdefault(a, a) != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for (i, j), pairs in pair_matches.items():
        for a, b in pairs:
            ra, rb = find((i, int(a))), find((j, int(b)))
            if ra != rb:
                parent[ra] = rb
    groups: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    for kp in list(parent.keys()):
        groups.setdefault(find(kp), []).append(kp)
    tracks = []
    for members in groups.values():
        imgs = [m[0] for m in members]
        if len(members) >= 2 and len(set(imgs)) == len(imgs):
            tracks.append(sorted(members))
    return tracks


def global_sfm(images: List[np.ndarray], K: np.ndarray,
               cfg: Optional[SfMConfig] = None,
               verbose: bool = False) -> SfMResult:
    cfg = cfg or SfMConfig()
    xy, valid, pair_matches = compute_features_and_matches(images, cfg)
    return global_sfm_from_matches(xy, pair_matches, K, len(images), cfg,
                                   verbose)


def global_sfm_from_matches(xy: List[np.ndarray],
                            pair_matches: Dict[Tuple[int, int], np.ndarray],
                            K: np.ndarray, n: int,
                            cfg: Optional[SfMConfig] = None,
                            verbose: bool = False) -> SfMResult:
    cfg = cfg or SfMConfig()
    key = jax.random.PRNGKey(0)

    # 1. relative poses on every pair
    pairs, R_rel, t_rel, pair_inl = [], [], [], {}
    for (i, j), pm in sorted(pair_matches.items()):
        p0 = _normalize(xy[i][pm[:, 0]], K).astype(np.float32)
        p1 = _normalize(xy[j][pm[:, 1]], K).astype(np.float32)
        key, sub = jax.random.split(key)
        res = ransac_essential(sub, jnp.asarray(p0), jnp.asarray(p1),
                               jnp.ones(len(p0), bool),
                               cfg.ransac_threshold,
                               adaptive=cfg.adaptive_ransac)
        if int(res.n_inliers) < cfg.min_matches:
            continue
        pairs.append((i, j))
        R_rel.append(np.asarray(res.R))
        t_rel.append(np.asarray(res.t))
        pair_inl[(i, j)] = np.asarray(res.inliers)
    if not pairs:
        raise ValueError("no pair passed two-view RANSAC")
    connected = sorted({i for p in pairs for i in p})
    if verbose:
        print(f"[gsfm] {len(pairs)} pairs over {len(connected)} cameras")

    # 2. rotation + translation averaging
    R_glob = rotation_averaging(n, pairs, R_rel)
    C_glob = translation_averaging(n, pairs, R_glob, t_rel)

    # 3. tracks + triangulation from the two widest-baseline observations
    tracks = _build_tracks(n, xy, pair_matches)
    points, track_obs = [], []
    for members in tracks:
        best, best_base = None, -1.0
        for a in range(len(members)):
            for b in range(a + 1, len(members)):
                i, j = members[a][0], members[b][0]
                base = np.linalg.norm(C_glob[j] - C_glob[i])
                if base > best_base:
                    best, best_base = (members[a], members[b]), base
        (i, ka), (j, kb) = best
        # relative pose i->j from globals
        Rij = R_glob[j] @ R_glob[i].T
        tij = -R_glob[j] @ (C_glob[j] - C_glob[i])
        p0 = _normalize(xy[i][None, ka], K).astype(np.float32)
        p1 = _normalize(xy[j][None, kb], K).astype(np.float32)
        X, z0 = triangulate_midpoint(jnp.asarray(Rij, jnp.float32),
                                     jnp.asarray(tij, jnp.float32),
                                     jnp.asarray(p0), jnp.asarray(p1))
        Xi = np.asarray(X)[0]
        if float(z0[0]) <= 0:
            continue
        # cam_i coords -> world
        Xw = R_glob[i].T @ Xi + C_glob[i]
        points.append(Xw)
        track_obs.append([(img, int(kp)) for img, kp in members])
    if verbose:
        print(f"[gsfm] {len(points)} triangulated tracks")
    if not points:
        raise ValueError("triangulation produced no points")

    # 4. global bundle adjustment (shared LM engine)
    from hcmvs_tpu.sfm.ba import (BAState, build_problem,
                                  rotation_to_rvec, run_ba)
    reg = connected
    cam_of = {img: c for c, img in enumerate(reg)}
    obs_cam, obs_pt, obs_uv = [], [], []
    for tid, obs in enumerate(track_obs):
        for img, kp in obs:
            if img in cam_of:
                obs_cam.append(cam_of[img])
                obs_pt.append(tid)
                obs_uv.append(xy[img][kp])
    Ks = np.tile(K[None], (len(reg), 1, 1))
    problem = build_problem(Ks, np.asarray(obs_cam), np.asarray(obs_pt),
                            np.asarray(obs_uv, np.float32), len(points),
                            fixed_cams=[img == reg[0] for img in reg])
    rvecs = np.stack([rotation_to_rvec(R_glob[i]) for i in reg])
    tvecs = np.stack([-R_glob[i] @ C_glob[i] for i in reg])
    state = BAState(rvecs=jnp.asarray(rvecs, jnp.float32),
                    tvecs=jnp.asarray(tvecs, jnp.float32),
                    points=jnp.asarray(np.stack(points), jnp.float32))
    state, cost = run_ba(problem, state, cfg.final_ba_iters)
    rms = float(np.sqrt(float(cost) / max(len(obs_cam), 1)))

    from hcmvs_tpu.sfm.ba import rodrigues
    out_poses = {}
    for img in reg:
        c = cam_of[img]
        R = np.asarray(rodrigues(state.rvecs[c]))
        t = np.asarray(state.tvecs[c])
        out_poses[img] = (R, -R.T @ t)
    return SfMResult(poses=out_poses, points=np.asarray(state.points),
                     track_obs=track_obs, keypoints=xy,
                     reproj_rms=float(rms))
