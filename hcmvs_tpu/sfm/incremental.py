"""Incremental structure-from-motion driver.

The batched replacement for the OpenMVG pipeline the reference shells
out to (ref: frame_main/MvgMvsPipeline.py:181-192 — SfMInit_ImageListing,
ComputeFeatures, ComputeMatches, IncrementalSfM): feature detection,
matching, two-view init, PnP registration and bundle adjustment all run as
jitted device programs; only the track bookkeeping (ragged, data-dependent)
stays on host, exactly the split the build plan prescribes (SURVEY §2.3).

Output plugs straight into ``io.mvs.SceneMVS`` for the dense stage.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from hcmvs_tpu.io.mvs import (CameraIntrinsic, ImageRecord, Platform, Pose,
                              SceneMVS)
from hcmvs_tpu.sfm.ba import (BAState, build_problem, rodrigues,
                              rotation_to_rvec, run_ba)
from hcmvs_tpu.sfm.features import (detect_and_describe,
                                    detect_and_describe_pyramid)
from hcmvs_tpu.sfm.matching import match_descriptors
from hcmvs_tpu.sfm.pnp import ransac_pnp
from hcmvs_tpu.sfm.two_view import ransac_essential, triangulate_midpoint


@dataclasses.dataclass
class SfMConfig:
    max_keypoints: int = 1024
    n_octaves: int = 3       # downsampled DoG octaves (OpenMVG-SIFT
                             # scale coverage; 1 = single-octave)
    match_ratio: float = 0.8
    min_matches: int = 30
    ransac_threshold: float = 2e-5   # squared Sampson, normalized coords
                                     # (fallback / homography-check scale)
    adaptive_ransac: bool = True     # a-contrario (AC-RANSAC/ORSA) mode
                                     # for the two-view E estimation: the
                                     # inlier threshold becomes the
                                     # data-driven NFA optimum instead of
                                     # the fixed ransac_threshold — the
                                     # reference's AutoEstimator driver
                                     # (AutoEstimator.h:230), which is
                                     # what lets the frontend run
                                     # unattended across noise scales.
                                     # Measured A/B (r5, ridge golden +
                                     # noise-scale gates): parity at the
                                     # calibrated scale, strictly better
                                     # across 10x noise (see
                                     # tests/test_sfm.py adaptive gates).
    pnp_threshold: float = 1e-4
    min_pnp_inliers: int = 12
    ba_every: int = 3
    final_ba_iters: int = 25
    max_homography_ratio: float = 0.85  # init pairs with H/E inlier ratio
                                        # above this are planar-degenerate
    max_init_pairs: int = 40            # only the best pairs (by match
                                        # count) run init two-view RANSAC
                                        # — scanning all O(N^2) pairs is
                                        # pointless at 50+ images
    match_window: int = 0               # 0 = exhaustive pairwise matching;
                                        # k > 0 = only pairs |i - j| <= k
                                        # (OpenMVG's VIDEO_MODE_MATCHING
                                        # analog — O(N k) instead of
                                        # O(N^2) pairs; required for
                                        # bounded time at 200+ images)
    ba_growth: float = 0.0              # 0 = global BA every ba_every
                                        # registrations; g > 1 = geometric
                                        # schedule (BA when the map grew
                                        # by factor g since the last BA) —
                                        # O(log N) bundles instead of
                                        # O(N / ba_every), the standard
                                        # incremental-SfM scaling move


@dataclasses.dataclass
class SfMResult:
    poses: Dict[int, Tuple[np.ndarray, np.ndarray]]  # img -> (R, C)
    points: np.ndarray                               # (P, 3)
    track_obs: List[List[Tuple[int, int]]]           # per point: (img, kp)
    keypoints: List[np.ndarray]                      # per image (K, 2)
    reproj_rms: float = 0.0


def _normalize(uv: np.ndarray, K: np.ndarray) -> np.ndarray:
    return (uv - K[:2, 2]) / np.array([K[0, 0], K[1, 1]])


def _bucket_pad(*arrays, valid=None, min_size: int = 64):
    """Pad leading dims to the next power of two (>= min_size) with a
    validity mask: every variable-length RANSAC/triangulation input maps
    onto a handful of compiled shapes instead of one executable per match
    count (a 50-image scene has ~1000 distinct counts — compiling each
    aborted CI with exhausted memory)."""
    m = arrays[0].shape[0]
    size = min_size
    while size < m:
        size *= 2
    pad = size - m
    out = [np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1)) for a in arrays]
    v = np.zeros(size, bool)
    v[:m] = True if valid is None else valid
    return (*out, v)


def compute_features_and_matches(images: List[np.ndarray],
                                 cfg: SfMConfig):
    """Stage 1+2: per-image features and pairwise matches (device)."""
    n = len(images)
    kps = [(detect_and_describe_pyramid(jnp.asarray(im),
                                        cfg.max_keypoints,
                                        cfg.n_octaves)
            if cfg.n_octaves > 1 else
            detect_and_describe(jnp.asarray(im), cfg.max_keypoints))
           for im in images]
    xy = [np.asarray(k.xy) for k in kps]
    valid = [np.asarray(k.score) > 0 for k in kps]
    pair_matches: Dict[Tuple[int, int], np.ndarray] = {}
    for i in range(n):
        for j in range(i + 1, n):
            if cfg.match_window and j - i > cfg.match_window:
                continue
            m = match_descriptors(kps[i].desc, kps[j].desc,
                                  jnp.asarray(valid[i]),
                                  jnp.asarray(valid[j]), cfg.match_ratio)
            mi = np.asarray(m.idx)
            mv = np.asarray(m.valid)
            pairs = np.stack([np.nonzero(mv)[0], mi[mv]], axis=1)
            if len(pairs) >= cfg.min_matches:
                pair_matches[(i, j)] = pairs
    return xy, valid, pair_matches


def incremental_sfm(images: List[np.ndarray], K: np.ndarray,
                    cfg: Optional[SfMConfig] = None,
                    verbose: bool = False) -> SfMResult:
    cfg = cfg or SfMConfig()
    xy, valid, pair_matches = compute_features_and_matches(images, cfg)
    return sfm_from_matches(xy, pair_matches, K, len(images), cfg, verbose)


def sfm_from_matches(xy: List[np.ndarray],
                     pair_matches: Dict[Tuple[int, int], np.ndarray],
                     K: np.ndarray, n: int,
                     cfg: Optional[SfMConfig] = None,
                     verbose: bool = False) -> SfMResult:
    """Stages 3-6 from precomputed keypoints + matches (the track,
    registration, and BA machinery — testable independently of the
    feature front end)."""
    cfg = cfg or SfMConfig()
    key = jax.random.PRNGKey(0)

    if not pair_matches:
        raise ValueError("no image pairs with enough matches")

    # 3. init pair: two-view RANSAC on every candidate, pick the pair with
    # the most E inliers among pairs NOT explained by a homography —
    # OpenMVG's AUTO model selection (a pair whose matches a homography
    # explains is planar / low-parallax and degenerate for initialization)
    from hcmvs_tpu.sfm.two_view import ransac_homography
    best_pair, best_res, best_inl = None, None, -1
    fallback = (None, None, -1)
    init_pairs = sorted(pair_matches, key=lambda p: -len(pair_matches[p]))
    for (i, j) in init_pairs[:cfg.max_init_pairs]:
        pairs = pair_matches[(i, j)]
        p0 = _normalize(xy[i][pairs[:, 0]], K).astype(np.float32)
        p1 = _normalize(xy[j][pairs[:, 1]], K).astype(np.float32)
        p0, p1, vmask = _bucket_pad(p0, p1)
        key, sub = jax.random.split(key)
        res = ransac_essential(sub, jnp.asarray(p0), jnp.asarray(p1),
                               jnp.asarray(vmask),
                               cfg.ransac_threshold,
                               adaptive=cfg.adaptive_ransac)
        n_inl = int(res.n_inliers)
        key, sub = jax.random.split(key)
        # the H-vs-E planarity guard stays at the FIXED calibrated scale:
        # a pair-specific (NFA) threshold weakens exactly the planar
        # pairs the guard exists to reject (tight E threshold shrinks the
        # denominator faster than the H count) — measured on the
        # dolly-zoom golden (r5)
        hres = ransac_homography(sub, jnp.asarray(p0), jnp.asarray(p1),
                                 jnp.asarray(vmask),
                                 2.0 * cfg.ransac_threshold)
        h_ratio = int(hres.n_inliers) / max(n_inl, 1)
        # fallback ranking for the all-planar case: weight support by how
        # much of it the homography does NOT explain — raw max-inliers
        # favors short-baseline lateral pairs (the most degenerate ones),
        # while n*(1-ratio) prefers the pair with the most genuinely
        # non-planar parallax (e.g. the dolly pairs on a plane scene)
        fb_score = n_inl * max(1.0 - h_ratio, 0.02)
        if fb_score > fallback[2]:
            fallback = ((i, j), res, fb_score)
        if h_ratio > cfg.max_homography_ratio:
            continue
        if n_inl > best_inl:
            best_pair, best_res, best_inl = (i, j), res, n_inl
    if best_pair is None:
        # every pair is near-planar: take the least-planar strong pair
        best_pair, best_res, best_inl = fallback
    i0, i1 = best_pair
    if verbose:
        print(f"[sfm] init pair ({i0},{i1}) inliers={best_inl}")

    # 4. initialize map: camera i0 at origin, i1 at recovered pose
    R1 = np.asarray(best_res.R)
    t1 = np.asarray(best_res.t)
    poses: Dict[int, Tuple[np.ndarray, np.ndarray]] = {
        i0: (np.eye(3), np.zeros(3)),
        i1: (R1, t1),
    }
    pairs01 = pair_matches[best_pair]
    m01 = len(pairs01)
    inl = np.asarray(best_res.inliers)[:m01]
    p0 = _normalize(xy[i0][pairs01[:, 0]], K).astype(np.float32)
    p1 = _normalize(xy[i1][pairs01[:, 1]], K).astype(np.float32)
    p0, p1, _ = _bucket_pad(p0, p1)
    X, z0 = triangulate_midpoint(jnp.asarray(R1, jnp.float32),
                                 jnp.asarray(t1, jnp.float32),
                                 jnp.asarray(p0), jnp.asarray(p1))
    X = np.asarray(X)[:m01]
    z1 = (X @ R1.T + t1)[:, 2]
    good = inl & (np.asarray(z0)[:m01] > 0) & (z1 > 0)

    # track bookkeeping as dense arrays (the per-match Python dict loops
    # of the first version were O(N * pairs * matches) per registration —
    # minutes-to-hours at 100+ images):
    #   track_of (N, K) int32: keypoint -> track id (-1 unassigned)
    #   adj_*[i]: image i's matches across ALL pairs, concatenated
    n_kp = max(len(x) for x in xy)
    track_of = np.full((n, n_kp), -1, np.int32)
    adj_other = [[] for _ in range(n)]
    adj_kp_self = [[] for _ in range(n)]
    adj_kp_other = [[] for _ in range(n)]
    for (a, b), pairs in pair_matches.items():
        adj_other[a].append(np.full(len(pairs), b, np.int32))
        adj_kp_self[a].append(pairs[:, 0].astype(np.int32))
        adj_kp_other[a].append(pairs[:, 1].astype(np.int32))
        adj_other[b].append(np.full(len(pairs), a, np.int32))
        adj_kp_self[b].append(pairs[:, 1].astype(np.int32))
        adj_kp_other[b].append(pairs[:, 0].astype(np.int32))
    cat = lambda ls: (np.concatenate(ls) if ls else  # noqa: E731
                      np.zeros(0, np.int32))
    adj_other = [cat(v) for v in adj_other]
    adj_kp_self = [cat(v) for v in adj_kp_self]
    adj_kp_other = [cat(v) for v in adj_kp_other]
    registered = np.zeros(n, bool)
    registered[[i0, i1]] = True

    points: List[np.ndarray] = []
    track_obs: List[List[Tuple[int, int]]] = []
    for m_idx in np.nonzero(good)[0]:
        a, b = pairs01[m_idx]
        tid = len(points)
        points.append(X[m_idx])
        track_obs.append([(i0, int(a)), (i1, int(b))])
        track_of[i0, a] = tid
        track_of[i1, b] = tid

    def run_global_ba():
        nonlocal points
        reg = sorted(poses.keys())
        cam_of = {img: c for c, img in enumerate(reg)}
        obs_cam, obs_pt, obs_uv = [], [], []
        for tid, obs in enumerate(track_obs):
            for (img, kp) in obs:
                if img in cam_of:
                    obs_cam.append(cam_of[img])
                    obs_pt.append(tid)
                    obs_uv.append(xy[img][kp])
        Ks = np.tile(K[None], (len(reg), 1, 1))
        problem = build_problem(Ks, obs_cam, obs_pt, obs_uv, len(points),
                                fixed_cams=[img == i0 for img in reg])
        rvecs = np.stack([rotation_to_rvec(poses[img][0]) for img in reg])
        tvecs = np.stack([poses[img][1] for img in reg])
        state = BAState(rvecs=jnp.asarray(rvecs, jnp.float32),
                        tvecs=jnp.asarray(tvecs, jnp.float32),
                        points=jnp.asarray(np.stack(points), jnp.float32))
        state, cost = run_ba(problem, state, cfg.final_ba_iters)
        for c, img in enumerate(reg):
            Rn = np.asarray(rodrigues(state.rvecs[c]))
            poses[img] = (Rn, np.asarray(state.tvecs[c]))
        points = [p for p in np.asarray(state.points)]
        rms = float(np.sqrt(cost / max(len(obs_cam), 1)))
        return rms

    # 5. register remaining views by 2D-3D support (all bookkeeping is
    # numpy joins over the per-image adjacency tables — one fancy-index
    # per candidate instead of the per-match dict loops)
    remaining = set(range(n)) - set(poses)
    n_registered = 2
    last_ba_size = 2
    while remaining:
        # count 2D-3D correspondences per candidate
        counts = {}
        for img in remaining:
            ok = (registered[adj_other[img]]
                  & (track_of[adj_other[img], adj_kp_other[img]] >= 0))
            counts[img] = int(ok.sum())
        img = max(counts, key=counts.get)
        if counts[img] < cfg.min_pnp_inliers:
            break
        remaining.discard(img)

        # gather its 2D-3D correspondences
        tid_other = track_of[adj_other[img], adj_kp_other[img]]
        sel = (registered[adj_other[img]] & (tid_other >= 0)
               & (track_of[img, adj_kp_self[img]] < 0))
        corr_kp = adj_kp_self[img][sel]
        corr_tid = tid_other[sel]
        if len(corr_kp) < cfg.min_pnp_inliers:
            continue
        pts_np = np.stack(points)
        n_corr = len(corr_kp)
        corr_X = pts_np[corr_tid].astype(np.float32)
        uvn = _normalize(xy[img][corr_kp], K).astype(np.float32)
        corr_X, uvn, vmask = _bucket_pad(corr_X, uvn)
        key, sub = jax.random.split(key)
        res = ransac_pnp(sub, jnp.asarray(corr_X), jnp.asarray(uvn),
                         jnp.asarray(vmask), cfg.pnp_threshold)
        if int(res.n_inliers) < cfg.min_pnp_inliers:
            if verbose:
                print(f"[sfm] image {img}: PnP failed "
                      f"({int(res.n_inliers)}/{n_corr} inliers)")
            continue
        R = np.asarray(res.R)
        t = np.asarray(res.t)
        poses[img] = (R, t)
        registered[img] = True
        inl = np.asarray(res.inliers)[:n_corr]
        for k_i in np.nonzero(inl)[0]:
            track_of[img, corr_kp[k_i]] = corr_tid[k_i]
            track_obs[corr_tid[k_i]].append((img, int(corr_kp[k_i])))
        if verbose:
            print(f"[sfm] registered image {img} "
                  f"({int(res.n_inliers)}/{len(corr_X)} inliers)")

        # triangulate new tracks between img and registered others
        for (a, b), pairs in pair_matches.items():
            if a != img and b != img:
                continue
            other = b if a == img else a
            if other not in poses:
                continue
            kp_s_all = (pairs[:, 0] if a == img else pairs[:, 1]).astype(
                np.int32)
            kp_o_all = (pairs[:, 1] if a == img else pairs[:, 0]).astype(
                np.int32)
            fresh = ((track_of[img, kp_s_all] < 0)
                     & (track_of[other, kp_o_all] < 0))
            if not fresh.any():
                continue
            kp_s = kp_s_all[fresh]
            kp_o = kp_o_all[fresh]
            m_new = len(kp_s)
            Rs, ts = poses[img]
            Ro, to = poses[other]
            # relative pose other->img: X_img = R_rel X_other + t_rel
            R_rel = Rs @ Ro.T
            t_rel = ts - R_rel @ to
            po = _normalize(xy[other][kp_o], K).astype(np.float32)
            ps = _normalize(xy[img][kp_s], K).astype(np.float32)
            po, ps, _ = _bucket_pad(po, ps)
            Xo, zo = triangulate_midpoint(
                jnp.asarray(R_rel, jnp.float32),
                jnp.asarray(t_rel, jnp.float32),
                jnp.asarray(po), jnp.asarray(ps))
            Xo = np.asarray(Xo)[:m_new]
            po, ps, zo = po[:m_new], ps[:m_new], np.asarray(zo)[:m_new]
            Xs = Xo @ R_rel.T + t_rel
            zs = Xs[:, 2]
            # to world: X_w = Ro^T (X_other - to)
            Xw = (Xo - to) @ Ro
            # reprojection gate in both views (mismatched pairs triangulate
            # somewhere, but not consistently with the measured rays)
            zo_np = np.asarray(zo)
            with np.errstate(divide="ignore", invalid="ignore"):
                r_o = Xo[:, :2] / Xo[:, 2:3]
                r_s = Xs[:, :2] / Xs[:, 2:3]
            err = (np.sum((r_o - po) ** 2, 1) + np.sum((r_s - ps) ** 2, 1))
            okc = ((zo_np > 0) & (zs > 0)
                   & (err < 4 * cfg.pnp_threshold))
            acc = np.nonzero(okc)[0]
            tids = len(points) + np.arange(len(acc), dtype=np.int32)
            track_of[other, kp_o[acc]] = tids
            track_of[img, kp_s[acc]] = tids
            for k_i in acc:
                points.append(Xw[k_i])
                track_obs.append([(other, int(kp_o[k_i])),
                                  (img, int(kp_s[k_i]))])

        n_registered += 1
        if cfg.ba_growth > 1.0:
            if n_registered >= last_ba_size * cfg.ba_growth:
                run_global_ba()
                last_ba_size = n_registered
        elif n_registered % cfg.ba_every == 0:
            run_global_ba()

    # 6. final global BA
    rms = run_global_ba()
    if verbose:
        print(f"[sfm] done: {len(poses)}/{n} cams, {len(points)} points, "
              f"rms {rms:.3f}px")
    # convert t to camera centers
    out_poses = {img: (R, -R.T @ t) for img, (R, t) in poses.items()}
    return SfMResult(poses=out_poses, points=np.stack(points),
                     track_obs=track_obs, keypoints=xy, reproj_rms=rms)


def sfm_to_scene(result: SfMResult, K: np.ndarray, image_names: List[str],
                 width: int, height: int) -> SceneMVS:
    """Package an SfM result as a SceneMVS for the dense stage / .mvs IO."""
    plat = Platform(name="p0")
    plat.cameras.append(CameraIntrinsic(
        name="cam0", width=width, height=height, K=K.astype(np.float64),
        R=np.eye(3), C=np.zeros(3)))
    scene = SceneMVS(platforms=[plat])
    img_to_pose = {}
    for img_idx in sorted(result.poses):
        R, C = result.poses[img_idx]
        img_to_pose[img_idx] = len(plat.poses)
        plat.poses.append(Pose(R=R.astype(np.float64),
                               C=C.astype(np.float64)))
        scene.images.append(ImageRecord(
            name=image_names[img_idx], platform_id=0, camera_id=0,
            pose_id=img_to_pose[img_idx], id=img_idx))
    # points + view lists (only registered images)
    reg = {img: k for k, img in enumerate(sorted(result.poses))}
    pts, counts, ids, confs = [], [], [], []
    for tid, obs in enumerate(result.track_obs):
        vids = [reg[img] for img, _ in obs if img in reg]
        if len(vids) < 2:
            continue
        pts.append(result.points[tid])
        counts.append(len(vids))
        ids.extend(vids)
        confs.extend([1.0] * len(vids))
    scene.points = (np.stack(pts).astype(np.float32) if pts
                    else np.zeros((0, 3), np.float32))
    scene.point_view_counts = np.asarray(counts, np.int32)
    scene.point_view_ids = np.asarray(ids, np.uint32)
    scene.point_view_confs = np.asarray(confs, np.float32)
    return scene
