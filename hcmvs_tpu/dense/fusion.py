"""Cross-view depth filtering, gap interpolation, and point-cloud fusion.

Data-parallel re-design of the reference's multi-view fusion stack:
- ``cross_view_filter`` — the consistency vote + fused-map computation the
  reference hides inside the hijacked RemoveSmallSegments
  (ref: frame_main/libs/MVS/SceneDensify.cpp:1953-2276) and FilterDepthMap
  (:3006-3259).
- ``gap_interpolate`` — row/column gap fill
  (ref: SceneDensify.cpp:2280-3001 GapInterpolation).
- ``fuse_point_cloud`` — depth maps -> world point cloud with per-point
  view support, weights, colors, normals
  (ref: SceneDensify.cpp:3265-3495 FuseDepthMaps, Conf2Weight :154-156).

The reference fuses sequentially, claiming pixels through a mutable
index map (first-processed image wins).  Here every view computes in
parallel and a deterministic ownership rule replaces the mutation: a pixel
emits its point only if no higher-priority view agrees with it (the
higher-priority view emits the merged point instead).

Layout: all per-pixel 3-vector fields are planes-first (3, H, W); normals
come in as (N, 3, H, W) — see dense/types.py LAYOUT RULE.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from hcmvs_tpu.core.camera import Camera
from hcmvs_tpu.core.config import DenseConfig
from hcmvs_tpu.dense.types import (dot3, mat3_apply, mat3_apply_t,
                                   normalize3, pixel_rays)
from hcmvs_tpu.ops.sampling import bilinear_sample_xy


def conf_to_weight(conf: jax.Array, depth: jax.Array) -> jax.Array:
    """ref: SceneDensify.cpp:154-156."""
    return 1.0 / (jnp.maximum(1.0 - conf, 0.03)
                  * jnp.maximum(depth, 1e-6) ** 2)


def _cam_to_world(cam: Camera, Xc):
    Xw = mat3_apply_t(cam.R, Xc)
    return (Xw[0] + cam.C[0], Xw[1] + cam.C[1], Xw[2] + cam.C[2])


def _world_to_cam(cam: Camera, Xw):
    return mat3_apply(cam.R, (Xw[0] - cam.C[0], Xw[1] - cam.C[1],
                              Xw[2] - cam.C[2]))


def _project(cam: Camera, Xw):
    """World planes -> (u, v, z) planes in the camera."""
    Xc = _world_to_cam(cam, Xw)
    p = mat3_apply(cam.K, Xc)
    z = p[2]
    inv_z = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    return p[0] * inv_z, p[1] * inv_z, z


@partial(jax.jit, static_argnames=("cfg",))
def cross_view_filter(depths: jax.Array, normals: jax.Array,
                      confs: jax.Array, cams: Camera, nbr_idx: jax.Array,
                      nbr_valid: jax.Array, cfg: DenseConfig
                      ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Consistency filter + fused depth across views.

    Args: depths (N, H, W); normals (N, 3, H, W); confs (N, H, W); cams
    batched Camera (N); nbr_idx/nbr_valid (N, V).

    Returns (filtered_depth, fused_depth, support): depths with
    insufficient cross-view support zeroed; the support-weighted average
    depth (the analog of depthMap_fuse); and the supporting-view count.
    """
    n, h, w = depths.shape
    rays = jax.vmap(lambda c: pixel_rays(c.K_inv, h, w))(cams)

    def per_view(i):
        cam_i = jax.tree.map(lambda x: x[i], cams)
        depth_i = depths[i]
        r = rays[i]
        X_w = _cam_to_world(cam_i, (r[0] * depth_i, r[1] * depth_i,
                                    r[2] * depth_i))
        w0 = conf_to_weight(confs[i], depth_i)
        acc_d = depth_i * w0
        acc_w = w0
        support = jnp.zeros((h, w), jnp.int32)

        def body(k, carry):
            acc_d, acc_w, support = carry
            j = nbr_idx[i, k]
            cam_j = jax.tree.map(lambda x: x[j], cams)
            u_j, v_j, z_j = _project(cam_j, X_w)
            d_j, ok = bilinear_sample_xy(depths[j], u_j, v_j)
            c_j, _ = bilinear_sample_xy(confs[j], u_j, v_j)
            agree = (ok & (d_j > 0) & (z_j > 0)
                     & (jnp.abs(z_j - d_j)
                        < cfg.depth_diff_threshold * cfg.depth_weight * d_j))
            agree = agree & nbr_valid[i, k]
            # neighbor's own depth re-expressed in view i (for the fused map)
            scale = d_j / jnp.where(z_j <= 0, 1e9, z_j)
            w_j = conf_to_weight(c_j, d_j) * agree
            return (acc_d + depth_i * scale * w_j, acc_w + w_j,
                    support + agree.astype(jnp.int32))

        acc_d, acc_w, support = jax.lax.fori_loop(
            0, nbr_idx.shape[1], body, (acc_d, acc_w, support))
        fused = jnp.where(depth_i > 0, acc_d / jnp.maximum(acc_w, 1e-12), 0.)
        keep = (support + 1 >= cfg.min_views_filter) & (depth_i > 0)
        return jnp.where(keep, depth_i, 0.0), fused, support

    idx = jnp.arange(n)
    filt, fused, support = jax.lax.map(per_view, idx)
    return filt, fused, support


def _gap_fill_1d(depth_row: jax.Array, conf_row: jax.Array, gap: int,
                 thr: float,
                 gra_row: Optional[jax.Array] = None,
                 normal_row: Optional[jax.Array] = None,
                 tx_gate: float = 0.1):
    """Fill invalid runs between valid depths by linear interpolation
    (one row; vmapped over rows/columns).

    Runs up to ``gap`` pixels fill when the endpoint depths are similar
    (ref: GapInterpolation small-gap branch, SceneDensify.cpp:2295-2360);
    LONGER runs fill only when the texture-gradient ratio across the gap
    is below ``tx_gate`` — similar texture implies the same surface
    crossing a fusion hole (ref: the texture_ratio <= 0.1 gates,
    :2360-2460).  Normals, when given as (W, 3), are interpolated and
    renormalized (the reference lerps in spherical dir space).
    """
    w = depth_row.shape[0]
    idx = jnp.arange(w, dtype=jnp.float32)
    valid = depth_row > 0
    has_tx = gra_row is not None
    gra_row = gra_row if has_tx else jnp.zeros_like(depth_row)
    has_n = normal_row is not None
    nr = normal_row if has_n else jnp.zeros((w, 3), jnp.float32)

    def scan_dir(xs, reverse):
        def step(carry, x):
            i, d, c, g, n3, v = x
            new = tuple(jnp.where(v, a, b) for a, b in
                        zip((i, d, c, g), carry[:4]))
            new = new + (jnp.where(v, n3, carry[4]),)
            return new, new
        init = (jnp.float32(-1e9) if not reverse else jnp.float32(1e9),
                jnp.float32(0.0), jnp.float32(0.0), jnp.float32(0.0),
                jnp.zeros(3, jnp.float32))
        _, out = jax.lax.scan(step, init, xs, reverse=reverse)
        return out

    xs = (idx, depth_row, conf_row, gra_row, nr, valid)
    li, ld, lc, lg, ln = scan_dir(xs, False)   # nearest valid left
    ri, rd, rc, rg, rn = scan_dir(xs, True)    # nearest valid right
    span = ri - li
    similar = jnp.abs(ld - rd) < thr * jnp.maximum(ld, rd)
    ends = (ld > 0) & (rd > 0)
    small = (~valid) & (span <= gap + 1) & ends & similar
    if has_tx:
        tx_ok = (jnp.abs(rg - lg) / jnp.maximum(lg, 1e-6)) <= tx_gate
        large = (~valid) & (span > gap + 1) & ends & (tx_ok | similar)
        fill = small | large
    else:
        fill = small
    t = (idx - li) / jnp.where(span == 0, 1.0, span)
    d_interp = ld * (1 - t) + rd * t
    c_interp = jnp.minimum(lc, rc)
    depth_out = jnp.where(fill, d_interp, depth_row)
    conf_out = jnp.where(fill, c_interp, conf_row)
    if has_n:
        n_interp = ln * (1 - t)[:, None] + rn * t[:, None]
        n_interp = n_interp / jnp.maximum(
            jnp.linalg.norm(n_interp, axis=-1, keepdims=True), 1e-9)
        normal_out = jnp.where(fill[:, None], n_interp, nr)
        return depth_out, conf_out, normal_out
    return depth_out, conf_out


@partial(jax.jit, static_argnames=("cfg",))
def gap_interpolate(depth: jax.Array, conf: jax.Array,
                    cfg: DenseConfig,
                    gra: Optional[jax.Array] = None,
                    normal: Optional[jax.Array] = None):
    """Row then column gap interpolation on one (H, W) depth map
    (ref: GapInterpolation phase 1, SceneDensify.cpp:2295-2785): similar-
    depth fills for small gaps, texture-ratio-gated fills for large gaps
    (when ``gra`` is given), with dir-space normal interpolation (when
    ``normal`` (3, H, W) is given).  Returns (depth, conf) or
    (depth, conf, normal)."""
    gap = cfg.ipol_gap_size
    thr = cfg.depth_diff_threshold * 2.5  # ref: fDepthDiffThreshold*2.5
    if normal is not None:
        g = gra if gra is not None else jnp.zeros_like(depth)
        nrm = jnp.moveaxis(normal, 0, -1)                   # (H, W, 3)
        d, c, nrm = jax.vmap(_gap_fill_1d,
                             in_axes=(0, 0, None, None, 0, 0))(
            depth, conf, gap, thr, g, nrm)
        d, c, nrm = jax.vmap(_gap_fill_1d,
                             in_axes=(1, 1, None, None, 1, 1),
                             out_axes=1)(d, c, gap, thr, g, nrm)
        return d, c, jnp.moveaxis(nrm, -1, 0)
    if gra is not None:
        d, c = jax.vmap(_gap_fill_1d, in_axes=(0, 0, None, None, 0))(
            depth, conf, gap, thr, gra)
        d, c = jax.vmap(_gap_fill_1d, in_axes=(1, 1, None, None, 1),
                        out_axes=1)(d, c, gap, thr, gra)
        return d, c
    d, c = jax.vmap(_gap_fill_1d, in_axes=(0, 0, None, None))(
        depth, conf, gap, thr)
    d, c = jax.vmap(_gap_fill_1d, in_axes=(1, 1, None, None),
                    out_axes=1)(d, c, gap, thr)
    return d, c


@partial(jax.jit, static_argnames=("cfg",))
def gap_repropagate(depth_fuse: jax.Array, normal_fuse: jax.Array,
                    depth: jax.Array, normal: jax.Array, conf: jax.Array,
                    gra: jax.Array, rays: jax.Array, cfg: DenseConfig):
    """Gradient-guided re-propagation over remaining fusion holes
    (ref: GapInterpolation phase 2, SceneDensify.cpp:2791-2983).

    For every invalid fused pixel, harvest the HC cross-pattern
    candidates (texture-adaptive radius: 5 where gra > 150, else
    propagate_step) from the CURRENT depth map; where the local texture
    and depth fields are smooth (mean ratios below 1%), fill with the
    plane-propagated depth of the candidate closest to the local depth
    mean and adopt its normal.  Vectorized: every hole evaluates its
    candidate set in parallel instead of the reference's per-pixel loop.
    """
    h, w = depth_fuse.shape
    step = max(cfg.propagate_step, 1)
    radius = max(cfg.propagate_half_window, step)
    dists = list(range(1, radius + 1, step))
    offs = [(0, d) for d in dists] + [(0, -d) for d in dists] + \
           [(d, 0) for d in dists] + [(-d, 0) for d in dists]
    pad = radius
    dp = jnp.pad(depth, pad)
    np_ = jnp.pad(normal, ((0, 0), (pad, pad), (pad, pad)))
    gp = jnp.pad(gra, pad, mode="edge")
    cp = jnp.pad(conf, pad)
    rp = jnp.pad(rays, ((0, 0), (pad, pad), (pad, pad)), mode="edge")

    # texture-adaptive radius mask per candidate (ref: :2803-2809)
    r_eff = jnp.where(gra > 150.0, jnp.minimum(5, radius),
                      jnp.minimum(step, radius)).astype(jnp.float32)

    def sl(a, dy, dx):
        return a[..., pad + dy:pad + dy + h, pad + dx:pad + dx + w]

    cnt = jnp.zeros((h, w), jnp.float32)
    d_sum = jnp.zeros((h, w), jnp.float32)
    tx_sum = jnp.zeros((h, w), jnp.float32)
    d_min = jnp.full((h, w), jnp.inf)
    d_max = jnp.full((h, w), -jnp.inf)
    for dy, dx in offs:
        ok = (sl(dp, dy, dx) > 0) & (max(abs(dy), abs(dx)) <= r_eff)
        okf = ok.astype(jnp.float32)
        d_c = sl(dp, dy, dx)
        cnt += okf
        d_sum += okf * d_c
        tx_sum += okf * (sl(gp, dy, dx) - gra)
        d_min = jnp.where(ok, jnp.minimum(d_min, d_c), d_min)
        d_max = jnp.where(ok, jnp.maximum(d_max, d_c), d_max)
    cnt_s = jnp.maximum(cnt, 1.0)
    d_mean = d_sum / cnt_s
    texture_ratio = jnp.abs(tx_sum / cnt_s) / jnp.maximum(gra, 1e-6)
    depth_ratio = (d_max - d_min) / jnp.maximum(d_mean, 1e-9)
    smooth = (texture_ratio < 0.01) & (depth_ratio < 0.01) & (cnt >= 2)

    # chosen candidate: closest to the local depth mean (x1_demin analog);
    # fill = its hypothesis plane propagated to this pixel
    best_dev = jnp.full((h, w), jnp.inf)
    best_d = jnp.zeros((h, w))
    best_n = jnp.zeros((3, h, w))
    best_c = jnp.zeros((h, w))
    for dy, dx in offs:
        ok = (sl(dp, dy, dx) > 0) & (max(abs(dy), abs(dx)) <= r_eff)
        d_c = sl(dp, dy, dx)
        n_c = sl(np_, dy, dx)
        num = (n_c[0] * sl(rp, dy, dx)[0] + n_c[1] * sl(rp, dy, dx)[1]
               + n_c[2] * sl(rp, dy, dx)[2]) * d_c
        den = n_c[0] * rays[0] + n_c[1] * rays[1] + n_c[2] * rays[2]
        d_prop = num / jnp.where(jnp.abs(den) < 1e-9, 1e-9, den)
        dev = jnp.where(ok, jnp.abs(d_c - d_mean), jnp.inf)
        better = dev < best_dev
        best_dev = jnp.where(better, dev, best_dev)
        best_d = jnp.where(better, d_prop, best_d)
        best_n = jnp.where(better[None], n_c, best_n)
        best_c = jnp.where(better, sl(cp, dy, dx), best_c)

    fill = (depth_fuse <= 0) & smooth & (best_d > 0) & jnp.isfinite(
        best_dev)
    depth_out = jnp.where(fill, best_d, depth_fuse)
    normal_out = jnp.where(fill[None], best_n, normal_fuse)
    conf_out = jnp.where(fill, best_c, conf)
    return depth_out, normal_out, conf_out


@partial(jax.jit, static_argnames=("cfg", "with_colors"))
def fuse_point_cloud(depths: jax.Array, normals: jax.Array,
                     confs: jax.Array, cams: Camera, nbr_idx: jax.Array,
                     nbr_valid: jax.Array, priority: jax.Array,
                     cfg: DenseConfig,
                     colors: Optional[jax.Array] = None,
                     with_colors: bool = False):
    """Fuse per-view depth maps into a world point cloud.

    Args:
      depths (N, H, W); normals (N, 3, H, W) camera-space; confs
        (N, H, W); colors (N, H, W, 3) optional.
      priority: (N,) smaller = higher priority (the reference processes
        best-connected images first; SceneDensify.cpp:3290-3302).

    Returns dict of per-pixel arrays + ``keep`` mask; compact with
    ``compact_point_cloud`` on host.  Points are (N, 3, H, W) planes.
    """
    n, h, w = depths.shape
    nrm_err = float(np.cos(np.radians(cfg.normal_diff_threshold
                                      * cfg.normal_weight)))

    rays = jax.vmap(lambda c: pixel_rays(c.K_inv, h, w))(cams)

    def per_view(i):
        cam_i = jax.tree.map(lambda x: x[i], cams)
        depth_i = depths[i]
        valid = depth_i > 0
        r = rays[i]
        X_w = _cam_to_world(cam_i, (r[0] * depth_i, r[1] * depth_i,
                                    r[2] * depth_i))
        n_i = normals[i]
        n_w = mat3_apply_t(cam_i.R, (n_i[0], n_i[1], n_i[2]))
        w_i = conf_to_weight(confs[i], depth_i)
        accX = tuple(X_w[c] * w_i for c in range(3))
        accN = tuple(n_w[c] * w_i for c in range(3))
        accC = (tuple(colors[i][..., c] * w_i for c in range(3))
                if with_colors else
                (jnp.zeros((h, w)),) * 3)
        accW = w_i
        count = jnp.ones((h, w), jnp.int32)
        owned = jnp.zeros((h, w), bool)
        v_nbr = nbr_idx.shape[1]
        # per-neighbor agreement + supporting confidence, kept so the fused
        # scene records FULL per-point view lists like the reference
        # (FuseDepthMaps views/weights, SceneDensify.cpp:3265-3495)
        agree_k = jnp.zeros((v_nbr, h, w), bool)
        conf_k = jnp.zeros((v_nbr, h, w), jnp.float32)

        def body(k, carry):
            accX, accN, accC, accW, count, owned, agree_k, conf_k = carry
            j = nbr_idx[i, k]
            cam_j = jax.tree.map(lambda x: x[j], cams)
            u_j, v_j, z_j = _project(cam_j, X_w)
            d_j, ok = bilinear_sample_xy(depths[j],
                                         jnp.round(u_j), jnp.round(v_j))
            c_j, _ = bilinear_sample_xy(confs[j], jnp.round(u_j),
                                        jnp.round(v_j))
            n_j = tuple(bilinear_sample_xy(normals[j][c], jnp.round(u_j),
                                           jnp.round(v_j))[0]
                        for c in range(3))
            n_jw = mat3_apply_t(cam_j.R, n_j)
            agree = (ok & (d_j > 0) & (z_j > 0) & nbr_valid[i, k]
                     & (jnp.abs(z_j - d_j)
                        < cfg.depth_diff_threshold * cfg.depth_weight * d_j)
                     & (dot3(n_w, n_jw) > nrm_err))
            ray_j = mat3_apply(cam_j.K_inv, (u_j, v_j, jnp.ones_like(u_j)))
            X_j = _cam_to_world(cam_j, (ray_j[0] * d_j, ray_j[1] * d_j,
                                        ray_j[2] * d_j))
            w_j = conf_to_weight(c_j, d_j) * agree
            accX = tuple(accX[c] + X_j[c] * w_j for c in range(3))
            accN = tuple(accN[c] + n_jw[c] * w_j for c in range(3))
            if with_colors:
                col_j = tuple(bilinear_sample_xy(colors[j][..., c],
                                                 jnp.round(u_j),
                                                 jnp.round(v_j))[0]
                              for c in range(3))
                accC = tuple(accC[c] + col_j[c] * w_j for c in range(3))
            accW = accW + w_j
            count = count + agree.astype(jnp.int32)
            owned = owned | (agree & (priority[j] < priority[i]))
            agree_k = jax.lax.dynamic_update_index_in_dim(
                agree_k, agree, k, 0)
            conf_k = jax.lax.dynamic_update_index_in_dim(
                conf_k, jnp.where(agree, c_j, 0.0), k, 0)
            return accX, accN, accC, accW, count, owned, agree_k, conf_k

        (accX, accN, accC, accW, count, owned, agree_k,
         conf_k) = jax.lax.fori_loop(
            0, nbr_idx.shape[1], body,
            (accX, accN, accC, accW, count, owned, agree_k, conf_k))
        keep = valid & (~owned) & (count >= cfg.min_views_fuse)
        inv_w = 1.0 / jnp.maximum(accW, 1e-12)
        pts = jnp.stack([accX[c] * inv_w for c in range(3)])
        nrm = jnp.stack(normalize3(tuple(accN[c] * inv_w for c in range(3))))
        col = jnp.stack([accC[c] * inv_w for c in range(3)])
        return pts, nrm, col, accW, count, keep, agree_k, conf_k

    pts, nrm, col, wts, count, keep, agree_k, conf_k = jax.lax.map(
        per_view, jnp.arange(n))
    return {"points": pts, "normals": nrm, "colors": col, "weights": wts,
            "support": count, "keep": keep,
            "nbr_agree": agree_k, "nbr_conf": conf_k}


def compact_point_cloud(fused: dict, nbr_idx: Optional[np.ndarray] = None,
                        confs: Optional[np.ndarray] = None) -> dict:
    """Host-side compaction of the fused per-pixel arrays into (M, ...).

    When ``nbr_idx`` (N, V) is given, also emits the FULL ragged per-point
    view lists the reference's FuseDepthMaps records
    (SceneDensify.cpp:3265-3495): ``view_counts`` (M,), ``view_ids`` (sum,)
    with the owner view first then each agreeing neighbor, and
    ``view_confs`` (sum,) — the owner's confidence (pass ``confs``
    (N, H, W)) followed by the supporting views' sampled confidences.
    """
    keep = np.asarray(fused["keep"]).reshape(-1)
    out = {}
    for name in ("points", "normals", "colors"):
        arr = np.asarray(fused[name])            # (N, 3, H, W)
        arr = np.moveaxis(arr, 1, -1).reshape(-1, 3)
        out[name] = arr[keep]
    for name in ("weights", "support"):
        out[name] = np.asarray(fused[name]).reshape(-1)[keep]
    n = np.asarray(fused["keep"]).shape[0]
    hw = keep.size // n
    owner = np.repeat(np.arange(n, dtype=np.uint32), hw)[keep]
    out["owner_view"] = owner
    if nbr_idx is not None:
        agree = np.asarray(fused["nbr_agree"])       # (N, V, H, W)
        nconf = np.asarray(fused["nbr_conf"])        # (N, V, H, W)
        v = agree.shape[1]
        agree = np.moveaxis(agree, 1, -1).reshape(-1, v)[keep]   # (M, V)
        nconf = np.moveaxis(nconf, 1, -1).reshape(-1, v)[keep]
        nbr_of = np.asarray(nbr_idx, np.uint32)[owner]           # (M, V)
        oconf = (np.asarray(confs).reshape(-1)[keep]
                 if confs is not None else np.ones(len(owner), np.float32))
        counts = 1 + agree.sum(1).astype(np.int32)               # (M,)
        total = int(counts.sum())
        ids = np.empty(total, np.uint32)
        cfs = np.empty(total, np.float32)
        offs = np.concatenate([[0], np.cumsum(counts)])
        # owner first...
        ids[offs[:-1]] = owner
        cfs[offs[:-1]] = oconf
        # ...then agreeing neighbors, in nbr_idx order: positions via
        # per-row running rank of the agreement flags
        rank = np.cumsum(agree, axis=1)                          # 1-based
        rows, cols = np.nonzero(agree)
        pos = offs[rows] + rank[rows, cols]
        ids[pos] = nbr_of[rows, cols]
        cfs[pos] = nconf[rows, cols]
        out["view_counts"] = counts
        out["view_ids"] = ids
        out["view_confs"] = cfs
    return out


def estimate_point_labels(points: np.ndarray, owner_view: np.ndarray,
                          semantic: np.ndarray, cams: "Camera"
                          ) -> np.ndarray:
    """Per-point semantic labels by projecting each fused point into its
    owner view's mask (ref: EstimatePointLabels,
    frame_main/libs/MVS/DepthMap.cpp:2165).  Host-side: runs once per
    scene on the compacted cloud.

    Args:
      points: (P, 3) world points.
      owner_view: (P,) view index that fused each point.
      semantic: (N, H, W) integer label maps.
      cams: batched Camera.
    Returns (P,) int32 labels (-1 where the projection misses).
    """
    import numpy as _np
    Ks = _np.asarray(cams.K)
    Rs = _np.asarray(cams.R)
    Cs = _np.asarray(cams.C)
    n, h, w = semantic.shape
    labels = _np.full(len(points), -1, _np.int32)
    for v in range(n):
        sel = owner_view == v
        if not sel.any():
            continue
        Xc = (points[sel] - Cs[v]) @ Rs[v].T
        z = Xc[:, 2]
        uv = Xc @ Ks[v].T
        with _np.errstate(divide="ignore", invalid="ignore"):
            x = _np.round(uv[:, 0] / uv[:, 2]).astype(int)
            y = _np.round(uv[:, 1] / uv[:, 2]).astype(int)
        ok = (z > 0) & (x >= 0) & (x < w) & (y >= 0) & (y < h)
        lab = _np.full(sel.sum(), -1, _np.int32)
        lab[ok] = semantic[v, y[ok], x[ok]]
        labels[sel] = lab
    return labels
