"""Semi-global matching: the alternative stereo path (fusion modes -1/-2).

Data-parallel re-design of the reference's SGM
(ref: frame_main/libs/MVS/SemiGlobalMatcher.{h,cpp} — census transform,
WTA over an 8-path aggregated cost volume, left-right consistency check,
sub-pixel refinement; invoked via DensifyPointCloud --fusion-mode -1/-2,
SceneDensify.cpp:3899-3911):

- The census transform is shifted-array XOR popcounts (pure VPU).
- Instead of rectification + disparity, the cost volume is built by
  plane-sweeping D fronto-parallel depth hypotheses through the full
  homography (general two-view poses, no rectification stage needed);
  one warp per hypothesis amortizes over all pixels.
- Path aggregation is the classic dynamic program, expressed as
  ``lax.scan`` along rows/columns in both directions — the textbook
  accelerator-friendly scan pattern (SURVEY §2.3).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from hcmvs_tpu.dense.types import ViewGeometry


def census_transform(gray: jax.Array, radius: int = 2) -> jax.Array:
    """(H, W) -> (H, W) uint32 census bitstring over a (2r+1)^2-1 window."""
    h, w = gray.shape
    pad = jnp.pad(gray, radius, mode="edge")
    bits = jnp.zeros((h, w), jnp.uint32)
    k = 0
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dy == 0 and dx == 0:
                continue
            nb = pad[radius + dy:radius + dy + h,
                     radius + dx:radius + dx + w]
            bits = bits | ((nb < gray).astype(jnp.uint32) << k)
            k += 1
    return bits


def hamming_distance(a: jax.Array, b: jax.Array) -> jax.Array:
    """Popcount of a XOR b for uint32 arrays."""
    v = a ^ b
    # bit-twiddling popcount
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24).astype(jnp.float32)


@partial(jax.jit, static_argnames=("n_depths",))
def cost_volume(geom: ViewGeometry, ref_gray: jax.Array,
                src_gray: jax.Array, d_min: jax.Array, d_max: jax.Array,
                n_depths: int = 64, view: int = 0) -> Tuple[jax.Array,
                                                            jax.Array]:
    """(D, H, W) census cost volume by plane-sweeping fronto-parallel
    depths, plus the (D,) swept inverse-depth values."""
    h, w = ref_gray.shape
    cr = census_transform(ref_gray)
    v_, u_ = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                          jnp.arange(w, dtype=jnp.float32), indexing="ij")
    A = geom.A[view]
    wv = geom.wv[view]
    p0x = A[0, 0] * u_ + A[0, 1] * v_ + A[0, 2]
    p0y = A[1, 0] * u_ + A[1, 1] * v_ + A[1, 2]
    p0z = A[2, 0] * u_ + A[2, 1] * v_ + A[2, 2]
    inv_depths = jnp.linspace(1.0 / d_max, 1.0 / d_min, n_depths)
    cs = census_transform(src_gray)

    def sweep(inv_d):
        # fronto-parallel plane at depth 1/inv_d: warp = A p + wv * inv_d
        phx = p0x + wv[0] * inv_d
        phy = p0y + wv[1] * inv_d
        phz = p0z + wv[2] * inv_d
        inv_z = 1.0 / jnp.where(jnp.abs(phz) < 1e-9, 1e-9, phz)
        # census of the warped source: sample census bits nearest-neighbor
        xs = jnp.round(phx * inv_z)
        ys = jnp.round(phy * inv_z)
        xi = jnp.clip(xs.astype(jnp.int32), 0, w - 1)
        yi = jnp.clip(ys.astype(jnp.int32), 0, h - 1)
        oob = (xs < 0) | (xs > w - 1) | (ys < 0) | (ys > h - 1) | (phz <= 0)
        c = hamming_distance(cr, cs[yi, xi])
        return jnp.where(oob, 24.0, c)

    vol = jax.lax.map(sweep, inv_depths)
    return vol, inv_depths


def _aggregate_dir(cost: jax.Array, p1: float, p2: float,
                   axis: int, reverse: bool,
                   col_shift: int = 0) -> jax.Array:
    """One SGM path: scan the (D, H, W) volume along ``axis`` (1 for
    rows, 2 for cols), carrying the classic min-penalty recurrence.

    ``col_shift`` (+/-1, rows-scan only) makes the path diagonal: each
    step's predecessor row is shifted one column sideways; paths entering
    from outside the image restart (predecessor zeroed)."""
    d, h, w = cost.shape
    scan_axis = axis  # 1 = vertical path, 2 = horizontal path
    vol = jnp.moveaxis(cost, scan_axis, 0)      # (L, D, rest)

    def step(prev, cur):
        if col_shift:
            prev = jnp.roll(prev, col_shift, axis=-1)
            prev = prev.at[:, 0 if col_shift > 0 else -1].set(0.0)
        prev_min = jnp.min(prev, axis=0, keepdims=True)
        up = jnp.roll(prev, 1, axis=0).at[0].set(jnp.inf)
        down = jnp.roll(prev, -1, axis=0).at[-1].set(jnp.inf)
        best = jnp.minimum(jnp.minimum(prev, up + p1),
                           jnp.minimum(down + p1, prev_min + p2))
        out = cur + best - prev_min
        return out, out

    if reverse:
        _, agg = jax.lax.scan(step, vol[-1], vol[:-1], reverse=True)
        agg = jnp.concatenate([agg, vol[-1:]], axis=0)
    else:
        _, agg = jax.lax.scan(step, vol[0], vol[1:])
        agg = jnp.concatenate([vol[:1], agg], axis=0)
    return jnp.moveaxis(agg, 0, scan_axis)


@partial(jax.jit, static_argnames=("n_paths",))
def sgm_aggregate(cost: jax.Array, p1: float = 3.0,
                  p2: float = 20.0, n_paths: int = 8) -> jax.Array:
    """4- or 8-path SGM aggregation of a (D, H, W) volume
    (ref: SemiGlobalMatcher 4/8-path option): up/down/left/right plus,
    for 8 paths, the four diagonals as shifted row scans."""
    total = jnp.zeros_like(cost)
    for axis in (1, 2):
        for reverse in (False, True):
            total = total + _aggregate_dir(cost, p1, p2, axis, reverse)
    if n_paths >= 8:
        for reverse in (False, True):
            for col_shift in (1, -1):
                total = total + _aggregate_dir(cost, p1, p2, 1, reverse,
                                               col_shift)
    return total


@partial(jax.jit, static_argnames=("n_depths", "n_paths"))
def sgm_match(geom: ViewGeometry, ref_gray: jax.Array, src_gray: jax.Array,
              d_min: jax.Array, d_max: jax.Array, n_depths: int = 64,
              p1: float = 3.0, p2: float = 20.0,
              max_cost: float = 18.0,
              n_paths: int = 8) -> Tuple[jax.Array, jax.Array]:
    """Full SGM depth for a view pair: (depth (H, W), cost (H, W)).

    WTA over the aggregated volume + parabola sub-pixel refinement in
    inverse depth + winner-cost thresholding (the LR-check analog is
    cross_view_filter downstream, matching how the reference fuses
    SGM maps; SemiGlobalMatcher.cpp:739 Fuse).
    """
    vol, inv_depths = cost_volume(geom, ref_gray, src_gray, d_min, d_max,
                                  n_depths)
    agg = sgm_aggregate(vol, p1, p2, n_paths)
    best = jnp.argmin(agg, axis=0)                      # (H, W)
    d_idx = jnp.clip(best, 1, n_depths - 2)
    h, w = ref_gray.shape
    yy, xx = jnp.meshgrid(jnp.arange(h), jnp.arange(w), indexing="ij")
    c0 = agg[d_idx - 1, yy, xx]
    c1 = agg[d_idx, yy, xx]
    c2 = agg[d_idx + 1, yy, xx]
    denom = c0 + c2 - 2 * c1
    offset = jnp.where(jnp.abs(denom) > 1e-6,
                       0.5 * (c0 - c2) / jnp.maximum(denom, 1e-6), 0.0)
    offset = jnp.clip(offset, -0.5, 0.5)
    step = inv_depths[1] - inv_depths[0]
    inv_d = inv_depths[d_idx] + offset * step
    depth = 1.0 / jnp.maximum(inv_d, 1e-9)
    win_cost = c1 / float(n_paths)                      # per-path average
    depth = jnp.where(win_cost < max_cost, depth, 0.0)
    return depth, win_cost


def lr_consistency(geom: ViewGeometry, depth_ref: jax.Array,
                   depth_src: jax.Array, rel_thr: float = 0.02,
                   dsig: Optional[jax.Array] = None,
                   view: int = 0) -> jax.Array:
    """Left-right cross-check mask for one pair (ref: the rectified LR
    check inside SemiGlobalMatcher::Match, SemiGlobalMatcher.cpp:530 —
    here in depth space, no rectification stage: forward-project each ref
    pixel's depth into the source view and compare against the source's
    own SGM depth there).

    Returns a bool (H, W) mask: True only where the source's own estimate
    agrees — pixels projecting outside the source, onto invalid source
    pixels, or onto a disagreeing depth (occlusions) are rejected, like
    the reference's invalidation of LR-inconsistent disparities.
    """
    h, w = depth_ref.shape
    v_, u_ = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                          jnp.arange(w, dtype=jnp.float32), indexing="ij")
    A = geom.A[view]
    wv = geom.wv[view]
    # src pixel of the hypothesis point: A p * d + wv (homogeneous)
    px = (A[0, 0] * u_ + A[0, 1] * v_ + A[0, 2]) * depth_ref + wv[0]
    py = (A[1, 0] * u_ + A[1, 1] * v_ + A[1, 2]) * depth_ref + wv[1]
    pz = (A[2, 0] * u_ + A[2, 1] * v_ + A[2, 2]) * depth_ref + wv[2]
    inv_z = 1.0 / jnp.where(jnp.abs(pz) < 1e-9, 1e-9, pz)
    xs = px * inv_z
    ys = py * inv_z
    # depth of the SAME point in the source camera: z of R_rel X + t_rel
    R = geom.R_rel[view]
    t = geom.t_rel[view]
    Ki = geom.K_inv_ref
    rz = (R[2, 0] * Ki[0, 0] + R[2, 1] * Ki[1, 0]) * u_ \
        + (R[2, 0] * Ki[0, 1] + R[2, 1] * Ki[1, 1]) * v_ \
        + (R[2, 0] * Ki[0, 2] + R[2, 1] * Ki[1, 2]
           + R[2, 2])                      # K_inv_ref row-3 is (0, 0, 1)
    d_in_src = rz * depth_ref + t[2]
    xi = jnp.clip(jnp.round(xs).astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(jnp.round(ys).astype(jnp.int32), 0, h - 1)
    d_src = depth_src[yi, xi]
    inside = ((xs >= 0) & (xs <= w - 1) & (ys >= 0) & (ys <= h - 1)
              & (pz > 0))
    thr = rel_thr * jnp.maximum(d_in_src, 1e-9)
    if dsig is not None:
        # floor at ~2 sweep-quantization steps (tighter than fusion's 4:
        # both directions carry sub-pixel refinement, and the check's
        # whole point is rejecting; measured on the box occlusion scene:
        # 4 steps passes 22% outliers vs 15% at 2 steps)
        thr = jnp.maximum(thr, 2.0 * d_in_src * d_in_src * dsig)
    agree = (d_src > 0) & (jnp.abs(d_src - d_in_src) < thr)
    return inside & agree


def sgm_fuse_pairs(depths: jax.Array, costs: jax.Array,
                   max_cost: float = 18.0,
                   depth_thr: float = 0.02,
                   dsig: Optional[jax.Array] = None
                   ) -> Tuple[jax.Array, jax.Array]:
    """Fuse one view's per-neighbor SGM maps (K, H, W) into a single map
    (ref: SemiGlobalMatcher::Fuse, SemiGlobalMatcher.cpp:739 — each pair
    is matched independently, then per-pixel estimates that agree are
    cost-weight-averaged; pairs with no supporting agreement are dropped,
    which is the redundancy the method depends on).

    ``dsig``: the swept inverse-depth grid step — the agreement
    threshold floors at ~4 quantization steps (per-pair WTA estimates scatter by 2-3 steps
    on weakly textured patches even after sub-pixel refinement) (depth step = d^2 * dsig),
    or per-pair estimates get rejected by discretization alone.

    Returns (depth (H, W), fused per-path-average cost (H, W)).
    """
    k = depths.shape[0]
    valid = (depths > 0) & (costs < max_cost)
    wts = jnp.where(valid, 1.0 / jnp.maximum(costs, 0.5), 0.0)
    if k == 1:
        return jnp.where(valid[0], depths[0], 0.0), costs[0]

    def thr(d):
        t = depth_thr * d
        if dsig is not None:
            t = jnp.maximum(t, 4.0 * d * d * dsig)
        return t

    # support: for each pair's estimate, how many other pairs agree
    agree = jnp.zeros_like(depths)
    for a in range(k):
        for b in range(k):
            if a == b:
                continue
            ok = (valid[a] & valid[b]
                  & (jnp.abs(depths[a] - depths[b]) < thr(depths[a])))
            agree = agree.at[a].add(ok.astype(jnp.float32))
    best = jnp.argmax(jnp.where(valid, agree, -1.0)
                      - costs * 1e-3, axis=0)             # (H, W)
    d_best = jnp.take_along_axis(depths, best[None], 0)[0]
    v_best = jnp.take_along_axis(valid, best[None], 0)[0]
    sup_best = jnp.take_along_axis(agree, best[None], 0)[0]
    # average every agreeing pair around the winner
    close = valid & (jnp.abs(depths - d_best[None])
                     < thr(jnp.maximum(d_best, 1e-9))[None])
    w_c = jnp.where(close, wts, 0.0)
    d_fused = (jnp.sum(w_c * depths, 0)
               / jnp.maximum(jnp.sum(w_c, 0), 1e-12))
    c_fused = (jnp.sum(w_c * costs, 0)
               / jnp.maximum(jnp.sum(w_c, 0), 1e-12))
    # require >= 1 cross-pair agreement wherever a cross-check EXISTS;
    # pixels with a single valid pair (invalid/padded neighbors) keep
    # their lone estimate — the cross-VIEW filter still checks them
    n_valid = valid.sum(0)
    keep = v_best & ((sup_best >= 1.0) | (n_valid <= 1))
    return jnp.where(keep, d_fused, 0.0), jnp.where(keep, c_fused,
                                                    2.0 * max_cost)


def sgm_scene(scene, cfg=None, n_depths: int = 64, n_pairs: int = 0,
              lr_check: bool = True):
    """SGM depth maps for every view, matched against each of its top
    neighbors and fused — the DensifyPointCloud --fusion-mode -1/-2 path
    (ref: SceneDensify.cpp:3899-3911 sgm.Match per image pair +
    SemiGlobalMatcher.cpp:530 Match / :739 Fuse).  Each pair runs the
    left-right cross-check (lr_consistency — the reverse-direction match
    is computed per pair), so single-pair mode rejects occlusion ghosts
    like the reference; the per-pair fusion is sgm_fuse_pairs; the
    remaining cross-VIEW consistency check is
    dense/fusion.cross_view_filter, applied by the caller exactly as for
    PatchMatch maps.

    ``scene`` is a dense.scene_driver.SceneTensors; ``n_pairs`` limits
    how many neighbors each view matches (0 = all in nbr_idx).  Returns
    (depth (N, H, W), normal (N, 3, H, W), conf (N, H, W)).
    """
    from hcmvs_tpu.dense.types import make_view_geometry, pixel_rays
    from hcmvs_tpu.ops.gradients import normals_from_depth
    n, h, w = scene.gray.shape
    v_all = scene.nbr_idx.shape[1]
    k = v_all if n_pairs <= 0 else min(n_pairs, v_all)

    def per_view(i):
        cam_i = jax.tree.map(lambda x: x[i], scene.cams)
        cams_nbr = jax.tree.map(lambda x: x[scene.nbr_idx[i]], scene.cams)
        geom = make_view_geometry(cam_i, cams_nbr)
        dsig_i = (1.0 / scene.d_min[i] - 1.0 / scene.d_max[i]) / n_depths

        def per_pair(j):
            import dataclasses as _dc
            sl = lambda x: jax.lax.dynamic_index_in_dim(  # noqa: E731
                x, j, 0, keepdims=True)
            geom_j = _dc.replace(
                geom, A=sl(geom.A), wv=sl(geom.wv), R_rel=sl(geom.R_rel),
                t_rel=sl(geom.t_rel), K_src=sl(geom.K_src),
                K_inv_src=sl(geom.K_inv_src), F=sl(geom.F))
            src_gray = scene.gray[scene.nbr_idx[i][j]]
            d, c = sgm_match(geom_j, scene.gray[i], src_gray,
                             scene.d_min[i], scene.d_max[i], n_depths)
            if lr_check:
                # reverse-direction match (src as reference) for the LR
                # cross-check — SemiGlobalMatcher.cpp:530's rectified
                # check, done in depth space
                nbr = scene.nbr_idx[i][j]
                cam_j = jax.tree.map(lambda x: x[nbr], scene.cams)
                cam_i1 = jax.tree.map(lambda x: x[None], cam_i)
                geom_rev = make_view_geometry(cam_j, cam_i1)
                # reverse match sweeps the SOURCE view's depth, so its
                # range must cover the source view — use the union of
                # both views' ranges (the reference's per-view dMin/dMax)
                d_rev, _ = sgm_match(geom_rev, src_gray, scene.gray[i],
                                     jnp.minimum(scene.d_min[i],
                                                 scene.d_min[nbr]),
                                     jnp.maximum(scene.d_max[i],
                                                 scene.d_max[nbr]),
                                     n_depths)
                ok = lr_consistency(geom_j, d, d_rev, dsig=dsig_i)
                d = jnp.where(ok, d, 0.0)
            valid = scene.nbr_valid[i, j]
            return (jnp.where(valid, d, 0.0),
                    jnp.where(valid, c, 1e9))

        pair_d, pair_c = jax.lax.map(per_pair, jnp.arange(k))
        depth, cost = sgm_fuse_pairs(pair_d, pair_c, dsig=dsig_i)
        rays = pixel_rays(geom.K_inv_ref, h, w)
        normal = normals_from_depth(depth, rays)
        conf = jnp.where(depth > 0,
                         jnp.maximum(1.0 - cost / 18.0, 0.01), 0.0)
        return depth, normal, conf

    return jax.vmap(per_view)(jnp.arange(n))
