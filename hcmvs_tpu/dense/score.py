"""PatchMatch cost terms, evaluated for every pixel in parallel.

Data-parallel re-design of the reference's per-pixel scoring
(ref: frame_main/libs/MVS/DepthMap.cpp:522-983 ScorePixelImage and
:987-1046 ScorePixel): instead of one C++ worker per pixel, every term is a
whole-image tensor expression — static patch offsets become shifted slices,
homography warps become fused FMA + gather, and the per-view loop is a
``vmap``.  All 3-vector fields are planes-first (3, H, W) and all 3x3
algebra is scalar-expanded (see dense/types.py LAYOUT RULE).

The cost stack and its blending schedule follow the reference:

  photometric phase (it_ext < photo2geo):
      score = (1-w_flow) * score_ncc + w_flow * score_flow
  geometric phase (it_ext >= photo2geo):
      s = (1-para_tapa) * score_ncc + para_tapa * score_geo
      s = (1-para_part) * s + para_part * score_gra
      s = (1-w_flow) * s + w_flow * score_flow
      s = (1-para_prior) * s + 2*(1-exp(-dd^2/2s^2)) * para_prior   [w/ prior]

with para_tapa/para_part selected per pixel from the texture-gradient
thresholds (ref: DepthMap.cpp:900-930).

Deliberate deviations from reference *bugs* (we implement the evident
intent; each is a no-op or near-no-op in the reference due to the bug):
 - DepthMap.cpp:931 overwrites the geo/part blend with a pure ncc+flow
   blend; we keep the composed blend.
 - DepthMap.cpp:777 the flow score is assigned to a shadowed local, so the
   term is almost always 0; we return the real score, and score 0 (not 1)
   for perfectly agreeing vectors: (1-|cos|) + (1-length_ratio).
 - DepthMap.cpp:681-687 sums fundamental-matrix rows out of bounds for the
   epipolar distance; we compute the true point-to-epiline distance.
 - geometric normal agreement compares normals from two different camera
   frames; we rotate the neighbor normal into the reference frame first.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from hcmvs_tpu.core.config import DenseConfig, resolve_engines
from hcmvs_tpu.dense.types import (ViewGeometry, mat3_apply,
                                   mat3_apply_t, normalize3)
from hcmvs_tpu.ops.sampling import (bilinear_sample_xy,
                                    nearest_sample_planes_batched)

_SIGMA_COLOR = 0.2          # ref: DepthMap.h:538 GetWeight sigmaColor
_GRA_STRONG = 100.0         # ref: DepthMap.cpp:457 hardcoded texture split
_STRONG_HALFWIN = 5         # ref: DepthMap.cpp:458


def patch_offsets(cfg: DenseConfig) -> Tuple[Tuple[int, int], ...]:
    """Static tuple of (dy, dx) patch sample offsets.

    Covers the *largest* half-window (weak texture); samples outside a
    pixel's adaptive half-window are masked at runtime
    (ref: DepthMap.cpp:450-462 FillPixelPatch adaptive window).
    """
    hw = max(cfg.adapt_half_window, cfg.patch_half_window)
    r = range(-hw, hw + 1, cfg.patch_step)
    return tuple((dy, dx) for dy in r for dx in r)


def halfwin_map(gra: jax.Array, cfg: DenseConfig) -> jax.Array:
    """Per-pixel adaptive half-window: small for strong texture."""
    return jnp.where(gra > _GRA_STRONG, float(_STRONG_HALFWIN),
                     float(cfg.adapt_half_window))


class RefPatchStats(NamedTuple):
    """Per-pixel weighted patch statistics of the reference image, constant
    across the whole estimation (ref: FillPixelPatch weightMap0 cache)."""

    tm: jax.Array        # (H, W) weighted patch mean
    norm_sq0: jax.Array  # (H, W) weighted centered sum of squares
    sum_w: jax.Array     # (H, W) sum of bilateral weights
    ref_pad: jax.Array   # (H+2P, W+2P) edge-padded gray image; P derived
                         # statically from the offsets (max |offset|)
    wts: jax.Array       # (S, H, W) bilateral patch weights per offset —
                         # candidate-independent, so the batched scoring
                         # path reuses them across every hypothesis
                         # instead of re-deriving them per scan step


def _pad_of(offsets) -> int:
    return int(max(max(abs(dy), abs(dx)) for dy, dx in offsets))


def _shifted(ref_pad: jax.Array, pad: int, dy: int, dx: int,
             h: int, w: int) -> jax.Array:
    """Static-offset slice of the padded image — free in XLA."""
    return ref_pad[pad + dy:pad + dy + h, pad + dx:pad + dx + w]


def _offset_weight(v_c: jax.Array, v_d: jax.Array, dy: int, dx: int,
                   hw: jax.Array) -> jax.Array:
    """Bilateral patch weight (ref: DepthMap.h:536-549 GetWeight) with the
    adaptive-window mask folded in."""
    w_color = (v_d - v_c) ** 2 * (-1.0 / (2.0 * _SIGMA_COLOR ** 2))
    w_spatial = (dy * dy + dx * dx) / (-2.0 * hw * hw)
    in_win = (max(abs(dy), abs(dx)) <= hw).astype(jnp.float32)
    return jnp.exp(w_color + w_spatial) * in_win


def _stacked_shifts(ref_pad: jax.Array, pad: int, offsets, h: int, w: int
                    ) -> jax.Array:
    """(S, H, W) stack of the statically-shifted reference values."""
    return jnp.stack([_shifted(ref_pad, pad, dy, dx, h, w)
                      for dy, dx in offsets])


def _weights_traced(v_c: jax.Array, v_d: jax.Array, dyf: jax.Array,
                    dxf: jax.Array, hw: jax.Array) -> jax.Array:
    """_offset_weight with traced offsets (for scan bodies)."""
    w_color = (v_d - v_c) ** 2 * (-1.0 / (2.0 * _SIGMA_COLOR ** 2))
    w_spatial = (dyf * dyf + dxf * dxf) / (-2.0 * hw * hw)
    in_win = jnp.maximum(jnp.abs(dyf), jnp.abs(dxf)) <= hw
    return jnp.exp(w_color + w_spatial) * in_win


def ref_patch_stats(ref_gray: jax.Array, hw: jax.Array,
                    offsets) -> RefPatchStats:
    h, w = ref_gray.shape
    pad = _pad_of(offsets)
    ref_pad = jnp.pad(ref_gray, pad, mode="edge")
    v_ds = _stacked_shifts(ref_pad, pad, offsets, h, w)
    offs = jnp.asarray(offsets, jnp.float32)
    wts = jax.vmap(lambda v_d, off: _weights_traced(
        ref_gray, v_d, off[0], off[1], hw))(v_ds, offs)
    sum_w = jnp.sum(wts, axis=0)
    tm = jnp.sum(wts * v_ds, axis=0) / jnp.maximum(sum_w, 1e-12)
    norm_sq0 = jnp.sum(wts * (v_ds - tm) ** 2, axis=0)
    return RefPatchStats(tm=tm, norm_sq0=norm_sq0, sum_w=sum_w,
                         ref_pad=ref_pad, wts=wts)


def photometric_scores(geom: ViewGeometry, src_grays: jax.Array,
                       stats: RefPatchStats, hw: jax.Array,
                       depth: jax.Array, normal: jax.Array, rays: jax.Array,
                       offsets, cfg: DenseConfig
                       ) -> Tuple[jax.Array, jax.Array]:
    """Weighted-ZNCC photometric cost per source view.

    ``normal``/``rays`` are (3, H, W).  Returns ``(scores, bad)`` both
    (V, H, W): the ``1 - zncc`` cost in [0, 2], and a mask of
    out-of-bounds / textureless evaluations that got the flat thRobust
    cost.  Callers must not rescale bad entries — the reference returns
    thRobust *before* the smoothness bonus (ref: ScorePixelImage
    DepthMap.cpp:526-595, early returns :558/:591).
    """
    h, w = depth.shape
    pad = _pad_of(offsets)
    th_robust = cfg.ncc_threshold_keep * 1.2  # ref: DepthMap.cpp:433

    nx, ny, nz = normal[0], normal[1], normal[2]
    n_ray0 = nx * rays[0] + ny * rays[1] + nz * rays[2]
    d_plane = n_ray0 * depth
    inv_dp = 1.0 / jnp.where(jnp.abs(d_plane) < 1e-12, 1e-12, d_plane)
    # n . ray(p+delta) = n_ray0 + nk_x*dx + nk_y*dy  (K_inv columns 0/1)
    Ki = geom.K_inv_ref
    nk_x = nx * Ki[0, 0] + ny * Ki[1, 0] + nz * Ki[2, 0]
    nk_y = nx * Ki[0, 1] + ny * Ki[1, 1] + nz * Ki[2, 1]

    v_, u_ = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                          jnp.arange(w, dtype=jnp.float32), indexing="ij")
    ref_center = stats.ref_pad[pad:pad + h, pad:pad + w]
    # pre-stacked shifted ref values: the only part of the offset loop that
    # needs static offsets; the rest scans so compile time stays flat in S
    v_ds = _stacked_shifts(stats.ref_pad, pad, offsets, h, w)
    offs = jnp.asarray(offsets, jnp.float32)

    def per_view(A, wvec, src):
        # homogeneous warp of the pixel grid: components kept as planes
        p0x = A[0, 0] * u_ + A[0, 1] * v_ + A[0, 2]
        p0y = A[1, 0] * u_ + A[1, 1] * v_ + A[1, 2]
        p0z = A[2, 0] * u_ + A[2, 1] * v_ + A[2, 2]

        def step(carry, inp):
            num, s1, sq1, sw = carry
            v_d, off = inp
            dyf, dxf = off[0], off[1]
            wt = _weights_traced(ref_center, v_d, dyf, dxf, hw)
            s = (n_ray0 + nk_x * dxf + nk_y * dyf) * inv_dp
            phx = p0x + A[0, 0] * dxf + A[0, 1] * dyf + wvec[0] * s
            phy = p0y + A[1, 0] * dxf + A[1, 1] * dyf + wvec[1] * s
            phz = p0z + A[2, 0] * dxf + A[2, 1] * dyf + wvec[2] * s
            inv_z = 1.0 / jnp.where(jnp.abs(phz) < 1e-9, 1e-9, phz)
            v1, valid = bilinear_sample_xy(src, phx * inv_z, phy * inv_z)
            wt = wt * valid
            return (num + wt * (v_d - stats.tm) * v1,
                    s1 + wt * v1,
                    sq1 + wt * v1 * v1,
                    sw + wt), None

        zeros = jnp.zeros((h, w), jnp.float32)
        (num, s1, sq1, sw), _ = jax.lax.scan(
            step, (zeros, zeros, zeros, zeros), (v_ds, offs))
        var1 = sq1 - s1 * s1 / jnp.maximum(sw, 1e-12)
        denom = jnp.sqrt(jnp.maximum(stats.norm_sq0 * var1, 1e-16))
        ncc = jnp.clip(num / denom, -1.0, 1.0)
        score = 1.0 - ncc

        # center visibility: warp the center pixel, require in-bounds
        s_c = n_ray0 * inv_dp
        cx = p0x + wvec[0] * s_c
        cy = p0y + wvec[1] * s_c
        cz = p0z + wvec[2] * s_c
        inv_cz = 1.0 / jnp.where(jnp.abs(cz) < 1e-9, 1e-9, cz)
        ucx = cx * inv_cz
        ucy = cy * inv_cz
        hs, ws = src.shape
        oob = ((ucx < 0) | (ucx > ws - 1) | (ucy < 0) | (ucy > hs - 1)
               | (cz <= 0))
        bad = (oob | (var1 <= 1e-12)
               | (stats.norm_sq0 <= cfg.min_patch_variance ** 2))
        return jnp.where(bad, th_robust, score), bad

    # vmap over views: the scoring body is traced once (compile time stays
    # flat in V) and XLA batches the gathers
    scores, bad = jax.vmap(per_view)(geom.A, geom.wv, src_grays)
    return scores, bad


def photometric_scores_warped(geom: ViewGeometry, src_grays: jax.Array,
                              stats: RefPatchStats, hw: jax.Array,
                              depth: jax.Array, normal: jax.Array,
                              rays: jax.Array, offsets, cfg: DenseConfig
                              ) -> Tuple[jax.Array, jax.Array]:
    """Warped-image weighted-ZNCC: the approximate scoring mode.

    Instead of warping all S patch samples through each pixel's own plane
    homography (S gathers per pixel — the reference's semantics), sample
    each source view ONCE per pixel at
    the hypothesis warp center, forming a warped source image, and take the
    patch values from that image at *static* offsets (free shifted slices).

    The two coincide exactly when neighboring pixels carry the same plane —
    which is precisely the fixed point propagation drives toward; during
    early random-init sweeps the approximation adds score noise comparable
    to the reference's own racy cross-view reads (SURVEY §5.2).  Gather
    cost drops by S (36x with default patch settings).
    """
    h, w = depth.shape
    pad = _pad_of(offsets)
    th_robust = cfg.ncc_threshold_keep * 1.2

    nx, ny, nz = normal[0], normal[1], normal[2]
    n_ray0 = nx * rays[0] + ny * rays[1] + nz * rays[2]
    d_plane = n_ray0 * depth
    inv_dp = 1.0 / jnp.where(jnp.abs(d_plane) < 1e-12, 1e-12, d_plane)

    v_, u_ = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                          jnp.arange(w, dtype=jnp.float32), indexing="ij")
    ref_center = stats.ref_pad[pad:pad + h, pad:pad + w]
    # partition: window corners are warped exactly (normal observability),
    # everything else reads the center-warped image — each offset once so
    # the accumulation stays consistent with ref_patch_stats' weights.
    # NOTE (measured): warped mode is only trustworthy on locally planar
    # scenes — candidate fields carry each pixel's own propagated plane,
    # so patches mix hypotheses on curved/ridge geometry (0.41 vs exact's
    # 0.95 2%-accuracy on the ridge golden scene); exact is the default.
    corner_offsets = tuple((dy, dx) for dy, dx in offsets
                           if abs(dy) == pad and abs(dx) == pad)
    scan_offsets = tuple(o for o in offsets if o not in corner_offsets)
    Ki = geom.K_inv_ref
    nk_x = nx * Ki[0, 0] + ny * Ki[1, 0] + nz * Ki[2, 0]
    nk_y = nx * Ki[0, 1] + ny * Ki[1, 1] + nz * Ki[2, 1]

    def center_warp(A, wvec, src):
        # center warp only: one bilinear sample per pixel
        s_c = n_ray0 * inv_dp
        phx = A[0, 0] * u_ + A[0, 1] * v_ + A[0, 2] + wvec[0] * s_c
        phy = A[1, 0] * u_ + A[1, 1] * v_ + A[1, 2] + wvec[1] * s_c
        phz = A[2, 0] * u_ + A[2, 1] * v_ + A[2, 2] + wvec[2] * s_c
        inv_z = 1.0 / jnp.where(jnp.abs(phz) < 1e-9, 1e-9, phz)
        warped, valid_c = bilinear_sample_xy(src, phx * inv_z, phy * inv_z)
        return warped, valid_c, (~(valid_c > 0)) | (phz <= 0)

    def corner_acc(A, wvec, src):
        # 4 corner samples warped exactly through the pixel's own plane:
        # the center warp is normal-independent (s_c = 1/depth), so without
        # these the slanted-plane orientation would be photometrically
        # unobservable in this mode
        zeros = jnp.zeros((h, w), jnp.float32)
        num, s1, sq1, sw = zeros, zeros, zeros, zeros
        for dy, dx in corner_offsets:
            v_d = _shifted(stats.ref_pad, pad, int(dy), int(dx), h, w)
            wt = _weights_traced(ref_center, v_d, jnp.float32(dy),
                                 jnp.float32(dx), hw)
            s = (n_ray0 + nk_x * dx + nk_y * dy) * inv_dp
            qx = A[0, 0] * (u_ + dx) + A[0, 1] * (v_ + dy) + A[0, 2] \
                + wvec[0] * s
            qy = A[1, 0] * (u_ + dx) + A[1, 1] * (v_ + dy) + A[1, 2] \
                + wvec[1] * s
            qz = A[2, 0] * (u_ + dx) + A[2, 1] * (v_ + dy) + A[2, 2] \
                + wvec[2] * s
            inv_qz = 1.0 / jnp.where(jnp.abs(qz) < 1e-9, 1e-9, qz)
            v1, ok = bilinear_sample_xy(src, qx * inv_qz, qy * inv_qz)
            wt = wt * ok
            num = num + wt * (v_d - stats.tm) * v1
            s1 = s1 + wt * v1
            sq1 = sq1 + wt * v1 * v1
            sw = sw + wt
        return jnp.stack([num, s1, sq1, sw])

    warped, valid_c, oob = jax.vmap(center_warp)(geom.A, geom.wv, src_grays)
    acc = jax.vmap(corner_acc)(geom.A, geom.wv, src_grays)
    warped_pad = jnp.pad(warped, ((0, 0), (pad, pad), (pad, pad)),
                         mode="edge")
    valid_pad = jnp.pad(valid_c.astype(jnp.float32),
                        ((0, 0), (pad, pad), (pad, pad)))

    v_ds = _stacked_shifts(stats.ref_pad, pad, scan_offsets, h, w)
    offs = jnp.asarray(scan_offsets, jnp.float32)

    def per_view(w_pad, vwarp_pad, acc_v):
        # patch stats from static shifts of the warped image; samples
        # whose source pixel was invalid are masked out of the window
        w_ds = _stacked_shifts(w_pad, pad, scan_offsets, h, w)
        vv_ds = _stacked_shifts(vwarp_pad, pad, scan_offsets, h, w)

        def step(carry, inp):
            num, s1, sq1, sw = carry
            v_d, w_d, ok, off = inp
            wt = _weights_traced(ref_center, v_d, off[0], off[1], hw) * ok
            return (num + wt * (v_d - stats.tm) * w_d,
                    s1 + wt * w_d,
                    sq1 + wt * w_d * w_d,
                    sw + wt), None

        (num, s1, sq1, sw), _ = jax.lax.scan(
            step, (acc_v[0], acc_v[1], acc_v[2], acc_v[3]),
            (v_ds, w_ds, vv_ds, offs))
        var1 = sq1 - s1 * s1 / jnp.maximum(sw, 1e-12)
        denom = jnp.sqrt(jnp.maximum(stats.norm_sq0 * var1, 1e-16))
        ncc = jnp.clip(num / denom, -1.0, 1.0)
        return 1.0 - ncc, var1

    score, var1 = jax.vmap(per_view)(warped_pad, valid_pad, acc)

    bad = (oob | (var1 <= 1e-12)
           | (stats.norm_sq0 <= cfg.min_patch_variance ** 2)[None])
    return jnp.where(bad, th_robust, score), bad


def photometric_scores_volume(geom: ViewGeometry, vol, stats: RefPatchStats,
                              hw: jax.Array, depth: jax.Array,
                              normal: jax.Array, rays: jax.Array, offsets,
                              cfg: DenseConfig
                              ) -> Tuple[jax.Array, jax.Array]:
    """Exact plane-homography scoring through sigma-volume lookups.

    Same geometry as photometric_scores (ref: ScorePixelImage,
    DepthMap.cpp:522-595) with the per-sample source fetch served from the
    per-pixel plane-sweep tables (ops/volume.py) instead of per-index
    bilinear gathers: the epipolar parameter

        s(p, delta) = (n_ray0 + nk_x*dx + nk_y*dy) * inv_dp

    is VIEW-INDEPENDENT, so one (S, H, W) index field feeds every view's
    table lookup; sample validity is the analytic valid-sigma interval
    (no gather).  The intensity is lerped between adjacent sigma planes
    (~<=1px apart along the epipolar line) — the only deviation from
    exact bilinear sampling, validated by the volume parity test and the
    ridge golden gate.
    """
    from hcmvs_tpu.ops.volume import (from_volume_order, to_volume_order,
                                      use_rect_volume_build,
                                      volume_lookup_xla)
    h, w = depth.shape
    # the rect-frame build (ops/volume.py) writes tables in tile-major
    # pixel order; mirror its gate so f2 rows line up with tab rows
    blocked = use_rect_volume_build(cfg, h, w)
    pad = _pad_of(offsets)
    th_robust = cfg.ncc_threshold_keep * 1.2
    s_count = len(offsets)

    nx, ny, nz = normal[0], normal[1], normal[2]
    n_ray0 = nx * rays[0] + ny * rays[1] + nz * rays[2]
    d_plane = n_ray0 * depth
    inv_dp = 1.0 / jnp.where(jnp.abs(d_plane) < 1e-12, 1e-12, d_plane)
    Ki = geom.K_inv_ref
    nk_x = nx * Ki[0, 0] + ny * Ki[1, 0] + nz * Ki[2, 0]
    nk_y = nx * Ki[0, 1] + ny * Ki[1, 1] + nz * Ki[2, 1]
    s_c = n_ray0 * inv_dp
    gx = nk_x * inv_dp
    gy = nk_y * inv_dp

    # forward-shifted s fields: row q of field k holds s(q - delta_k) —
    # the lookup lands on the table row of the SAMPLE pixel q = p + delta
    s_cp = jnp.pad(s_c, pad, mode="edge")
    gxp = jnp.pad(gx, pad, mode="edge")
    gyp = jnp.pad(gy, pad, mode="edge")
    fwd = jnp.stack([
        _shifted(s_cp, pad, -dy, -dx, h, w)
        + _shifted(gxp, pad, -dy, -dx, h, w) * dx
        + _shifted(gyp, pad, -dy, -dx, h, w) * dy
        for dy, dx in offsets])                       # (S, H, W)

    # the sigma grid is shared across views (built from d_min/d_max only)
    f3 = (fwd - vol.sig0[0]) * vol.inv_dsig[0]
    p_pad = vol.tab.shape[1]
    f_flat = (to_volume_order(f3) if blocked
              else f3.reshape(s_count, h * w))
    p_used = f_flat.shape[1]            # tile-padded pixel count when
    f2 = jnp.pad(f_flat.T,              # blocked (ops/volume.py)
                 ((0, p_pad - p_used), (0, 0)))        # (P_pad, S)

    ref_center = stats.ref_pad[pad:pad + h, pad:pad + w]
    v_ds = _stacked_shifts(stats.ref_pad, pad, offsets, h, w)
    offs = jnp.asarray(offsets, jnp.float32)

    def per_view(tab_v, lo_v, hi_v):
        out2 = volume_lookup_xla(tab_v, f2)
        if blocked:
            v3 = from_volume_order(out2[:p_used].T, h, w)
        else:
            v3 = out2[:p_used].T.reshape(s_count, h, w)
        # validity: the analytic in-image sigma interval AND the grid's
        # own range — beyond-grid sigmas would otherwise silently clamp
        # onto the edge plane's intensity (wrong value, not invalid)
        sig_hi_grid = vol.sig0[0] + (tab_v.shape[1] - 1) / vol.inv_dsig[0]
        ok3 = ((fwd >= lo_v[None]) & (fwd <= hi_v[None])
               & (fwd >= vol.sig0[0]) & (fwd <= sig_hi_grid))
        # consumption shift: center p reads sample row p + delta (zero
        # validity at borders where the sample pixel falls off-image)
        v3p = jnp.pad(v3, ((0, 0), (pad, pad), (pad, pad)))
        ok3p = jnp.pad(ok3.astype(jnp.float32),
                       ((0, 0), (pad, pad), (pad, pad)))
        v_cons = jnp.stack([_shifted(v3p[k], pad, dy, dx, h, w)
                            for k, (dy, dx) in enumerate(offsets)])
        ok_cons = jnp.stack([_shifted(ok3p[k], pad, dy, dx, h, w)
                             for k, (dy, dx) in enumerate(offsets)])

        def step(carry, inp):
            num, s1, sq1, sw = carry
            v_d, v1, ok, off = inp
            wt = _weights_traced(ref_center, v_d, off[0], off[1], hw) * ok
            return (num + wt * (v_d - stats.tm) * v1,
                    s1 + wt * v1,
                    sq1 + wt * v1 * v1,
                    sw + wt), None

        zeros = jnp.zeros((h, w), jnp.float32)
        (num, s1, sq1, sw), _ = jax.lax.scan(
            step, (zeros, zeros, zeros, zeros), (v_ds, v_cons, ok_cons,
                                                 offs))
        var1 = sq1 - s1 * s1 / jnp.maximum(sw, 1e-12)
        denom = jnp.sqrt(jnp.maximum(stats.norm_sq0 * var1, 1e-16))
        ncc = jnp.clip(num / denom, -1.0, 1.0)
        score = 1.0 - ncc
        # center visibility: the hypothesis itself must be inside the
        # valid-sigma interval at p (the analog of the exact path's
        # center warp in-bounds test)
        oob = (s_c < lo_v) | (s_c > hi_v)
        bad = (oob | (var1 <= 1e-12)
               | (stats.norm_sq0 <= cfg.min_patch_variance ** 2))
        return jnp.where(bad, th_robust, score), bad

    return jax.vmap(per_view)(vol.tab, vol.sig_lo, vol.sig_hi)


def photometric_scores_volume_batched(geom: ViewGeometry, vol,
                                      stats: RefPatchStats, hw: jax.Array,
                                      depths: jax.Array, normals: jax.Array,
                                      rays: jax.Array, offsets,
                                      cfg: DenseConfig
                                      ) -> Tuple[jax.Array, jax.Array]:
    """Exact sigma-volume scoring of a BATCH of K candidate hypotheses.

    Semantics identical to vmapping photometric_scores_volume over the
    candidate axis, but all K x S index columns ride ONE table lookup per
    view, so the (P, D) sigma table is read once per view instead of once
    per candidate (ref: the ProcessPixel candidate loop,
    frame_main/libs/MVS/DepthMap.cpp:1050-1668).  The ZNCC accumulation
    uses the precomputed candidate-independent bilateral weights
    (stats.wts) as a vectorized reduction over the offset axis instead
    of a per-offset scan.

    ``depths`` (K, H, W), ``normals`` (K, 3, H, W); returns
    (scores, bad) both (K, V, H, W).
    """
    from hcmvs_tpu.ops.volume import (from_volume_order_multi,
                                      to_volume_order_multi,
                                      use_rect_volume_build,
                                      volume_lookup_xla)
    k_n, h, w = depths.shape
    blocked = use_rect_volume_build(cfg, h, w)
    pad = _pad_of(offsets)
    th_robust = cfg.ncc_threshold_keep * 1.2
    s_count = len(offsets)
    Ki = geom.K_inv_ref
    p_pad = vol.tab.shape[1]
    d_planes = vol.tab.shape[-1]
    c_total = k_n * s_count

    def fields(depth, normal):
        nx, ny, nz = normal[0], normal[1], normal[2]
        n_ray0 = nx * rays[0] + ny * rays[1] + nz * rays[2]
        d_plane = n_ray0 * depth
        inv_dp = 1.0 / jnp.where(jnp.abs(d_plane) < 1e-12, 1e-12, d_plane)
        nk_x = nx * Ki[0, 0] + ny * Ki[1, 0] + nz * Ki[2, 0]
        nk_y = nx * Ki[0, 1] + ny * Ki[1, 1] + nz * Ki[2, 1]
        s_c = n_ray0 * inv_dp
        gx = nk_x * inv_dp
        gy = nk_y * inv_dp
        s_cp = jnp.pad(s_c, pad, mode="edge")
        gxp = jnp.pad(gx, pad, mode="edge")
        gyp = jnp.pad(gy, pad, mode="edge")
        # forward-shifted: row q of field k holds s(q - delta_k) so the
        # lookup lands on the SAMPLE pixel's table row (see
        # photometric_scores_volume)
        fwd = jnp.stack([_shifted(s_cp, pad, -dy, -dx, h, w)
                         + _shifted(gxp, pad, -dy, -dx, h, w) * dx
                         + _shifted(gyp, pad, -dy, -dx, h, w) * dy
                         for dy, dx in offsets])
        return fwd, s_c

    fwd_all, s_c_all = jax.vmap(fields)(depths, normals)  # (K,S,H,W)
    f_c = ((fwd_all - vol.sig0[0]) * vol.inv_dsig[0]).reshape(c_total, h, w)
    if blocked:
        f2 = to_volume_order_multi(f_c)                # (P_used, C)
    else:
        f2 = f_c.reshape(c_total, h * w).T
    p_used = f2.shape[0]
    f2 = jnp.pad(f2, ((0, p_pad - p_used), (0, 0)))    # (P_pad, C)
    v_ds = _stacked_shifts(stats.ref_pad, pad, offsets, h, w)
    coef_num = stats.wts * (v_ds - stats.tm[None])     # (S, H, W)
    # beyond-grid sigmas would silently clamp onto the edge plane
    sig_hi_grid = vol.sig0[0] + (d_planes - 1) / vol.inv_dsig[0]

    def consume_core(v3k, okk, s_ck, lo_v, hi_v):
        """ZNCC of one candidate from its (S, H, W) sample panel."""
        # consumption shift: center p reads sample row p + delta
        v3p = jnp.pad(v3k, ((0, 0), (pad, pad), (pad, pad)))
        ok3p = jnp.pad(okk.astype(jnp.float32),
                       ((0, 0), (pad, pad), (pad, pad)))
        v_cons = jnp.stack([_shifted(v3p[k], pad, dy, dx, h, w)
                            for k, (dy, dx) in enumerate(offsets)])
        ok_cons = jnp.stack([_shifted(ok3p[k], pad, dy, dx, h, w)
                             for k, (dy, dx) in enumerate(offsets)])
        w_eff = stats.wts * ok_cons                    # (S, H, W)
        sw = jnp.sum(w_eff, axis=0)
        wv = w_eff * v_cons
        s1 = jnp.sum(wv, axis=0)
        sq1 = jnp.sum(wv * v_cons, axis=0)
        num = jnp.sum(coef_num * ok_cons * v_cons, axis=0)
        var1 = sq1 - s1 * s1 / jnp.maximum(sw, 1e-12)
        denom = jnp.sqrt(jnp.maximum(stats.norm_sq0 * var1, 1e-16))
        ncc = jnp.clip(num / denom, -1.0, 1.0)
        score = 1.0 - ncc
        oob = (s_ck < lo_v) | (s_ck > hi_v)
        bad = (oob | (var1 <= 1e-12)
               | (stats.norm_sq0 <= cfg.min_patch_variance ** 2))
        return jnp.where(bad, th_robust, score), bad

    def per_view(tab_v, lo_v, hi_v):
        out2 = volume_lookup_xla(tab_v, f2)
        if blocked:
            v3 = from_volume_order_multi(out2[:p_used], h, w)
        else:
            v3 = out2[:p_used].T.reshape(c_total, h, w)
        v3 = v3.reshape(k_n, s_count, h, w)            # (K, S, H, W)
        ok3 = ((fwd_all >= lo_v[None, None])
               & (fwd_all <= hi_v[None, None])
               & (fwd_all >= vol.sig0[0]) & (fwd_all <= sig_hi_grid))
        return jax.vmap(
            lambda v3k, okk, s_ck: consume_core(v3k, okk, s_ck, lo_v,
                                                hi_v))(v3, ok3, s_c_all)

    # Python loop over views (V is small and static): each view's big
    # (P_pad, C) lookup output is consumed before the next view's is
    # produced, bounding peak device memory at reference-scale sizes
    v = vol.tab.shape[0]
    scores, bads = [], []
    for vi in range(v):
        s_v, b_v = per_view(vol.tab[vi], vol.sig_lo[vi], vol.sig_hi[vi])
        scores.append(s_v)
        bads.append(b_v)
    return (jnp.stack(scores, axis=1), jnp.stack(bads, axis=1))


def use_candidate_batch(cfg: DenseConfig) -> bool:
    """Whether propagation candidates are scored as one batched lookup
    per view (requires the volume backend).  "auto" resolves OFF: the
    per-candidate scan is the default until a trace on the card says
    otherwise."""
    return cfg.candidate_kernel == "on"


def use_volume_tables(cfg: DenseConfig) -> bool:
    """Whether exact scoring routes through the sigma-volume tables."""
    return (cfg.score_mode in ("exact", "hybrid")
            and resolve_engines(cfg).exact == "volume")


def score_photometric(geom: ViewGeometry, src_grays: jax.Array,
                      stats: RefPatchStats, hw: jax.Array, depth: jax.Array,
                      normal: jax.Array, rays: jax.Array, offsets,
                      cfg: DenseConfig, phase: int = 1,
                      vol=None) -> Tuple[jax.Array, jax.Array]:
    """Dispatch on cfg.score_mode.

    "hybrid" runs the cheap warped approximation during the photometric
    exploration phase and exact reference-semantics scoring once the
    geometric phase starts — most of the quality of exact at a fraction
    of its cost (the early random/propagation sweeps only need scores
    good enough to rank hypotheses)."""
    exact = (cfg.score_mode == "exact"
             or (cfg.score_mode == "hybrid" and phase >= 1))
    if exact and vol is not None:
        return photometric_scores_volume(geom, vol, stats, hw, depth,
                                         normal, rays, offsets, cfg)
    fn = photometric_scores if exact else photometric_scores_warped
    return fn(geom, src_grays, stats, hw, depth, normal, rays, offsets, cfg)


def aggregate_scores(scores: jax.Array, cfg: DenseConfig) -> jax.Array:
    """Min-mean aggregation over views (ref: ScorePixel
    DENSE_AGGNCC_MINMEAN, DepthMap.cpp:1015-1032): mean of the best
    ``idxScore+1`` view scores, dropping any beyond thRobust."""
    th_robust = cfg.ncc_threshold_keep * 1.2
    n_views = scores.shape[0]
    if n_views <= 2:
        return jnp.min(scores, axis=0)
    k = 2  # idxScore = 1 for >2 views (ref: DepthMap.cpp:422)
    neg_top, _ = jax.lax.top_k(jnp.moveaxis(-scores, 0, -1), k)
    best = -neg_top  # (..., k) ascending
    use = jnp.concatenate(
        [jnp.ones_like(best[..., :1], dtype=bool),
         best[..., 1:] < th_robust], axis=-1)
    return (jnp.sum(jnp.where(use, best, 0.0), axis=-1)
            / jnp.sum(use, axis=-1))


def use_rect_backend(cfg: DenseConfig, h: int, w: int) -> bool:
    """Whether neighbor-map lookups route through the rectified-epipolar
    engine (ops/rect_gather.py; unaligned sizes tile-pad internally)."""
    del h, w
    return resolve_engines(cfg).geo == "rect"


def _rect_taps(rect, depth: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """(V, 4, H, W) neighbor (depth, normal) samples at each pixel's
    forward projection, via the rect engine; valid = depth tap > 0.
    The rect maps carry the 2-word packed encoding (pack_depth_normals)."""
    from hcmvs_tpu.ops.rect_gather import rect_lookup_xla, unpack_taps
    sigma = 1.0 / jnp.maximum(depth, 1e-9)
    return unpack_taps(rect_lookup_xla(rect, sigma))


def geometric_scores(geom: ViewGeometry, depth: jax.Array, normal: jax.Array,
                     rays: jax.Array, nbr_depth: jax.Array,
                     nbr_normal: jax.Array, cfg: DenseConfig,
                     rect=None) -> jax.Array:
    """Forward-backward reprojection consistency per view: (V, H, W) in
    [0, 2] (ref: DepthMap.cpp:625-732).

    ``normal``/``rays`` are (3, H, W); ``nbr_normal`` is (V, 3, H, W).
    For each pixel: project into the neighbor view with the hypothesis
    depth, look up the neighbor's current (depth, normal), back-project and
    measure the reprojection error against the epipolar-line distance
    normalizer, plus a normal-agreement term.
    """
    h, w = depth.shape
    v_, u_ = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                          jnp.arange(w, dtype=jnp.float32), indexing="ij")
    X0 = (rays[0] * depth, rays[1] * depth, rays[2] * depth)
    max_dist = float(np.hypot(w / 2, h / 2))

    def fwd_view(R_rel, t_rel, K_src):
        X1 = mat3_apply(R_rel, X0)
        X1 = (X1[0] + t_rel[0], X1[1] + t_rel[1], X1[2] + t_rel[2])
        p1 = mat3_apply(K_src, X1)
        z1 = p1[2]
        inv_z1 = 1.0 / jnp.where(jnp.abs(z1) < 1e-9, 1e-9, z1)
        u1 = p1[0] * inv_z1
        v1c = p1[1] * inv_z1
        in1 = (u1 >= 0) & (u1 <= w - 1) & (v1c >= 0) & (v1c <= h - 1) \
            & (z1 > 0)
        return u1, v1c, in1

    u1_all, v1_all, in1_all = jax.vmap(fwd_view)(geom.R_rel, geom.t_rel,
                                                 geom.K_src)
    # nearest lookups, matching the reference's integer-pixel reads
    # (depthMap(x1_i), DepthMap.cpp:652-655).  With a rect context the
    # samples come from the rectified-epipolar engine
    # (ops/rect_gather.py); otherwise depth + 3 normal planes of ALL V
    # views ride ONE flat gather (ops/sampling.py)
    if rect is not None:
        taps_all, vd_all = _rect_taps(rect, depth)
    else:
        taps_all, vd_all = nearest_sample_planes_batched(
            jnp.concatenate([nbr_depth[:, None], nbr_normal], axis=1),
            jnp.round(u1_all), jnp.round(v1_all))

    def per_view(R_rel, t_rel, K_inv_src, F, u1, v1c, in1, taps, vd):
        d1 = taps[0]
        n1 = normalize3((taps[1], taps[2], taps[3]))
        # back-project via neighbor's depth
        ray1 = mat3_apply(K_inv_src, (u1, v1c, jnp.ones_like(u1)))
        X1b = (ray1[0] * d1, ray1[1] * d1, ray1[2] * d1)
        X0b = mat3_apply_t(R_rel, (X1b[0] - t_rel[0], X1b[1] - t_rel[1],
                                   X1b[2] - t_rel[2]))
        p0b = mat3_apply(geom.K_ref, X0b)
        z0b = p0b[2]
        inv_z0b = 1.0 / jnp.where(jnp.abs(z0b) < 1e-9, 1e-9, z0b)
        u0b = p0b[0] * inv_z0b
        v0b = p0b[1] * inv_z0b
        in0 = (u0b >= 0) & (u0b <= w - 1) & (v0b >= 0) & (v0b <= h - 1) \
            & (z0b > 0)
        err = jnp.hypot(u0b - u_, v0b - v_)
        # epipolar distance of x0 to the epiline of x1 (the adaptive
        # normalizer for the reprojection error); line = F^T [u1,v1,1]
        lin = mat3_apply_t(F, (u1, v1c, jnp.ones_like(u1)))
        dis = (jnp.abs(lin[0] * u_ + lin[1] * v_ + lin[2])
               / jnp.maximum(jnp.hypot(lin[0], lin[1]), 1e-9))
        dis = jnp.maximum(dis, 0.5)   # floor: sub-pixel epiline distances
        # normal agreement in a common (ref) frame
        n1_ref = mat3_apply_t(R_rel, n1)
        cos_n = jnp.abs(normal[0] * n1_ref[0] + normal[1] * n1_ref[1]
                        + normal[2] * n1_ref[2])
        score = jnp.where(err < dis * cfg.maxgeo_proportion,
                          err / dis + (1.0 - cos_n), 2.0)
        bad = (~in1) | (~in0) | (d1 <= 0) | (~vd) | (err > max_dist)
        return jnp.where(bad, 1.0, jnp.minimum(score, 2.0))

    return jax.vmap(per_view)(geom.R_rel, geom.t_rel, geom.K_inv_src,
                              geom.F, u1_all, v1_all, in1_all, taps_all,
                              vd_all)


def view_spread_candidates(geom: ViewGeometry, depth: jax.Array,
                           rays: jax.Array, nbr_depth: jax.Array,
                           nbr_normal: jax.Array, rect=None
                           ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Cross-view hypothesis harvesting (ref: OPTDENSE::viewspread,
    DepthMap.cpp:1504-1608): map each pixel into every neighbor view with
    its current depth, read that view's (depth, normal) there, and
    reproject them into the reference frame as PatchMatch candidates.

    Returns (cand_depth (V,H,W), cand_normal (V,3,H,W) facing the ref
    camera, valid (V,H,W)).
    """
    h, w = depth.shape
    X0 = (rays[0] * depth, rays[1] * depth, rays[2] * depth)

    def fwd_view(R_rel, t_rel, K_src):
        X1 = mat3_apply(R_rel, X0)
        X1 = (X1[0] + t_rel[0], X1[1] + t_rel[1], X1[2] + t_rel[2])
        p1 = mat3_apply(K_src, X1)
        inv_z1 = 1.0 / jnp.where(jnp.abs(p1[2]) < 1e-9, 1e-9, p1[2])
        return (jnp.round(p1[0] * inv_z1), jnp.round(p1[1] * inv_z1),
                p1[2])

    u1_all, v1_all, z1_all = jax.vmap(fwd_view)(geom.R_rel, geom.t_rel,
                                                geom.K_src)
    if rect is not None:
        taps_all, ok_all = _rect_taps(rect, depth)
    else:
        taps_all, ok_all = nearest_sample_planes_batched(
            jnp.concatenate([nbr_depth[:, None], nbr_normal], axis=1),
            u1_all, v1_all)

    def per_view(R_rel, t_rel, K_inv_src, u1, v1, z1, taps, ok_d):
        d1 = taps[0]
        n1 = (taps[1], taps[2], taps[3])
        # back-project the neighbor's hypothesis into the ref frame
        ray1 = mat3_apply(K_inv_src, (u1, v1, jnp.ones_like(u1)))
        X1b = (ray1[0] * d1, ray1[1] * d1, ray1[2] * d1)
        X0b = mat3_apply_t(R_rel, (X1b[0] - t_rel[0], X1b[1] - t_rel[1],
                                   X1b[2] - t_rel[2]))
        cand_d = X0b[2]
        n_ref = normalize3(mat3_apply_t(R_rel, n1))
        valid = ok_d & (d1 > 0) & (z1 > 0) & (cand_d > 0)
        return cand_d, jnp.stack(n_ref), valid

    return jax.vmap(per_view)(geom.R_rel, geom.t_rel, geom.K_inv_src,
                              u1_all, v1_all, z1_all, taps_all, ok_all)


def flow_score(geom: ViewGeometry, depth: jax.Array, rays: jax.Array,
               flow: jax.Array, view_idx: int = 0) -> jax.Array:
    """Optical-flow cross-consistency against the best neighbor: (H, W) in
    [0, 2] (ref: DepthMap.cpp:741-792; applied to idxView==1 only).

    ``flow`` is (2, H, W) (u, v planes).  Compares the PatchMatch-implied
    motion vector (projection into the neighbor minus the pixel) with the
    precomputed dense flow field, scoring direction and length agreement.
    """
    h, w = depth.shape
    v_, u_ = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                          jnp.arange(w, dtype=jnp.float32), indexing="ij")
    X0 = (rays[0] * depth, rays[1] * depth, rays[2] * depth)
    X1 = mat3_apply(geom.R_rel[view_idx], X0)
    t = geom.t_rel[view_idx]
    X1 = (X1[0] + t[0], X1[1] + t[1], X1[2] + t[2])
    p1 = mat3_apply(geom.K_src[view_idx], X1)
    z1 = p1[2]
    inv_z1 = 1.0 / jnp.where(jnp.abs(z1) < 1e-9, 1e-9, z1)
    u1 = p1[0] * inv_z1
    v1c = p1[1] * inv_z1
    mvx = u1 - u_
    mvy = v1c - v_
    fvx, fvy = flow[0], flow[1]
    n_mv = jnp.hypot(mvx, mvy)
    n_fv = jnp.hypot(fvx, fvy)
    max_dist = float(np.hypot(w / 2, h / 2))
    cos = (mvx * fvx + mvy * fvy) / jnp.maximum(n_mv * n_fv, 1e-9)
    ratio = jnp.minimum(n_mv, n_fv) / jnp.maximum(jnp.maximum(n_mv, n_fv),
                                                  1e-9)
    score = (1.0 - jnp.abs(cos)) + (1.0 - ratio)
    score = jnp.where(n_mv >= max_dist, 2.0, score)
    score = jnp.where((n_mv < 1e-6) & (n_fv >= 1e-6), 1.0, score)
    score = jnp.where((n_mv >= 1e-6) & (n_fv < 1e-6), 0.0, score)
    score = jnp.where((n_mv < 1e-6) & (n_fv < 1e-6), 0.0, score)
    oob = (u1 < 0) | (u1 > w - 1) | (v1c < 0) | (v1c > h - 1) | (z1 <= 0)
    return jnp.where(oob, 1.0, jnp.clip(score, 0.0, 2.0))


def local_smoothness_score(depth_map: jax.Array, normal_map: jax.Array,
                           rays: jax.Array, depth: jax.Array,
                           normal: jax.Array, d_max: jax.Array,
                           delta_c2pmax: jax.Array) -> jax.Array:
    """Local depth/normal/plane-distance consistency: (H, W) in [0, 2]
    (ref: DepthMap.cpp:798-887 — 4x4 neighborhood mean |d-d_n|, |n-n_n|_1,
    |n.X - n.X_n| with dMax/delta_c2pmax normalizers).

    ``normal_map``/``rays`` are (3, H, W).
    """
    h, w = depth.shape
    c2p_cur = (normal[0] * rays[0] + normal[1] * rays[1]
               + normal[2] * rays[2]) * depth
    pad = 2
    dm_pad = jnp.pad(depth_map, pad, mode="edge")
    nm_pad = jnp.pad(normal_map, ((0, 0), (pad, pad), (pad, pad)),
                     mode="edge")
    rays_pad = jnp.pad(rays, ((0, 0), (pad, pad), (pad, pad)), mode="edge")
    diff = jnp.zeros((h, w), jnp.float32)
    ndiff = jnp.zeros((h, w), jnp.float32)
    c2pdiff = jnp.zeros((h, w), jnp.float32)
    cnt = jnp.zeros((h, w), jnp.float32)
    for dy in range(-2, 2):
        for dx in range(-2, 2):
            ys = slice(pad + dy, pad + dy + h)
            xs = slice(pad + dx, pad + dx + w)
            d_n = dm_pad[ys, xs]
            ok = (d_n > 0).astype(jnp.float32)
            diff = diff + ok * jnp.abs(depth - d_n)
            nd = (jnp.abs(normal[0] - nm_pad[0, ys, xs])
                  + jnp.abs(normal[1] - nm_pad[1, ys, xs])
                  + jnp.abs(normal[2] - nm_pad[2, ys, xs]))
            ndiff = ndiff + ok * nd
            c2p_n = (normal[0] * rays_pad[0, ys, xs]
                     + normal[1] * rays_pad[1, ys, xs]
                     + normal[2] * rays_pad[2, ys, xs]) * d_n
            c2pdiff = c2pdiff + ok * jnp.abs(c2p_cur - c2p_n)
            cnt = cnt + ok
    cnt = jnp.maximum(cnt, 1.0)
    diff = diff / cnt
    ndiff = (ndiff / cnt / 3.0) * 2.0
    c2pdiff = c2pdiff / cnt
    diff_max = d_max * 0.5
    c2p_max = jnp.maximum(delta_c2pmax * 0.5, 1e-9)
    diff = jnp.where(diff > diff_max, 2.0, 2.0 * diff / diff_max)
    c2pdiff = jnp.where(c2pdiff > c2p_max, 2.0, 2.0 * c2pdiff / c2p_max)
    return (diff + ndiff + c2pdiff) / 3.0


def smoothness_bonus(depth_map: jax.Array, normal_map: jax.Array,
                     rays: jax.Array, depth: jax.Array, normal: jax.Array,
                     cfg: DenseConfig) -> jax.Array:
    """Multiplicative smoothness bonus on the photometric score from the
    4-adjacent neighbors (ref: DepthMap.cpp:605-617 — plane-distance and
    normal-angle factors, bonus = 1-fRandomSmoothBonus).

    ``normal_map``/``rays``/``normal`` are (3, H, W).
    """
    h, w = depth.shape
    bonus_d = 1.0 - cfg.random_smooth_bonus
    bonus_n = (1.0 - cfg.random_smooth_bonus) * 0.96
    sigma_d = -1.0 / (2.0 * cfg.random_smooth_depth ** 2)
    sigma_n = -1.0 / (2.0 * np.radians(cfg.random_smooth_normal) ** 2)
    dm_pad = jnp.pad(depth_map, 1, mode="edge")
    nm_pad = jnp.pad(normal_map, ((0, 0), (1, 1), (1, 1)), mode="edge")
    rays_pad = jnp.pad(rays, ((0, 0), (1, 1), (1, 1)), mode="edge")
    factor = jnp.ones((h, w), jnp.float32)
    n_dot_ray = (normal[0] * rays[0] + normal[1] * rays[1]
                 + normal[2] * rays[2])
    plane_d = n_dot_ray * depth
    inv_depth = 1.0 / jnp.maximum(depth, 1e-9)
    for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        ys = slice(1 + dy, 1 + dy + h)
        xs = slice(1 + dx, 1 + dx + w)
        d_n = dm_pad[ys, xs]
        # distance of the neighbor's point to the hypothesis plane, / depth
        nX = (normal[0] * rays_pad[0, ys, xs]
              + normal[1] * rays_pad[1, ys, xs]
              + normal[2] * rays_pad[2, ys, xs]) * d_n
        dist = (nX - plane_d) * inv_depth
        f_d = jnp.exp(dist ** 2 * sigma_d)
        cos = jnp.clip(normal[0] * nm_pad[0, ys, xs]
                       + normal[1] * nm_pad[1, ys, xs]
                       + normal[2] * nm_pad[2, ys, xs], -1.0, 1.0)
        f_n = jnp.exp(jnp.arccos(cos) ** 2 * sigma_n)
        ok = (d_n > 0).astype(jnp.float32)
        factor = factor * (1.0 - bonus_d * f_d * ok) \
                        * (1.0 - bonus_n * f_n * ok)
    return factor


def prior_blend(score: jax.Array, depth: jax.Array, prior_depth: jax.Array,
                cfg: DenseConfig) -> jax.Array:
    """Planar-prior term (ref: DepthMap.cpp:940-955): pull the score toward
    agreement with the prior depth where a prior exists."""
    dd = (prior_depth - depth) / jnp.maximum(jnp.abs(prior_depth), 1e-9)
    w_prior = jnp.exp(-(dd ** 2) / (2.0 * cfg.sigma_prior ** 2))
    blended = (score * (1.0 - cfg.para_prior)
               + 2.0 * (1.0 - w_prior) * cfg.para_prior)
    return jnp.where(prior_depth > 0, blended, score)


def texture_weights(gra: jax.Array, cfg: DenseConfig
                    ) -> Tuple[jax.Array, jax.Array]:
    """Per-pixel (para_tapa, para_part) from the gradient thresholds
    (ref: DepthMap.cpp:906-928): weak texture gets the strong geometric /
    smoothness weights, mid texture the secondary ones, strong texture
    none."""
    para_tapa = jnp.where(
        gra < cfg.tx_threshold, cfg.para_tapa,
        jnp.where(gra < cfg.tx_threshold2, cfg.para_tapa2, 0.0))
    para_part = jnp.where(
        gra < cfg.tx_threshold, cfg.para_part,
        jnp.where(gra < cfg.tx_threshold2, cfg.para_part2, 0.0))
    if not cfg.use_geo_consistency:
        para_tapa = jnp.zeros_like(para_tapa)
    if not cfg.use_part_consistency:
        para_part = jnp.zeros_like(para_part)
    return para_tapa, para_part
