"""Plane-sweep sigma-volume tables: a table-lookup engine for exact scoring.

The reference's hot op — per-pixel plane-homography patch warp + weighted
ZNCC (ref: frame_main/libs/MVS/DepthMap.cpp:522-595 ScorePixelImage) —
samples each source view at per-pixel, per-candidate, per-patch-offset
positions.  Every warp position lies on the pixel's epipolar line,
parameterized by the scalar

    s(p, delta) = (n . ray(p+delta)) / ((n . ray(p)) * depth(p))

in  warp(p, delta) = A.(p+delta) + wv * s  (the existing ViewGeometry
decomposition).  So per (ref, src) pair the source can be resampled ONCE
along every pixel's epipolar line at D uniform s-steps into a pixel-major
table ``tab[q, j] = src(proj(A.q + wv * sigma_j))`` — and every exact
score sample becomes a 1-D lookup ``lerp(tab[p+delta], f(s))``.

Semantics vs the reference: identical plane-homography geometry; the
source intensity is linearly interpolated between adjacent sigma planes
instead of bilinearly at the exact warp point.  With D chosen so adjacent
planes are ~1px apart along the epipolar segment the residual is below
image-noise level (validated by tests/test_volume.py parity + the ridge
golden gate).

In-image validity per sample is an *interval* in sigma (the epipolar ray
crosses each image border once), precomputed analytically per pixel —
the per-sample OOB test costs no gather.

Which engine "auto" selects is decided in core/config.resolve_engines.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from hcmvs_tpu.ops.sampling import bilinear_sample_xy

D_PLANES = 128          # sigma planes per table chunk
TAB_DTYPE = jnp.uint16  # table storage encoding.  uint16 = fixed-point
                        # intensities (v * 65535): quantum 1.5e-5, far
                        # below image noise, at bf16's 2-byte footprint.
                        # bf16's ~2^-9 absolute quantum measurably
                        # blunted ZNCC discrimination at reference
                        # scale: 1280x960 fixed-FOV ridge scored 0.8521
                        # (bf16) vs 0.8968 (f32); u16 matches f32.


class VolumeTables(NamedTuple):
    """Per-(ref, src-view) sweep tables; leading dim V (then N at scene
    level via an outer vmap/stack)."""

    tab: jax.Array       # (V, P, D) TAB_DTYPE-encoded intensities
    sig0: jax.Array      # (V,) grid origin
    inv_dsig: jax.Array  # (V,) 1 / grid step
    sig_lo: jax.Array    # (V, H, W) valid-sigma interval (already shrunk
    sig_hi: jax.Array    # by one grid step for the lerp neighbor)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _encode_tab(x: jax.Array) -> jax.Array:
    """Encode intensities into the storage dtype (see TAB_DTYPE)."""
    if TAB_DTYPE == jnp.uint16:
        return jnp.round(jnp.clip(x, 0.0, 1.0) * 65535.0).astype(jnp.uint16)
    return x.astype(TAB_DTYPE)


def _decode_tab(x: jax.Array) -> jax.Array:
    """Decode table entries to f32 intensities in [0, 1]."""
    if x.dtype == jnp.uint16:
        return x.astype(jnp.float32) * (1.0 / 65535.0)
    return x.astype(jnp.float32)


def sigma_grid(d_min: jax.Array, d_max: jax.Array,
               margin: float = 1.35,
               n_planes: int = D_PLANES) -> Tuple[jax.Array, jax.Array]:
    """(sigma0, dsigma): uniform grid over the realizable s range.

    Hypotheses are clamped to [0.8*d_min, 1.2*d_max] by candidate
    validity; patch obliquity scales s by (n.ray(p+delta))/(n.ray(p)),
    bounded by ``margin`` for sane tilts.  Uniform s ~ uniform disparity
    along the epipolar line (exact for in-plane motion).

    ``n_planes``: total plane count (a multiple of D_PLANES —
    at reference-class fixed-FOV resolutions the epipolar span exceeds
    128px, so 128 planes blur >1px between adjacent planes; see
    cfg.volume_planes).
    """
    s_min = 1.0 / (1.2 * margin * d_max)
    s_max = margin / (0.8 * d_min)
    dsig = (s_max - s_min) / (n_planes - 1)
    return s_min, dsig


def build_view_volume(A: jax.Array, wv: jax.Array, src_gray: jax.Array,
                      sig0: jax.Array, dsig: jax.Array, h: int, w: int,
                      build_step: int = 2, n_planes: int = D_PLANES
                      ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """One (ref, src) pair's table: (P_pad, D) + the valid-sigma interval.

    The build is the one remaining per-index gather (bilinear warps per
    sigma plane) — amortized over every candidate x offset x sweep of the
    stage.  ``build_step``: sample every k-th sigma plane with gathers and
    reconstruct the skipped planes by Catmull-Rom interpolation ALONG THE
    LANE AXIS (pure elementwise — the epipolar intensity profile is
    smooth at <=1px/plane, so half-rate sampling + cubic reconstruction
    is visually lossless; measured equal golden accuracy, build cost /2).
    """
    v_, u_ = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                          jnp.arange(w, dtype=jnp.float32), indexing="ij")
    p0x = A[0, 0] * u_ + A[0, 1] * v_ + A[0, 2]
    p0y = A[1, 0] * u_ + A[1, 1] * v_ + A[1, 2]
    p0z = A[2, 0] * u_ + A[2, 1] * v_ + A[2, 2]
    hs, ws = src_gray.shape

    def plane(j):
        sig = sig0 + dsig * j
        phx = p0x + wv[0] * sig
        phy = p0y + wv[1] * sig
        phz = p0z + wv[2] * sig
        inv_z = 1.0 / jnp.where(jnp.abs(phz) < 1e-9, 1e-9, phz)
        val, _ = bilinear_sample_xy(src_gray, phx * inv_z, phy * inv_z)
        return val

    if build_step == 1:
        vol = jax.lax.map(plane, jnp.arange(n_planes, dtype=jnp.float32))
    else:
        # gather the coarse planes (include the last fine plane so the
        # grid endpoint is exact), then cubic-upsample along sigma
        n_coarse = (n_planes - 1) // build_step + 1
        coarse = jax.lax.map(
            plane, jnp.arange(n_coarse, dtype=jnp.float32) * build_step)
        cm1 = jnp.concatenate([coarse[:1], coarse[:-1]])
        cp1 = jnp.concatenate([coarse[1:], coarse[-1:]])
        cp2 = jnp.concatenate([coarse[2:], coarse[-1:], coarse[-1:]])
        planes = []
        for r in range(build_step):
            t = r / build_step
            if r == 0:
                planes.append(coarse)
                continue
            # Catmull-Rom weights at fraction t
            w0 = -0.5 * t + t * t - 0.5 * t ** 3
            w1 = 1.0 - 2.5 * t * t + 1.5 * t ** 3
            w2 = 0.5 * t + 2.0 * t * t - 1.5 * t ** 3
            w3 = -0.5 * t * t + 0.5 * t ** 3
            planes.append(w0 * cm1 + w1 * coarse + w2 * cp1 + w3 * cp2)
        vol = jnp.stack(planes, axis=1).reshape(
            n_coarse * build_step, h, w)[:n_planes]
    tab = _encode_tab(vol.reshape(n_planes, h * w).T)  # (P, D)

    # valid-sigma interval: each border is one linear constraint
    # a + b*sigma >= 0 (z>0 folded in); intersect analytically
    cons = (
        (p0z, wv[2]),                                          # z > 0
        (p0x, wv[0]),                                          # u >= 0
        ((ws - 1) * p0z - p0x, (ws - 1) * wv[2] - wv[0]),      # u <= W-1
        (p0y, wv[1]),                                          # v >= 0
        ((hs - 1) * p0z - p0y, (hs - 1) * wv[2] - wv[1]),      # v <= H-1
    )
    lo, hi = _intersect_sigma(cons, (h, w))
    # shrink by one step: the lerp also reads plane floor(f)+1
    return tab, lo + dsig, hi - dsig


def _intersect_sigma(cons, shape) -> Tuple[jax.Array, jax.Array]:
    """Intersect linear validity constraints a + b*sigma >= 0."""
    lo = jnp.full(shape, -jnp.inf)
    hi = jnp.full(shape, jnp.inf)
    eps = 1e-12
    for a, b in cons:
        root = -a / jnp.where(jnp.abs(b) < eps, eps, b)
        lo = jnp.where(b > eps, jnp.maximum(lo, root), lo)
        hi = jnp.where(b < -eps, jnp.minimum(hi, root), hi)
        # b ~ 0: constraint is constant; a < 0 -> never valid
        lo = jnp.where((jnp.abs(b) <= eps) & (a < 0), jnp.inf, lo)
    return lo, hi


def volume_lookup_xla(tab: jax.Array, f: jax.Array) -> jax.Array:
    """Lerp-sample per-pixel tables: tab (P, D), f (P, C) -> (P, C)
    values at fractional plane indices f."""
    i0 = jnp.clip(jnp.floor(f), 0.0, tab.shape[1] - 2.0)
    t = f - i0
    i0i = i0.astype(jnp.int32)
    tab = _decode_tab(tab)
    g0 = jnp.take_along_axis(tab, i0i, axis=1)
    g1 = jnp.take_along_axis(tab, i0i + 1, axis=1)
    return g0 + (g1 - g0) * t


def build_volume_tables(geom, src_grays: jax.Array, d_min: jax.Array,
                        d_max: jax.Array,
                        n_chunks: int = 1) -> VolumeTables:
    """All neighbor views' tables for one reference view.

    ``geom`` is a dense.types.ViewGeometry (batched V); ``src_grays``
    (V, H, W).  Built once per stage — images and geometry are fixed
    across every sweep/candidate/external iteration.

    ``n_chunks``: sigma planes = n_chunks * 128 (cfg.volume_planes) —
    denser grids for reference-class fixed-FOV resolutions where one
    128-plane grid spans >1px per plane.
    """
    v, h, w = src_grays.shape
    n_planes = n_chunks * D_PLANES
    sig0, dsig = sigma_grid(d_min, d_max, n_planes=n_planes)

    def per_view(A, wv, src):
        return build_view_volume(A, wv, src, sig0, dsig, h, w,
                                 n_planes=n_planes)

    if h * w > 640 * 480:
        # large images: serialize the neighbor axis — the vmapped build
        # holds V pairs' multi-GB f32 plane stacks live at once
        tab, lo, hi = jax.lax.map(
            lambda a: per_view(a[0], a[1], a[2]),
            (geom.A, geom.wv, src_grays))
    else:
        tab, lo, hi = jax.vmap(per_view)(geom.A, geom.wv, src_grays)
    return VolumeTables(tab=tab,
                        sig0=jnp.broadcast_to(sig0, (v,)),
                        inv_dsig=jnp.broadcast_to(1.0 / dsig, (v,)),
                        sig_lo=lo, sig_hi=hi)


# ---------------------------------------------------------------------------
# Rectified-frame table build (ops/rect_gather.py geometry): the per-plane
# bilinear-warp build above spends D/2 x H x W per-index gathers per pair.
# In the rect frame every pixel's sigma-segment is a strided run of ONE
# row, so the table resolves from a one-time warp of the source into the
# rect frame plus reads along that row.  Pixel order of the resulting
# tables is TILE-MAJOR (see to_volume_order); the scoring consumer uses
# the same order when the gate below is on.
# ---------------------------------------------------------------------------

_RG_ROW_HALVES = 11     # row band: 11 x 8 rows (the build's rect frame
                        # is 2x vertically oversampled, doubling per-tile
                        # row spreads vs rect_gather's lookup engine)
_RG_COL_HALVES = 2      # col window: 2 x 512 cols
_RG_Y_SCALE = 2.0       # cross-epipolar oversampling (see
                        # rect_frame_shape) — kills the row-lerp blur


def use_rect_volume_build(cfg, h: int, w: int) -> bool:
    """Whether stage tables are built in the rect frame (unaligned sizes
    are tile-padded internally; multi-chunk plane grids —
    cfg.volume_planes > 128 — use the per-plane warp build)."""
    from hcmvs_tpu.core.config import resolve_engines
    del h, w
    if cfg.volume_planes > D_PLANES:
        return False
    return resolve_engines(cfg).build == "rect"


def padded_hw(h: int, w: int) -> Tuple[int, int]:
    """Tile-aligned size the rect paths pad unaligned images to."""
    return _round_up(h, 8), _round_up(w, 128)


def to_volume_order(x: jax.Array, pad_value: float = 0.0) -> jax.Array:
    """(..., H, W) -> (..., P) in the rect build's pixel order:
    (8, 128) image tiles in raster order; within a tile, column-major
    octets (group g = tile column g, its 8 rows in order).  Unaligned
    images are zero-padded to the tile grid (P = padded pixel count)."""
    *lead, h, w = x.shape
    h8, w128 = padded_hw(h, w)
    if (h8, w128) != (h, w):
        x = jnp.pad(x, [(0, 0)] * len(lead) + [(0, h8 - h), (0, w128 - w)],
                    constant_values=pad_value)
    x = x.reshape(*lead, h8 // 8, 8, w128 // 128, 128)
    x = jnp.moveaxis(x, -3, -2)                   # (..., bh, bw, 8, 128)
    x = jnp.swapaxes(x, -1, -2)                   # (..., bh, bw, 128, 8)
    return x.reshape(*lead, h8 * w128)


def to_volume_order_multi(x: jax.Array) -> jax.Array:
    """(C, H, W) -> (P, C) in the rect build's pixel order.

    Equivalent to ``to_volume_order(...).reshape(C, P).T`` for many
    channels at once, keeping the C axis minor in every intermediate."""
    c, h, w = x.shape
    h8, w128 = padded_hw(h, w)
    x = jnp.moveaxis(x, 0, -1)                        # (H, W, C)
    x = jnp.pad(x, ((0, h8 - h), (0, w128 - w), (0, 0)))
    x = x.reshape(h8 // 8, 8, w128 // 128, 128, c)
    x = jnp.transpose(x, (0, 2, 3, 1, 4))             # (bh, bw, 128, 8, C)
    return x.reshape(h8 * w128, c)


def from_volume_order_multi(x: jax.Array, h: int, w: int) -> jax.Array:
    """Inverse of to_volume_order_multi: (P, C) -> (C, H, W)."""
    p, c = x.shape
    h8, w128 = padded_hw(h, w)
    x = x.reshape(h8 // 8, w128 // 128, 128, 8, c)
    x = jnp.transpose(x, (0, 3, 1, 2, 4))             # (bh, 8, bw, 128, C)
    x = x.reshape(h8, w128, c)[:h, :w]
    return jnp.moveaxis(x, -1, 0)


def from_volume_order(x: jax.Array, h: int, w: int) -> jax.Array:
    """Inverse of to_volume_order (drops the alignment padding)."""
    *lead, _ = x.shape
    h8, w128 = padded_hw(h, w)
    x = x.reshape(*lead, h8 // 8, w128 // 128, 128, 8)
    x = jnp.swapaxes(x, -1, -2)
    x = jnp.moveaxis(x, -2, -3)
    return x.reshape(*lead, h8, w128)[..., :h, :w]


def _rect_build_xla(win_src: jax.Array, rb: jax.Array, cb: jax.Array,
                    rowf: jax.Array, c0w_t: jax.Array, kp_t: jax.Array
                    ) -> jax.Array:
    """Read each pixel's 128 table entries from its rect-frame row band
    (bilinear; rows outside the band read 0 and are excluded by the
    validity interval).

    ``win_src`` (V, H_r, W_r); fields in group-major (V, T, 128, 8)."""
    v, t, _, _ = rowf.shape
    h_r, w_r = win_src.shape[1:]
    r0 = jnp.floor(rowf)                       # band-relative
    fr = rowf - r0
    r0b = r0.astype(jnp.int32)
    in_band0 = (r0b >= 0) & (r0b < 8 * _RG_ROW_HALVES)
    in_band1 = (r0b + 1 >= 0) & (r0b + 1 < 8 * _RG_ROW_HALVES)
    band_lo = rb[..., None, None] * 8
    r0i = jnp.clip(r0b + band_lo, 0, h_r - 1)
    r1i = jnp.clip(r0b + 1 + band_lo, 0, h_r - 1)
    j = jnp.arange(128, dtype=jnp.float32)
    base = (c0w_t[..., None] + kp_t[..., None] * j)         # (V,T,128,8,128)
    i0 = jnp.clip(jnp.floor(base), 0.0, 1022.0)
    fc = jnp.clip(base - i0, 0.0, 1.0)
    ci = i0.astype(jnp.int32) + cb[..., None, None, None] * 512
    ci0 = jnp.clip(ci, 0, w_r - 1)
    ci1 = jnp.clip(ci + 1, 0, w_r - 1)
    flat = win_src.reshape(v, h_r * w_r)

    def fetch(ri, ok_r, cidx):
        idx = (ri[..., None] * w_r + cidx).reshape(v, -1)
        vals = jnp.take_along_axis(flat, idx, axis=1)
        return vals.reshape(cidx.shape) * ok_r[..., None]
    v00 = fetch(r0i, in_band0.astype(jnp.float32), ci0)
    v01 = fetch(r0i, in_band0.astype(jnp.float32), ci1)
    v10 = fetch(r1i, in_band1.astype(jnp.float32), ci0)
    v11 = fetch(r1i, in_band1.astype(jnp.float32), ci1)
    top = v00 * (1 - fc) + v01 * fc
    bot = v10 * (1 - fc) + v11 * fc
    return top * (1 - fr[..., None]) + bot * fr[..., None]


def build_volume_tables_rect(geom, src_grays: jax.Array, d_min: jax.Array,
                             d_max: jax.Array,
                             warp_row_step: int = 2) -> VolumeTables:
    """Rect-frame table build for one reference view (all V pairs).

    Semantics: tab[p, j] = bilerp(rect_src, row(p), col(p, sigma_j))
    where rect_src is the bilinear warp of the source into the pair's
    rect frame — a once-per-stage resample replacing the per-plane warp
    gathers.  The valid-sigma interval additionally intersects the rect
    band/window coverage, so banding misses are EXACT invalidity, never
    silent zeros.
    """
    from hcmvs_tpu.ops.rect_gather import make_rect_geometry
    from hcmvs_tpu.ops.sampling import bicubic_sample_xy
    from hcmvs_tpu.dense.types import mat3_apply

    v, h, w = src_grays.shape
    h8, w128 = padded_hw(h, w)
    sig0, dsig = sigma_grid(d_min, d_max)
    rg = make_rect_geometry(geom, h, w, y_scale=_RG_Y_SCALE)
    h_r0, w_r0 = _rect_frame_rounded(h, w)
    n_bh, n_bw = h8 // 8, w128 // 128
    n_tiles = n_bh * n_bw

    # one-time Catmull-Rom warp into the rect frame (the only gathers
    # left; bicubic because a bilinear resample followed by the table's
    # bilerp visibly smears high-frequency texture — measured -0.10
    # ridge depth accuracy).  ``warp_row_step=2``: warp every other
    # CROSS-epipolar row exactly and reconstruct the skipped rows by
    # elementwise vertical Catmull-Rom — the rect frame is already 2x
    # vertically oversampled (_RG_Y_SCALE), so the half-rate rows sample
    # the source at ~1-row spacing and cubic reconstruction is below
    # noise (tab parity + golden gates unchanged).  Columns (the epipolar/sigma
    # direction) are always warped exactly.
    n_rows = h_r0 // warp_row_step
    rv, ru = jnp.meshgrid(
        jnp.arange(n_rows, dtype=jnp.float32) * warp_row_step,
        jnp.arange(w_r0, dtype=jnp.float32), indexing="ij")

    def warp(H_sr, src):
        px, py, pz = mat3_apply(H_sr, (ru, rv, jnp.ones_like(ru)))
        inv = 1.0 / jnp.where(jnp.abs(pz) < 1e-9, 1e-9, pz)
        # EDGE-CLAMP beyond the src footprint instead of zero-filling:
        # table entries just inside the valid-sigma border lerp their
        # rect neighbors, and a zero neighbor would bleed into valid
        # samples (measured: border rows lost ~0.7 of their intensity).
        # Validity is governed exactly by the sigma intervals, so
        # clamped values outside them are never consumed.
        x = jnp.clip(px * inv, 0.0, w - 1.0)
        y = jnp.clip(py * inv, 0.0, h - 1.0)
        out, _ = bicubic_sample_xy(src, jnp.where(pz > 1e-9, x, 0.0),
                                   jnp.where(pz > 1e-9, y, 0.0))
        return out

    rect_src = jax.vmap(warp)(rg.H_sr, src_grays)     # (V, H_r/k, W_r)
    if warp_row_step > 1:
        # vertical cubic reconstruction of the skipped rows (pure
        # elementwise, mirroring build_view_volume's build_step trick)
        cm1 = jnp.concatenate([rect_src[:, :1], rect_src[:, :-1]], axis=1)
        cp1 = jnp.concatenate([rect_src[:, 1:], rect_src[:, -1:]], axis=1)
        cp2 = jnp.concatenate([rect_src[:, 2:], rect_src[:, -1:],
                               rect_src[:, -1:]], axis=1)
        rows = []
        for r in range(warp_row_step):
            t = r / warp_row_step
            if r == 0:
                rows.append(rect_src)
                continue
            w0 = -0.5 * t + t * t - 0.5 * t ** 3
            w1 = 1.0 - 2.5 * t * t + 1.5 * t ** 3
            w2 = 0.5 * t + 2.0 * t * t - 1.5 * t ** 3
            w3 = -0.5 * t * t + 0.5 * t ** 3
            rows.append(w0 * cm1 + w1 * rect_src + w2 * cp1 + w3 * cp2)
        rect_src = jnp.stack(rows, axis=2).reshape(v, h_r0, w_r0)

    # per-pixel fields
    pv, pu = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                          jnp.arange(w, dtype=jnp.float32), indexing="ij")

    def fields(M, bx):
        ax, ay, az = mat3_apply(M, (pu, pv, jnp.ones_like(pu)))
        ok = az > 1e-9
        inv = 1.0 / jnp.where(ok, az, 1.0)
        rowf = jnp.where(ok, ay * inv, -1e9)
        c0 = jnp.where(ok, ax * inv, 1e9)
        k = jnp.where(ok, bx * inv, 0.0)
        return rowf, c0, k, ok

    rowf, c0, k, az_ok = jax.vmap(fields)(rg.M, rg.bx)

    # per-tile bases (stage-static): centered band / 1024-col window.
    # Alignment padding enters as NaN so it never moves a tile's window.
    def blocks(x, pad_value=jnp.nan):
        if (h8, w128) != (h, w):
            x = jnp.pad(x, ((0, 0), (0, h8 - h), (0, w128 - w)),
                        constant_values=pad_value)
        return jnp.moveaxis(x.reshape(v, n_bh, 8, n_bw, 128), 2, 3)

    rows_b = blocks(jnp.where(az_ok, rowf, jnp.nan))
    rmin = jnp.nanmin(rows_b, axis=(-1, -2))
    rmax = jnp.nanmax(rows_b, axis=(-1, -2))
    center = jnp.nan_to_num(0.5 * (rmin + rmax), nan=0.0)
    rb = jnp.clip((center // 8.0).astype(jnp.int32) - _RG_ROW_HALVES // 2,
                  0, h_r0 // 8 - _RG_ROW_HALVES).reshape(v, n_tiles)
    cA = blocks(jnp.where(az_ok, c0 + k * sig0, jnp.nan))
    cB = blocks(jnp.where(az_ok, c0 + k * (sig0 + dsig * (D_PLANES - 1)),
                          jnp.nan))
    cmin = jnp.minimum(jnp.nanmin(cA, axis=(-1, -2)),
                       jnp.nanmin(cB, axis=(-1, -2)))
    cmax = jnp.maximum(jnp.nanmax(cA, axis=(-1, -2)),
                       jnp.nanmax(cB, axis=(-1, -2)))
    ccen = jnp.nan_to_num(0.5 * (cmin + cmax), nan=0.0)
    cb = jnp.clip((ccen // 512.0).astype(jnp.int32) - 1, 0,
                  w_r0 // 512 - _RG_COL_HALVES).reshape(v, n_tiles)

    # group-major fields (group g = tile column g): (V, T, 128, 8);
    # padded pixels carry the invalid-row sentinel so the build zeros
    # their rows (their table entries are never consumed — the scoring
    # consumer pads/unpads with the same to_volume_order layout)
    def group_major(x, pad_value):
        xb = blocks(x, pad_value)                     # (V, bh, bw, 8, 128)
        return jnp.swapaxes(xb, -1, -2).reshape(v, n_tiles, 128, 8)

    rb_full = jnp.repeat(rb.reshape(v, n_tiles, 1, 1), 128, axis=2)
    cb_full = jnp.repeat(cb.reshape(v, n_tiles, 1, 1), 128, axis=2)
    rowf_g = group_major(rowf, -1e9) - 8.0 * rb_full
    c0w_g = (group_major(c0 + k * sig0, 0.0) - 512.0 * cb_full)
    kp_g = group_major(k * dsig, 0.0)

    tabs = _rect_build_xla(rect_src, rb, cb, rowf_g, c0w_g, kp_g)

    tab = _encode_tab(tabs.reshape(v, n_tiles * 1024, D_PLANES))

    # exact valid-sigma interval: original src-frame constraints PLUS the
    # rect frame / band / window coverage, so misses are invalid samples
    def interval(A, wv, rowf_v, c0_v, k_v, ok_v, rb_v, cb_v):
        p0x = A[0, 0] * pu + A[0, 1] * pv + A[0, 2]
        p0y = A[1, 0] * pu + A[1, 1] * pv + A[1, 2]
        p0z = A[2, 0] * pu + A[2, 1] * pv + A[2, 2]
        rbf = _expand_tiles(rb_v, n_bh, n_bw)[:h, :w].astype(
            jnp.float32) * 8.0
        cbf = _expand_tiles(cb_v, n_bh, n_bw)[:h, :w].astype(
            jnp.float32) * 512.0
        cons = (
            (p0z, wv[2]),
            (p0x, wv[0]),
            ((w - 1) * p0z - p0x, (w - 1) * wv[2] - wv[0]),
            (p0y, wv[1]),
            ((h - 1) * p0z - p0y, (h - 1) * wv[2] - wv[1]),
            # rect col window: 512*cb <= c0 + k*sigma <= 512*cb + 1022
            (c0_v - cbf, k_v),
            (cbf + 1022.0 - c0_v, -k_v),
        )
        lo, hi = _intersect_sigma(cons, (h, w))
        # binary validity: behind rect cam, or row outside the band
        row_ok = (ok_v & (rowf_v >= rbf)
                  & (rowf_v <= rbf + 8.0 * _RG_ROW_HALVES - 1.0)
                  & (rowf_v <= h_r0 - 1))
        lo = jnp.where(row_ok, lo, jnp.inf)
        return lo + dsig, hi - dsig

    lo, hi = jax.vmap(interval)(geom.A, geom.wv, rowf, c0, k, az_ok, rb,
                                cb)
    return VolumeTables(tab=tab,
                        sig0=jnp.broadcast_to(sig0, (v,)),
                        inv_dsig=jnp.broadcast_to(1.0 / dsig, (v,)),
                        sig_lo=lo, sig_hi=hi)


def _rect_frame_rounded(h: int, w: int) -> Tuple[int, int]:
    """rect_gather's frame at the build's vertical oversampling, rounded
    so its rows/cols block into the 8-row / 512-col windows."""
    from hcmvs_tpu.ops.rect_gather import rect_frame_shape
    h_r, w_r = rect_frame_shape(h, w, _RG_Y_SCALE)
    return _round_up(h_r, 8), _round_up(w_r, 512)


def _expand_tiles(x_t: jax.Array, n_bh: int, n_bw: int) -> jax.Array:
    """(T,) per-tile values -> (H, W) per-pixel broadcast."""
    x = x_t.reshape(n_bh, n_bw, 1, 1)
    x = jnp.broadcast_to(x, (n_bh, n_bw, 8, 128))
    return jnp.moveaxis(x, 2, 1).reshape(n_bh * 8, n_bw * 128)
