"""Rectified epipolar gather: a table-style geo-consistency lookup engine.

The geometric-consistency term and view-spread candidate harvesting read
the neighbor view's (depth, normal) maps at the forward projection x1 of
every pixel for every PatchMatch candidate (ref: DepthMap.cpp:625-732 and
:1504-1608).

This engine rectifies each (ref, src) pair.  Rotate the source camera
with Q so that Q @ t_rel = (|t|, 0, 0); in the rotated ("rect") frame the
projection of ref pixel p at depth d is

    col(p, d) = c0(p) + k(p) / d          row(p) = r(p)

i.e. the ROW is candidate-independent (static for a whole stage) and the
COLUMN is affine in sigma = 1/d.  So:

  1. once per external iteration, the neighbor maps are warped into the
     rect frame (ONE flat gather per pair);
  2. every per-candidate lookup reads the rect maps at (row(p),
     round(c(p))), restricted to a 40-row x 512-col window per (8, 128)
     pixel tile.

Pixels whose rect row/column misses the window (steep rectification
slopes, extreme disparity spread within one tile) read 0, i.e. depth 0 —
exactly the existing "neighbor sample invalid -> geo score 1.0"
semantics for out-of-bounds reads.  The engine is therefore an
approximation of the direct per-index gather: coverage is ~100% for
typical MVS pair geometry (see tests/test_rect_gather.py) and degrades
toward "geo term off" for pathological pairs (near-forward motion), for
which ``geo_backend="direct"`` keeps the exact path.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from hcmvs_tpu.dense.types import mat3_apply

# static window geometry (see module docstring).  The row band must
# cover each (8, 128) ref tile's rect-row spread: 8 rows x d(row)/dy
# (~1..1.5) + 128 cols x d(row)/dx, where d(row)/dx = sin(epipolar tilt
# in the ref image) x scale — ~0.1-0.2 for lateral-baseline rigs
# (measured 20-29 rows/tile on the synthetic golden scenes).  5 halves
# of 8 rows with a centered base covers spans up to 32.
R_HALVES = 5          # row band = R_HALVES x 8 rows, 8-row-aligned base
ROWS_HALF = 8
COLS_HALF = 256       # window = 2 halves of 256 cols, 256-col-aligned
BAND_ROWS = R_HALVES * ROWS_HALF
WIN_COLS = 2 * COLS_HALF
_INVALID = 1 << 20    # sentinel pushing misses out of every window


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def rect_frame_shape(h: int, w: int,
                     y_scale: float = 1.0) -> Tuple[int, int]:
    """Static rect-frame size for an (h, w) image: room for the rotated
    source footprint at >= unit scale for typical pair geometry.
    ``y_scale`` > 1 oversamples the CROSS-epipolar axis (rows) — the
    volume build uses 2x so its row-lerp does not blur texture across
    epipolar lines; columns (the matching direction) are unaffected."""
    return (_ceil_to(max(int(1.25 * h * y_scale), BAND_ROWS), ROWS_HALF),
            _ceil_to(max(int(1.6 * w), WIN_COLS), WIN_COLS))


class RectGeometry(NamedTuple):
    """Per-(ref, src-view) rectification constants; leading dim V."""

    M: jax.Array        # (V, 3, 3)  K_rect Q R_rel K_inv_ref
    bx: jax.Array       # (V,)       (K_rect Q t_rel)_x  (y, z are 0)
    H_sr: jax.Array     # (V, 3, 3)  rect px -> src px homography
    scale: jax.Array    # (V,)       rect px per src px (diagnostic)


def make_rect_geometry(geom, h: int, w: int,
                       y_scale: float = 1.0) -> RectGeometry:
    """Rectifying rotation + frame fit for every neighbor view.

    Q rows: q1 = t_hat (so Q t = |t| e1), q2 perpendicular chosen from
    whichever axis is least aligned with t.  Degenerate near-forward
    motion still yields a valid rotation — the pair then rectifies to a
    heavily downscaled frame and its lookups mostly fall invalid
    (graceful degradation per the module docstring).
    """
    h_r, w_r = rect_frame_shape(h, w, y_scale)
    # all 3x3 products at HIGHEST precision: accelerator f32 matmuls may
    # run at reduced input precision (TF32 on Hopper, bf16 passes
    # elsewhere), and a 0.4% error on these matrices shifts rect positions
    # by several pixels at frame scale (measured 0.018 mean table error in
    # the volume build before this was pinned)
    mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)

    def per_view(R_rel, t_rel, K_inv_src):
        tn = jnp.linalg.norm(t_rel) + 1e-12
        q1 = t_rel / tn
        # free DOF: the rect frame's in-plane roll about q1.  Align the
        # rect y-axis (q2) with the REF image's y-axis transported into
        # the src camera, so the rect-row field over the ref grid has
        # ~zero horizontal gradient — that is what bounds the per-tile
        # row spread the lookup's band must cover.
        y_ref = R_rel[:, 1]
        q2 = y_ref - jnp.dot(y_ref, q1) * q1
        n2 = jnp.linalg.norm(q2)
        helper = jnp.where(jnp.abs(q1[2]) < 0.9,
                           jnp.array([0.0, 0.0, 1.0]),
                           jnp.array([0.0, 1.0, 0.0]))
        alt = jnp.cross(helper, q1)
        q2 = jnp.where(n2 > 1e-6, q2 / (n2 + 1e-12),
                       alt / (jnp.linalg.norm(alt) + 1e-12))
        q3 = jnp.cross(q1, q2)
        # keep the rect camera looking into the src forward hemisphere
        # (flip q2 with q3 to preserve right-handedness; q1 stays = t_hat)
        flip = jnp.where(q3[2] < 0.0, -1.0, 1.0)
        q2 = q2 * flip
        q3 = q3 * flip
        Q = jnp.stack([q1, q2, q3])                    # src-cam -> rect

        # fit: src corners through Q K_inv_src (RAY units); scale/offset
        # so the box fills the static frame.  The scale cap is relative
        # to the src focal length (rect px per src px <= 1.5 — no
        # information exists above the src map's own sampling rate).
        corners = jnp.array([[0.0, 0.0, 1.0], [w - 1.0, 0.0, 1.0],
                             [0.0, h - 1.0, 1.0],
                             [w - 1.0, h - 1.0, 1.0]]).T
        pr = mm(Q, mm(K_inv_src, corners))             # (3, 4)
        z = jnp.maximum(pr[2], 1e-6)
        cx = pr[0] / z
        cy = pr[1] / z
        f_src = 2.0 / jnp.maximum(
            jnp.abs(K_inv_src[0, 0]) + jnp.abs(K_inv_src[1, 1]), 1e-12)
        s = jnp.minimum(jnp.minimum(
            (w_r - 1.0) / jnp.maximum(cx.max() - cx.min(), 1e-6),
            (h_r - 1.0) / (y_scale
                           * jnp.maximum(cy.max() - cy.min(), 1e-6))),
            1.5 * f_src)
        sy = s * y_scale
        K_rect = jnp.array([[1.0, 0.0, 0.0],
                            [0.0, 1.0, 0.0],
                            [0.0, 0.0, 1.0]])
        K_rect = K_rect.at[0, 0].set(s).at[1, 1].set(sy)
        K_rect = K_rect.at[0, 2].set(-s * cx.min())
        K_rect = K_rect.at[1, 2].set(-sy * cy.min())
        KQ = mm(K_rect, Q)
        bx = mm(KQ, t_rel)[0]
        H_rs = mm(KQ, K_inv_src)                       # src px -> rect px
        return KQ, bx, jnp.linalg.inv(H_rs), s

    KQ, bx, H_sr, s = jax.vmap(per_view)(geom.R_rel, geom.t_rel,
                                         geom.K_inv_src)
    M = jnp.einsum("vij,vjk,kl->vil", KQ, geom.R_rel, geom.K_inv_ref,
                   precision=jax.lax.Precision.HIGHEST)
    return RectGeometry(M=M, bx=bx, H_sr=H_sr, scale=s)


class RectContext(NamedTuple):
    """Everything the rect lookup needs.  Rebuilt once per external
    iteration (the neighbor-map snapshot changes); the geometry-derived
    fields are constant across the stage by value."""

    maps: jax.Array      # (V, C, n_rh, n_ch, 8, 256) rect channels,
                         #   blocked into 8-row x 256-col window quarters
    row_int: jax.Array   # (V, H, W) int32 rect row (_INVALID marks bad)
    c0: jax.Array        # (V, H, W) col at sigma=0 (_INVALID when bad)
    k: jax.Array         # (V, H, W) d(col)/d(sigma)
    rb: jax.Array        # (V, n_bh, n_bw) int32 row base / ROWS_HALF
    roff: jax.Array      # (V, n_bh, n_bw, 8, 128) int32 row - 8*rb

    @property
    def frame_shape(self) -> Tuple[int, int]:
        _, _, n_rh, n_ch, _, _ = self.maps.shape
        return n_rh * ROWS_HALF, n_ch * COLS_HALF


def _padded_hw(h: int, w: int) -> Tuple[int, int]:
    return _ceil_to(h, 8), _ceil_to(w, 128)


def _to_blocks(x: jax.Array, pad_value: float = 0.0) -> jax.Array:
    """(..., H, W) -> (..., H8/8, W128/128, 8, 128) native-tile blocking
    (unaligned sizes tile-padded with ``pad_value``)."""
    *lead, h, w = x.shape
    h8, w128 = _padded_hw(h, w)
    if (h8, w128) != (h, w):
        x = jnp.pad(x, [(0, 0)] * len(lead) + [(0, h8 - h), (0, w128 - w)],
                    constant_values=pad_value)
    x = x.reshape(*lead, h8 // 8, 8, w128 // 128, 128)
    return jnp.moveaxis(x, -3, -2)


def _from_blocks(x: jax.Array, h: int = 0, w: int = 0) -> jax.Array:
    """Inverse of _to_blocks (slices off alignment padding when the
    target size is given)."""
    *lead, nbh, nbw, bh, bw = x.shape
    full = jnp.moveaxis(x, -2, -3).reshape(*lead, nbh * bh, nbw * bw)
    if h and w:
        return full[..., :h, :w]
    return full


def build_rect_context(geom, nbr_maps: jax.Array) -> RectContext:
    """Warp neighbor channels into the rect frames + per-pixel fields.

    ``nbr_maps`` is (V, C, H, W), depth plane first.  The warp is ONE
    flat nearest gather per call (ops/sampling.py) — replacing the
    per-candidate gathers at ~1/20 of their index volume.
    """
    from hcmvs_tpu.ops.sampling import nearest_sample_planes_batched
    v, c, h, w = nbr_maps.shape
    h_r, w_r = rect_frame_shape(h, w)
    rg = make_rect_geometry(geom, h, w)

    rv, ru = jnp.meshgrid(jnp.arange(h_r, dtype=jnp.float32),
                          jnp.arange(w_r, dtype=jnp.float32), indexing="ij")

    def warp_positions(H_sr):
        px, py, pz = mat3_apply(H_sr, (ru, rv, jnp.ones_like(ru)))
        inv = 1.0 / jnp.where(jnp.abs(pz) < 1e-9, 1e-9, pz)
        x = jnp.where(pz > 1e-9, px * inv, -1.0)
        y = jnp.where(pz > 1e-9, py * inv, -1.0)
        return jnp.round(x), jnp.round(y)

    xs, ys = jax.vmap(warp_positions)(rg.H_sr)
    maps, _ = nearest_sample_planes_batched(nbr_maps, xs, ys)
    maps = maps.reshape(v, c, h_r // ROWS_HALF, ROWS_HALF,
                        w_r // COLS_HALF, COLS_HALF)
    maps = jnp.moveaxis(maps, 3, 4)  # (V, C, n_rh, n_ch, 8, 256)

    # per-pixel fields: a = M p~ ;  row = a_y/a_z, c0 = a_x/a_z,
    # k = bx/a_z  (col(sigma) = c0 + k * sigma, sigma = 1/depth)
    pv, pu = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                          jnp.arange(w, dtype=jnp.float32), indexing="ij")

    def fields(M, bx):
        ax, ay, az = mat3_apply(M, (pu, pv, jnp.ones_like(pu)))
        ok = az > 1e-9
        inv = 1.0 / jnp.where(ok, az, 1.0)
        row = jnp.round(ay * inv)
        row_ok = ok & (row >= 0) & (row <= h_r - 1)
        return (jnp.where(row_ok, row, float(_INVALID)).astype(jnp.int32),
                jnp.where(ok, ax * inv, float(_INVALID)),
                jnp.where(ok, bx * inv, 0.0))

    row_int, c0, k = jax.vmap(fields)(rg.M, rg.bx)

    # 8-row-aligned band bases per (8, 128) block, centered between the
    # block's VALID row extremes (one bad pixel must not sink its block;
    # centering spends the alignment slack evenly on both sides).
    # Alignment padding enters as _INVALID so it never moves a window.
    rows_b = _to_blocks(row_int, _INVALID)           # (V, nbh, nbw, 8, 128)
    valid_b = rows_b < _INVALID
    rmin = jnp.min(jnp.where(valid_b, rows_b, _INVALID), axis=(-1, -2))
    rmax = jnp.max(jnp.where(valid_b, rows_b, 0), axis=(-1, -2))
    center = (jnp.minimum(rmin, rmax) + rmax) // 2
    rb = jnp.clip(center // ROWS_HALF - R_HALVES // 2, 0,
                  h_r // ROWS_HALF - R_HALVES)
    roff = rows_b - (rb * ROWS_HALF)[..., None, None]
    return RectContext(maps=maps, row_int=row_int, c0=c0, k=k,
                       rb=rb.astype(jnp.int32), roff=roff)


def pack_depth_normals(nbr_depth: jax.Array,
                       nbr_normal: jax.Array) -> jax.Array:
    """(V, H, W) depth + (V, 3, H, W) normals -> (V, 2, H, W) packed.

    Halves the lookup's gather work (its cost is linear in the
    channel count).  Word 0 carries the depth magnitude with n_z's sign
    folded into the float sign bit (depth is always > 0 when valid, and
    0 keeps meaning invalid); word 1 carries (n_x | n_y) as a bf16 pair
    (<= 0.8% quantization — ~0.5 degrees, below the random-refinement
    anneal scales and the cos-agreement term's sensitivity)."""
    w0 = jnp.where(nbr_normal[:, 2] >= 0, -nbr_depth, nbr_depth)
    ux = jax.lax.bitcast_convert_type(
        nbr_normal[:, 0].astype(jnp.bfloat16), jnp.uint16)
    uy = jax.lax.bitcast_convert_type(
        nbr_normal[:, 1].astype(jnp.bfloat16), jnp.uint16)
    u32 = (ux.astype(jnp.uint32) << 16) | uy.astype(jnp.uint32)
    w1 = jax.lax.bitcast_convert_type(u32, jnp.float32)
    return jnp.stack([w0, w1], axis=1)


def unpack_taps(taps: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Inverse of pack_depth_normals on gathered taps (V, 2, ...):
    returns ((V, 4, ...) [depth, nx, ny, nz], valid (V, ...))."""
    w0 = taps[:, 0]
    w1 = taps[:, 1]
    d1 = jnp.abs(w0)
    u32 = jax.lax.bitcast_convert_type(w1, jnp.uint32)
    nx = jax.lax.bitcast_convert_type(
        (u32 >> 16).astype(jnp.uint16), jnp.bfloat16).astype(jnp.float32)
    ny = jax.lax.bitcast_convert_type(
        (u32 & 0xFFFF).astype(jnp.uint16),
        jnp.bfloat16).astype(jnp.float32)
    nz_mag = jnp.sqrt(jnp.maximum(1.0 - nx * nx - ny * ny, 0.0))
    nz = jnp.where(w0 >= 0, -nz_mag, nz_mag)
    return jnp.stack([d1, nx, ny, nz], axis=1), d1 > 0.0


def _col_bases(ctx: RectContext, icol: jax.Array) -> Tuple[jax.Array,
                                                           jax.Array]:
    """256-col-aligned per-block window bases for this candidate's
    columns (out-of-frame columns excluded so they don't drag the
    window away from the valid pixels)."""
    _, w_r = ctx.frame_shape
    icol_b = _to_blocks(icol, -_INVALID)             # (V, nbh, nbw, 8, 128)
    cmin = jnp.min(jnp.where((icol_b < 0) | (icol_b > w_r - 1),
                             _INVALID, icol_b), axis=(-1, -2))
    cb = jnp.clip(cmin // COLS_HALF, 0, w_r // COLS_HALF - 2)
    return cb.astype(jnp.int32), icol_b


def rect_lookup_xla(ctx: RectContext, sigma: jax.Array) -> jax.Array:
    """Per-candidate lookup: every rect channel at
    (row(p), round(c0(p) + k(p) * sigma(p))) for all V views.

    ``sigma`` is (H, W) (= 1 / candidate depth); returns (V, C, H, W)
    with 0 where the lookup is invalid or misses its tile's window."""
    v, c, n_rh, n_ch, _, _ = ctx.maps.shape
    h_r, w_r = ctx.frame_shape
    _, h, w = ctx.row_int.shape
    col = ctx.c0 + ctx.k * sigma[None]
    icol = jnp.round(jnp.clip(col, -2.0 * _INVALID, 2.0 * _INVALID)
                     ).astype(jnp.int32)
    cb, _ = _col_bases(ctx, icol)
    cb_full = _from_blocks(jnp.broadcast_to(
        cb[..., None, None], cb.shape + (8, 128)), h, w)
    rb_full = _from_blocks(jnp.broadcast_to(
        ctx.rb[..., None, None], ctx.rb.shape + (8, 128)), h, w)
    iwin = icol - cb_full * COLS_HALF
    roff = ctx.row_int - rb_full * ROWS_HALF
    ok = ((roff >= 0) & (roff < BAND_ROWS) & (iwin >= 0)
          & (iwin < WIN_COLS) & (icol >= 0) & (icol <= w_r - 1)
          & (ctx.row_int <= h_r - 1))
    flat = jnp.moveaxis(ctx.maps, 4, 3).reshape(v, c, h_r * w_r)
    rc = jnp.clip(ctx.row_int, 0, h_r - 1)
    cc = jnp.clip(icol, 0, w_r - 1)
    idx = (rc * w_r + cc).reshape(v, -1)
    taps = jnp.take_along_axis(
        flat, jnp.broadcast_to(idx[:, None], (v, c, h * w)), axis=2)
    out = taps.reshape(v, c, h, w)
    return jnp.where(ok[:, None], out, 0.0)


def rect_coverage(ctx: RectContext, sigma: jax.Array) -> jax.Array:
    """Fraction of in-frame lookups that land inside their tile's window
    (diagnostic; ~1.0 for typical MVS pair geometry)."""
    col = ctx.c0 + ctx.k * sigma[None]
    icol = jnp.round(jnp.clip(col, -2.0 * _INVALID, 2.0 * _INVALID)
                     ).astype(jnp.int32)
    _, h, w = ctx.row_int.shape
    cb, _ = _col_bases(ctx, icol)
    cb_full = _from_blocks(jnp.broadcast_to(
        cb[..., None, None], cb.shape + (8, 128)), h, w)
    rb_full = _from_blocks(jnp.broadcast_to(
        ctx.rb[..., None, None], ctx.rb.shape + (8, 128)), h, w)
    h_r, w_r = ctx.frame_shape
    in_frame = ((ctx.row_int <= h_r - 1) & (icol >= 0)
                & (icol <= w_r - 1))
    iwin = icol - cb_full * COLS_HALF
    roff = ctx.row_int - rb_full * ROWS_HALF
    hit = ((roff >= 0) & (roff < BAND_ROWS) & (iwin >= 0)
           & (iwin < WIN_COLS))
    return (jnp.sum(hit & in_frame)
            / jnp.maximum(jnp.sum(in_frame), 1)).astype(jnp.float32)
