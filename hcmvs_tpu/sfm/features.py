"""On-device feature detection + description (DoG + SIFT-like descriptors).

The reference pipeline shells out to OpenMVG's SIFT binaries
(ref: frame_main/MvgMvsPipeline.py:184-186 openMVG_main_ComputeFeatures);
here the whole front end runs as one jitted program: separable Gaussian
pyramid (VPU convolutions), difference-of-Gaussians extrema with
shifted-array comparisons (no per-pixel loops), fixed-K top-k selection
(static shapes for jit), and 128-d gradient-orientation-histogram
descriptors built from a small number of per-keypoint gathers.

Design notes:
- Everything except the final per-keypoint descriptor sampling is dense
  whole-image arithmetic.
- K is static; weak images yield masked (score <= 0) keypoints.
- Descriptors are rotation-normalized by the dominant gradient direction,
  making matches robust to in-plane rotation like SIFT's.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class Keypoints(NamedTuple):
    xy: jax.Array          # (K, 2) float32 pixel coords (x, y)
    score: jax.Array       # (K,) DoG response magnitude; <= 0 -> invalid
    scale: jax.Array       # (K,) pyramid sigma
    angle: jax.Array       # (K,) dominant orientation (radians)
    desc: jax.Array        # (K, 128) L2-normalized descriptors


def _gauss_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1)
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def _sep_blur(img: jax.Array, kernel: np.ndarray) -> jax.Array:
    """Separable Gaussian blur via shifted adds (static taps)."""
    r = len(kernel) // 2
    pad = jnp.pad(img, ((r, r), (0, 0)), mode="edge")
    out = jnp.zeros_like(img)
    for i, kv in enumerate(kernel):
        out = out + float(kv) * pad[i:i + img.shape[0], :]
    pad = jnp.pad(out, ((0, 0), (r, r)), mode="edge")
    out2 = jnp.zeros_like(img)
    for i, kv in enumerate(kernel):
        out2 = out2 + float(kv) * pad[:, i:i + img.shape[1]]
    return out2


def _shift2(img: jax.Array, dy: int, dx: int) -> jax.Array:
    h, w = img.shape
    p = max(abs(dy), abs(dx), 1)
    pad = jnp.pad(img, p, mode="edge")
    return pad[p + dy:p + dy + h, p + dx:p + dx + w]


@partial(jax.jit, static_argnames=("max_keypoints", "n_scales"))
def detect_and_describe(gray: jax.Array, max_keypoints: int = 1024,
                        n_scales: int = 4,
                        contrast_threshold: float = 0.015) -> Keypoints:
    """Detect DoG keypoints and compute descriptors for one image."""
    h, w = gray.shape
    sigmas = [1.2 * (1.6 ** i) for i in range(n_scales + 1)]
    blurred = [_sep_blur(gray, _gauss_kernel1d(s, int(3 * s))) for s in sigmas]
    dogs = [blurred[i + 1] - blurred[i] for i in range(n_scales)]

    # scale-space extrema: strict max/min against 8 spatial neighbors at the
    # same scale and the center of adjacent scales
    best_score = jnp.zeros((h, w), jnp.float32)
    best_scale = jnp.zeros((h, w), jnp.float32)
    r_edge = 10.0  # SIFT edge-response ratio
    for si in range(1, n_scales - 1):
        d = dogs[si]
        neigh = [_shift2(d, dy, dx)
                 for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                 if (dy, dx) != (0, 0)]
        stack = jnp.stack(neigh + [dogs[si - 1], dogs[si + 1]])
        is_max = (d > jnp.max(stack, axis=0)) & (d > contrast_threshold)
        is_min = (d < jnp.min(stack, axis=0)) & (d < -contrast_threshold)
        # per-scale edge suppression via the Hessian ratio at this scale
        hxx = _shift2(d, 0, 1) + _shift2(d, 0, -1) - 2 * d
        hyy = _shift2(d, 1, 0) + _shift2(d, -1, 0) - 2 * d
        hxy = 0.25 * (_shift2(d, 1, 1) + _shift2(d, -1, -1)
                      - _shift2(d, 1, -1) - _shift2(d, -1, 1))
        tr = hxx + hyy
        det = hxx * hyy - hxy * hxy
        edge_ok = (det > 0) & (tr * tr * r_edge < (r_edge + 1) ** 2 * det)
        resp = jnp.abs(d) * (is_max | is_min) * edge_ok
        better = resp > best_score
        best_score = jnp.where(better, resp, best_score)
        best_scale = jnp.where(better, sigmas[si], best_scale)

    # keep away from borders (descriptor support)
    margin = 16
    yy, xx = jnp.meshgrid(jnp.arange(h), jnp.arange(w), indexing="ij")
    interior = ((xx >= margin) & (xx < w - margin)
                & (yy >= margin) & (yy < h - margin))
    best_score = jnp.where(interior, best_score, 0.0)

    flat = best_score.reshape(-1)
    scores, idx = jax.lax.top_k(flat, max_keypoints)
    ky = (idx // w).astype(jnp.float32)
    kx = (idx % w).astype(jnp.float32)
    kscale = best_scale.reshape(-1)[idx]

    # sub-pixel refinement: 1D quadratic fit of the response peak along x
    # and y (integer-grid keypoints alone add ~0.5px of match noise, which
    # dominates downstream pose accuracy)
    yi = ky.astype(jnp.int32)
    xi = kx.astype(jnp.int32)
    resp = best_score

    def _quad(dm, d0, dp):
        denom = dm + dp - 2.0 * d0
        off = 0.5 * (dm - dp) / jnp.where(jnp.abs(denom) < 1e-12, 1e-12,
                                          denom)
        return jnp.clip(off, -0.5, 0.5)

    xm = jnp.clip(xi - 1, 0, w - 1)
    xp = jnp.clip(xi + 1, 0, w - 1)
    ym = jnp.clip(yi - 1, 0, h - 1)
    yp = jnp.clip(yi + 1, 0, h - 1)
    kx = kx + _quad(resp[yi, xm], resp[yi, xi], resp[yi, xp])
    ky = ky + _quad(resp[ym, xi], resp[yi, xi], resp[yp, xi])

    # gradients of the base blur for orientation + descriptors
    base = blurred[1]
    gx = 0.5 * (_shift2(base, 0, -1) - _shift2(base, 0, 1))
    gy = 0.5 * (_shift2(base, -1, 0) - _shift2(base, 1, 0))

    # descriptor/orientation support scales with the detected sigma
    # (SIFT semantics: the window measures the same surface patch no
    # matter which scale fired) — normalized so the first interior DoG
    # scale keeps the base 12px support
    ksup = jnp.maximum(kscale, sigmas[1]) / sigmas[1]
    angle = _dominant_orientation(gx, gy, kx, ky, sup=ksup)
    desc = _descriptors(gx, gy, kx, ky, angle, sup=ksup)
    return Keypoints(xy=jnp.stack([kx, ky], axis=-1), score=scores,
                     scale=kscale, angle=angle, desc=desc)


def detect_and_describe_pyramid(gray: jax.Array,
                                max_keypoints: int = 1024,
                                n_octaves: int = 3,
                                n_scales: int = 4,
                                contrast_threshold: float = 0.015
                                ) -> Keypoints:
    """Multi-octave detection: the single-octave detector on a
    half-resolution pyramid, keypoints mapped back to full-res coords.

    The single-octave DoG spans sigma ~1.2-6.5px; OpenMVG's SIFT
    (ref: MvgMvsPipeline.py:184-186 openMVG_main_ComputeFeatures -m SIFT)
    covers decades of scale via octaves — without them, matching across a
    >=2x zoom change fails (no keypoint pair sees the same surface
    patch at the same blur).  Each octave gets an equal share of the
    keypoint budget; octave o's coordinates/scales scale by 2^o.

    Returns a single Keypoints with K = max_keypoints (weakest entries
    masked via score <= 0, like the base detector).
    """
    # budget proportional to pixel count (4:1:0.25...): fine-octave
    # keypoints carry the pose accuracy on same-scale rigs; coarse
    # octaves only need enough coverage for cross-scale matching
    weights = [4.0 ** -o for o in range(n_octaves)]
    total = sum(weights)
    parts = []
    img = gray
    for o in range(n_octaves):
        h, w = img.shape
        if min(h, w) < 48:      # descriptor support no longer fits
            break
        per_oct = max(int(max_keypoints * weights[o] / total), 16)
        kp = detect_and_describe(img, per_oct, n_scales,
                                 contrast_threshold)
        f = float(2 ** o)
        parts.append(Keypoints(xy=kp.xy * f, score=kp.score,
                               scale=kp.scale * f, angle=kp.angle,
                               desc=kp.desc))
        if o < n_octaves - 1:   # anti-alias blur, then decimate
            img = _sep_blur(img, _gauss_kernel1d(1.2, 3))[::2, ::2]
    kps = Keypoints(*(jnp.concatenate([getattr(p, f) for p in parts])
                      for f in Keypoints._fields))
    # global top-k so the output size is stable for downstream static
    # shapes (and the strongest features win regardless of octave)
    k = min(max_keypoints, kps.score.shape[0])
    _, order = jax.lax.top_k(kps.score, k)
    kps = Keypoints(*(getattr(kps, f)[order] for f in Keypoints._fields))
    if k < max_keypoints:
        # honor the K = max_keypoints contract even when the int-split
        # budget or the small-image early break shrinks the pool: pad
        # with masked (score <= 0) entries like the base detector's
        pad = max_keypoints - k
        kps = Keypoints(
            xy=jnp.pad(kps.xy, ((0, pad), (0, 0))),
            score=jnp.pad(kps.score, (0, pad), constant_values=-1.0),
            scale=jnp.pad(kps.scale, (0, pad), constant_values=1.0),
            angle=jnp.pad(kps.angle, (0, pad)),
            desc=jnp.pad(kps.desc, ((0, pad), (0, 0))))
    return kps


def _bilinear_at(img: jax.Array, x: jax.Array, y: jax.Array) -> jax.Array:
    h, w = img.shape
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0 = jnp.clip(x0.astype(jnp.int32), 0, w - 2)
    y0 = jnp.clip(y0.astype(jnp.int32), 0, h - 2)
    return ((img[y0, x0] * (1 - fx) + img[y0, x0 + 1] * fx) * (1 - fy)
            + (img[y0 + 1, x0] * (1 - fx) + img[y0 + 1, x0 + 1] * fx) * fy)


def _dominant_orientation(gx: jax.Array, gy: jax.Array, kx: jax.Array,
                          ky: jax.Array, n_bins: int = 36,
                          radius: int = 6,
                          sup: "jax.Array | None" = None) -> jax.Array:
    """Histogram of gradient directions in a disc around each keypoint.
    ``sup``: per-keypoint support multiplier (sigma-proportional)."""
    offs = [(dy, dx) for dy in range(-radius, radius + 1)
            for dx in range(-radius, radius + 1)
            if dy * dy + dx * dx <= radius * radius]
    offs = np.array(offs, np.float32)          # (P, 2)
    sig2 = (radius / 2) ** 2
    if sup is None:
        sup = jnp.ones_like(kx)

    def at_kp(kxi, kyi, si):
        xs = kxi + offs[:, 1] * si
        ys = kyi + offs[:, 0] * si
        gxs = _bilinear_at(gx, xs, ys)
        gys = _bilinear_at(gy, xs, ys)
        mag = jnp.hypot(gxs, gys)
        wgt = mag * jnp.exp(-(offs[:, 0] ** 2 + offs[:, 1] ** 2) / (2 * sig2))
        ang = jnp.arctan2(gys, gxs)            # [-pi, pi]
        bins = ((ang + np.pi) / (2 * np.pi) * n_bins).astype(jnp.int32)
        bins = jnp.clip(bins, 0, n_bins - 1)
        hist = jnp.zeros(n_bins).at[bins].add(wgt)
        b = jnp.argmax(hist)
        return (b.astype(jnp.float32) + 0.5) / n_bins * 2 * np.pi - np.pi

    return jax.vmap(at_kp)(kx, ky, sup)


def _descriptors(gx: jax.Array, gy: jax.Array, kx: jax.Array,
                 ky: jax.Array, angle: jax.Array,
                 n_cells: int = 4, n_ori: int = 8,
                 cell_size: float = 3.0,
                 sup: "jax.Array | None" = None) -> jax.Array:
    """SIFT-like 4x4x8 gradient histograms, rotation-normalized."""
    half = n_cells * cell_size / 2.0
    # sample grid in the keypoint's rotated frame: one sample per unit cell
    step = cell_size
    r = np.arange(n_cells) * step - half + step / 2
    sy, sx = np.meshgrid(r, r, indexing="ij")
    # supersample each cell 2x2
    sub = np.array([-0.75, 0.75]) * (step / 4)
    pts = []
    for oy in sub:
        for ox in sub:
            pts.append(np.stack([sy + oy, sx + ox], axis=-1).reshape(-1, 2))
    pts = np.concatenate(pts, 0).astype(np.float32)      # (P, 2) (y, x)
    cell_of = np.tile(np.arange(n_cells * n_cells), len(sub) ** 2)
    if sup is None:
        sup = jnp.ones_like(kx)

    def at_kp(kxi, kyi, ai, si):
        ca = jnp.cos(ai) * si
        sa = jnp.sin(ai) * si
        xs = kxi + ca * pts[:, 1] - sa * pts[:, 0]
        ys = kyi + sa * pts[:, 1] + ca * pts[:, 0]
        gxs = _bilinear_at(gx, xs, ys)
        gys = _bilinear_at(gy, xs, ys)
        mag = jnp.hypot(gxs, gys)
        ang = jnp.arctan2(gys, gxs) - ai
        bins = jnp.mod((ang + np.pi) / (2 * np.pi) * n_ori, n_ori)
        b0 = jnp.floor(bins).astype(jnp.int32) % n_ori
        fb = bins - jnp.floor(bins)
        idx0 = cell_of * n_ori + b0
        idx1 = cell_of * n_ori + (b0 + 1) % n_ori
        d = jnp.zeros(n_cells * n_cells * n_ori)
        d = d.at[idx0].add(mag * (1 - fb))
        d = d.at[idx1].add(mag * fb)
        d = d / jnp.maximum(jnp.linalg.norm(d), 1e-9)
        d = jnp.minimum(d, 0.2)                     # SIFT clamp
        return d / jnp.maximum(jnp.linalg.norm(d), 1e-9)

    return jax.vmap(at_kp)(kx, ky, angle, sup)
