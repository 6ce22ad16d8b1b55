"""Bilinear image sampling (gather-based).

The batched analog of the reference's ``TImage::sample()`` bilinear taps
(ref: frame_main/libs/Common/Types.inl) used throughout patch scoring and
cross-view lookups.  XLA lowers the gathers to dynamic-slice loads.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def bilinear_sample(img: jax.Array, uv: jax.Array,
                    oob_value: float = 0.0) -> Tuple[jax.Array, jax.Array]:
    """Sample ``img`` at continuous pixel coords ``uv``.

    Args:
      img: (H, W) or (H, W, C) image.
      uv: (..., 2) coordinates, uv[..., 0] = x (column), uv[..., 1] = y (row).
      oob_value: value returned outside the image.

    Returns:
      (values, valid): values has shape (...,) or (..., C); valid is a
      boolean mask of in-bounds samples.
    """
    h, w = img.shape[:2]
    x = uv[..., 0]
    y = uv[..., 1]
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)

    valid = (x >= 0) & (y >= 0) & (x <= w - 1) & (y <= h - 1)
    x0c = jnp.clip(x0i, 0, w - 2)
    y0c = jnp.clip(y0i, 0, h - 2)

    v00 = img[y0c, x0c]
    v01 = img[y0c, x0c + 1]
    v10 = img[y0c + 1, x0c]
    v11 = img[y0c + 1, x0c + 1]
    if img.ndim == 3:
        fx = fx[..., None]
        fy = fy[..., None]
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    out = top * (1 - fy) + bot * fy
    if img.ndim == 3:
        out = jnp.where(valid[..., None], out, oob_value)
    else:
        out = jnp.where(valid, out, oob_value)
    return out, valid


def bilinear_sample_xy(img: jax.Array, x: jax.Array, y: jax.Array,
                       oob_value: float = 0.0
                       ) -> Tuple[jax.Array, jax.Array]:
    """Planes-form bilinear sampling: coordinates as separate (H, W)
    arrays instead of a packed (..., 2) tensor.

    This is the hot-path variant: packed uv has minor dimension 2, which
    wastes 126 of the VPU's 128 lanes and forces relayouts (the dense
    module's LAYOUT RULE, see dense/types.py).

    The four taps are fetched by ONE gather from a 2x2-tap-packed copy of
    the image (one index per sample instead of four), and the packing
    itself is elementwise work that XLA hoists out of the
    candidate-scoring loops since the image is loop-invariant.
    """
    h, w = img.shape[:2]
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    valid = (x >= 0) & (y >= 0) & (x <= w - 1) & (y <= h - 1)
    x0c = jnp.clip(x0i, 0, w - 2)
    y0c = jnp.clip(y0i, 0, h - 2)
    packed = pack_bilinear_taps(img)                  # (4, H*W)
    taps = jnp.take(packed, (y0c * w + x0c).reshape(-1), axis=1)
    v00 = taps[0].reshape(x.shape)
    v01 = taps[1].reshape(x.shape)
    v10 = taps[2].reshape(x.shape)
    v11 = taps[3].reshape(x.shape)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    out = top * (1 - fy) + bot * fy
    return jnp.where(valid, out, oob_value), valid


def bicubic_sample_xy(img: jax.Array, x: jax.Array, y: jax.Array,
                      oob_value: float = 0.0
                      ) -> Tuple[jax.Array, jax.Array]:
    """Catmull-Rom resampling with ONE gather per point.

    The 4x4 tap neighborhood is pre-packed into 16 channels (same trick
    as pack_bilinear_taps — gathers cost per-index, not per-element), so
    bicubic costs the same index volume as bilinear while preserving the
    high-frequency texture that bilinear-of-bilinear smears (measured:
    mean |dtab| of the rect-frame volume build vs the exact build drops
    from 0.018 to image-noise level — see ops/volume.py).
    """
    h, w = img.shape[:2]
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = jnp.clip(x0.astype(jnp.int32), 0, w - 2)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, h - 2)
    valid = (x >= 0) & (y >= 0) & (x <= w - 1) & (y <= h - 1)
    r = jnp.pad(img, ((1, 2), (1, 2)), mode="edge")
    packed = jnp.stack([r[dy:dy + h, dx:dx + w].reshape(-1)
                        for dy in range(4) for dx in range(4)])
    taps = jnp.take(packed, (y0i * w + x0i).reshape(-1), axis=1)
    taps = taps.reshape((4, 4) + x.shape)          # [dy, dx, ...]

    def cr_w(t):
        t2 = t * t
        t3 = t2 * t
        return (-0.5 * t + t2 - 0.5 * t3,
                1.0 - 2.5 * t2 + 1.5 * t3,
                0.5 * t + 2.0 * t2 - 1.5 * t3,
                -0.5 * t2 + 0.5 * t3)

    wx = cr_w(fx)
    wy = cr_w(fy)
    rows = [sum(wx[j] * taps[i, j] for j in range(4)) for i in range(4)]
    out = sum(wy[i] * rows[i] for i in range(4))
    return jnp.where(valid, out, oob_value), valid


def pack_bilinear_taps(img: jax.Array) -> jax.Array:
    """(H, W) -> (4, H*W): channel k holds the 2x2-neighborhood tap
    [v00, v01, v10, v11] anchored at each pixel (edge-clamped)."""
    r = jnp.pad(img, ((0, 1), (0, 1)), mode="edge")
    return jnp.stack([r[:-1, :-1], r[:-1, 1:],
                      r[1:, :-1], r[1:, 1:]]).reshape(4, -1)


def nearest_sample_planes(planes: jax.Array, x: jax.Array, y: jax.Array,
                          oob_value: float = 0.0
                          ) -> Tuple[jax.Array, jax.Array]:
    """Nearest sampling of C planes at shared coordinates with ONE gather:
    ``planes`` is (C, H, W); returns ((C, ...), valid).  Use instead of C
    separate nearest_sample_xy calls (one index per sample, not C)."""
    c, h, w = planes.shape
    xi = jnp.clip(x.astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(y.astype(jnp.int32), 0, h - 1)
    valid = (x >= 0) & (y >= 0) & (x <= w - 1) & (y <= h - 1)
    taps = jnp.take(planes.reshape(c, -1), (yi * w + xi).reshape(-1),
                    axis=1)
    out = taps.reshape((c,) + x.shape)
    return jnp.where(valid[None], out, oob_value), valid


def nearest_sample_planes_batched(planes: jax.Array, x: jax.Array,
                                  y: jax.Array, oob_value: float = 0.0
                                  ) -> Tuple[jax.Array, jax.Array]:
    """Batched nearest_sample_planes collapsed into ONE flat gather.

    ``planes`` is (V, C, H, W) — V independent maps sampled at per-map
    coordinates x/y (V, ...).  Instead of a vmapped per-map gather, the V
    maps are flattened into one (C, V*H*W) operand and the indices get a
    per-map offset, so the geo-consistency term's hot op is one flat
    gather rather than XLA's batched gather.
    """
    v, c, h, w = planes.shape
    xi = jnp.clip(x.astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(y.astype(jnp.int32), 0, h - 1)
    valid = (x >= 0) & (y >= 0) & (x <= w - 1) & (y <= h - 1)
    flat = jnp.moveaxis(planes, 1, 0).reshape(c, v * h * w)
    voff = (jnp.arange(v, dtype=jnp.int32) * (h * w)).reshape(
        (v,) + (1,) * (x.ndim - 1))
    idx = (yi * w + xi + voff).reshape(-1)
    taps = jnp.take(flat, idx, axis=1)            # (C, V*...)
    out = jnp.moveaxis(taps.reshape((c,) + x.shape), 0, 1)
    return jnp.where(valid[:, None], out, oob_value), valid


def nearest_sample_xy(img: jax.Array, x: jax.Array, y: jax.Array,
                      oob_value: float = 0.0) -> Tuple[jax.Array, jax.Array]:
    """Planes-form nearest sampling: 1 load per point (pass pre-rounded
    coordinates to skip the rounding)."""
    h, w = img.shape[:2]
    xi = x.astype(jnp.int32)
    yi = y.astype(jnp.int32)
    valid = (x >= 0) & (y >= 0) & (x <= w - 1) & (y <= h - 1)
    out = img[jnp.clip(yi, 0, h - 1), jnp.clip(xi, 0, w - 1)]
    return jnp.where(valid, out, oob_value), valid


def nearest_sample(img: jax.Array, uv: jax.Array,
                   oob_value: float = 0.0) -> Tuple[jax.Array, jax.Array]:
    """Nearest-neighbor variant (used for label/segment maps)."""
    h, w = img.shape[:2]
    x = jnp.round(uv[..., 0]).astype(jnp.int32)
    y = jnp.round(uv[..., 1]).astype(jnp.int32)
    valid = (x >= 0) & (y >= 0) & (x < w) & (y < h)
    out = img[jnp.clip(y, 0, h - 1), jnp.clip(x, 0, w - 1)]
    if img.ndim == 3:
        out = jnp.where(valid[..., None], out, oob_value)
    else:
        out = jnp.where(valid, out, oob_value)
    return out, valid
