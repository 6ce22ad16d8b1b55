"""Image gradient operators.

Batched analog of the reference's gradient map computation
(ref: frame_main/libs/MVS/SceneDensify.cpp:581-645 InitGraMap — a 3x3 Sobel
over the gray image whose magnitude gates the texture-adaptive window and
propagation extent).  Implemented as shifted adds so XLA fuses it into one
VPU pass; no conv needed for a 3x3 stencil.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _shift(img: jax.Array, dy: int, dx: int) -> jax.Array:
    """Shift with edge replication (matches cv2.Sobel BORDER_REFLECT-ish
    behavior closely enough for thresholding use)."""
    out = img
    if dy:
        out = jnp.roll(out, dy, axis=0)
        if dy > 0:
            out = out.at[:dy, :].set(out[dy:dy + 1, :])
        else:
            out = out.at[dy:, :].set(out[dy - 1:dy, :])
    if dx:
        out = jnp.roll(out, dx, axis=1)
        if dx > 0:
            out = out.at[:, :dx].set(out[:, dx:dx + 1])
        else:
            out = out.at[:, dx:].set(out[:, dx - 1:dx])
    return out


def sobel_xy(img: jax.Array) -> tuple[jax.Array, jax.Array]:
    """3x3 Sobel x/y responses of a (H, W) image."""
    tl = _shift(img, 1, 1)
    t = _shift(img, 1, 0)
    tr = _shift(img, 1, -1)
    l = _shift(img, 0, 1)
    r = _shift(img, 0, -1)
    bl = _shift(img, -1, 1)
    b = _shift(img, -1, 0)
    br = _shift(img, -1, -1)
    gx = (tr + 2 * r + br) - (tl + 2 * l + bl)
    gy = (bl + 2 * b + br) - (tl + 2 * t + tr)
    return gx, gy


def sobel_magnitude(img: jax.Array, scale: float = 255.0) -> jax.Array:
    """Gradient magnitude in the reference's 8-bit convention.

    The reference computes ``0.5*|Sobel_x| + 0.5*|Sobel_y|`` on 8-bit gray,
    saturated to [0, 255], and compares against thresholds like 100/150/175
    (ref: frame_main/libs/MVS/SceneDensify.cpp:589-596 InitGraMap,
    DepthMap.cpp:454-462); our images are [0, 1] floats so ``scale``
    restores that range to keep the config thresholds 1:1.
    """
    gx, gy = sobel_xy(img * scale)
    return jnp.minimum(0.5 * (jnp.abs(gx) + jnp.abs(gy)), 255.0)


def normals_from_depth(depth: jax.Array, rays: jax.Array) -> jax.Array:
    """(3, H, W) camera-frame normals from a depth map's 3D gradients
    (ref: EstimateNormalMap, frame_main/libs/MVS/DepthMap.cpp:2272 —
    cross product of the tangents along x and y, oriented toward the
    camera; used by the SGM path's --estimate-normals and by fusion when
    PatchMatch normals are absent).

    ``rays`` is the (3, H, W) pixel-ray field (dense/types.pixel_rays).
    """
    X = rays * depth[None]                                 # (3, H, W)
    dx = tuple(_shift(X[i], 0, 1) - _shift(X[i], 0, -1) for i in range(3))
    dy = tuple(_shift(X[i], 1, 0) - _shift(X[i], -1, 0) for i in range(3))
    n = (dy[1] * dx[2] - dy[2] * dx[1],
         dy[2] * dx[0] - dy[0] * dx[2],
         dy[0] * dx[1] - dy[1] * dx[0])
    norm = jnp.sqrt(n[0] ** 2 + n[1] ** 2 + n[2] ** 2)
    inv = 1.0 / jnp.maximum(norm, 1e-12)
    n = tuple(c * inv for c in n)
    # face the camera: n . ray < 0
    n_dot_r = n[0] * rays[0] + n[1] * rays[1] + n[2] * rays[2]
    sign = jnp.where(n_dot_r > 0, -1.0, 1.0)
    n = jnp.stack([c * sign for c in n])
    valid = depth > 0
    return jnp.where(valid[None], n,
                     jnp.stack([jnp.zeros_like(depth),
                                jnp.zeros_like(depth),
                                -jnp.ones_like(depth)]))
