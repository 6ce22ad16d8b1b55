"""Pytree state and precomputed geometry for the PatchMatch engine.

Batched replacements for the reference's per-image working set
(ref: frame_main/libs/MVS/DepthMap.h:214-348 ``DepthData`` and
:412-444 ``ViewData`` homography constants).  The reference precomputes
per-view homography factors Hl/Hm/Hr so each pixel's plane homography is a
rank-1 update; we keep the same factorization — ``H p = A p + wv * (n.ray(p)
/ d_plane)`` — so per-pixel, per-candidate warps cost a handful of FMAs and
never materialize 3x3 matrices per pixel.

LAYOUT RULE: per-pixel vector fields (normals, rays, 3D points) are stored
planes-first — shape ``(3, H, W)`` — never ``(H, W, 3)``: a minor dimension
of 3 makes every elementwise op strided.  All hot-path math expands
3-vector algebra into scalar-coefficient elementwise ops on (H, W) planes
(see ``mat3_apply`` / ``dot3``), so no matmul runs on the dense path.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from hcmvs_tpu.core.camera import Camera, jnp_einsum, relative_motion, skew


def mat3_apply(M: jax.Array, v) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """``M @ v`` with M (3, 3) and v a 3-tuple/array of (H, W) planes.

    Expands to 9 scalar-broadcast FMAs — the planes-first form of the
    (H, W, 3) einsum.
    """
    vx, vy, vz = v[0], v[1], v[2]
    return (M[0, 0] * vx + M[0, 1] * vy + M[0, 2] * vz,
            M[1, 0] * vx + M[1, 1] * vy + M[1, 2] * vz,
            M[2, 0] * vx + M[2, 1] * vy + M[2, 2] * vz)


def mat3_apply_t(M: jax.Array, v) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """``M^T @ v`` (e.g. camera-to-world rotation without materializing
    the transpose)."""
    vx, vy, vz = v[0], v[1], v[2]
    return (M[0, 0] * vx + M[1, 0] * vy + M[2, 0] * vz,
            M[0, 1] * vx + M[1, 1] * vy + M[2, 1] * vz,
            M[0, 2] * vx + M[1, 2] * vy + M[2, 2] * vz)


def dot3(a, b) -> jax.Array:
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def norm3(a) -> jax.Array:
    return jnp.sqrt(jnp.maximum(dot3(a, a), 1e-18))


def normalize3(a) -> Tuple[jax.Array, jax.Array, jax.Array]:
    inv = 1.0 / norm3(a)
    return a[0] * inv, a[1] * inv, a[2] * inv


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ViewGeometry:
    """Constants for one reference view against V neighbor (source) views."""

    A: jax.Array          # (V, 3, 3)  K_s R_rel K_r^-1  (infinite-depth part)
    wv: jax.Array         # (V, 3)     K_s t_rel          (parallax part)
    R_rel: jax.Array      # (V, 3, 3)  ref-cam -> src-cam rotation
    t_rel: jax.Array      # (V, 3)
    K_src: jax.Array      # (V, 3, 3)
    K_inv_src: jax.Array  # (V, 3, 3)
    F: jax.Array          # (V, 3, 3)  maps ref pixel -> src epiline
    K_ref: jax.Array      # (3, 3)
    K_inv_ref: jax.Array  # (3, 3)


def make_view_geometry(ref_cam: Camera, src_cams: Camera) -> ViewGeometry:
    """Precompute per-src-view warp constants (ref: DepthMap.h:412-444)."""
    R_rel, t_rel = relative_motion(ref_cam, src_cams)
    K_inv_ref = ref_cam.K_inv
    K_src = src_cams.K
    K_inv_src = src_cams.K_inv
    A = jnp_einsum("vij,vjk,kl->vil", K_src, R_rel, K_inv_ref)
    wv = jnp_einsum("vij,vj->vi", K_src, t_rel)
    E = jnp_einsum("vij,vjk->vik", skew(t_rel), R_rel)
    F = jnp_einsum("vji,vjk,kl->vil", K_inv_src, E, K_inv_ref)
    return ViewGeometry(A=A, wv=wv, R_rel=R_rel, t_rel=t_rel, K_src=K_src,
                        K_inv_src=K_inv_src, F=F, K_ref=ref_cam.K,
                        K_inv_ref=K_inv_ref)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PatchMatchState:
    """Per-pixel hypothesis state (the functional analog of the mutable
    depthMap/normalMap/confMap trio in DepthData)."""

    depth: jax.Array   # (H, W) f32; 0 marks invalid
    normal: jax.Array  # (3, H, W) f32 unit, camera space, n . ray < 0
    cost: jax.Array    # (H, W) f32 aggregated score (0 best, 2 worst)
    key: jax.Array     # PRNG key driving this map's random refinement


def pixel_rays(K_inv: jax.Array, h: int, w: int) -> jax.Array:
    """(3, H, W) camera rays with z == 1 for every pixel center."""
    v, u = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                        jnp.arange(w, dtype=jnp.float32), indexing="ij")
    rx, ry, rz = mat3_apply(K_inv, (u, v, jnp.ones_like(u)))
    return jnp.stack([rx, ry, rz])


def random_normals(key: jax.Array, rays: jax.Array) -> jax.Array:
    """(3, H, W) random unit normals facing the camera (n . ray < 0).

    Mirrors the reference's random plane init which draws normals in a cone
    around the viewing ray (ref: DepthMap.cpp random assignment using
    fRandomAngle1/2Range).
    """
    _, h, w = rays.shape
    k1, k2 = jax.random.split(key)
    cos_t = jax.random.uniform(k1, (h, w), minval=0.5, maxval=1.0)
    phi = jax.random.uniform(k2, (h, w), minval=0.0, maxval=2 * jnp.pi)
    sin_t = jnp.sqrt(1.0 - cos_t ** 2)
    # tangent frame around d = -normalize(ray)
    d = normalize3((-rays[0], -rays[1], -rays[2]))
    t1, t2 = tangent_frame(d)
    cp = sin_t * jnp.cos(phi)
    sp = sin_t * jnp.sin(phi)
    n = tuple(d[i] * cos_t + t1[i] * cp + t2[i] * sp for i in range(3))
    n = face_camera_t(n, rays)
    return jnp.stack(n)


def tangent_frame(d):
    """Orthonormal (t1, t2) perpendicular to unit direction d (planes)."""
    use_z = jnp.abs(d[2]) < 0.9
    ux = jnp.where(use_z, 0.0, 1.0)
    uz = jnp.where(use_z, 1.0, 0.0)
    # t1 = up x d  (up = (ux, 0, uz))
    t1 = (0.0 * d[0] - uz * d[1],
          uz * d[0] - ux * d[2],
          ux * d[1] - 0.0 * d[0])
    t1 = normalize3(t1)
    # t2 = d x t1
    t2 = (d[1] * t1[2] - d[2] * t1[1],
          d[2] * t1[0] - d[0] * t1[2],
          d[0] * t1[1] - d[1] * t1[0])
    return t1, t2


def face_camera_t(n, rays):
    """Flip normal planes so n . ray <= 0 (pointing toward the camera)."""
    s = jnp.where(dot3(n, rays) > 0, -1.0, 1.0)
    return (n[0] * s, n[1] * s, n[2] * s)


def face_camera(n: jax.Array, rays: jax.Array) -> jax.Array:
    """(3, H, W) stacked variant of face_camera_t."""
    return jnp.stack(face_camera_t((n[0], n[1], n[2]),
                                   (rays[0], rays[1], rays[2])))


def _upsample_bilinear(x: jax.Array, h: int, w: int) -> jax.Array:
    """(h0, w0) -> (h, w) bilinear resize (align-corners-ish)."""
    return jax.image.resize(x, (h, w), method="bilinear")


def init_state(key: jax.Array, rays: jax.Array, d_min, d_max,
               smooth_grid: int = 8) -> PatchMatchState:
    """Random-plane initialization (ref: InitDepthMap's random fallback).

    Depths are drawn on a coarse grid and bilinearly upsampled, with a
    small per-pixel jitter on top: locally-coherent random fields are
    required for the warped-image scoring mode to bootstrap (neighbors of
    a pixel must carry comparable hypotheses for its warped patch to be
    meaningful), and they lose nothing for the exact mode — the random
    refinement ladder restores per-pixel diversity.
    """
    _, h, w = rays.shape
    k_c, k_j, k_n, k_s = jax.random.split(key, 4)
    hc = max(2, h // smooth_grid)
    wc = max(2, w // smooth_grid)
    coarse = jax.random.uniform(k_c, (hc, wc), minval=d_min, maxval=d_max)
    depth = _upsample_bilinear(coarse, h, w)
    span = d_max - d_min
    jitter = jax.random.uniform(k_j, (h, w), minval=-0.02, maxval=0.02)
    depth = jnp.clip(depth + jitter * span, d_min, d_max)
    normal = random_normals(k_n, rays)
    cost = jnp.full((h, w), 2.0, jnp.float32)
    return PatchMatchState(depth=depth.astype(jnp.float32),
                           normal=normal.astype(jnp.float32),
                           cost=cost, key=k_s)
