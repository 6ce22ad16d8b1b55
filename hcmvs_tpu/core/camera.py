"""Pinhole camera model as a JAX pytree.

Batched analog of the reference camera layer
(ref: frame_main/libs/MVS/Camera.h:55-68 — K/R/C decomposition,
TransformPointI2W/W2C/C2I and friends).  Unlike the reference's scalar C++
methods, every op here is shape-polymorphic over leading batch axes so a
whole view set (or a whole pixel grid) is transformed in one fused XLA call.

Conventions (identical to the reference so poses interop through `.mvs`):
- ``K``: 3x3 intrinsics (pixels), ``R``: world->camera rotation,
  ``C``: camera center in world coordinates; translation ``t = -R @ C``.
- camera coords: ``X_cam = R @ (X_world - C)``; depth = ``X_cam[..., 2]``.
- image coords: ``x_img = hnorm(K @ X_cam)`` with (u, v) pixel coordinates.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp

# Geometry runs on tiny 3x3 systems where reduced-precision matmul passes
# (TF32 on Hopper keeps ~3 decimal digits) lose accuracy; force full fp32
# for every contraction in this module (the cost is negligible — these ops
# are tiny).
jnp_einsum = functools.partial(jnp.einsum,
                               precision=jax.lax.Precision.HIGHEST)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Camera:
    """A (batch of) pinhole camera(s); all fields broadcast together.

    Shapes: ``K``: (..., 3, 3), ``R``: (..., 3, 3), ``C``: (..., 3).
    """

    K: jax.Array
    R: jax.Array
    C: jax.Array

    @property
    def t(self) -> jax.Array:
        """Translation vector t = -R @ C, shape (..., 3)."""
        return -jnp_einsum("...ij,...j->...i", self.R, self.C)

    @property
    def K_inv(self) -> jax.Array:
        """Closed-form inverse of the (upper-triangular) intrinsics."""
        fx = self.K[..., 0, 0]
        fy = self.K[..., 1, 1]
        s = self.K[..., 0, 1]
        cx = self.K[..., 0, 2]
        cy = self.K[..., 1, 2]
        zero = jnp.zeros_like(fx)
        one = jnp.ones_like(fx)
        inv_fx = 1.0 / fx
        inv_fy = 1.0 / fy
        row0 = jnp.stack([inv_fx, -s * inv_fx * inv_fy,
                          (s * cy - cx * fy) * inv_fx * inv_fy], axis=-1)
        row1 = jnp.stack([zero, inv_fy, -cy * inv_fy], axis=-1)
        row2 = jnp.stack([zero, zero, one], axis=-1)
        return jnp.stack([row0, row1, row2], axis=-2)

    @property
    def P(self) -> jax.Array:
        """Projection matrix P = K @ [R | t], shape (..., 3, 4)."""
        Rt = jnp.concatenate([self.R, self.t[..., :, None]], axis=-1)
        return jnp_einsum("...ij,...jk->...ik", self.K, Rt)

    # -- world <-> camera ---------------------------------------------------

    def world_to_cam(self, X: jax.Array) -> jax.Array:
        """(..., 3) world points -> camera coords (ref: TransformPointW2C)."""
        return jnp_einsum("...ij,...j->...i", self.R, X - self.C)

    def cam_to_world(self, Xc: jax.Array) -> jax.Array:
        """(..., 3) camera coords -> world (ref: TransformPointC2W)."""
        return jnp_einsum("...ji,...j->...i", self.R, Xc) + self.C

    # -- camera <-> image ---------------------------------------------------

    def cam_to_image(self, Xc: jax.Array) -> jax.Array:
        """(..., 3) camera coords -> (..., 2) pixel coords (ref: C2I)."""
        x = jnp_einsum("...ij,...j->...i", self.K, Xc)
        return x[..., :2] / x[..., 2:3]

    def image_to_ray(self, uv: jax.Array) -> jax.Array:
        """(..., 2) pixels -> (..., 3) camera-frame ray with dir[2] == 1.

        ``depth * image_to_ray(uv)`` is the camera-space point at ``depth``.
        """
        ones = jnp.ones_like(uv[..., :1])
        return jnp_einsum(
            "...ij,...j->...i", self.K_inv,
            jnp.concatenate([uv, ones], axis=-1))

    # -- combined -----------------------------------------------------------

    def project(self, X: jax.Array) -> Tuple[jax.Array, jax.Array]:
        """World points -> ((..., 2) pixels, (...,) depth)."""
        Xc = self.world_to_cam(X)
        return self.cam_to_image(Xc), Xc[..., 2]

    def backproject(self, uv: jax.Array, depth: jax.Array) -> jax.Array:
        """Pixels + depth -> (..., 3) world points (ref: TransformPointI2W)."""
        Xc = self.image_to_ray(uv) * depth[..., None]
        return self.cam_to_world(Xc)

    def scaled(self, scale: jax.Array | float) -> "Camera":
        """Camera for an image resized by ``scale`` (ref: Camera::GetScaledK).

        Uses the pixel-center-preserving convention K' = S K with
        S = diag(s, s, 1) composed with the half-pixel offset: the reference
        scales fx, fy, cx, cy directly, which matches corner-anchored
        resizing; we follow the reference for `.dmap` interop.
        """
        K = self.K
        s = jnp.asarray(scale, K.dtype)
        scale_mat = jnp.stack([s, s, jnp.ones_like(s)], axis=-1)
        K = K * scale_mat[..., :, None]
        return Camera(K=K, R=self.R, C=self.C)


def relative_motion(ref: Camera, src: Camera) -> Tuple[jax.Array, jax.Array]:
    """Rigid motion taking ref-camera coords to src-camera coords.

    ``X_src = R_rel @ X_ref + t_rel`` with
    ``R_rel = R_s R_r^T`` and ``t_rel = R_s (C_r - C_s)``.
    """
    R_rel = jnp_einsum("...ij,...kj->...ik", src.R, ref.R)
    t_rel = jnp_einsum("...ij,...j->...i", src.R, ref.C - src.C)
    return R_rel, t_rel


def plane_homography(ref: Camera, src: Camera, n: jax.Array,
                     d_plane: jax.Array) -> jax.Array:
    """Plane-induced homography ref-image -> src-image, shape (..., 3, 3).

    The plane is ``n . X = d_plane`` in ref-camera coordinates (``n`` unit,
    pointing toward the camera so ``d_plane < 0`` for OpenMVS-convention
    normals).  This is the batched analog of the per-view homography constants
    precomputed by the reference estimator
    (ref: frame_main/libs/MVS/DepthMap.h:412-444 — Hl/Hm/Hr).
    """
    R_rel, t_rel = relative_motion(ref, src)
    H_cam = R_rel + jnp_einsum("...i,...j->...ij", t_rel, n) / d_plane[..., None, None]
    return jnp_einsum("...ij,...jk,...kl->...il", src.K, H_cam, ref.K_inv)


def apply_homography(H: jax.Array, uv: jax.Array) -> jax.Array:
    """Apply (..., 3, 3) homography to (..., 2) points -> (..., 2)."""
    ones = jnp.ones_like(uv[..., :1])
    x = jnp_einsum("...ij,...j->...i",
                   H, jnp.concatenate([uv, ones], axis=-1))
    return x[..., :2] / x[..., 2:3]


def fundamental_matrix(ref: Camera, src: Camera) -> jax.Array:
    """Fundamental matrix mapping ref-image points to src-image epilines.

    ``l_src = F @ [u, v, 1]``.  Built from the relative motion as
    ``F = K_s^-T [t]_x R_rel K_r^-1`` (ref: DepthMap.h:577-599 computes the
    same quantity from homography constants for the epipolar-distance term
    of the geometric-consistency score).
    """
    R_rel, t_rel = relative_motion(ref, src)
    E = jnp_einsum("...ij,...jk->...ik", skew(t_rel), R_rel)
    Ksi = Camera(K=src.K, R=src.R, C=src.C).K_inv
    Kri = ref.K_inv
    return jnp_einsum("...ji,...jk,...kl->...il", Ksi, E, Kri)


def skew(v: jax.Array) -> jax.Array:
    """(..., 3) -> (..., 3, 3) cross-product matrix [v]_x."""
    z = jnp.zeros_like(v[..., 0])
    return jnp.stack([
        jnp.stack([z, -v[..., 2], v[..., 1]], axis=-1),
        jnp.stack([v[..., 2], z, -v[..., 0]], axis=-1),
        jnp.stack([-v[..., 1], v[..., 0], z], axis=-1),
    ], axis=-2)


def point_to_epiline_dist(F: jax.Array, uv_ref: jax.Array,
                          uv_src: jax.Array) -> jax.Array:
    """Distance of ``uv_src`` to the epipolar line of ``uv_ref`` under F."""
    ones = jnp.ones_like(uv_ref[..., :1])
    l = jnp_einsum("...ij,...j->...i",
                   F, jnp.concatenate([uv_ref, ones], axis=-1))
    num = jnp.abs(l[..., 0] * uv_src[..., 0] + l[..., 1] * uv_src[..., 1]
                  + l[..., 2])
    den = jnp.sqrt(l[..., 0] ** 2 + l[..., 1] ** 2) + 1e-12
    return num / den
