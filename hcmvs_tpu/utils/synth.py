"""Synthetic multi-view scenes with analytic ground truth.

Used by tests, bench.py, and the graft entries.

Renders a textured slanted plane (or several) from pinhole cameras by exact
ray-plane intersection — no external data needed, and every pixel has an
exact ground-truth depth and normal.  Serves the role the reference's
bundled sample scene plays for its golden runs (SURVEY §4).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

import jax.numpy as jnp

from hcmvs_tpu.core.camera import Camera


def _texture_params(rng: np.random.Generator, n_waves: int = 24):
    return (rng.uniform(1.5, 11.0, (n_waves, 2)),
            rng.uniform(0, 2 * np.pi, n_waves),
            rng.uniform(0.3, 1.0, n_waves) / n_waves)


def _texture(xy: np.ndarray, params) -> np.ndarray:
    """Smooth, high-gradient-everywhere pattern: random sum of sinusoids.
    The params are fixed per scene so every view samples the *same*
    view-invariant (Lambertian) world texture."""
    freqs, phases, amps = params
    val = np.zeros(xy.shape[:-1])
    for k in range(len(amps)):
        val += amps[k] * np.sin(xy[..., 0] * freqs[k, 0]
                                + xy[..., 1] * freqs[k, 1] + phases[k])
    return (0.5 + 0.5 * val / np.abs(val).max()).astype(np.float32)


def wave_texture_fn(rng: np.random.Generator, scale: float = 1.0):
    """World-(x,y) -> intensity: the random sinusoid texture with its
    frequencies multiplied by ``scale`` (finer texture for scenes seen at
    many pixels per world unit)."""
    params = _texture_params(rng)
    return lambda xy: _texture(xy * scale, params)


@dataclasses.dataclass
class PlaneScene:
    cameras: List[Camera]
    images: List[np.ndarray]          # (H, W) float32 gray
    depth_gt: np.ndarray              # (H, W) ref-view ground truth
    normal_gt: np.ndarray             # (3,) plane normal in ref cam coords
    n_w: np.ndarray                   # world plane normal
    c_w: float                        # world plane offset: n.X = c
    d_min: float
    d_max: float


def _rotation(rx: float, ry: float, rz: float) -> np.ndarray:
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rx @ Ry @ Rz


def blob_texture_fn(rng: np.random.Generator, n_blobs: int = 1200,
                    extent: float = 3.5):
    """Returns a world-(x,y) -> intensity function rich in DoG blobs —
    the feature-detector-friendly alternative to the sinusoid texture.
    Blob sigmas are sized to span ~2-9 px at the default scene geometry
    (z~4, fx~180)."""
    centers = rng.uniform(-extent, extent, (n_blobs, 2))
    sigmas = rng.uniform(0.03, 0.08, n_blobs)
    amps = rng.uniform(0.25, 0.6, n_blobs) * rng.choice([-1, 1], n_blobs)

    def fn(xy: np.ndarray) -> np.ndarray:
        # each blob touches only the points within 6 sigma of its center
        # in x (beyond that a blob adds < 1e-8): sort the points by x once
        # and visit each blob's slice — ~10x fewer exp() at 1280x960
        flat = xy.reshape(-1, 2)
        order = np.argsort(flat[:, 0], kind="stable")
        xs = flat[order, 0]
        ys = flat[order, 1]
        val = np.full(len(xs), 0.5)
        lo = np.searchsorted(xs, centers[:, 0] - 6 * sigmas)
        hi = np.searchsorted(xs, centers[:, 0] + 6 * sigmas, side="right")
        for c, s, a, i, j in zip(centers, sigmas, amps, lo, hi):
            d2 = (xs[i:j] - c[0]) ** 2 + (ys[i:j] - c[1]) ** 2
            val[i:j] += a * np.exp(-d2 / (2 * s * s))
        out = np.empty_like(val)
        out[order] = val
        return np.clip(out.reshape(xy.shape[:-1]), 0.0, 1.0).astype(
            np.float32)

    return fn


@dataclasses.dataclass
class RidgeScene:
    cameras: List[Camera]
    images: List[np.ndarray]
    depth_gt: np.ndarray              # ref-view depth
    planes: List[Tuple[np.ndarray, float]]   # [(n_w, c_w)] two planes

    def surface_dist(self, pts: np.ndarray) -> np.ndarray:
        """Distance of world points to the ridge surface (min over the
        side-appropriate plane)."""
        (n1, c1), (n2, c2) = self.planes
        d1 = np.abs(pts @ n1 - c1)
        d2 = np.abs(pts @ n2 - c2)
        return np.where(pts[:, 0] < 0, d1, d2)


def make_ridge_scene(rng: np.random.Generator, h: int = 96, w: int = 128,
                     n_views: int = 4, fx: float = 180.0,
                     z0: float = 4.0, slopes: Tuple[float, float] =
                     (0.5, -0.35), spacing: float = 0.5,
                     texture_fn=None) -> RidgeScene:
    """Two planes meeting at x = 0 (a ridge): non-planar structure, which
    single-plane scenes lack — planar scenes are the degenerate case for
    essential-matrix SfM (homography ambiguity), so SfM tests need this."""
    a1, a2 = slopes
    planes = []
    for a in (a1, a2):
        n = np.array([-a, 0.0, 1.0])
        nn = np.linalg.norm(n)
        planes.append((n / nn, z0 / nn))

    K = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1.0]])
    cams_np = []
    for i in range(n_views):
        if i == 0:
            R = np.eye(3)
            C = np.zeros(3)
        else:
            side = 1 if i % 2 else -1
            k = (i + 1) // 2
            R = _rotation(0.01 * side * k, -0.02 * side * k, 0.005 * k)
            C = np.array([spacing * side * k, 0.1 * spacing * k, 0.0])
        cams_np.append((K, R, C))

    tex = texture_fn or blob_texture_fn(rng)

    def render(cam_np):
        Kn, Rn, Cn = cam_np
        Kinv = np.linalg.inv(Kn)
        v, u = np.meshgrid(np.arange(h, dtype=np.float64),
                           np.arange(w, dtype=np.float64), indexing="ij")
        p = np.stack([u, v, np.ones_like(u)], axis=-1)
        ray_w = (p @ Kinv.T) @ Rn
        ts, valids = [], []
        for k, (n_w, c_w) in enumerate(planes):
            t = (c_w - n_w @ Cn) / (ray_w @ n_w)
            X = Cn + ray_w * t[..., None]
            want_neg = (k == 0)
            ok = (t > 0) & ((X[..., 0] < 0) == want_neg)
            ts.append(t)
            valids.append(ok)
        t = np.where(valids[0], ts[0],
                     np.where(valids[1], ts[1],
                              np.minimum(ts[0], ts[1])))
        X = Cn + ray_w * t[..., None]
        img = tex(X[..., :2])
        return img.astype(np.float32), t.astype(np.float32)

    images = []
    depth_ref = None
    for i, cam_np in enumerate(cams_np):
        img, depth = render(cam_np)
        images.append(img)
        if i == 0:
            depth_ref = depth
    cams = [Camera(K=jnp.asarray(Kn, jnp.float32),
                   R=jnp.asarray(Rn, jnp.float32),
                   C=jnp.asarray(Cn, jnp.float32))
            for Kn, Rn, Cn in cams_np]
    return RidgeScene(cameras=cams, images=images, depth_gt=depth_ref,
                      planes=planes)


def make_plane_scene(rng: np.random.Generator, h: int = 64, w: int = 80,
                     n_views: int = 3, fx: float = 100.0,
                     slant: Tuple[float, float] = (0.3, 0.15),
                     z0: float = 4.0, texture_fn=None,
                     cam_positions=None,
                     bounded_rotations: bool = False) -> PlaneScene:
    """Textured slanted plane z = z0 + a*x + b*y seen from ``n_views``
    cameras: camera 0 is the reference at the origin; the others are
    translated sideways with a small rotation (stereo-like baselines).
    ``cam_positions``: optional explicit camera centers (overrides the
    default sideways rig — e.g. dolly-in positions for scale-change
    tests)."""
    a, b = slant
    # plane: z - a*x - b*y = z0  ->  n_w = (-a, -b, 1)/|.|, c = z0/|.|
    n_w = np.array([-a, -b, 1.0])
    norm = np.linalg.norm(n_w)
    n_w = n_w / norm
    c_w = z0 / norm

    K = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1.0]])
    # everything stays numpy until the very end (host-side scene build)
    cams_np = []
    for i in range(n_views):
        if cam_positions is not None:
            # bounded_rotations: jitter pattern that does NOT grow with i
            # (the linear-in-i default turns a 200-camera corridor's tail
            # 26+ degrees away from the plane footprint)
            k = (i % 7) - 3 if bounded_rotations else i
            R = (np.eye(3) if i == 0 else
                 _rotation(0.004 * k, -0.006 * k, 0.002 * k))
            C = np.asarray(cam_positions[i], np.float64)
        elif i == 0:
            R = np.eye(3)
            C = np.zeros(3)
        else:
            side = 1 if i % 2 else -1
            k = (i + 1) // 2
            R = _rotation(0.01 * side * k, -0.02 * side * k, 0.005 * k)
            C = np.array([0.25 * side * k, 0.05 * k, 0.0])
        cams_np.append((K, R, C))

    tex_params = _texture_params(np.random.default_rng(12345))

    def render(cam_np) -> Tuple[np.ndarray, np.ndarray]:
        Kn, Rn, Cn = cam_np
        Kinv = np.linalg.inv(Kn)
        v, u = np.meshgrid(np.arange(h, dtype=np.float64),
                           np.arange(w, dtype=np.float64), indexing="ij")
        p = np.stack([u, v, np.ones_like(u)], axis=-1)
        ray_cam = p @ Kinv.T
        ray_w = ray_cam @ Rn           # R^T @ ray
        t = (c_w - n_w @ Cn) / (ray_w @ n_w)
        X = Cn + ray_w * t[..., None]
        if texture_fn is not None:
            img = texture_fn(X[..., :2])
        else:
            img = _texture(X[..., :2] * 2.0, tex_params)
        return img.astype(np.float32), t.astype(np.float32)

    images = []
    depth_ref = None
    for i, cam_np in enumerate(cams_np):
        img, depth = render(cam_np)
        images.append(img)
        if i == 0:
            depth_ref = depth
    cams = [Camera(K=jnp.asarray(Kn, jnp.float32),
                   R=jnp.asarray(Rn, jnp.float32),
                   C=jnp.asarray(Cn, jnp.float32))
            for Kn, Rn, Cn in cams_np]

    # ref-camera-frame plane normal (identity ref pose: same as world)
    n_cam = n_w.astype(np.float32)
    if n_cam[2] > 0:
        n_cam = -n_cam   # face the camera (points have +z in cam frame)
    d_min = float(depth_ref.min() * 0.7)
    d_max = float(depth_ref.max() * 1.4)
    return PlaneScene(cameras=cams, images=images, depth_gt=depth_ref,
                      normal_gt=n_cam, n_w=n_w, c_w=c_w,
                      d_min=d_min, d_max=d_max)


def plane_depth_of_view(scene: PlaneScene, view: int) -> np.ndarray:
    """Ground-truth depth of any view from the world plane n_w . X = c_w."""
    cam = scene.cameras[view]
    h, w = scene.images[view].shape
    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    K_inv = np.linalg.inv(cam.K)
    rc = np.stack([u, v, np.ones_like(u)])            # (3, H, W) cam rays
    dir_w = np.einsum("ji,jhw->ihw", cam.R, np.einsum(
        "ij,jhw->ihw", K_inv, rc))                    # R^T K^-1 p
    denom = np.einsum("i,ihw->hw", scene.n_w, dir_w)
    s = (scene.c_w - scene.n_w @ cam.C) / np.where(
        np.abs(denom) < 1e-12, 1e-12, denom)
    return s.astype(np.float32)                       # rc_z == 1 => depth


def plane_normal_of_view(scene: PlaneScene, view: int) -> np.ndarray:
    """(3,) GT plane normal in the view's camera frame, facing the camera."""
    cam = scene.cameras[view]
    n_c = cam.R @ scene.n_w
    return (-n_c if n_c[2] > 0 else n_c).astype(np.float32)


@dataclasses.dataclass
class BoxScene:
    cameras: List[Camera]
    images: List[np.ndarray]
    depth_gts: List[np.ndarray]       # per-view GT depth
    d_min: float
    d_max: float


def make_box_scene(rng: np.random.Generator, h: int = 96, w: int = 128,
                   n_views: int = 4, fx: float = 150.0,
                   z_bg: float = 6.0, z_fg: float = 4.0,
                   fg_half: float = 0.6) -> BoxScene:
    """Occlusion scene: a textured foreground plate (z = z_fg, |x|,|y| <=
    fg_half) floating over a textured background plane (z = z_bg) —
    depth discontinuities and per-view occlusion, the failure mode the
    cross-view filter and fusion must survive."""
    K = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1.0]])
    cams_np = []
    for i in range(n_views):
        if i == 0:
            R, C = np.eye(3), np.zeros(3)
        else:
            side = 1 if i % 2 else -1
            k = (i + 1) // 2
            R = _rotation(0.008 * side * k, -0.015 * side * k, 0.004 * k)
            C = np.array([0.3 * side * k, 0.04 * k, 0.0])
        cams_np.append((K, R, C))
    tex_bg = _texture_params(np.random.default_rng(777))
    tex_fg = _texture_params(np.random.default_rng(778))

    images, depths = [], []
    for Kn, Rn, Cn in cams_np:
        Kinv = np.linalg.inv(Kn)
        v, u = np.meshgrid(np.arange(h, dtype=np.float64),
                           np.arange(w, dtype=np.float64), indexing="ij")
        p = np.stack([u, v, np.ones_like(u)], axis=-1)
        ray_w = (p @ Kinv.T) @ Rn
        # intersect both z = const planes (rays have ray_w[...,2] != 0)
        t_fg = (z_fg - Cn[2]) / ray_w[..., 2]
        t_bg = (z_bg - Cn[2]) / ray_w[..., 2]
        X_fg = Cn + ray_w * t_fg[..., None]
        X_bg = Cn + ray_w * t_bg[..., None]
        on_fg = ((np.abs(X_fg[..., 0]) <= fg_half)
                 & (np.abs(X_fg[..., 1]) <= fg_half))
        img = np.where(on_fg, _texture(X_fg[..., :2] * 2.0, tex_fg),
                       _texture(X_bg[..., :2], tex_bg))
        # camera depth = z of the hit point in camera coords
        d_fg = ((X_fg - Cn) @ Rn.T)[..., 2]
        d_bg = ((X_bg - Cn) @ Rn.T)[..., 2]
        depth = np.where(on_fg, d_fg, d_bg)
        images.append(img.astype(np.float32))
        depths.append(depth.astype(np.float32))
    cams = [Camera(K=jnp.asarray(Kn, jnp.float32),
                   R=jnp.asarray(Rn, jnp.float32),
                   C=jnp.asarray(Cn, jnp.float32))
            for Kn, Rn, Cn in cams_np]
    return BoxScene(cameras=cams, images=images, depth_gts=depths,
                    d_min=z_fg * 0.6, d_max=z_bg * 1.4)


def write_scene_mvs(sc, out_dir: str, n_sparse: int = 200,
                    seed: int = 0) -> Tuple[str, str]:
    """Write a synthetic scene as ``scene.mvs`` (ground-truth poses) plus
    8-bit PNG images, the input of the densify/hierarchy entry points.

    Sparse points are ``n_sparse`` reference-view pixels back-projected at
    their ground-truth depth, listed as seen by every view (they seed the
    depth range and the neighbor-view scores).  Returns (mvs_path,
    images_dir)."""
    import os
    from hcmvs_tpu.io.images import write_png
    from hcmvs_tpu.io.mvs import (CameraIntrinsic, ImageRecord, Platform,
                                  Pose, SceneMVS, write_mvs)
    h, w = sc.images[0].shape
    K = np.asarray(sc.cameras[0].K, np.float64)
    plat = Platform(name="p0")
    plat.cameras.append(CameraIntrinsic(name="c0", width=w, height=h, K=K,
                                        R=np.eye(3), C=np.zeros(3)))
    scene = SceneMVS(platforms=[plat])
    img_dir = os.path.join(out_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    for i, cam in enumerate(sc.cameras):
        plat.poses.append(Pose(R=np.asarray(cam.R, np.float64),
                               C=np.asarray(cam.C, np.float64)))
        name = f"im{i:04d}.png"
        write_png(os.path.join(img_dir, name),
                  np.round(np.clip(sc.images[i], 0, 1) * 255).astype(
                      np.uint8))
        scene.images.append(ImageRecord(name=name, platform_id=0,
                                        camera_id=0, pose_id=i, id=i))
    rng = np.random.default_rng(seed)
    m = max(h, w) // 8
    v = rng.integers(m, h - m, n_sparse)
    u = rng.integers(m, w - m, n_sparse)
    d = np.asarray(sc.depth_gt, np.float64)[v, u]
    rays = np.linalg.inv(K) @ np.stack([u, v, np.ones(n_sparse)])
    R0 = np.asarray(sc.cameras[0].R, np.float64)
    C0 = np.asarray(sc.cameras[0].C, np.float64)
    scene.points = ((R0.T @ (rays * d)).T + C0).astype(np.float32)
    n_views = len(sc.cameras)
    scene.point_view_counts = np.full(n_sparse, n_views, np.int32)
    scene.point_view_ids = np.tile(np.arange(n_views, dtype=np.uint32),
                                   n_sparse)
    scene.point_view_confs = np.ones(n_sparse * n_views, np.float32)
    path = os.path.join(out_dir, "scene.mvs")
    write_mvs(path, scene)
    return path, img_dir
