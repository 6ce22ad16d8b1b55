"""Rectified epipolar gather engine (ops/rect_gather.py).

The lookup agrees (where the window covers) with direct nearest sampling
in the source frame; plus the coverage diagnostic on typical MVS pair
geometry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hcmvs_tpu.core.camera import Camera
from hcmvs_tpu.dense.types import make_view_geometry
from hcmvs_tpu.ops.rect_gather import (build_rect_context, rect_coverage,
                                       rect_lookup_xla)
from hcmvs_tpu.utils.synth import make_plane_scene

H, W, V = 64, 128, 3


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(3)
    sc = make_plane_scene(rng, h=H, w=W, n_views=V + 1)
    cams = Camera(K=jnp.stack([c.K for c in sc.cameras]),
                  R=jnp.stack([c.R for c in sc.cameras]),
                  C=jnp.stack([c.C for c in sc.cameras]))
    cam0 = jax.tree.map(lambda x: x[0], cams)
    nbr = jax.tree.map(lambda x: x[jnp.arange(1, V + 1)], cams)
    geom = make_view_geometry(cam0, nbr)
    # smooth neighbor maps: depth plane + a synthetic "normal" field
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    base = 0.5 * (sc.d_min + sc.d_max)
    amp = 0.2 * (sc.d_max - sc.d_min)
    depth = base + amp * np.sin(xx / 17.0) * np.cos(yy / 13.0)
    chans = np.stack([depth, np.sin(xx / 9.0), np.cos(yy / 7.0),
                      -np.ones_like(depth)])
    nbr_maps = jnp.asarray(np.stack([chans * (1 + 0.01 * i)
                                     for i in range(V)]), jnp.float32)
    ctx = build_rect_context(geom, nbr_maps)
    # candidate depth field spanning the scene range with mild variation
    dcand = base + 0.3 * amp * np.sin(yy / 11.0)
    sigma = jnp.asarray(1.0 / dcand, jnp.float32)
    return geom, nbr_maps, ctx, sigma, sc


def test_coverage_near_total(setup):
    _, _, ctx, sigma, _ = setup
    cov = float(rect_coverage(ctx, sigma))
    assert cov > 0.99, f"banding coverage {cov:.4f}"


def test_values_match_direct_sampling(setup):
    """Where the rect lookup is valid, the depth it reads agrees with
    direct nearest sampling of the source-frame map (within the <=1.5px
    double-nearest bound, which on a smooth map is a small value)."""
    geom, nbr_maps, ctx, sigma, sc = setup
    from hcmvs_tpu.dense.types import mat3_apply, pixel_rays
    out = np.asarray(rect_lookup_xla(ctx, sigma))
    rays = pixel_rays(geom.K_inv_ref, H, W)
    depth = 1.0 / sigma
    X0 = (rays[0] * depth, rays[1] * depth, rays[2] * depth)
    agree = []
    for v in range(V):
        X1 = mat3_apply(geom.R_rel[v], X0)
        X1 = tuple(X1[i] + geom.t_rel[v][i] for i in range(3))
        p1 = mat3_apply(geom.K_src[v], X1)
        u1 = np.asarray(jnp.round(p1[0] / p1[2])).astype(int)
        v1 = np.asarray(jnp.round(p1[1] / p1[2])).astype(int)
        inb = (u1 >= 0) & (u1 < W) & (v1 >= 0) & (v1 < H)
        direct = np.asarray(nbr_maps[v, 0])[
            np.clip(v1, 0, H - 1), np.clip(u1, 0, W - 1)]
        valid = (out[v, 0] > 0) & inb
        assert valid.mean() > 0.5
        rel = np.abs(out[v, 0][valid] - direct[valid]) / direct[valid]
        # the rect path reads nearest-of-nearest (<= ~1.5px position
        # slack); this synthetic depth map varies ~1%/px, so the bound
        # translates to <= ~2% value deviation at the tail
        agree.append((rel < 0.02).mean())
        assert np.median(rel) < 0.005
    assert min(agree) > 0.97, f"rect vs direct agreement {agree}"


def test_forward_motion_degrades_gracefully(setup):
    """A near-forward pair must still produce finite outputs (mostly
    invalid is acceptable — the direct backend handles such pairs)."""
    geom, nbr_maps, _, sigma, _ = setup
    import dataclasses
    fwd = dataclasses.replace(
        geom, t_rel=jnp.tile(jnp.array([[0.01, 0.0, 1.0]]), (V, 1)))
    ctx = build_rect_context(fwd, nbr_maps)
    out = rect_lookup_xla(ctx, sigma)
    assert bool(jnp.all(jnp.isfinite(out)))


def test_scene_quality_rect_vs_direct():
    """End-to-end scene estimation with the rect backend matches the
    direct per-index path on the ridge golden scene (the rect path's
    <=1.5px sampling slack must not move depth accuracy)."""
    from hcmvs_tpu.core.config import DenseConfig
    from hcmvs_tpu.dense.scene_driver import (SceneTensors, estimate_scene,
                                              finalize)
    from hcmvs_tpu.utils.synth import make_ridge_scene

    sc = make_ridge_scene(np.random.default_rng(0), h=64, w=128, n_views=4)
    cams = Camera(K=jnp.stack([c.K for c in sc.cameras]),
                  R=jnp.stack([c.R for c in sc.cameras]),
                  C=jnp.stack([c.C for c in sc.cameras]))
    nbr = np.array([[j for j in range(4) if j != i][:3] for i in range(4)],
                   np.int32)
    d_lo = float(sc.depth_gt.min() * 0.7)
    d_hi = float(sc.depth_gt.max() * 1.3)
    scene = SceneTensors(
        gray=jnp.stack([jnp.asarray(im) for im in sc.images]), cams=cams,
        nbr_idx=jnp.asarray(nbr), nbr_valid=jnp.ones((4, 3), bool),
        d_min=jnp.full((4,), d_lo, jnp.float32),
        d_max=jnp.full((4,), d_hi, jnp.float32))
    accs = {}
    for backend in ("direct", "rect"):
        cfg = DenseConfig(estimation_iters=2, random_iters=3,
                          geo_backend=backend)
        st = estimate_scene(jax.random.PRNGKey(0), scene, cfg)
        depth, _, _ = finalize(st, cfg)
        gt = np.asarray(sc.depth_gt)
        d0 = np.asarray(depth[0])
        ok = d0 > 0
        rel = np.abs(d0[ok] - gt[ok]) / gt[ok]
        accs[backend] = (rel < 0.02).mean()
    assert accs["rect"] > accs["direct"] - 0.02, accs


def test_pack_unpack_roundtrip():
    from hcmvs_tpu.ops.rect_gather import pack_depth_normals, unpack_taps
    rng = np.random.default_rng(0)
    d = jnp.asarray(rng.uniform(0.5, 5.0, (2, 8, 16)), jnp.float32)
    n = rng.normal(size=(2, 3, 8, 16))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n = jnp.asarray(n, jnp.float32)
    packed = pack_depth_normals(d, n)
    assert packed.shape == (2, 2, 8, 16)
    taps, ok = unpack_taps(packed)
    assert bool(jnp.all(ok))
    np.testing.assert_allclose(np.asarray(taps[:, 0]), np.asarray(d),
                               rtol=0, atol=0)  # depth is exact
    np.testing.assert_allclose(np.asarray(taps[:, 1]),
                               np.asarray(n[:, 0]), atol=0.01)
    np.testing.assert_allclose(np.asarray(taps[:, 2]),
                               np.asarray(n[:, 1]), atol=0.01)
    # nz is reconstructed from quantized nx/ny: its error is amplified
    # by 1/|nz| near the unit circle (d(nz) = (nx dnx + ny dny)/nz) —
    # harmless for the cos-agreement term, but the test bound must
    # reflect it
    np.testing.assert_allclose(np.asarray(taps[:, 3]),
                               np.asarray(n[:, 2]), atol=0.1)
    # zero taps (invalid lookups) decode as invalid
    taps0, ok0 = unpack_taps(jnp.zeros((1, 2, 4, 4)))
    assert not bool(jnp.any(ok0))
    assert bool(jnp.all(taps0[:, 0] == 0))


def test_rect_lookup_unaligned_size():
    """Unaligned sizes (60x96 -> padded 64x128) tile-pad internally:
    the output keeps the image shape and is valid in the real region."""
    sc = make_plane_scene(np.random.default_rng(7), h=60, w=96,
                          n_views=3)
    cams = Camera(K=jnp.stack([c.K for c in sc.cameras]),
                  R=jnp.stack([c.R for c in sc.cameras]),
                  C=jnp.stack([c.C for c in sc.cameras]))
    cam0 = jax.tree.map(lambda x: x[0], cams)
    nbr = jax.tree.map(lambda x: x[jnp.arange(1, 3)], cams)
    geom = make_view_geometry(cam0, nbr)
    base = 0.5 * (sc.d_min + sc.d_max)
    nbr_maps = jnp.full((2, 4, 60, 96), base, jnp.float32)
    ctx = build_rect_context(geom, nbr_maps)
    sigma = jnp.full((60, 96), 1.0 / base, jnp.float32)
    out = np.asarray(rect_lookup_xla(ctx, sigma))
    assert out.shape == (2, 4, 60, 96)
    valid = out[:, 0] > 0
    assert float(valid.mean()) > 0.5
    # constant maps: every valid lookup reads the constant back
    np.testing.assert_allclose(out[:, 0][valid], base, rtol=1e-6)
