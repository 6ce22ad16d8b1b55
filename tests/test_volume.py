"""Parity of the sigma-volume exact-scoring path (ops/volume.py +
score.photometric_scores_volume) against the direct bilinear exact path.

The volume path must reproduce the reference-semantics scores (ref:
ScorePixelImage, frame_main/libs/MVS/DepthMap.cpp:522-595) up to the
sigma-plane lerp residual.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp


def _ctx_inputs(h=40, w=56, n_views=3):
    from hcmvs_tpu.core.camera import Camera
    from hcmvs_tpu.core.config import DenseConfig
    from hcmvs_tpu.dense import score as S
    from hcmvs_tpu.dense.types import make_view_geometry, pixel_rays
    from hcmvs_tpu.ops.gradients import sobel_magnitude
    from hcmvs_tpu.utils.synth import make_plane_scene
    sc = make_plane_scene(np.random.default_rng(1), h=h, w=w,
                          n_views=n_views)
    cfg = DenseConfig(adapt_half_window=4, patch_half_window=3,
                      patch_step=2, exact_backend="volume")
    cam0 = Camera(K=jnp.asarray(sc.cameras[0].K),
                  R=jnp.asarray(sc.cameras[0].R),
                  C=jnp.asarray(sc.cameras[0].C))
    cams_nbr = Camera(K=jnp.stack([c.K for c in sc.cameras[1:]]),
                      R=jnp.stack([c.R for c in sc.cameras[1:]]),
                      C=jnp.stack([c.C for c in sc.cameras[1:]]))
    geom = make_view_geometry(cam0, cams_nbr)
    src = jnp.stack([jnp.asarray(im) for im in sc.images[1:]])
    gray = jnp.asarray(sc.images[0])
    gra = sobel_magnitude(gray)
    hw_map = S.halfwin_map(gra, cfg)
    offsets = S.patch_offsets(cfg)
    stats = S.ref_patch_stats(gray, hw_map, offsets)
    rays = pixel_rays(geom.K_inv_ref, h, w)
    return sc, cfg, geom, src, stats, hw_map, offsets, rays


@pytest.mark.parametrize("d", [128, 256, 384])
def test_lookup_xla_matches_numpy_lerp(d):
    """volume_lookup_xla == a plain numpy lerp between adjacent planes,
    including lookups that straddle a 128-plane chunk boundary and the
    clamp at the last plane."""
    from hcmvs_tpu.ops.volume import volume_lookup_xla
    rng = np.random.default_rng(d)
    p, c = 300, 24
    tab = rng.random((p, d)).astype(np.float32)
    f = (rng.random((p, c)) * (d - 1)).astype(np.float32)
    f[:, 0] = 127.5
    f[:, 1] = d - 1.0
    out = np.asarray(volume_lookup_xla(jnp.asarray(tab), jnp.asarray(f)))
    i0 = np.clip(np.floor(f), 0, d - 2).astype(int)
    t = f - i0
    rows = np.arange(p)[:, None]
    ref = tab[rows, i0] + (tab[rows, i0 + 1] - tab[rows, i0]) * t
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_volume_scores_match_bilinear_exact():
    from hcmvs_tpu.dense import score as S
    from hcmvs_tpu.ops.volume import build_volume_tables
    sc, cfg, geom, src, stats, hw_map, offsets, rays = _ctx_inputs()
    h, w = sc.depth_gt.shape
    vol = build_volume_tables(geom, src, jnp.float32(sc.d_min),
                              jnp.float32(sc.d_max))
    # hypothesis field: GT depth with mild noise + GT-ish normals
    rng = np.random.default_rng(2)
    depth = jnp.asarray(sc.depth_gt * (1 + 0.01 * rng.standard_normal(
        sc.depth_gt.shape)), jnp.float32)
    normal = jnp.broadcast_to(
        jnp.asarray(sc.normal_gt, jnp.float32)[:, None, None], (3, h, w))
    s_ref, bad_ref = S.photometric_scores(
        geom, src, stats, hw_map, depth, normal, rays, offsets, cfg)
    s_vol, bad_vol = S.photometric_scores_volume(
        geom, vol, stats, hw_map, depth, normal, rays, offsets, cfg)
    s_ref = np.asarray(s_ref)
    s_vol = np.asarray(s_vol)
    both_good = ~(np.asarray(bad_ref) | np.asarray(bad_vol))
    # interior pixels where both paths produced a real score: the sigma
    # lerp residual must be small
    m = both_good[:, 6:-6, 6:-6]
    d = np.abs(s_ref - s_vol)[:, 6:-6, 6:-6][m]
    assert m.mean() > 0.8
    assert np.median(d) < 0.01, np.median(d)
    assert (d < 0.05).mean() > 0.97, (d < 0.05).mean()


def test_volume_backend_end_to_end_quality():
    """estimate_depth_map with the volume backend reaches the same plane
    accuracy as the bilinear exact backend."""
    from hcmvs_tpu.core.config import DenseConfig
    from hcmvs_tpu.dense.patchmatch import (confidence_from_cost,
                                            estimate_depth_map,
                                            make_context)
    from hcmvs_tpu.dense.types import init_state
    from hcmvs_tpu.ops.volume import build_volume_tables
    import dataclasses
    sc, _, geom, src, stats, hw_map, offsets, rays = _ctx_inputs()

    def run(backend):
        cfg = DenseConfig(adapt_half_window=4, patch_half_window=3,
                          patch_step=2, estimation_iters=2,
                          estimation_iters_external=2, random_iters=4,
                          use_optical_flow=0, use_geo_consistency=0,
                          explore_patch_step=0, exact_backend=backend)
        ctx = make_context(geom, jnp.asarray(sc.images[0]), src,
                           sc.d_min, sc.d_max, cfg)
        if backend == "volume":
            vol = build_volume_tables(geom, src, jnp.float32(sc.d_min),
                                      jnp.float32(sc.d_max))
            ctx = dataclasses.replace(ctx, vol=vol)
        from hcmvs_tpu.dense.patchmatch import run_sweeps
        state = init_state(jax.random.PRNGKey(0), ctx.rays,
                           sc.d_min, sc.d_max)
        for it in range(2):
            state = run_sweeps(state, ctx, cfg, 0, 2)
        gt = sc.depth_gt
        rel = np.abs(np.asarray(state.depth) - gt) / gt
        # interior accuracy: both backends leave border-band errors at
        # this tiny size/budget (patch + propagation truncation)
        return (rel < 0.02)[6:-6, 6:-6].mean()

    acc_b = run("bilinear")
    acc_v = run("volume")
    assert acc_v > 0.8, acc_v
    assert acc_v > acc_b - 0.03, (acc_v, acc_b)


def test_rect_build_matches_planes_build():
    """The rect-frame table build (build_volume_tables_rect) agrees with
    the per-plane warp build inside the intersection of their validity
    intervals, and end-to-end exact scoring through either build ranks
    hypotheses identically on the plane scene."""
    import numpy as np
    from hcmvs_tpu.core.camera import Camera
    from hcmvs_tpu.dense.types import make_view_geometry
    from hcmvs_tpu.ops.volume import (build_volume_tables,
                                      build_volume_tables_rect,
                                      from_volume_order, to_volume_order)
    from hcmvs_tpu.utils.synth import make_plane_scene
    h, w, v = 64, 128, 2
    sc = make_plane_scene(np.random.default_rng(5), h=h, w=w,
                          n_views=v + 1)
    cams = Camera(K=jnp.stack([c.K for c in sc.cameras]),
                  R=jnp.stack([c.R for c in sc.cameras]),
                  C=jnp.stack([c.C for c in sc.cameras]))
    cam0 = jax.tree.map(lambda x: x[0], cams)
    nbr = jax.tree.map(lambda x: x[jnp.arange(1, v + 1)], cams)
    geom = make_view_geometry(cam0, nbr)
    src = jnp.stack([jnp.asarray(im) for im in sc.images[1:v + 1]])
    d_min = jnp.float32(sc.d_min)
    d_max = jnp.float32(sc.d_max)
    volp = build_volume_tables(geom, src, d_min, d_max)
    volr = build_volume_tables_rect(geom, src, d_min, d_max)
    assert volp.tab.shape == volr.tab.shape
    # compare along each pixel's jointly-valid sigma range.  The planes
    # build reads src bilinearly at the exact warp; the rect build reads
    # a bilinear resample of it (one extra lerp): tolerance is image-
    # noise scale, not exact.
    p = h * w
    from hcmvs_tpu.ops.volume import _decode_tab
    tabs_p = np.asarray(_decode_tab(volp.tab[:, :p]))
    # rect tab rows are in to_volume_order; un-permute for comparison
    perm = np.asarray(to_volume_order(
        jnp.arange(p).reshape(h, w))).astype(int)
    tabs_r = np.zeros_like(tabs_p)
    tabs_r[:, perm] = np.asarray(_decode_tab(volr.tab[:, :p]))
    sig0 = float(volp.sig0[0])
    dsig = 1.0 / float(volp.inv_dsig[0])
    agree = []
    for vi in range(v):
        lo = np.maximum(np.asarray(volp.sig_lo[vi]),
                        np.asarray(volr.sig_lo[vi])).reshape(-1)
        hi = np.minimum(np.asarray(volp.sig_hi[vi]),
                        np.asarray(volr.sig_hi[vi])).reshape(-1)
        j = np.arange(128, dtype=np.float32)
        sig = sig0 + dsig * j
        valid = (sig[None, :] >= lo[:, None]) & (sig[None, :] <= hi[:, None])
        assert valid.mean() > 0.2, "joint validity collapsed"
        d = np.abs(tabs_p[vi] - tabs_r[vi])[valid]
        agree.append(float((d < 0.03).mean()))
    assert min(agree) > 0.95, f"table agreement {agree}"
    # rect intervals must be contained in (or equal to) something sane:
    # every rect-valid sample must also be planes-valid (the rect build
    # only ADDS constraints)
    for vi in range(v):
        lo_r = np.asarray(volr.sig_lo[vi])
        lo_p = np.asarray(volp.sig_lo[vi])
        ok = np.isfinite(lo_r)
        assert np.all(lo_r[ok] >= lo_p[ok] - 1e-5)


def test_rect_build_unaligned_size():
    """Unaligned image sizes (here 72x96 -> padded 72x128) ride the rect
    build via internal tile padding; end-to-end scene accuracy matches
    the planes build."""
    import numpy as np
    from hcmvs_tpu.core.camera import Camera
    from hcmvs_tpu.core.config import DenseConfig
    from hcmvs_tpu.dense.scene_driver import (SceneTensors, estimate_scene,
                                              finalize)
    from hcmvs_tpu.utils.synth import make_ridge_scene
    sc = make_ridge_scene(np.random.default_rng(1), h=72, w=96, n_views=4)
    cams = Camera(K=jnp.stack([c.K for c in sc.cameras]),
                  R=jnp.stack([c.R for c in sc.cameras]),
                  C=jnp.stack([c.C for c in sc.cameras]))
    nbr = np.array([[j for j in range(4) if j != i][:3] for i in range(4)],
                   np.int32)
    scene = SceneTensors(
        gray=jnp.stack([jnp.asarray(im) for im in sc.images]), cams=cams,
        nbr_idx=jnp.asarray(nbr), nbr_valid=jnp.ones((4, 3), bool),
        d_min=jnp.full((4,), float(sc.depth_gt.min() * 0.7), jnp.float32),
        d_max=jnp.full((4,), float(sc.depth_gt.max() * 1.3), jnp.float32))
    accs = {}
    for vb in ("planes", "rect"):
        cfg = DenseConfig(estimation_iters=2, random_iters=3,
                          volume_build=vb, exact_backend="volume")
        st = estimate_scene(jax.random.PRNGKey(0), scene, cfg)
        depth, _, _ = finalize(st, cfg)
        gt = np.asarray(sc.depth_gt)
        d0 = np.asarray(depth[0])
        ok = d0 > 0
        rel = np.abs(d0[ok] - gt[ok]) / gt[ok]
        accs[vb] = (rel < 0.02).mean()
    assert accs["rect"] > accs["planes"] - 0.02, accs


def test_volume_scores_multichunk_parity():
    """256-plane tables (volume_planes=256) reproduce the direct bilinear
    exact scores at least as tightly as the 128-plane grid (double
    density can only shrink the lerp residual)."""
    from hcmvs_tpu.dense import score as S
    from hcmvs_tpu.ops.volume import build_volume_tables
    sc, cfg, geom, src, stats, hw_map, offsets, rays = _ctx_inputs()
    h, w = sc.depth_gt.shape
    rng = np.random.default_rng(2)
    depth = jnp.asarray(sc.depth_gt * (1 + 0.01 * rng.standard_normal(
        sc.depth_gt.shape)), jnp.float32)
    normal = jnp.broadcast_to(
        jnp.asarray(sc.normal_gt, jnp.float32)[:, None, None], (3, h, w))
    s_ref, bad_ref = S.photometric_scores(
        geom, src, stats, hw_map, depth, normal, rays, offsets, cfg)
    meds = {}
    for chunks in (1, 2):
        vol = build_volume_tables(geom, src, jnp.float32(sc.d_min),
                                  jnp.float32(sc.d_max), n_chunks=chunks)
        s_vol, bad_vol = S.photometric_scores_volume(
            geom, vol, stats, hw_map, depth, normal, rays, offsets,
            cfg.replace(volume_planes=128 * chunks))
        both = ~(np.asarray(bad_ref) | np.asarray(bad_vol))
        m = both[:, 6:-6, 6:-6]
        d = np.abs(np.asarray(s_ref) - np.asarray(s_vol))[:, 6:-6, 6:-6][m]
        assert m.mean() > 0.8
        meds[chunks] = np.median(d)
    assert meds[2] <= meds[1] * 1.05, meds
    assert meds[2] < 0.01, meds


def test_batched_candidate_scores_match_per_candidate():
    """photometric_scores_volume_batched == vmapped
    photometric_scores_volume (same lookups, same math — only the
    offset-accumulation order differs)."""
    from hcmvs_tpu.dense import score as S
    from hcmvs_tpu.ops.volume import build_volume_tables
    sc, cfg, geom, src, stats, hw_map, offsets, rays = _ctx_inputs()
    h, w = sc.depth_gt.shape
    rng = np.random.default_rng(5)
    k_n = 5
    depths = jnp.asarray(
        sc.depth_gt[None] * (1 + 0.05 * rng.standard_normal((k_n, h, w))),
        jnp.float32)
    normals = []
    for k in range(k_n):
        n = sc.normal_gt + 0.2 * rng.standard_normal(3)
        n = n / np.linalg.norm(n)
        normals.append(np.broadcast_to(n[:, None, None], (3, h, w)))
    normals = jnp.asarray(np.stack(normals), jnp.float32)
    vol = build_volume_tables(geom, src, jnp.float32(sc.d_min),
                              jnp.float32(sc.d_max))
    s_ref, b_ref = jax.vmap(
        lambda d, n: S.photometric_scores_volume(
            geom, vol, stats, hw_map, d, n, rays, offsets, cfg))(
                depths, normals)
    s_bat, b_bat = S.photometric_scores_volume_batched(
        geom, vol, stats, hw_map, depths, normals, rays, offsets, cfg)
    assert s_bat.shape == (k_n, src.shape[0], h, w)
    np.testing.assert_array_equal(np.asarray(b_bat), np.asarray(b_ref))
    np.testing.assert_allclose(np.asarray(s_bat), np.asarray(s_ref),
                               rtol=2e-4, atol=2e-4)


def test_half_sweep_batched_matches_scan_path():
    """A full half_sweep with candidate_kernel on vs off picks the same
    hypotheses almost everywhere (fp-reassociation near-ties aside)."""
    from hcmvs_tpu.dense import patchmatch as PM
    from hcmvs_tpu.dense.types import init_state
    from hcmvs_tpu.ops.volume import build_volume_tables
    sc, cfg, geom, src, stats, hw_map, offsets, rays = _ctx_inputs()
    h, w = sc.depth_gt.shape
    vol = build_volume_tables(geom, src, jnp.float32(sc.d_min),
                              jnp.float32(sc.d_max))
    base = cfg.replace(random_iters=2, refine_batched=False)
    st0 = init_state(jax.random.PRNGKey(3), rays,
                     jnp.float32(sc.d_min), jnp.float32(sc.d_max))
    outs = {}
    for mode in ("on", "off"):
        c = base.replace(candidate_kernel=mode)
        ctx = PM.make_context(geom, jnp.asarray(sc.images[0]), src,
                              sc.d_min, sc.d_max, c)
        import dataclasses
        ctx = dataclasses.replace(ctx, vol=vol)
        st = PM.half_sweep(st0, ctx, c, 0, 0, offsets,
                           PM.propagation_offsets(c))
        outs[mode] = st
    d_on = np.asarray(outs["on"].depth)
    d_off = np.asarray(outs["off"].depth)
    same_pick = np.isclose(d_on, d_off, rtol=1e-5)
    assert same_pick.mean() > 0.97, same_pick.mean()
    c_on = np.asarray(outs["on"].cost)
    c_off = np.asarray(outs["off"].cost)
    np.testing.assert_allclose(c_on[same_pick], c_off[same_pick],
                               rtol=1e-3, atol=1e-3)


def test_volume_streaming_matches_attached():
    """cfg.volume_streaming (per-view in-sweep table build — the
    10-neighbor memory-wall escape, VERDICT r4 #4) produces the same
    estimate as the stage-attached scene-wide tables."""
    import numpy as np
    from hcmvs_tpu.core.camera import Camera
    from hcmvs_tpu.core.config import DenseConfig
    from hcmvs_tpu.dense.scene_driver import (SceneTensors, estimate_scene,
                                              finalize)
    from hcmvs_tpu.utils.synth import make_ridge_scene
    sc = make_ridge_scene(np.random.default_rng(2), h=48, w=64, n_views=4)
    cams = Camera(K=jnp.stack([c.K for c in sc.cameras]),
                  R=jnp.stack([c.R for c in sc.cameras]),
                  C=jnp.stack([c.C for c in sc.cameras]))
    nbr = np.array([[j for j in range(4) if j != i][:3] for i in range(4)],
                   np.int32)
    scene = SceneTensors(
        gray=jnp.stack([jnp.asarray(im) for im in sc.images]), cams=cams,
        nbr_idx=jnp.asarray(nbr), nbr_valid=jnp.ones((4, 3), bool),
        d_min=jnp.full((4,), float(sc.depth_gt.min() * 0.7), jnp.float32),
        d_max=jnp.full((4,), float(sc.depth_gt.max() * 1.3), jnp.float32))
    outs = {}
    for streaming in (False, True):
        cfg = DenseConfig(estimation_iters=2, random_iters=3,
                          exact_backend="volume",
                          volume_streaming=streaming)
        st = estimate_scene(jax.random.PRNGKey(0), scene, cfg)
        depth, _, conf = finalize(st, cfg)
        outs[streaming] = np.asarray(depth)
    # identical tables, identical PRNG path -> identical maps
    mismatch = (np.abs(outs[True] - outs[False])
                > 1e-5 * np.abs(outs[False])).mean()
    assert mismatch < 0.01, mismatch
