import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hcmvs_tpu.core.camera import Camera
from hcmvs_tpu.core.config import DenseConfig
from hcmvs_tpu.dense.fusion import (compact_point_cloud, cross_view_filter,
                                    fuse_point_cloud, gap_interpolate)
from hcmvs_tpu.dense.scene_driver import (SceneTensors, estimate_scene,
                                          finalize, init_scene_state)
from hcmvs_tpu.dense.view_selection import (depth_range_from_points,
                                            pair_scores, select_neighbors)

from synthetic import make_plane_scene

# exact scoring: these tests validate the multi-view machinery at minimal
# iteration counts; the warped production mode needs (cheaper) longer
# schedules and is covered in test_patchmatch
CFG = DenseConfig(
    adapt_half_window=5, patch_half_window=3, patch_step=2,
    estimation_iters=2, estimation_iters_external=3, photo2geo=1,
    random_iters=3, use_optical_flow=0, use_geo_consistency=1,
    use_part_consistency=0, optimize=0, min_views_fuse=2,
    score_mode="exact", explore_patch_step=0)


def _scene_tensors(sc, num_views=2):
    n = len(sc.cameras)
    cams = Camera(K=jnp.stack([c.K for c in sc.cameras]),
                  R=jnp.stack([c.R for c in sc.cameras]),
                  C=jnp.stack([c.C for c in sc.cameras]))
    # every view neighbors every other (tiny scenes)
    nbr_idx = np.zeros((n, num_views), np.int32)
    nbr_valid = np.ones((n, num_views), bool)
    for i in range(n):
        others = [j for j in range(n) if j != i][:num_views]
        nbr_idx[i, :len(others)] = others
        nbr_valid[i, len(others):] = False
    gray = jnp.stack([jnp.asarray(im) for im in sc.images])
    d_min = jnp.full((n,), sc.d_min, jnp.float32)
    d_max = jnp.full((n,), sc.d_max, jnp.float32)
    return SceneTensors(gray=gray, cams=cams, nbr_idx=jnp.asarray(nbr_idx),
                        nbr_valid=jnp.asarray(nbr_valid), d_min=d_min,
                        d_max=d_max)


@pytest.fixture(scope="module")
def scene():
    return make_plane_scene(np.random.default_rng(5), h=48, w=64, n_views=3)


@pytest.fixture(scope="module")
def est(scene):
    tensors = _scene_tensors(scene)
    state = estimate_scene(jax.random.PRNGKey(1), tensors, CFG)
    return tensors, state


def test_scene_estimation_all_views(scene, est):
    tensors, state = est
    depth, normal, conf = finalize(state, CFG)
    d = np.asarray(depth)
    interior = np.zeros(d.shape[1:], bool)
    interior[6:-6, 6:-6] = True
    # ref view must match GT
    rel = np.abs(d[0] - scene.depth_gt) / scene.depth_gt
    valid = (d[0] > 0) & interior
    assert valid.sum() > 0.8 * interior.sum()
    assert np.median(rel[valid]) < 0.01
    # every view produced a dense result
    for i in range(d.shape[0]):
        assert (d[i][interior] > 0).mean() > 0.7


def test_fusion_to_point_cloud(scene, est):
    tensors, state = est
    depth, normal, conf = finalize(state, CFG)
    # trim unconstrained borders (the full pipeline's filters handle these)
    border = np.zeros(depth.shape[1:], np.float32)
    border[6:-6, 6:-6] = 1.0
    depth = depth * border[None]
    priority = jnp.arange(depth.shape[0], dtype=jnp.float32)
    fused = fuse_point_cloud(depth, normal, conf, tensors.cams,
                             tensors.nbr_idx, tensors.nbr_valid, priority,
                             CFG)
    cloud = compact_point_cloud(fused)
    pts = cloud["points"]
    assert len(pts) > 500
    # all fused points must lie on the GT world plane n.X = c
    dist = np.abs(pts @ scene.n_w - scene.c_w)
    assert np.median(dist) < 0.01
    assert np.quantile(dist, 0.9) < 0.05
    # support counts: fused points are seen by >= min_views_fuse views
    assert (cloud["support"] >= CFG.min_views_fuse).all()
    # dedup: fused cloud should be substantially smaller than the sum of
    # valid pixels (ownership rule collapses multi-view duplicates)
    n_valid = int((np.asarray(depth) > 0).sum())
    assert len(pts) < 0.8 * n_valid


def test_cross_view_filter_kills_outliers(scene, est):
    tensors, state = est
    depth, normal, conf = finalize(state, CFG)
    # corrupt a block of the ref view with bogus depths
    d_corrupt = np.asarray(depth).copy()
    d_corrupt[0, 10:20, 10:20] *= 2.0
    filt, fused, support = cross_view_filter(
        jnp.asarray(d_corrupt), normal, conf, tensors.cams,
        tensors.nbr_idx, tensors.nbr_valid, CFG)
    blk = np.asarray(filt)[0, 10:20, 10:20]
    assert (blk == 0).mean() > 0.9   # outlier block rejected
    good = np.asarray(filt)[0, 30:40, 30:40]
    assert (good > 0).mean() > 0.8   # consistent region survives


def test_gap_interpolate():
    cfg = DenseConfig(ipol_gap_size=7)
    depth = np.full((24, 32), 5.0, np.float32)
    conf = np.full((24, 32), 0.9, np.float32)
    depth[2, 10:14] = 0.0            # small gap -> filled
    depth[8:20, 5:25] = 0.0          # big 2D hole -> left open
    d2, c2 = gap_interpolate(jnp.asarray(depth), jnp.asarray(conf), cfg)
    d2 = np.asarray(d2)
    assert (d2[2, 10:14] > 0).all()
    np.testing.assert_allclose(d2[2, 10:14], 5.0, rtol=1e-5)
    assert (d2[12:16, 12:18] == 0).all()


def test_view_selection(scene):
    rng = np.random.default_rng(0)
    # synth sparse points on the GT plane, visible in all 3 views
    n_pts = 40
    xy = rng.uniform(-0.5, 0.5, (n_pts, 2))
    z = (scene.c_w - xy @ scene.n_w[:2]) / scene.n_w[2]
    pts = np.column_stack([xy, z]).astype(np.float32)
    counts = np.full(n_pts, 3, np.int32)
    ids = np.tile(np.arange(3, dtype=np.uint32), n_pts)
    centers = np.stack([np.asarray(c.C) for c in scene.cameras])
    score = pair_scores(pts, counts, ids, centers, 3)
    assert (score > 0).sum() >= 6    # all pairs covisible
    nbr_idx, nbr_valid = select_neighbors(score, 2)
    assert nbr_valid.all()
    for i in range(3):
        assert i not in nbr_idx[i]
    R = np.eye(3)
    C = np.zeros(3)
    d_min, d_max = depth_range_from_points(pts, counts, ids, R, C, 0)
    assert 0 < d_min < z.min() + 0.1
    assert d_max > z.max() - 0.1


def test_view_spread_candidates(scene):
    """OPTDENSE::viewspread: estimation with cross-view hypothesis
    harvesting stays accurate (ref: DepthMap.cpp:1504-1608)."""
    from hcmvs_tpu.utils.synth import plane_depth_of_view
    tensors = _scene_tensors(scene)
    cfg = CFG.replace(view_spread=1, estimation_iters=2,
                      estimation_iters_external=2, random_iters=2)
    state = estimate_scene(jax.random.PRNGKey(3), tensors, cfg)
    depth, _, conf = finalize(state, cfg)
    gt = jnp.stack([jnp.asarray(plane_depth_of_view(scene, j))
                    for j in range(len(scene.cameras))])
    valid = (depth > 0) & (gt > 0)
    rel = jnp.abs(depth - gt) / gt
    acc = float(jnp.sum((rel < 0.02) & valid) / jnp.sum(valid))
    assert acc > 0.5


def test_view_spread_transfers_exact_hypothesis(scene):
    """A neighbor holding the ground-truth plane spreads it to a view
    initialized randomly: candidates must include the true depth."""
    from hcmvs_tpu.dense.score import view_spread_candidates
    from hcmvs_tpu.dense.types import make_view_geometry, pixel_rays
    tensors = _scene_tensors(scene)
    i = 0
    cam_i = jax.tree.map(lambda x: x[i], tensors.cams)
    cams_nbr = jax.tree.map(lambda x: x[tensors.nbr_idx[i]], tensors.cams)
    geom = make_view_geometry(cam_i, cams_nbr)
    from hcmvs_tpu.utils.synth import (plane_depth_of_view,
                                       plane_normal_of_view)
    h, w = scene.images[0].shape
    rays = pixel_rays(geom.K_inv_ref, h, w)
    nbrs = np.asarray(tensors.nbr_idx[i])
    gt = jnp.stack([jnp.asarray(plane_depth_of_view(scene, j))
                    for j in nbrs])
    gt_n = jnp.stack([jnp.broadcast_to(
        jnp.asarray(plane_normal_of_view(scene, j))[:, None, None],
        (3, h, w)) for j in nbrs])
    cand_d, cand_n, ok = view_spread_candidates(
        geom, jnp.asarray(plane_depth_of_view(scene, i)), rays, gt, gt_n)
    ref_gt = jnp.asarray(plane_depth_of_view(scene, i))
    # where valid, the reprojected neighbor depth matches this view's GT
    rel = jnp.abs(cand_d[0] - ref_gt) / ref_gt
    frac = float(jnp.sum((rel < 0.02) & ok[0]) / jnp.maximum(
        jnp.sum(ok[0]), 1))
    assert frac > 0.8


def test_global_pair_assignment():
    """nNumViews==1 global pair MRF analog: strong mutual scores resolve
    to good pairs; isolated images go empty."""
    from hcmvs_tpu.dense.view_selection import global_pair_assignment
    score = np.zeros((5, 5))
    # 0-1 and 2-3 strongly covisible; 4 isolated
    score[0, 1] = score[1, 0] = 10.0
    score[2, 3] = score[3, 2] = 8.0
    score[0, 2] = score[2, 0] = 1.0
    pairs = global_pair_assignment(score)
    # coverage semantics (the reference's fSamePairwise penalty): each
    # strong edge is densified from one side, not both
    assert pairs[0] == 1 or pairs[1] == 0
    assert pairs[2] == 3 or pairs[3] == 2
    assert pairs[4] == -1


def test_pair_assignment_matches_brute_force_optimum():
    """The TRW-S + restart-ensemble solver vs exhaustive enumeration on
    small instances (the r2 gap: plain ICM was never compared — measured
    23% exact with energy gaps to 53%; ref solver:
    SceneDensify.cpp:184-301 TRW-S, Math/TRWS/MRFEnergy.h)."""
    import itertools
    from hcmvs_tpu.dense.view_selection import (assignment_energy,
                                                global_pair_assignment,
                                                _pair_mrf)
    n, K = 6, 3
    exact = 0
    worst_gap = 0.0
    for seed in range(15):
        r = np.random.default_rng(seed)
        score = r.uniform(0, 1, (n, n)) * (r.uniform(0, 1, (n, n)) > 0.3)
        score = (score + score.T) / 2
        np.fill_diagonal(score, 0)
        cand, _, _, _, _ = _pair_mrf(score, K, 0.3)
        k = cand.shape[1]
        best_E = np.inf
        for labels in itertools.product(range(k + 1), repeat=n):
            assign = np.array([cand[i, l] if l < k else -1
                               for i, l in enumerate(labels)])
            best_E = min(best_E, assignment_energy(score, assign, K))
        a = global_pair_assignment(score, max_candidates=K)
        gap = (assignment_energy(score, a, K) - best_E) / max(best_E, 1e-9)
        exact += gap < 1e-9
        worst_gap = max(worst_gap, gap)
    assert exact >= 13, (exact, worst_gap)
    assert worst_gap < 0.01, worst_gap


def test_lk_flow_recovers_translation():
    """Pyramidal LK in JAX recovers a known integer shift."""
    import jax.numpy as jnp
    from hcmvs_tpu.dense.flow import lk_flow
    rng = np.random.default_rng(0)
    h, w = 64, 96
    base = rng.random((h + 16, w + 16)).astype(np.float32)
    import scipy.ndimage as ndi
    base = ndi.gaussian_filter(base, 2.0)
    ref = base[8:8 + h, 8:8 + w]
    du, dv = 3, -2
    # nbr(x, y) = ref(x + du, y + dv)  =>  flow ref->nbr is (-du, -dv)
    nbr = base[8 + dv:8 + dv + h, 8 + du:8 + du + w]
    flow = np.asarray(lk_flow(jnp.asarray(ref), jnp.asarray(nbr)))
    inner = (slice(12, h - 12), slice(12, w - 12))
    assert np.median(np.abs(flow[0][inner] + du)) < 0.3
    assert np.median(np.abs(flow[1][inner] + dv)) < 0.3


def test_triangulate_init_interpolates_plane():
    """Delaunay seed maps reproduce a planar depth field from sparse
    samples (ref: TriangulatePoints2DepthMap, DepthMap.cpp:1879)."""
    from hcmvs_tpu.dense.init_tri import triangulate_init
    rng = np.random.default_rng(0)
    h, w = 48, 64
    uv = rng.uniform([2, 2], [w - 3, h - 3], (80, 2))
    gt = 2.0 + 0.01 * uv[:, 0] + 0.02 * uv[:, 1]   # planar depth
    dmap, mask = triangulate_init(uv, gt, h, w, add_corners=True)
    ys, xs = np.mgrid[0:h, 0:w]
    gt_map = 2.0 + 0.01 * xs + 0.02 * ys
    inner = mask & (dmap > 0)
    rel = np.abs(dmap[inner] - gt_map[inner]) / gt_map[inner]
    assert inner.mean() > 0.9
    assert np.median(rel) < 0.02


def test_save_depth_png(tmp_path):
    from hcmvs_tpu.io.images import save_depth_png, load_image
    d = np.zeros((16, 24), np.float32)
    d[4:12, 6:18] = np.linspace(1, 5, 12)[None]
    p = str(tmp_path / "d.png")
    save_depth_png(p, d)
    img = load_image(p)
    assert img.shape[:2] == (16, 24)
    assert img[0, 0].max() <= 5.0 / 255  # invalid = black (normalized)
    assert img[8, 12].max() > 0.2


def test_estimate_point_labels():
    from hcmvs_tpu.core.camera import Camera as Cam
    from hcmvs_tpu.dense.fusion import estimate_point_labels
    import jax.numpy as jnp
    K = np.array([[50.0, 0, 32], [0, 50.0, 24], [0, 0, 1]])
    cams = Cam(K=jnp.asarray(K)[None], R=jnp.eye(3)[None],
               C=jnp.zeros(3)[None])
    sem = np.zeros((1, 48, 64), np.int32)
    sem[0, :, 32:] = 7
    pts = np.array([[-0.5, 0, 4.0], [0.5, 0, 4.0], [100, 0, 4.0]])
    lab = estimate_point_labels(pts, np.zeros(3, int), sem, cams)
    assert lab[0] == 0 and lab[1] == 7 and lab[2] == -1


def test_occlusion_scene_quality():
    """Depth discontinuities + per-view occlusion (foreground plate over a
    background plane): estimation with the cross-view filter must keep
    both surfaces accurate away from the ~boundary band."""
    from hcmvs_tpu.utils.synth import make_box_scene
    sc = make_box_scene(np.random.default_rng(0), h=96, w=128, n_views=4)
    n, v = 4, 3
    cams = Camera(K=jnp.stack([c.K for c in sc.cameras]),
                  R=jnp.stack([c.R for c in sc.cameras]),
                  C=jnp.stack([c.C for c in sc.cameras]))
    nbr = np.array([[j for j in range(n) if j != i][:v]
                    for i in range(n)], np.int32)
    tensors = SceneTensors(
        gray=jnp.stack([jnp.asarray(im) for im in sc.images]),
        cams=cams, nbr_idx=jnp.asarray(nbr),
        nbr_valid=jnp.ones((n, v), bool),
        d_min=jnp.full((n,), sc.d_min, jnp.float32),
        d_max=jnp.full((n,), sc.d_max, jnp.float32))
    cfg = CFG.replace(optimize=1, explore_patch_step=4,
                      score_mode="exact")
    state = estimate_scene(jax.random.PRNGKey(0), tensors, cfg)
    depth, _, _ = finalize(state, cfg)
    for i in range(2):
        d0 = np.asarray(depth[i])
        gt = sc.depth_gts[i]
        valid = (d0 > 0) & (gt > 0)
        rel = np.abs(d0 - gt) / gt
        acc = ((rel < 0.02) & valid).sum() / max(valid.sum(), 1)
        assert acc > 0.75, (i, acc)
        assert valid.mean() > 0.9


def test_gap_repropagate_fills_smooth_holes_only():
    """Phase-2 re-propagation (ref: GapInterpolation
    SceneDensify.cpp:2791-2983): holes over a smooth textured surface
    fill with accurate plane-propagated depths; holes sitting on a depth
    discontinuity (depth_ratio gate) stay unfilled."""
    from hcmvs_tpu.core.config import DenseConfig
    from hcmvs_tpu.dense.fusion import gap_repropagate
    from hcmvs_tpu.dense.types import pixel_rays
    from hcmvs_tpu.utils.synth import make_plane_scene
    sc = make_plane_scene(np.random.default_rng(5), h=48, w=64, n_views=1)
    h, w = 48, 64
    gt = jnp.asarray(sc.depth_gt)
    normal = jnp.broadcast_to(
        jnp.asarray(sc.normal_gt, jnp.float32)[:, None, None], (3, h, w))
    rays = pixel_rays(jnp.linalg.inv(jnp.asarray(sc.cameras[0].K)), h, w)
    # working maps: GT with a step discontinuity on the right half
    depth = jnp.where(jnp.arange(w)[None, :] >= 48, gt * 1.5, gt)
    # fused maps: holes punched in the smooth region and at the step
    holes = np.zeros((h, w), bool)
    holes[20:24, 10:14] = True        # smooth region
    holes[20:24, 46:50] = True        # straddles the discontinuity
    depth_fuse = jnp.where(jnp.asarray(holes), 0.0, depth)
    conf = jnp.full((h, w), 0.7)
    gra = jnp.full((h, w), 50.0)      # weak texture everywhere
    cfg = DenseConfig(propagate_half_window=5, propagate_step=2)
    d_out, n_out, c_out = gap_repropagate(
        depth_fuse, normal * jnp.asarray(holes == 0, jnp.float32)[None],
        depth, normal, conf, gra, rays, cfg)
    d_out = np.asarray(d_out)
    smooth_holes = np.zeros((h, w), bool)
    smooth_holes[20:24, 10:14] = True
    filled = d_out[smooth_holes]
    gt_np = np.asarray(gt)[smooth_holes]
    assert (filled > 0).mean() > 0.9, (filled > 0).mean()
    ok = filled > 0
    rel = np.abs(filled[ok] - gt_np[ok]) / gt_np[ok]
    assert rel.max() < 0.02, rel.max()
    # the hole pixel whose candidates straddle the discontinuity (col 48:
    # left neighbor on the gt side, right on the 1.5x side) must stay
    # unfilled (the depth_ratio gate); hole pixels wholly on one side may
    # fill, and must match THEIR side's depth
    assert (d_out[20:24, 48] == 0).all(), d_out[20:24, 48]
    gt_np_full = np.asarray(gt)
    for col, scale in ((46, 1.0), (47, 1.0), (49, 1.5)):
        vals = d_out[20:24, col]
        ok = vals > 0
        if ok.any():
            tgt = gt_np_full[20:24, col][ok] * scale
            assert (np.abs(vals[ok] - tgt) / tgt).max() < 0.02, (col, vals)


def test_window_cfg_for_width():
    """Resolution-aware windows (VERDICT r4 #8 closure): >= 2x the
    reference width doubles window + step (same sample count, 2x
    extent); below it and with the knob off, the config is untouched."""
    from hcmvs_tpu.core.config import DenseConfig, window_cfg_for_width
    base = DenseConfig(adapt_half_window=5, patch_half_window=3,
                       patch_step=2, window_ref_width=320)
    hi = window_cfg_for_width(base, 1280)
    assert (hi.adapt_half_window, hi.patch_half_window,
            hi.patch_step) == (10, 6, 4)
    assert hi.num_patch_samples == base.num_patch_samples
    lo = window_cfg_for_width(base, 320)
    assert lo == base
    off = window_cfg_for_width(base.replace(window_ref_width=0), 1280)
    assert off.patch_half_window == 3
