import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hcmvs_tpu.core.camera import Camera
from hcmvs_tpu.core.config import DenseConfig
from hcmvs_tpu.dense import score as S
from hcmvs_tpu.dense.patchmatch import (confidence_from_cost,
                                        estimate_depth_map, make_context,
                                        propagation_offsets, run_sweeps)
from hcmvs_tpu.dense.types import (PatchMatchState, init_state,
                                   make_view_geometry, pixel_rays)
from hcmvs_tpu.ops.sampling import bilinear_sample

from synthetic import make_plane_scene

TEST_CFG = DenseConfig(
    adapt_half_window=5, patch_half_window=3, patch_step=2,
    propagate_half_window=5, propagate_step=4,
    estimation_iters=2, estimation_iters_external=2, photo2geo=99,
    random_iters=3, use_optical_flow=0, use_geo_consistency=0,
    use_part_consistency=0)


def _stack_cams(cams):
    return Camera(K=jnp.stack([c.K for c in cams]),
                  R=jnp.stack([c.R for c in cams]),
                  C=jnp.stack([c.C for c in cams]))


@pytest.fixture(scope="module")
def scene():
    return make_plane_scene(np.random.default_rng(3), h=48, w=64, n_views=3)


def test_scene_rendering_consistency(scene):
    """The synthetic views must be consistent: warping the ref view's GT
    depth into src view 1 and sampling must reproduce the ref image."""
    ref_cam = scene.cameras[0]
    src_cam = scene.cameras[1]
    h, w = scene.images[0].shape
    rays = jnp.moveaxis(pixel_rays(ref_cam.K_inv, h, w), 0, -1)
    X = rays * jnp.asarray(scene.depth_gt)[..., None]
    Xw = ref_cam.cam_to_world(X)
    uv, d = src_cam.project(Xw)
    vals, valid = bilinear_sample(jnp.asarray(scene.images[1]), uv)
    err = jnp.abs(vals - scene.images[0]) * valid
    interior = np.zeros((h, w), bool)
    interior[4:-4, 4:-4] = True
    assert float(jnp.mean(err * interior)) < 0.02


def test_gt_plane_scores_better_than_random(scene):
    """The analytic GT plane must out-score perturbed hypotheses."""
    cfg = TEST_CFG
    geom = make_view_geometry(scene.cameras[0], _stack_cams(scene.cameras[1:]))
    ctx = make_context(geom, jnp.asarray(scene.images[0]),
                       jnp.stack([jnp.asarray(im) for im in scene.images[1:]]),
                       scene.d_min, scene.d_max, cfg)
    h, w = scene.images[0].shape
    offsets = S.patch_offsets(cfg)
    depth_gt = jnp.asarray(scene.depth_gt)
    normal_gt = jnp.broadcast_to(
        jnp.asarray(scene.normal_gt)[:, None, None], (3, h, w))
    ncc_gt, _ = S.photometric_scores(geom, ctx.src_grays, ctx.stats, ctx.hw,
                                  depth_gt, normal_gt, ctx.rays, offsets, cfg)
    agg_gt = S.aggregate_scores(ncc_gt, cfg)
    interior = np.zeros((h, w), bool)
    interior[6:-6, 6:-6] = True
    # GT should score very well (near 0) in the interior
    assert float(jnp.mean(jnp.where(interior, agg_gt, 0))) < 0.1 * interior.mean() * 2

    ncc_bad, _ = S.photometric_scores(geom, ctx.src_grays, ctx.stats, ctx.hw,
                                   depth_gt * 1.15, normal_gt, ctx.rays,
                                   offsets, cfg)
    agg_bad = S.aggregate_scores(ncc_bad, cfg)
    frac_better = float(jnp.mean((agg_gt < agg_bad) & interior) /
                        interior.mean())
    assert frac_better > 0.9


@pytest.mark.parametrize("score_mode", ["exact", "warped"])
def test_patchmatch_recovers_plane(scene, score_mode):
    """End-to-end single-pair estimation: photometric-only checkerboard
    PatchMatch must recover the slanted plane's depth (both the exact
    reference-semantics scoring and the approximate warped-image mode).

    The warped mode needs more (much cheaper) sweeps to converge — its
    per-sweep cost is ~1/36th of exact."""
    cfg = TEST_CFG.replace(score_mode=score_mode)
    if score_mode == "warped":
        # warped needs more (much cheaper) sweeps; pin the red/black
        # schedule it was characterized with
        cfg = cfg.replace(estimation_iters=4, estimation_iters_external=3,
                          random_iters=6, sweep_mode="redblack")
    geom = make_view_geometry(scene.cameras[0], _stack_cams(scene.cameras[1:]))
    state = estimate_depth_map(
        jax.random.PRNGKey(0), geom, jnp.asarray(scene.images[0]),
        jnp.stack([jnp.asarray(im) for im in scene.images[1:]]),
        scene.d_min, scene.d_max, cfg)
    depth, normal, conf = confidence_from_cost(state, cfg)
    interior = np.zeros(scene.depth_gt.shape, bool)
    interior[6:-6, 6:-6] = True
    d = np.asarray(depth)
    valid = (d > 0) & interior
    rel_err = np.abs(d - scene.depth_gt) / scene.depth_gt
    # most interior pixels valid, median relative error < 1%
    assert valid.sum() > 0.85 * interior.sum()
    assert np.median(rel_err[valid]) < 0.01
    # normals should agree with the GT plane normal
    n = np.asarray(normal)           # (3, H, W) planes-first
    cos = np.abs((n * scene.normal_gt[:, None, None]).sum(0))
    assert np.median(cos[valid]) > 0.95


def test_propagation_offsets_cross_pattern():
    cfg = DenseConfig(propagate_half_window=5, propagate_step=4)
    offs = propagation_offsets(cfg)
    # distances 1 and 5 in 4 directions each
    assert (0, 1) in offs and (0, -1) in offs
    assert (5, 0) in offs and (0, -5) in offs
    assert len(offs) == 8


def test_aggregate_minmean():
    cfg = DenseConfig()
    scores = jnp.asarray(np.array([0.1, 0.3, 1.9])[:, None, None]
                         * np.ones((1, 2, 2)))
    agg = S.aggregate_scores(scores, cfg)
    np.testing.assert_allclose(np.asarray(agg), 0.2, atol=1e-6)
    # two views -> plain min
    agg2 = S.aggregate_scores(scores[:2], cfg)
    np.testing.assert_allclose(np.asarray(agg2), 0.1, atol=1e-6)
