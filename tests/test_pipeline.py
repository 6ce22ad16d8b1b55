import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hcmvs_tpu.core.config import DenseConfig
from hcmvs_tpu.io.images import write_png
from hcmvs_tpu.io.mvs import (CameraIntrinsic, ImageRecord, Platform, Pose,
                              SceneMVS, write_mvs)
from hcmvs_tpu.pipeline.densify import build_scene_tensors, densify
from hcmvs_tpu.pipeline.hierarchy import default_schedule, run_hierarchy

from synthetic import make_plane_scene

CFG = DenseConfig(
    adapt_half_window=5, patch_half_window=3, patch_step=2,
    estimation_iters=2, estimation_iters_external=2, photo2geo=1,
    random_iters=3, use_optical_flow=0, use_geo_consistency=1,
    use_part_consistency=0, optimize=0, score_mode="exact",
    resolution_level=0, min_resolution=0, use_semantic=False)


def _write_scene(tmp_path, sc, n_sparse=60):
    """Write the synthetic scene as scene.mvs + PNG images."""
    h, w = sc.images[0].shape
    rng = np.random.default_rng(0)
    plat = Platform(name="p0")
    K = np.asarray(sc.cameras[0].K, np.float64)
    plat.cameras.append(CameraIntrinsic(name="c0", width=w, height=h,
                                        K=K, R=np.eye(3), C=np.zeros(3)))
    scene = SceneMVS(platforms=[plat])
    img_dir = tmp_path / "images"
    os.makedirs(img_dir, exist_ok=True)
    for i, cam in enumerate(sc.cameras):
        plat.poses.append(Pose(R=np.asarray(cam.R, np.float64),
                               C=np.asarray(cam.C, np.float64)))
        name = f"im{i:04d}.png"
        write_png(str(img_dir / name),
                  (sc.images[i] * 255).astype(np.uint8))
        scene.images.append(ImageRecord(name=name, platform_id=0,
                                        camera_id=0, pose_id=i, id=i))
    # sparse points on the GT plane, visible everywhere
    xy = rng.uniform(-0.5, 0.5, (n_sparse, 2))
    z = (sc.c_w - xy @ sc.n_w[:2]) / sc.n_w[2]
    scene.points = np.column_stack([xy, z]).astype(np.float32)
    scene.point_view_counts = np.full(n_sparse, len(sc.cameras), np.int32)
    scene.point_view_ids = np.tile(
        np.arange(len(sc.cameras), dtype=np.uint32), n_sparse)
    scene.point_view_confs = np.ones(
        n_sparse * len(sc.cameras), np.float32)
    path = str(tmp_path / "scene.mvs")
    write_mvs(path, scene)
    return path, str(img_dir)


@pytest.fixture(scope="module")
def scene():
    return make_plane_scene(np.random.default_rng(9), h=48, w=64,
                            n_views=3)


def test_densify_driver_end_to_end(scene, tmp_path):
    scene_path, img_dir = _write_scene(tmp_path, scene)
    out_dir = str(tmp_path / "out")
    stats = densify(scene_path, img_dir, out_dir, CFG, verbose=False)
    assert stats["n_views"] == 3
    assert stats["valid_frac"] > 0.5
    assert stats["n_points"] > 200
    # artifacts exist and are readable
    from hcmvs_tpu.io.dmap import read_dmap
    from hcmvs_tpu.io.mvs import read_mvs
    dm = read_dmap(os.path.join(out_dir, "depthmap", "depth0000.dmap"))
    assert dm.depth.shape == (48, 64)
    interior = dm.depth[8:-8, 8:-8]
    valid = interior > 0
    rel = np.abs(interior - scene.depth_gt[8:-8, 8:-8]) / \
        scene.depth_gt[8:-8, 8:-8]
    assert np.median(rel[valid]) < 0.02
    dense = read_mvs(os.path.join(out_dir, "scene_dense.mvs"))
    assert len(dense.points) == stats["n_points"]
    assert os.path.exists(os.path.join(out_dir, "scene_dense.ply"))


def test_densify_fusion_modes(scene, tmp_path):
    """The app-level --fusion-mode dispatch (ref: DensifyPointCloud.cpp:154
    and the ABS(mode)==1 export-only early exit at :436-441)."""
    scene_path, img_dir = _write_scene(tmp_path, scene)
    # mode 1: PatchMatch depth maps only, no fusion artifacts
    out1 = str(tmp_path / "mode1")
    s1 = densify(scene_path, img_dir, out1, CFG, verbose=False,
                 fusion_mode=1)
    assert s1["n_points"] == 0
    assert os.path.exists(os.path.join(out1, "depthmap", "depth0000.dmap"))
    assert not os.path.exists(os.path.join(out1, "scene_dense.ply"))
    assert not os.path.exists(os.path.join(out1, "scene_dense.mvs"))
    assert s1["valid_frac"] > 0.5
    # mode -2: SGM stereo maps + fusion -> cloud artifacts present
    out2 = str(tmp_path / "mode-2")
    s2 = densify(scene_path, img_dir, out2, CFG, verbose=False,
                 fusion_mode=-2)
    assert s2["valid_frac"] > 0.2
    assert s2["n_points"] > 50
    assert os.path.exists(os.path.join(out2, "scene_dense.ply"))
    # mode -1: SGM export only
    out3 = str(tmp_path / "mode-1")
    s3 = densify(scene_path, img_dir, out3, CFG, verbose=False,
                 fusion_mode=-1)
    assert s3["n_points"] == 0
    assert os.path.exists(os.path.join(out3, "depthmap", "depth0000.dmap"))
    assert not os.path.exists(os.path.join(out3, "scene_dense.ply"))


def test_densify_priors_dir(scene, tmp_path):
    """--priors-dir ingestion: external .dmap prior maps load, resize and
    feed the prior channel even without use-semantic (the meanshift
    channel; ref: GenerateFinalPrior, SceneDensify.cpp:1079-1161)."""
    from hcmvs_tpu.io.dmap import DepthMapData, write_dmap
    from hcmvs_tpu.pipeline.densify import load_prior_maps
    from hcmvs_tpu.io.mvs import read_mvs
    scene_path, img_dir = _write_scene(tmp_path, scene)
    sc = read_mvs(scene_path)
    h, w = scene.images[0].shape
    pdir = tmp_path / "priors"
    os.makedirs(pdir)
    # priors at HALF resolution to exercise the resize; view 1 has none
    ph, pw = h // 2, w // 2
    K = np.asarray(scene.cameras[0].K, np.float64)
    for i in (0, 2):
        write_dmap(str(pdir / f"depth{i:04d}.dmap"),
                   DepthMapData(depth=np.full((ph, pw), 3.5, np.float32),
                                normal=np.zeros((ph, pw, 3), np.float32),
                                conf=np.ones((ph, pw), np.float32),
                                K=K, R=np.eye(3), C=np.zeros(3),
                                d_min=1.0, d_max=10.0,
                                image_size=(pw, ph),
                                image_name=f"im{i:04d}.png",
                                view_ids=[i]))
    ext = load_prior_maps(str(pdir), sc, (h, w))
    assert ext is not None and ext.shape == (3, h, w)
    assert np.allclose(ext[0], 3.5) and np.allclose(ext[2], 3.5)
    assert np.all(ext[1] == 0)
    # full driver run with the channel plumbed (no semantic masks)
    out = str(tmp_path / "out_priors")
    stats = densify(scene_path, img_dir, out, CFG, verbose=False,
                    priors_dir=str(pdir))
    assert stats["valid_frac"] > 0.5


def test_hierarchy_schedule_structure():
    sched = default_schedule(CFG)
    assert [s.level for s in sched] == [3, 2, 2, 1, 1]
    assert [s.variant for s in sched] == ["A", "B", "A", "B", "A"]
    # variant A reads init, variant B triangulates + uses priors
    assert sched[0].cfg.init_triangulate == 0
    assert sched[1].cfg.init_triangulate == 1
    assert sched[1].cfg.use_semantic


def test_hierarchy_two_level_run(scene, tmp_path):
    """Coarse-to-fine: level-2 estimation initializes level-1; the final
    maps must match GT."""
    import dataclasses as dc
    scene_path, img_dir = _write_scene(tmp_path, scene)
    from hcmvs_tpu.io.mvs import read_mvs
    from hcmvs_tpu.io.images import resize_image
    mvs = read_mvs(scene_path)
    full = [im for im in scene.images]
    half = [resize_image(im, 0.5) for im in scene.images]
    cfg = CFG.replace(estimation_iters_external=1, photo2geo=99,
                      use_geo_consistency=0)
    tensors = {
        1: build_scene_tensors(mvs, full, cfg),
        2: build_scene_tensors(mvs, half, cfg),
    }
    from hcmvs_tpu.pipeline.hierarchy import Stage
    sched = [Stage(level=2, variant="A", cfg=cfg),
             Stage(level=1, variant="A", cfg=cfg),
             Stage(level=1, variant="B",
                   cfg=cfg.replace(use_semantic=False))]
    state = run_hierarchy(tensors, cfg, sched)
    d = np.asarray(state.depth[0])
    interior = np.s_[8:-8, 8:-8]
    rel = np.abs(d[interior] - scene.depth_gt[interior]) / \
        scene.depth_gt[interior]
    assert np.median(rel) < 0.02


def test_densify_resume_and_profiling(tmp_path, scene):
    """Per-image resume: a second densify() run loads the existing .dmap
    files instead of re-estimating (ref: SceneDensify.cpp:3865-3880), and
    the profiling report records the stages."""
    from hcmvs_tpu.utils import profiling
    cfg = CFG
    scene_path, images_dir = _write_scene(tmp_path, scene)
    out = str(tmp_path / "out")
    profiling.reset_report()
    s1 = densify(scene_path, images_dir, out, cfg, verbose=False)
    rep = profiling.report()
    assert "densify.estimate" in rep and rep["densify.estimate"]["calls"] == 1
    s2 = densify(scene_path, images_dir, out, cfg, verbose=False)
    # no second estimation happened
    assert profiling.report()["densify.estimate"]["calls"] == 1
    np.testing.assert_allclose(s2["depth"], s1["depth"], atol=1e-4)
    # and the visibility filter path runs end-to-end
    s3 = densify(scene_path, images_dir, out, cfg, verbose=False,
                 filter_point_cloud=-3)
    assert s3["n_points"] <= s1["n_points"]


def test_hierarchy_checkpoint_resume(tmp_path, scene):
    """Stage-handoff checkpoints: killing after stage k and rerunning
    resumes from k+1 and reproduces the uninterrupted result (the run.sh
    `mv` handoff replacement)."""
    from hcmvs_tpu.pipeline.hierarchy import Stage, run_hierarchy
    scene_path, images_dir = _write_scene(tmp_path, scene)
    from hcmvs_tpu.io.mvs import read_mvs
    mvs = read_mvs(scene_path)
    grays = [np.asarray(im, np.float32) for im in scene.images]
    from hcmvs_tpu.pipeline.densify import build_scene_tensors
    cfg = CFG.replace(estimation_iters=1, estimation_iters_external=1,
                      random_iters=2, use_semantic=False, optimize=0)
    tensors = build_scene_tensors(mvs, grays, cfg)
    sched = [Stage(level=1, variant="A", cfg=cfg),
             Stage(level=1, variant="B", cfg=cfg),
             Stage(level=1, variant="A", cfg=cfg)]
    levels = {1: tensors}
    ck = str(tmp_path / "ck")
    full = run_hierarchy(levels, cfg, schedule=sched,
                         checkpoint_dir=ck, resume=False)
    # simulate a crash after stage 1: new checkpoint dir, run only 2 stages
    ck2 = str(tmp_path / "ck2")
    run_hierarchy(levels, cfg, schedule=sched[:2], checkpoint_dir=ck2,
                  resume=False)
    resumed = run_hierarchy(levels, cfg, schedule=sched,
                            checkpoint_dir=ck2, resume=True)
    np.testing.assert_allclose(np.asarray(resumed.depth),
                               np.asarray(full.depth), atol=1e-4)


def test_densify_hierarchical_cli(tmp_path, scene):
    """run.sh-equivalent driver end-to-end on a tiny scene (2 levels)."""
    from hcmvs_tpu.pipeline.hierarchy import (Stage, densify_hierarchical)
    scene_path, images_dir = _write_scene(tmp_path, scene)
    cfg = CFG.replace(estimation_iters=1, estimation_iters_external=1,
                      random_iters=2, use_semantic=False,
                      resolution_level=0, min_resolution=0)
    sched = [Stage(level=1, variant="A", cfg=cfg),
             Stage(level=0, variant="B", cfg=cfg),
             Stage(level=0, variant="A", cfg=cfg)]
    out = str(tmp_path / "hc_out")
    stats = densify_hierarchical(scene_path, images_dir, out,
                                 cfg, schedule=sched, verbose=False)
    assert stats["valid_frac"] > 0.3
    assert os.path.exists(os.path.join(out, "depthmap", "depth0000.dmap"))
    assert os.path.exists(os.path.join(out, "scene_dense.ply"))


def test_run_pipeline_sgm_preset(tmp_path):
    """Full images->SfM->SGM dense->mesh->texture pipeline (the MVS_SGM
    preset / --fusion-mode -1 path)."""
    from hcmvs_tpu.pipeline.mvgmvs import run_pipeline
    from hcmvs_tpu.sfm.incremental import SfMConfig
    from hcmvs_tpu.utils.synth import make_ridge_scene
    sc = make_ridge_scene(np.random.default_rng(3), h=144, w=192,
                          n_views=4, fx=180.0, z0=4.0, spacing=0.25)
    K = np.array([[180.0, 0, 96], [0, 180.0, 72], [0, 0, 1.0]])
    out = run_pipeline(
        [im.astype(np.float32) for im in sc.images], K,
        str(tmp_path / "out"),
        sfm_cfg=SfMConfig(max_keypoints=512, min_matches=20,
                          min_pnp_inliers=10, ba_every=2),
        dense_cfg=CFG, fusion_mode=-1, verbose=False)
    # the per-pair LR cross-check (round 3) rejects pixels the reverse
    # match cannot verify — under SfM pose noise that thins the cloud
    # (200+ -> ~150 here) by design, trading density for verification
    # exactly like the reference's in-Match LR invalidation
    assert len(out["cloud"]["points"]) > 120
    assert os.path.exists(str(tmp_path / "out" / "scene_dense.ply"))


@pytest.mark.slow
def test_full_run_smoke(tmp_path, monkeypatch):
    """The full-product harness (eval/full_run — SfM -> 5-stage
    hierarchy -> mesh -> refine -> texture) composes at smoke size.
    Keeps the flagship driver from rotting between device runs."""
    from hcmvs_tpu.eval import full_run
    out = full_run.run(h=120, w=160, n_views=4, cpu=True,
                       refine_scales=1, refine_iters=2,
                       mesh_points=20000, verbose=False)
    assert out["depth_acc_2pct"] > 0.8
    assert out["n_points"] > 5000
    assert out["mesh_fscore"] > 0.3
    assert out["n_faces"] > 1000


def test_sample_mesh_mode(tmp_path):
    """--sample-mesh side mode (ref: DensifyPointCloud.cpp:383-397):
    density > 0 samples ~area*density points, negative value = exact
    total count; points land on the mesh surface."""
    from hcmvs_tpu.io.obj import write_obj
    from hcmvs_tpu.io.ply import read_ply
    from hcmvs_tpu.pipeline.densify import sample_mesh
    verts = np.array([[0, 0, 0], [2, 0, 0], [2, 1, 0], [0, 1, 0]],
                     np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    mesh_path = str(tmp_path / "m.obj")
    write_obj(mesh_path, verts, faces)
    out = str(tmp_path / "sampled.ply")
    n = sample_mesh(mesh_path, out, 100.0, verbose=False)  # area 2.0
    assert n == 200
    pts, extras = read_ply(out)
    assert len(pts) == 200 and "normals" in extras
    assert np.allclose(pts[:, 2], 0.0, atol=1e-6)          # on the plane
    assert pts[:, 0].min() >= 0 and pts[:, 0].max() <= 2.0
    n2 = sample_mesh(mesh_path, out, -57, verbose=False)
    assert n2 == 57 and len(read_ply(out)[0]) == 57


def test_project_labels_mode(scene, tmp_path):
    """--project-labels side mode (ref: DensifyPointCloud.cpp:416-433 +
    EstimatePointLabels DepthMap.cpp:2165-2217): every point takes the
    label color of its CLOSEST view's colored mask."""
    from hcmvs_tpu.io.mvs import read_mvs
    from hcmvs_tpu.io.ply import read_ply
    from hcmvs_tpu.pipeline.densify import project_labels
    scene_path, img_dir = _write_scene(tmp_path, scene)
    # one solid label color per view, given in BGR order
    cols = [(255, 0, 0), (0, 255, 0), (0, 0, 255)]
    h, w = scene.images[0].shape
    for i, c in enumerate(cols):
        lbl = np.zeros((h, w, 3), np.uint8)
        lbl[:] = c
        write_png(os.path.join(img_dir, f"im{i:04d}_l_colored.png"),
                  lbl[..., ::-1])
    stats = project_labels(scene_path, img_dir,
                           str(tmp_path / "scene"), verbose=False)
    assert stats["n_label_images"] == 3
    out = read_mvs(str(tmp_path / "scene_labelled.mvs"))
    assert out.point_colors is not None
    # closest view per point from GT geometry
    sc = read_mvs(scene_path)
    depths = np.stack([
        np.einsum("ij,pj->pi", sc.pose_of(i)[0],
                  sc.points - sc.pose_of(i)[1])[:, 2]
        for i in range(3)])                                # (3, P)
    best = depths.argmin(axis=0)
    # the files hold RGB; load_image returns RGB; point_colors stored
    # BGR -> expected BGR color of the winning view
    exp_bgr = np.array(cols, np.uint8)[:, ::-1][best][:, ::-1]
    assert (out.point_colors == exp_bgr).all(), (
        out.point_colors[:4], exp_bgr[:4])
    pts, extras = read_ply(str(tmp_path / "scene_labelled.ply"))
    assert len(pts) == len(sc.points) and "colors" in extras
