"""Golden end-to-end quality gate.

One command running the FULL pipeline (SfM from images -> dense ->
surface) on a synthetic ridge scene with known ground truth, printing one
JSON line of quality metrics — the formalization of the reference's
golden-run style (SURVEY §4: the run.py configs were its only "tests").

    python -m hcmvs_tpu.eval.golden            # CPU by default

Metrics:
  ate_rmse        trajectory error of the SfM poses (similarity-aligned)
  sfm_rms_px      frozen-pose reprojection RMS (pose quality)
  depth_acc_2pct  fraction of valid dense-depth pixels within 2% of GT
  cloud_dist      median distance of fused points to the GT surface
"""

from __future__ import annotations

import json

import numpy as np



def _env_cfg(cfg):
    """A/B hook: HCMVS_GOLDEN_CFG = JSON dict of DenseConfig overrides
    (mirrors bench.py's HCMVS_BENCH_CFG; not set in production runs)."""
    import json as _json
    import os as _os
    ov = _os.environ.get("HCMVS_GOLDEN_CFG")
    return cfg.replace(**_json.loads(ov)) if ov else cfg


def run(h: int = 144, w: int = 192, n_views: int = 5, seed: int = 0,
        verbose: bool = False, fx: float = None) -> dict:
    import jax
    import jax.numpy as jnp
    from hcmvs_tpu.core.camera import Camera
    from hcmvs_tpu.core.config import DenseConfig
    from hcmvs_tpu.dense.fusion import compact_point_cloud, fuse_point_cloud
    from hcmvs_tpu.dense.scene_driver import (SceneTensors, estimate_scene,
                                              finalize)
    from hcmvs_tpu.eval.pose_eval import ate, structure_from_known_poses
    from hcmvs_tpu.sfm.incremental import SfMConfig, incremental_sfm
    from hcmvs_tpu.utils.synth import make_ridge_scene

    rng = np.random.default_rng(seed)
    # FOV-preserving focal scaling: quality-vs-resolution measurements
    # must hold the camera geometry fixed.  The r2 ladder kept fx=180 at
    # every size, so "640x480" was a 121-degree ultra-wide camera with
    # grazing borders — measured root cause of the apparent 0.97 -> 0.77
    # accuracy "cliff": at fx scaled (56-degree FOV held), 640x480 scores
    # 0.908; at fx=180 every exact backend (volume/bilinear) agrees at
    # ~0.772, i.e. the degradation is the scene geometry, not resolution
    # or the sigma-table engine (BASELINE.md round 3).  Pass fx=180
    # explicitly to reproduce the wide-FOV stress case.
    if fx is None:
        fx = 180.0 * w / 192.0
    sc = make_ridge_scene(rng, h=h, w=w, n_views=n_views,
                          spacing=0.25, fx=fx)
    K = np.asarray(sc.cameras[0].K)

    # --- SfM from pixels ---
    result = incremental_sfm(
        [im.astype(np.float32) for im in sc.images], K,
        SfMConfig(max_keypoints=512, min_matches=20, min_pnp_inliers=10,
                  ba_every=2), verbose=verbose)
    gt_C = np.stack([c.C for c in sc.cameras])
    reg = sorted(result.poses)
    est_C = np.stack([result.poses[i][1] for i in reg])
    # SfM scale is arbitrary: metrics after similarity alignment
    pose_stats = ate(est_C, gt_C[reg])
    sfm_rms = structure_from_known_poses(result, K)

    # --- dense with the GT poses (isolates dense quality from SfM) ---
    cams = Camera(K=jnp.stack([c.K for c in sc.cameras]),
                  R=jnp.stack([c.R for c in sc.cameras]),
                  C=jnp.stack([c.C for c in sc.cameras]))
    v = min(3, n_views - 1)
    nbr = np.array([[j for j in range(n_views) if j != i][:v]
                    for i in range(n_views)], np.int32)
    zs = sc.depth_gt[sc.depth_gt > 0]
    scene = SceneTensors(
        gray=jnp.stack([jnp.asarray(im) for im in sc.images]),
        cams=cams, nbr_idx=jnp.asarray(nbr),
        nbr_valid=jnp.ones((n_views, v), bool),
        d_min=jnp.full((n_views,), float(zs.min()) * 0.7, jnp.float32),
        d_max=jnp.full((n_views,), float(zs.max()) * 1.4, jnp.float32))
    cfg = DenseConfig(adapt_half_window=5, patch_half_window=3,
                      patch_step=2, estimation_iters=2,
                      estimation_iters_external=3, photo2geo=1,
                      random_iters=3, use_optical_flow=0,
                      use_geo_consistency=1, use_part_consistency=0,
                      optimize=0)
    cfg = _env_cfg(cfg)
    state = estimate_scene(jax.random.PRNGKey(0), scene, cfg,
                           verbose=verbose)
    depth, normal, conf = finalize(state, cfg)
    d0 = np.asarray(depth[0])
    valid = (d0 > 0) & (sc.depth_gt > 0)
    rel = np.abs(d0 - sc.depth_gt) / np.maximum(sc.depth_gt, 1e-9)
    depth_acc = float(((rel < 0.02) & valid).sum() / max(valid.sum(), 1))

    fused = fuse_point_cloud(depth, normal,
                             jnp.maximum(1.0 - state.cost, 0.01),
                             scene.cams, scene.nbr_idx, scene.nbr_valid,
                             jnp.arange(n_views, dtype=jnp.float32), cfg)
    cloud = compact_point_cloud(fused, nbr_idx=np.asarray(scene.nbr_idx),
                                confs=np.asarray(conf))
    dist = (float(np.median(sc.surface_dist(cloud["points"])))
            if len(cloud["points"]) else float("inf"))

    # surface F-score gate: graph-cut mesh from the fused MULTI-VIEW
    # cloud (full per-point observation lists), sampled against GT
    # surface samples (ref: the ETH3D/T&T-style metric of SURVEY §6)
    mesh_fscore = 0.0
    if len(cloud["points"]) > 100:
        from hcmvs_tpu.eval.compare import point_cloud_fscore
        from hcmvs_tpu.mesh.delaunay import reconstruct_mesh
        from hcmvs_tpu.mesh.mesh_ops import sample_points
        sub = np.random.default_rng(1).permutation(
            len(cloud["points"]))[:4000]
        pts = cloud["points"][sub].astype(np.float64)
        offs = np.concatenate([[0], np.cumsum(cloud["view_counts"])])
        obs_pt, obs_cam, obs_w = [], [], []
        for ci, p in enumerate(sub):
            for k in range(offs[p], offs[p + 1]):
                obs_pt.append(ci)
                obs_cam.append(cloud["view_ids"][k])
                obs_w.append(max(cloud["view_confs"][k], 0.1))
        centers = np.stack([np.asarray(c.C) for c in sc.cameras])
        try:
            mesh = reconstruct_mesh(pts, centers,
                                    cloud["owner_view"][sub],
                                    obs_pt=np.asarray(obs_pt),
                                    obs_cam=np.asarray(obs_cam),
                                    obs_weight=np.asarray(obs_w))
            samples, _ = sample_points(mesh.vertices, mesh.faces, 8000)
            # GT surface samples: backproject the ref view's GT depth
            K0 = np.asarray(sc.cameras[0].K)
            hh, ww = sc.depth_gt.shape
            vv, uu = np.meshgrid(np.arange(hh), np.arange(ww),
                                 indexing="ij")
            sel = np.random.default_rng(2).permutation(hh * ww)[:8000]
            rays = np.linalg.inv(K0) @ np.stack(
                [uu.ravel()[sel], vv.ravel()[sel], np.ones(len(sel))])
            gt_pts = (rays * sc.depth_gt.ravel()[sel]).T
            # threshold at 2x the SUBSAMPLED cloud's point spacing — the
            # finest surface the reconstruction could represent (the
            # ETH3D-style metric is always quoted at a stated tolerance)
            from scipy.spatial import cKDTree
            h_sub = float(np.median(
                cKDTree(pts).query(pts, k=2)[0][:, 1]))
            mesh_fscore = point_cloud_fscore(
                samples, gt_pts, 2.0 * h_sub)["fscore"]
        except Exception:
            mesh_fscore = -1.0

    return {"ate_rmse": round(pose_stats["rmse"], 5),
            "sfm_rms_px": round(sfm_rms, 3),
            "depth_acc_2pct": round(depth_acc, 3),
            "cloud_dist": round(dist, 5),
            "mesh_fscore": round(mesh_fscore, 3),
            "n_points": len(cloud["points"]),
            "registered": len(reg), "views": n_views}


def run_hierarchy(h: int = 144, w: int = 192, n_views: int = 5,
                  seed: int = 0, fx: float = None,
                  full_stack: bool = False, sweep_mult: int = 1,
                  ablate: str = "") -> dict:
    """Full product path: SfM poses (not GT) -> scene.mvs -> 3-stage
    hierarchical-cross densification; depth accuracy after median-scale
    alignment (SfM scale is arbitrary).  Measured 0.970 on the ridge
    scene — above the single-level gate (0.919), as the cross-fed
    hierarchy is designed to deliver."""
    import os
    import tempfile
    from hcmvs_tpu.core.config import DenseConfig
    from hcmvs_tpu.io.images import write_png
    from hcmvs_tpu.io.mvs import write_mvs
    from hcmvs_tpu.pipeline.hierarchy import Stage, densify_hierarchical
    from hcmvs_tpu.sfm.incremental import (SfMConfig, incremental_sfm,
                                           sfm_to_scene)
    from hcmvs_tpu.utils.synth import make_ridge_scene
    rng = np.random.default_rng(seed)
    if fx is None:      # FOV-preserving (see run() — cliff root cause)
        fx = 180.0 * w / 192.0
    sc = make_ridge_scene(rng, h=h, w=w, n_views=n_views, spacing=0.25,
                          fx=fx)
    K = np.asarray(sc.cameras[0].K)
    sfm_cfg = SfMConfig(max_keypoints=512, min_matches=20,
                        min_pnp_inliers=10, ba_every=2)
    sfm_ov = os.environ.get("HCMVS_GOLDEN_SFM")   # A/B hook (like
    if sfm_ov:                                    # HCMVS_GOLDEN_CFG)
        import dataclasses as _dc
        sfm_cfg = _dc.replace(sfm_cfg, **json.loads(sfm_ov))
    res = incremental_sfm(
        [im.astype(np.float32) for im in sc.images], K, sfm_cfg)
    tmp = tempfile.mkdtemp()
    img_dir = os.path.join(tmp, "images")
    os.makedirs(img_dir)
    for i in range(n_views):
        write_png(os.path.join(img_dir, f"im{i:04d}.png"),
                  (sc.images[i] * 255).astype(np.uint8))
    scene = sfm_to_scene(res, K, [f"im{i:04d}.png"
                                  for i in range(n_views)], w, h)
    scene_path = os.path.join(tmp, "scene.mvs")
    write_mvs(scene_path, scene)
    cfg = DenseConfig(
        adapt_half_window=5, patch_half_window=3, patch_step=2,
        estimation_iters=2 * sweep_mult,
        estimation_iters_external=2, photo2geo=1,
        random_iters=3, use_optical_flow=0, use_geo_consistency=1,
        use_part_consistency=0, optimize=0, resolution_level=0,
        min_resolution=0, use_semantic=False)
    cfg = _env_cfg(cfg)
    if full_stack:
        # the FULL HC machinery (verdict r4 #5 — wide-FOV saturation
        # experiment): priors + view-spread + mid-pipeline filter +
        # external-iteration budget, on the 5-stage run.sh schedule.
        # ``ablate``: comma list of components to turn back off
        # (priors, viewspread, optimize, part) for attribution.
        off = set(ablate.split(",")) if ablate else set()
        cfg = cfg.replace(
            use_semantic="priors" not in off,
            view_spread=0 if "viewspread" in off else 1,
            optimize=0 if "optimize" in off else 1,
            estimation_iters_external=3,
            use_part_consistency=0 if "part" in off else 1)
    a = cfg.replace(init_triangulate=0)
    b = cfg.replace(init_triangulate=1, use_geo_consistency=0,
                    photo2geo=99)
    if full_stack:
        sched = [Stage(level=2, variant="A", cfg=a),
                 Stage(level=1, variant="B", cfg=b),
                 Stage(level=1, variant="A", cfg=a),
                 Stage(level=0, variant="B", cfg=b),
                 Stage(level=0, variant="A", cfg=a)]
    else:
        sched = [Stage(level=1, variant="A", cfg=a),
                 Stage(level=0, variant="B", cfg=b),
                 Stage(level=0, variant="A", cfg=a)]
    stats = densify_hierarchical(scene_path, img_dir,
                                 os.path.join(tmp, "out"), cfg,
                                 schedule=sched, verbose=False)
    d0 = stats["depth"][0]
    gt = sc.depth_gt
    valid = (d0 > 0) & (gt > 0)
    scale = np.median(gt[valid] / d0[valid])
    rel = np.abs(d0 * scale - gt) / gt
    acc = float(((rel < 0.02) & valid).sum() / max(valid.sum(), 1))
    return {"hier_depth_acc_2pct": round(acc, 3),
            "valid_frac": round(float(valid.mean()), 3),
            "n_points": stats["n_points"]}


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--hierarchy", action="store_true")
    ap.add_argument("--full-stack", action="store_true",
                    help="5-stage schedule + priors + view-spread + "
                         "filter (the wide-FOV saturation experiment)")
    ap.add_argument("--h", type=int, default=144)
    ap.add_argument("--w", type=int, default=192)
    ap.add_argument("--views", type=int, default=5)
    ap.add_argument("--fx", type=float, default=None)
    ap.add_argument("--sweep-mult", type=int, default=1)
    ap.add_argument("--ablate", default="",
                    help="full-stack components to disable "
                         "(priors,viewspread,optimize,part)")
    args = ap.parse_args()
    from hcmvs_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    if args.hierarchy or args.full_stack:
        print(json.dumps(run_hierarchy(
            h=args.h, w=args.w, n_views=args.views, fx=args.fx,
            full_stack=args.full_stack, sweep_mult=args.sweep_mult,
            ablate=args.ablate)))
    else:
        print(json.dumps(run(h=args.h, w=args.w, n_views=args.views,
                             fx=args.fx)))


if __name__ == "__main__":
    main()
