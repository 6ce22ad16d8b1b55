"""Full-product end-to-end run at the reference workload.

One command running the ACTUAL product chain the reference delivers via
run.sh (ref: /root/reference/run.sh:1-20 + MvgMvsPipeline.py:180-229):
images -> SfM -> 5-stage hierarchical-cross densification -> fusion ->
graph-cut surface -> variational refine -> texture — at 1280x960 on the
default device, with per-stage wall-clock and quality recorded.

    python -m hcmvs_tpu.eval.full_run                     # flagship
    python -m hcmvs_tpu.eval.full_run --h 240 --w 320 --cpu --views 4

Prints one JSON line:
  stage walls  sfm_s, dense_s (+ per-stage breakdown), fuse inside dense,
               mesh_s, refine_s, texture_s, total_s (compilation included)
  quality      depth_acc_2pct (scale-aligned vs GT), cloud_dist,
               mesh_fscore, ate_rmse, n_points, n_faces

Every stage runs in this process on one device; the wall-clocks include
compilation, so steady-state compute is what bench.py isolates.  This
harness proves the chain composes and records whole-pipeline quality at
flagship size.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np


def _render_scene(h, w, n_views, seed, out_dir):
    """Render the golden ridge scene, write PNGs + GT, return scene."""
    from hcmvs_tpu.io.images import write_png
    from hcmvs_tpu.utils.synth import make_ridge_scene
    rng = np.random.default_rng(seed)
    fx = 180.0 * w / 192.0          # FOV-preserving (golden.py contract)
    sc = make_ridge_scene(rng, h=h, w=w, n_views=n_views, spacing=0.25,
                          fx=fx)
    img_dir = os.path.join(out_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    for i in range(n_views):
        write_png(os.path.join(img_dir, f"im{i:04d}.png"),
                  (sc.images[i] * 255).astype(np.uint8))
    return sc, img_dir


def _sfm(img_dir, out_dir, n_views, w, h, fx):
    """SfM on the written images -> scene.mvs; returns pose stats."""
    from hcmvs_tpu.eval.pose_eval import ate
    from hcmvs_tpu.io.images import load_image
    from hcmvs_tpu.io.mvs import write_mvs
    from hcmvs_tpu.sfm.incremental import (SfMConfig, incremental_sfm,
                                           sfm_to_scene)
    imgs = [load_image(os.path.join(img_dir, f"im{i:04d}.png"), gray=True)
            for i in range(n_views)]
    K = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1.0]])
    res = incremental_sfm(imgs, K,
                          SfMConfig(max_keypoints=1024, min_matches=20,
                                    min_pnp_inliers=10, ba_every=2))
    scene = sfm_to_scene(res, K, [f"im{i:04d}.png"
                                  for i in range(n_views)], w, h)
    write_mvs(os.path.join(out_dir, "scene.mvs"), scene)
    gt = np.load(os.path.join(out_dir, "gt_centers.npy"))
    reg = sorted(res.poses)
    est = np.stack([res.poses[i][1] for i in reg])
    return {"registered": len(reg), "rms_px": res.reproj_rms,
            "ate_rmse": ate(est, gt[reg])["rmse"]}


def run(h=960, w=1280, n_views=6, seed=0, cpu=False,
        refine_scales=2, refine_iters=5, mesh_points=60000,
        verbose=True, out_dir=None) -> dict:
    import jax
    if cpu:
        jax.config.update("jax_platforms", "cpu")
    from hcmvs_tpu.core.config import DenseConfig
    from hcmvs_tpu.pipeline.hierarchy import Stage, densify_hierarchical
    from hcmvs_tpu.utils.compile_cache import enable_compile_cache
    from hcmvs_tpu.utils.profiling import report as prof_report
    enable_compile_cache()

    out_dir = out_dir or tempfile.mkdtemp(prefix=f"hcmvs_full_{w}x{h}_")
    os.makedirs(out_dir, exist_ok=True)
    t_total = time.time()
    sc, img_dir = _render_scene(h, w, n_views, seed, out_dir)
    np.save(os.path.join(out_dir, "gt_centers.npy"),
            np.stack([np.asarray(c.C) for c in sc.cameras]))

    # --- SfM ---
    t0 = time.time()
    fx = 180.0 * w / 192.0
    sfm_stats = _sfm(img_dir, out_dir, n_views, w, h, fx)
    sfm_s = time.time() - t0
    if verbose:
        print(f"[full] sfm {sfm_s:.0f}s {sfm_stats}", flush=True)

    # --- 5-stage hierarchical-cross dense (the run.sh schedule) ---
    # levels (2,1,1,0,0): the two finest stages run at FULL resolution —
    # the reference's resize3->resize1 ladder relative to the working
    # size (run.sh:1-20)
    base = DenseConfig(
        adapt_half_window=5, patch_half_window=3, patch_step=2,
        estimation_iters=2, estimation_iters_external=2, photo2geo=1,
        random_iters=3, use_optical_flow=0, use_geo_consistency=1,
        use_part_consistency=0, optimize=1, resolution_level=0,
        min_resolution=0, use_semantic=False, geo_max_neighbors=3)
    a = base.replace(init_triangulate=0)
    b = base.replace(init_triangulate=1, use_geo_consistency=0,
                     photo2geo=99)
    sched = [Stage(level=2, variant="A", cfg=a),
             Stage(level=1, variant="B", cfg=b),
             Stage(level=1, variant="A", cfg=a),
             Stage(level=0, variant="B", cfg=b),
             Stage(level=0, variant="A", cfg=a)]
    t0 = time.time()
    dstats = densify_hierarchical(os.path.join(out_dir, "scene.mvs"),
                                  img_dir, os.path.join(out_dir, "mvs"),
                                  base, schedule=sched, resume=True,
                                  verbose=verbose)
    dense_s = time.time() - t0
    stage_walls = {k: round(v["total_s"], 1)
                   for k, v in prof_report().items()}
    if verbose:
        print(f"[full] dense {dense_s:.0f}s n_points={dstats['n_points']}"
              f" stages={stage_walls}", flush=True)

    # quality: depth acc after median-scale alignment (SfM gauge)
    d0 = dstats["depth"][0]
    gt = sc.depth_gt
    valid = (d0 > 0) & (gt > 0)
    scale = float(np.median(gt[valid] / d0[valid]))
    rel = np.abs(d0 * scale - gt) / gt
    depth_acc = float(((rel < 0.02) & valid).sum() / max(valid.sum(), 1))

    # the SfM gauge is an arbitrary sim3 (the init pair's first camera is
    # the origin — NOT image 0 in general): the mesh stages run in the
    # SfM frame, and metrics align into the GT frame.  Camera centers
    # alone are nearly COLLINEAR on this rig (umeyama leaves the roll
    # about the baseline free — measured 0.19 cloud offset from exactly
    # that), so the sim3 comes from dense 3D correspondences: pixel p of
    # view 0 backprojected at the SfM depth vs at the GT depth.
    from hcmvs_tpu.eval.pose_eval import umeyama_align
    from hcmvs_tpu.io.mvs import read_mvs
    scn = read_mvs(os.path.join(out_dir, "scene.mvs"))
    est_centers = np.stack([scn.pose_of(i)[1]
                            for i in range(len(scn.images))])
    R0, C0 = scn.pose_of(0)
    K0 = scn.intrinsics_of(0, w, h)
    vv0, uu0 = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    sel0 = valid & (np.random.default_rng(5).random((h, w)) < 0.01)
    rays0 = np.linalg.inv(K0) @ np.stack(
        [uu0[sel0], vv0[sel0], np.ones(sel0.sum())])
    X_sfm = (R0.T @ (rays0 * d0[sel0])).T + C0
    Kg = np.asarray(sc.cameras[0].K)
    Rg, Cg = np.asarray(sc.cameras[0].R), np.asarray(sc.cameras[0].C)
    raysg = np.linalg.inv(Kg) @ np.stack(
        [uu0[sel0], vv0[sel0], np.ones(sel0.sum())])
    X_gt = (Rg.T @ (raysg * gt[sel0])).T + Cg
    s_al, R_al, t_al = umeyama_align(X_sfm, X_gt)
    to_gt = lambda p: (s_al * (R_al @ np.asarray(p, np.float64).T)).T + t_al  # noqa: E731
    align_res = float(np.median(np.linalg.norm(
        to_gt(X_sfm) - X_gt, axis=1)))
    if verbose:
        print(f"[full] sim3 alignment: scale {s_al:.4f}, median residual "
              f"{align_res:.4f}", flush=True)

    cloud = dstats["cloud"]
    cloud_dist = float(np.median(sc.surface_dist(to_gt(cloud["points"])))) \
        if len(cloud["points"]) else float("inf")

    # --- graph-cut surface (ReconstructMesh) ---
    from hcmvs_tpu.mesh.delaunay import reconstruct_mesh
    from hcmvs_tpu.mesh.mesh_ops import clean_mesh, sample_points
    t0 = time.time()
    sub = np.random.default_rng(1).permutation(
        len(cloud["points"]))[:mesh_points]
    pts = cloud["points"][sub].astype(np.float64)
    offs = np.concatenate([[0], np.cumsum(cloud["view_counts"])])
    obs_pt, obs_cam, obs_w = [], [], []
    for ci, p in enumerate(sub):
        for k in range(offs[p], offs[p + 1]):
            obs_pt.append(ci)
            obs_cam.append(cloud["view_ids"][k])
            obs_w.append(max(cloud["view_confs"][k], 0.1))
    # mesh runs in the SfM frame with the SfM camera centers (the frame
    # the cloud lives in); GT metrics go through to_gt
    centers = est_centers
    mesh = reconstruct_mesh(pts, centers, cloud["owner_view"][sub],
                            obs_pt=np.asarray(obs_pt),
                            obs_cam=np.asarray(obs_cam),
                            obs_weight=np.asarray(obs_w))
    mv, mf = clean_mesh(mesh.vertices, mesh.faces, min_component_faces=20)
    mesh_s = time.time() - t0
    if verbose:
        print(f"[full] mesh {mesh_s:.0f}s v={len(mv)} f={len(mf)}",
              flush=True)

    # mesh F-score vs GT surface samples at a STATED physical tolerance:
    # 1% of the median scene depth (the ETH3D-style convention of
    # quoting F at a tolerance; a spacing-derived threshold would shrink
    # with cloud density and punish denser reconstructions)
    from hcmvs_tpu.eval.compare import point_cloud_fscore
    from hcmvs_tpu.io.ply import write_ply_mesh
    samples, _ = sample_points(mv, mf, 12000)
    vv, uu = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    sel = np.random.default_rng(2).permutation(h * w)[:12000]
    Kg0 = np.asarray(sc.cameras[0].K)
    rays = np.linalg.inv(Kg0) @ np.stack(
        [uu.ravel()[sel], vv.ravel()[sel], np.ones(len(sel))])
    gt_pts = (rays * sc.depth_gt.ravel()[sel]).T
    tol = 0.01 * float(np.median(sc.depth_gt[sc.depth_gt > 0]))
    fs = point_cloud_fscore(to_gt(samples), gt_pts, tol)
    write_ply_mesh(os.path.join(out_dir, "scene_mesh.ply"), mv, mf)

    # --- variational refine (RefineMesh; runs at half resolution like
    # the reference's --resolution-level on the refine app) ---
    from hcmvs_tpu.io.images import resize_image
    t0 = time.time()
    imgs_half = np.stack([resize_image(im.astype(np.float32), 0.5)
                          for im in sc.images])
    Ks_half = np.stack([np.diag([0.5, 0.5, 1.0]) @ np.asarray(c.K)
                        for c in sc.cameras])
    for i in range(len(Ks_half)):
        Ks_half[i][0, 2] -= 0.25
        Ks_half[i][1, 2] -= 0.25
    # SfM-frame rotations, consistent with the mesh/cloud frame
    Rs = np.stack([scn.pose_of(i)[0] for i in range(len(scn.images))])
    pairs = np.asarray([(i, j) for i in range(n_views)
                        for j in range(n_views)
                        if i != j and abs(i - j) <= 2])
    from hcmvs_tpu.mesh.refine import refine_mesh
    mv_r = refine_mesh(mv, mf, imgs_half, Ks_half, Rs, centers, pairs,
                       scales=refine_scales,
                       iters_per_scale=refine_iters)
    refine_s = time.time() - t0
    samples_r, _ = sample_points(mv_r, mf, 12000)
    fs_r = point_cloud_fscore(to_gt(samples_r), gt_pts, tol)
    write_ply_mesh(os.path.join(out_dir, "scene_mesh_refined.ply"),
                   mv_r, mf)
    if verbose:
        print(f"[full] refine {refine_s:.0f}s fscore "
              f"{fs['fscore']:.3f} -> {fs_r['fscore']:.3f}", flush=True)

    # --- texture (TextureMesh) ---
    t0 = time.time()
    from hcmvs_tpu.mesh.texture import texture_mesh, write_textured_obj
    Ks_full = np.stack([np.asarray(c.K) for c in sc.cameras])
    tm = texture_mesh(mv_r, mf, [im.astype(np.float32)
                                 for im in sc.images], Ks_full, Rs,
                      centers)
    write_textured_obj(os.path.join(out_dir, "scene_textured.obj"), tm)
    texture_s = time.time() - t0

    out = {
        "w": w, "h": h, "views": n_views,
        "sfm_s": round(sfm_s, 1), "dense_s": round(dense_s, 1),
        "mesh_s": round(mesh_s, 1), "refine_s": round(refine_s, 1),
        "texture_s": round(texture_s, 1),
        "total_s": round(time.time() - t_total, 1),
        "stage_walls": stage_walls,
        "ate_rmse": round(sfm_stats["ate_rmse"], 5),
        "depth_acc_2pct": round(depth_acc, 3),
        "valid_frac": round(float(valid.mean()), 3),
        "cloud_dist": round(cloud_dist, 5),
        "mesh_fscore": round(fs["fscore"], 3),
        "mesh_fscore_refined": round(fs_r["fscore"], 3),
        "fscore_tolerance": round(tol, 4),
        "align_residual": round(align_res, 4),
        "n_points": int(dstats["n_points"]), "n_faces": int(len(mf)),
    }
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--h", type=int, default=960)
    ap.add_argument("--w", type=int, default=1280)
    ap.add_argument("--views", type=int, default=6)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args()
    print(json.dumps(run(h=args.h, w=args.w, n_views=args.views,
                         cpu=args.cpu, seed=args.seed,
                         verbose=not args.quiet)), flush=True)


if __name__ == "__main__":
    main()
