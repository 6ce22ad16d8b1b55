"""Dense reconstruction driver: the DensifyPointCloud equivalent.

Loads a `.mvs` scene + images, runs neighbor selection, the multi-view
PatchMatch schedule, fusion, and writes `.dmap` files, the fused cloud and
a dense scene (ref: apps/DensifyPointCloud/DensifyPointCloud.cpp:373-458
main + Scene::DenseReconstruction, SceneDensify.cpp:3532).  CLI flags map
1:1 to the reference's via core.config.CLI_FLAG_MAP.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional

import numpy as np

import jax
import jax.numpy as jnp

from hcmvs_tpu.core.camera import Camera
from hcmvs_tpu.core.config import DenseConfig, config_from_cli_flags
from hcmvs_tpu.dense.fusion import compact_point_cloud, fuse_point_cloud
from hcmvs_tpu.dense.scene_driver import (SceneTensors, estimate_scene,
                                          finalize)
from hcmvs_tpu.dense.view_selection import (depth_range_from_points,
                                            pair_scores, select_neighbors)
from hcmvs_tpu.io.dmap import DepthMapData, write_dmap
from hcmvs_tpu.io.images import compute_resolution_scale, load_image, \
    resize_image, to_gray
from hcmvs_tpu.io.mvs import SceneMVS, read_mvs, write_mvs
from hcmvs_tpu.io.ply import write_ply_points


def find_scene_masks(scene: SceneMVS, images_dir: str,
                     masks_dir: Optional[str] = None
                     ) -> Optional[List[Optional[str]]]:
    """Resolve per-image semantic-mask file paths (or None).

    Order per image (ref: Image::maskName, frame_main/libs/MVS/
    Image.h:75-99 — the reference records the mask path in the scene):
    1. the scene's recorded ``mask_name`` (absolute, or relative to
       ``images_dir``);
    2. ``<masks_dir>/<image-stem>.png`` (any extension) when a masks dir
       is given;
    3. ``<image-stem>.mask.png`` next to the image.
    Returns None when no image has a mask (the SLIC self-prior path).
    """
    exts = (".png", ".pgm", ".tif", ".tiff", ".bmp", ".jpg")
    paths: List[Optional[str]] = []
    for im in scene.images:
        stem = os.path.splitext(os.path.basename(im.name))[0]
        cand: List[str] = []
        if getattr(im, "mask_name", ""):
            m = im.mask_name
            if os.path.isabs(m):
                cand.append(m)
            else:
                # full relative path first (masks recorded as e.g.
                # "masks/im0.png" relative to the scene), basename fallback
                cand.append(os.path.join(images_dir, m))
                cand.append(os.path.join(images_dir, os.path.basename(m)))
        if masks_dir:
            cand += [os.path.join(masks_dir, stem + e) for e in exts]
            cand.append(os.path.join(masks_dir, os.path.basename(im.name)))
        cand.append(os.path.join(images_dir, stem + ".mask.png"))
        paths.append(next((c for c in cand if os.path.exists(c)), None))
    return paths if any(p is not None for p in paths) else None


def load_scene_masks(mask_paths: List[Optional[str]],
                     shape_hw) -> np.ndarray:
    """Load + nearest-resize masks to the working resolution, remapping
    labels to one dense scene-wide id space ((N, H, W) int32; images with
    no mask get a single all-zero region)."""
    from hcmvs_tpu.io.images import load_semantic_mask, resize_mask
    masks = []
    for p in mask_paths:
        if p is None:
            masks.append(np.zeros(shape_hw, np.int32))
        else:
            masks.append(resize_mask(load_semantic_mask(p), shape_hw))
    # shared label space: identical raw ids mean the same class across
    # views (the usual segmentation-export convention), so remap jointly
    stack = np.stack(masks)
    _, inv = np.unique(stack, return_inverse=True)
    return inv.reshape(stack.shape).astype(np.int32)


def load_prior_maps(priors_dir: str, scene: SceneMVS,
                    shape_hw) -> Optional[np.ndarray]:
    """Ingest externally produced prior depth maps (the reference's
    meanshift prior channel — ref: GenerateFinalPrior LoadDepthMap of
    ComposeMeanshiftDepthPriorsPath, SceneDensify.cpp:1088-1100, channel
    DepthMap.h:294-297).

    Per image, looks for ``depth%04d.dmap`` (the stage-handoff naming)
    or ``<image-stem>.dmap`` in ``priors_dir``; maps are resized to the
    working resolution with nearest-neighbor (zero = no-prior holes must
    not bleed into neighboring pixels).  Returns (N, H, W) float32 or
    None when no prior file exists."""
    from hcmvs_tpu.io.dmap import read_dmap
    h, w = shape_hw
    out = np.zeros((len(scene.images), h, w), np.float32)
    found = False
    for i, im in enumerate(scene.images):
        stem = os.path.splitext(os.path.basename(im.name))[0]
        cand = [os.path.join(priors_dir, f"depth{i:04d}.dmap"),
                os.path.join(priors_dir, stem + ".dmap")]
        path = next((c for c in cand if os.path.exists(c)), None)
        if path is None:
            continue
        d = read_dmap(path).depth
        ys = (np.arange(h) * (d.shape[0] / h)).astype(np.int64)
        xs = (np.arange(w) * (d.shape[1] / w)).astype(np.int64)
        out[i] = d[ys[:, None], xs[None, :]]
        found = True
    return out if found else None


def build_scene_tensors(scene: SceneMVS, images_gray: List[np.ndarray],
                        cfg: DenseConfig,
                        flows: Optional[np.ndarray] = None,
                        semantic: Optional[np.ndarray] = None
                        ) -> SceneTensors:
    """Assemble device tensors from a host scene (uniform image sizes)."""
    n = len(scene.images)
    h, w = images_gray[0].shape
    Ks, Rs, Cs = [], [], []
    for i in range(n):
        R, C = scene.pose_of(i)
        Ks.append(scene.intrinsics_of(i, w, h))
        Rs.append(R)
        Cs.append(C)
    cams = Camera(K=jnp.asarray(np.stack(Ks), jnp.float32),
                  R=jnp.asarray(np.stack(Rs), jnp.float32),
                  C=jnp.asarray(np.stack(Cs), jnp.float32))
    centers = np.stack(Cs)
    score = pair_scores(scene.points, scene.point_view_counts,
                        scene.point_view_ids, centers, n,
                        cfg.optim_angle, cfg.min_angle, cfg.max_angle)
    v = min(cfg.geo_max_neighbors, max(n - 1, 1))
    nbr_idx, nbr_valid = select_neighbors(score, v,
                                          cfg.view_min_score_ratio)
    d_ranges = np.stack([
        depth_range_from_points(scene.points, scene.point_view_counts,
                                scene.point_view_ids, Rs[i], Cs[i], i)
        for i in range(n)])
    cams_np = [(Ks[i], Rs[i], Cs[i]) for i in range(n)]
    if cfg.init_triangulate:
        # full Delaunay-interpolated init (ref: InitDepthMap
        # initTriangulate=1 -> TriangulatePoints2DepthMap)
        from hcmvs_tpu.dense.init_tri import scene_triangulated_seeds
        seeds = scene_triangulated_seeds(
            scene.points, scene.point_view_counts, scene.point_view_ids,
            cams_np, n, h, w, add_corners=cfg.add_corners)
    else:
        from hcmvs_tpu.dense.scene_driver import splat_sparse_depths
        seeds = splat_sparse_depths(scene.points, scene.point_view_counts,
                                    scene.point_view_ids, cams_np, n, h, w)
    return SceneTensors(
        gray=jnp.stack([jnp.asarray(g) for g in images_gray]),
        cams=cams, nbr_idx=jnp.asarray(nbr_idx),
        nbr_valid=jnp.asarray(nbr_valid),
        d_min=jnp.asarray(d_ranges[:, 0], jnp.float32),
        d_max=jnp.asarray(d_ranges[:, 1], jnp.float32),
        seed_depth=jnp.asarray(seeds),
        flows=None if flows is None else jnp.asarray(flows),
        semantic=None if semantic is None else jnp.asarray(semantic))


def load_mesh_any(path: str):
    """Load a mesh from .obj or .ply -> (vertices (V,3), faces (F,3))."""
    if path.lower().endswith(".obj"):
        from hcmvs_tpu.io.obj import read_obj
        m = read_obj(path)
        return m.vertices, m.faces
    from hcmvs_tpu.io.ply import read_ply
    verts, extras = read_ply(path)
    faces = extras.get("faces")
    if faces is None:
        raise ValueError(f"{path}: no faces — not a mesh")
    return verts, faces


def sample_mesh(input_path: str, out_path: str, f_sample: float,
                verbose: bool = True) -> int:
    """The --sample-mesh side mode (ref: DensifyPointCloud.cpp:383-397):
    load a mesh and export an area-weighted surface sampling as a point
    cloud.  ``f_sample`` > 0 is a sampling density (points per unit
    area, Mesh::SamplePoints(REAL) Mesh.cpp:3455-3461); < 0 is a total
    point count (Mesh::SamplePoints(unsigned), :3444-3454).  Returns the
    number of points written."""
    from hcmvs_tpu.mesh.mesh_ops import sample_points
    verts, faces = load_mesh_any(input_path)
    a, b, c = (verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]])
    area = float(0.5 * np.linalg.norm(np.cross(b - a, c - a),
                                      axis=1).sum())
    if f_sample > 0:
        n_pts = int(np.ceil(area * f_sample))
    else:
        n_pts = int(round(-f_sample))
    n_pts = max(n_pts, 1)
    pts, nrm = sample_points(verts, faces, n_pts)
    write_ply_points(out_path, pts, nrm)
    if verbose:
        print(f"[densify] sampled mesh ({len(faces)} faces, area "
              f"{area:.3g}) -> {n_pts} points -> {out_path}")
    return n_pts


def find_label_masks(scene: SceneMVS, images_dir: str,
                     masks_dir: Optional[str] = None
                     ) -> List[Optional[str]]:
    """Per-image COLORED label image paths for --project-labels (ref:
    the coloredMaskName convention '<image-stem>_l_colored.png' next to
    the image, DensifyPointCloud.cpp:418-424); ``masks_dir`` overrides
    the location."""
    paths: List[Optional[str]] = []
    for im in scene.images:
        stem = os.path.splitext(os.path.basename(im.name))[0]
        cand = []
        if masks_dir:
            cand += [os.path.join(masks_dir, stem + "_l_colored.png"),
                     os.path.join(masks_dir, stem + ".png")]
        cand.append(os.path.join(images_dir, stem + "_l_colored.png"))
        paths.append(next((c for c in cand if os.path.exists(c)), None))
    return paths


def estimate_point_labels(scene: SceneMVS, label_paths: List[Optional[str]]
                          ) -> np.ndarray:
    """Project every point into its CLOSEST view (min point depth among
    the point's view list) and sample that view's colored label image —
    the EstimatePointLabels analog (ref: frame_main/libs/MVS/
    DepthMap.cpp:2165-2217), vectorized over the whole cloud instead of
    a per-point loop.  Returns (P, 3) uint8 BGR colors (white where the
    view has no label image or the projection falls outside)."""
    pts = scene.points.astype(np.float64)
    counts = scene.point_view_counts.astype(np.int64)
    ids = scene.point_view_ids.astype(np.int64)
    n_img = len(scene.images)
    offs = np.concatenate([[0], np.cumsum(counts)])
    pt_of = np.repeat(np.arange(len(pts)), counts)       # (T,)

    labels = []
    sizes = np.zeros((n_img, 2), np.int64)
    for i, p in enumerate(label_paths):
        if p is None:
            labels.append(None)
            continue
        img = load_image(p)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, -1)
        img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
        labels.append(img)
        sizes[i] = img.shape[:2]

    # per-(point, view) depth; argmin per point picks the closest view
    Rs = np.zeros((n_img, 3, 3))
    Cs = np.zeros((n_img, 3))
    Ks = np.zeros((n_img, 3, 3))
    for i in range(n_img):
        R, C = scene.pose_of(i)
        Rs[i], Cs[i] = R, C
        if labels[i] is not None:
            Ks[i] = scene.intrinsics_of(i, int(sizes[i][1]),
                                        int(sizes[i][0]))
    Xc = np.einsum("tij,tj->ti", Rs[ids], pts[pt_of] - Cs[ids])  # (T, 3)
    depth = np.where(Xc[:, 2] > 0, Xc[:, 2], np.inf)
    has_lbl = np.array([lbl is not None for lbl in labels])[ids]
    depth = np.where(has_lbl, depth, np.inf)
    # segment argmin via lexical sort on (point, depth)
    order = np.lexsort((depth, pt_of))
    first = np.searchsorted(pt_of[order], np.arange(len(pts)))
    best_t = order[np.clip(first, 0, len(order) - 1)]    # (P,) pair index

    colors = np.full((len(pts), 3), 255, np.uint8)
    best_view = ids[best_t]
    best_ok = np.isfinite(depth[best_t]) & (counts > 0)
    for i in range(n_img):
        if labels[i] is None:
            continue
        sel = best_ok & (best_view == i)
        if not sel.any():
            continue
        uvw = np.einsum("ij,pj->pi", Ks[i], Xc[best_t[sel]])
        x = uvw[:, 0] / np.maximum(uvw[:, 2], 1e-12)
        y = uvw[:, 1] / np.maximum(uvw[:, 2], 1e-12)
        h_i, w_i = int(sizes[i][0]), int(sizes[i][1])
        xi = np.clip(np.round(x).astype(np.int64), 0, w_i - 1)
        yi = np.clip(np.round(y).astype(np.int64), 0, h_i - 1)
        inside = (x >= -0.5) & (x < w_i - 0.5) & (y >= -0.5) \
            & (y < h_i - 0.5)
        rgb = labels[i][yi, xi]
        colors[np.nonzero(sel)[0][inside]] = rgb[inside][:, ::-1]  # BGR
    return colors


def project_labels(scene_path: str, images_dir: str, out_base: str,
                   masks_dir: Optional[str] = None,
                   verbose: bool = True) -> dict:
    """The ProjectLabels==1 side mode (ref: DensifyPointCloud.cpp:416-433):
    colorize the scene's point cloud from per-image colored label images
    and save ``<out_base>_labelled.mvs`` + ``.ply``."""
    scene = read_mvs(scene_path)
    label_paths = find_label_masks(scene, images_dir, masks_dir)
    n_found = sum(p is not None for p in label_paths)
    colors = estimate_point_labels(scene, label_paths)
    scene.point_colors = colors
    write_mvs(out_base + "_labelled.mvs", scene)
    write_ply_points(out_base + "_labelled.ply", scene.points,
                     colors=colors[:, ::-1])            # PLY wants RGB
    if verbose:
        print(f"[densify] projected labels from {n_found}/"
              f"{len(scene.images)} label images -> "
              f"{out_base}_labelled.mvs/.ply")
    return {"n_points": len(scene.points), "n_label_images": n_found}


def densify(scene_path: str, images_dir: str, out_dir: str,
            cfg: Optional[DenseConfig] = None,
            init_state_maps=None, verbose: bool = True,
            resume: bool = True,
            filter_point_cloud: Optional[int] = None,
            masks_dir: Optional[str] = None,
            fusion_mode: int = 0,
            priors_dir: Optional[str] = None) -> Dict:
    """Full densification of a `.mvs` scene; returns summary stats.

    ``resume``: when every per-view ``depth%04d.dmap`` already exists in
    the output, estimation is skipped and the maps are loaded — the
    reference's per-image resumability (ref: File::access check in
    DenseReconstructionEstimate, SceneDensify.cpp:3865-3880).
    ``filter_point_cloud``: when set, run the visibility filter on the
    fused cloud with this threshold (the --filter-point-cloud mode).
    ``fusion_mode`` mirrors the reference app's dispatch (ref:
    DensifyPointCloud.cpp:154 + the |mode|==1 early exit at :436-441):
    0 = PatchMatch depth maps + fusion; 1 = PatchMatch depth maps only
    (export .dmap, skip fusion); -1 = SGM stereo maps only; -2 = SGM
    stereo maps + fusion.
    """
    from hcmvs_tpu.utils.profiling import stage_timer
    cfg = cfg or DenseConfig()
    os.makedirs(out_dir, exist_ok=True)
    scene = read_mvs(scene_path)
    n = len(scene.images)

    # load + scale images to the working resolution (color kept for the
    # fused cloud's per-point colors — nEstimateColors)
    grays, colors = [], []
    scale = None
    for i in range(n):
        name = scene.images[i].name
        path = name if os.path.isabs(name) else os.path.join(images_dir,
                                                             os.path.basename(name))
        img = load_image(path)
        if scale is None:
            scale = compute_resolution_scale(img.shape[1], img.shape[0],
                                             cfg.resolution_level,
                                             cfg.max_resolution,
                                             cfg.min_resolution)
        img = resize_image(img, scale)
        if img.ndim == 3:
            colors.append(img)
            # BT.601 luminance, matching the reference's cv2
            # IMREAD_GRAYSCALE conversion
            grays.append(to_gray(img).astype(np.float32))
        else:
            colors.append(np.repeat(img[..., None], 3, -1))
            grays.append(img)
    # scale intrinsics: handled by intrinsics_of via working size
    h, w = grays[0].shape

    flows = None
    if cfg.use_optical_flow:
        from hcmvs_tpu.dense.flow import scene_flows
        centers = np.stack([scene.pose_of(i)[1] for i in range(n)])
        score = pair_scores(scene.points, scene.point_view_counts,
                            scene.point_view_ids, centers, n)
        nbr_idx, _ = select_neighbors(score, 1)
        flows = scene_flows(np.stack(grays), nbr_idx, cfg.flow_backend)

    semantic = None
    if cfg.use_semantic:
        mask_paths = find_scene_masks(scene, images_dir, masks_dir)
        if mask_paths is not None:
            semantic = load_scene_masks(mask_paths, (h, w))
            if verbose:
                n_found = sum(p is not None for p in mask_paths)
                print(f"[densify] semantic masks: {n_found}/{n} images, "
                      f"{int(semantic.max()) + 1} labels")

    tensors = build_scene_tensors(scene, grays, cfg, flows,
                                  semantic=semantic)
    if priors_dir is not None:
        ext = load_prior_maps(priors_dir, scene, (h, w))
        if ext is not None:
            import dataclasses as _dc
            tensors = _dc.replace(tensors,
                                  ext_prior_depth=jnp.asarray(ext))
            if verbose:
                print(f"[densify] external prior maps: "
                      f"{int((ext.reshape(n, -1) > 0).any(1).sum())}/{n} "
                      f"views")
    dmap_dir = os.path.join(out_dir, "depthmap")
    dmap_path = lambda i: os.path.join(dmap_dir, f"depth{i:04d}.dmap")  # noqa: E731
    t0 = time.time()
    if resume and all(os.path.exists(dmap_path(i)) for i in range(n)):
        # per-image resumability: all maps exist, skip estimation
        from hcmvs_tpu.io.dmap import read_dmap
        loaded = [read_dmap(dmap_path(i)) for i in range(n)]
        depth = jnp.stack([jnp.asarray(d.depth) for d in loaded])
        normal = jnp.stack([jnp.asarray(np.moveaxis(d.normal, -1, 0))
                            for d in loaded])
        conf = jnp.stack([jnp.asarray(d.conf) for d in loaded])
    elif fusion_mode < 0:
        # SGM stereo path (ref: SceneDensify.cpp:3899-3911 sgm.Match
        # dispatch when nFusionMode -1/-2)
        from hcmvs_tpu.dense.sgm import sgm_scene
        with stage_timer("densify.sgm", log=verbose):
            depth, normal, conf = sgm_scene(tensors)
    else:
        with stage_timer("densify.estimate", log=verbose):
            state = estimate_scene(jax.random.PRNGKey(0), tensors, cfg,
                                   verbose=verbose)
            depth, normal, conf = finalize(state, cfg)
    wall = time.time() - t0

    # save per-view .dmap artifacts (the stage-handoff format; ref:
    # SceneDensify.cpp:3984-3992 saving depthmap/ and normalmap/)
    os.makedirs(dmap_dir, exist_ok=True)
    depth_np = np.asarray(depth)
    normal_np = np.asarray(normal)
    conf_np = np.asarray(conf)
    if verbose:
        # jet-colored debug artifacts (the reference's verbosity-gated
        # depth%04u.png dumps)
        from hcmvs_tpu.io.images import save_depth_png
        for i in range(n):
            save_depth_png(os.path.join(dmap_dir, f"depth{i:04d}.png"),
                           depth_np[i])
    for i in range(n):
        R, C = scene.pose_of(i)
        write_dmap(dmap_path(i),
                   DepthMapData(
                       depth=depth_np[i],
                       normal=np.moveaxis(normal_np[i], 0, -1),
                       conf=conf_np[i],
                       K=scene.intrinsics_of(i, w, h), R=R, C=C,
                       d_min=float(tensors.d_min[i]),
                       d_max=float(tensors.d_max[i]),
                       image_size=(w, h),
                       image_name=scene.images[i].name,
                       view_ids=[i] + list(np.asarray(tensors.nbr_idx[i]))))

    if abs(fusion_mode) == 1:
        # export-only modes stop after the .dmap artifacts (ref: the
        # ABS(nFusionMode)==1 early exit, DensifyPointCloud.cpp:436-441)
        return {"n_views": n, "wall_s": wall, "views_per_s": n / wall,
                "n_points": 0, "valid_frac": float((depth_np > 0).mean()),
                "depth": depth_np, "normal": normal_np, "conf": conf_np}

    # fuse to a point cloud
    priority = jnp.asarray(np.argsort(np.argsort(
        -np.asarray(tensors.nbr_valid).sum(1))), jnp.float32)
    with stage_timer("densify.fuse", log=verbose):
        fused = fuse_point_cloud(depth, normal, conf, tensors.cams,
                                 tensors.nbr_idx, tensors.nbr_valid,
                                 priority, cfg,
                                 colors=jnp.asarray(np.stack(colors)),
                                 with_colors=cfg.estimate_colors > 0)
        cloud = compact_point_cloud(fused, nbr_idx=tensors.nbr_idx,
                                    confs=conf_np)
    owner0 = cloud["owner_view"]
    if filter_point_cloud is not None and len(cloud["points"]):
        from hcmvs_tpu.dense.point_filter import filter_point_cloud as fpc
        counts = np.ones(len(cloud["points"]), np.int32)
        with stage_timer("densify.point_filter", log=verbose):
            keep = fpc(cloud["points"], counts, owner0.astype(np.uint32),
                       tensors.cams, grays[0].shape,
                       th_remove=filter_point_cloud)
        # ragged per-point view lists filter through their offsets
        offs = np.concatenate([[0], np.cumsum(cloud["view_counts"])])
        ragged_keep = np.zeros(offs[-1], bool)
        for p in np.nonzero(keep)[0]:
            ragged_keep[offs[p]:offs[p + 1]] = True
        cloud["view_ids"] = cloud["view_ids"][ragged_keep]
        cloud["view_confs"] = cloud["view_confs"][ragged_keep]
        cloud = {k: (v[keep] if isinstance(v, np.ndarray)
                     and len(v) == len(keep) else v)
                 for k, v in cloud.items()}
        owner0 = owner0[keep]
    col_u8 = np.clip(cloud["colors"] * 255, 0, 255).astype(np.uint8)
    write_ply_points(os.path.join(out_dir, "scene_dense.ply"),
                     cloud["points"], cloud["normals"], colors=col_u8)

    # dense scene .mvs with FULL per-point view lists: owner view first,
    # then every agreeing neighbor with its sampled confidence (ref:
    # FuseDepthMaps per-point views/weights, SceneDensify.cpp:3265-3495)
    dense_scene = SceneMVS(platforms=scene.platforms, images=scene.images,
                           points=cloud["points"].astype(np.float32),
                           point_view_counts=cloud["view_counts"].astype(
                               np.int32),
                           point_view_ids=cloud["view_ids"].astype(
                               np.uint32),
                           point_view_confs=cloud["view_confs"].astype(
                               np.float32),
                           point_normals=cloud["normals"].astype(
                               np.float32))
    write_mvs(os.path.join(out_dir, "scene_dense.mvs"), dense_scene)

    return {"n_views": n, "wall_s": wall,
            "views_per_s": n / wall,
            "n_points": len(cloud["points"]),
            "valid_frac": float((depth_np > 0).mean()),
            "depth": depth_np, "normal": normal_np, "conf": conf_np}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="DensifyPointCloud equivalent")
    ap.add_argument("--input-file", required=True)
    ap.add_argument("--images-dir", default=None)
    ap.add_argument("-w", "--working-dir", default="mvs_out")
    ap.add_argument("--flags", nargs="*", default=[],
                    help="reference-style flag=value pairs, e.g. "
                         "resolution-level=2 n-EstimationIters=3")
    ap.add_argument("--filter-point-cloud", type=int, default=None,
                    help="visibility-filter threshold (ref: negative "
                         "values, e.g. -1)")
    ap.add_argument("--fusion-mode", type=int, default=0,
                    help="-2 fuse SGM maps, -1 export SGM maps only, "
                         "0 depth-maps & fusion, 1 export depth-maps "
                         "only (ref: DensifyPointCloud.cpp:154)")
    ap.add_argument("--no-resume", action="store_true",
                    help="re-estimate even if depth*.dmap files exist")
    ap.add_argument("--masks-dir", default=None,
                    help="directory of per-image semantic masks "
                         "(<image-stem>.png); with use-semantic=1 they "
                         "feed the RANSAC planar priors (ref: Image "
                         "maskName + GenerateDepthPrior)")
    ap.add_argument("--priors-dir", default=None,
                    help="directory of externally produced prior depth "
                         "maps (depth%%04d.dmap or <image-stem>.dmap) — "
                         "the meanshift prior channel merged per pixel "
                         "with the superpixel prior (ref: "
                         "GenerateFinalPrior, SceneDensify.cpp:1079-1161)")
    ap.add_argument("--export-viewer", action="store_true",
                    help="also write scene_dense.html (offline WebGL "
                         "orbit viewer — the Viewer app equivalent)")
    ap.add_argument("--sample-mesh", type=float, default=0.0,
                    help="side mode (ref: DensifyPointCloud.cpp:383-397):"
                         " sample the input MESH to a point cloud and "
                         "exit; > 0 = points per unit area, < 0 = total "
                         "point count")
    ap.add_argument("--project-labels", action="store_true",
                    help="side mode (ref: DensifyPointCloud.cpp:416-433):"
                         " colorize the scene points from per-image "
                         "'<stem>_l_colored.png' label images (or "
                         "--masks-dir) and save *_labelled.mvs/.ply")
    args = ap.parse_args(argv)
    from hcmvs_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    flags = dict(f.split("=", 1) for f in args.flags)
    cfg = config_from_cli_flags(flags)
    images_dir = args.images_dir or os.path.dirname(args.input_file)
    if args.sample_mesh != 0.0:
        os.makedirs(args.working_dir, exist_ok=True)
        n = sample_mesh(args.input_file,
                        os.path.join(args.working_dir,
                                     "scene_sampled.ply"),
                        args.sample_mesh)
        print({"mode": "sample-mesh", "n_points": n})
        return
    if args.project_labels:
        os.makedirs(args.working_dir, exist_ok=True)
        stats = project_labels(args.input_file, images_dir,
                               os.path.join(args.working_dir, "scene"),
                               masks_dir=args.masks_dir)
        print({"mode": "project-labels", **stats})
        return
    stats = densify(args.input_file, images_dir, args.working_dir, cfg,
                    resume=not args.no_resume,
                    filter_point_cloud=args.filter_point_cloud,
                    masks_dir=args.masks_dir,
                    fusion_mode=args.fusion_mode,
                    priors_dir=args.priors_dir)
    if args.export_viewer:
        from hcmvs_tpu.io.ply import read_ply
        from hcmvs_tpu.io.viewer import export_viewer_html
        ply = os.path.join(args.working_dir, "scene_dense.ply")
        verts, extras = read_ply(ply)
        export_viewer_html(os.path.join(args.working_dir,
                                        "scene_dense.html"),
                           verts, colors=extras.get("colors"))
    print({k: v for k, v in stats.items()
           if k not in ("depth", "normal", "conf")})
    from hcmvs_tpu.utils.profiling import log_report
    log_report()


if __name__ == "__main__":
    main()
