"""End-to-end pipeline driver: images -> SfM -> dense -> mesh -> texture.

The analog of the reference's MvgMvsPipeline.py 16-step orchestration
(ref: frame_main/MvgMvsPipeline.py:180-229 — OpenMVG SfM steps 0-9, then
DensifyPointCloud / ReconstructMesh / RefineMesh / TextureMesh), with the
process-per-step + file handoff replaced by in-memory flow; `.mvs`/.dmap/
PLY/OBJ artifacts are still written at each stage boundary for interop
and resumability (the reference's own checkpoint style, SURVEY §5.4).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

import jax

from hcmvs_tpu.core.config import DenseConfig
from hcmvs_tpu.io.mvs import write_mvs
from hcmvs_tpu.io.ply import write_ply_mesh
from hcmvs_tpu.sfm.incremental import SfMConfig, incremental_sfm, \
    sfm_to_scene


def run_pipeline(images: List[np.ndarray], K: np.ndarray, out_dir: str,
                 sfm_cfg: Optional[SfMConfig] = None,
                 dense_cfg: Optional[DenseConfig] = None,
                 with_mesh: bool = True, with_texture: bool = True,
                 preset: str = "SEQUENTIAL", fusion_mode: int = 0,
                 verbose: bool = True) -> Dict:
    """Run the full reconstruction from grayscale images + intrinsics.

    ``preset``: "SEQUENTIAL" (incremental SfM) or "GLOBAL" (rotation +
    translation averaging) — the reference's MvgMvsPipeline presets
    (ref: MvgMvsPipeline.py:116-122).  ``fusion_mode``: 0 = PatchMatch
    densification; -1/-2 = the SGM stereo path (the MVS_SGM preset,
    MvgMvsPipeline.py:119 / SceneDensify.cpp:3899-3911).
    """
    os.makedirs(out_dir, exist_ok=True)
    dense_cfg = dense_cfg or DenseConfig()
    h, w = images[0].shape[:2]

    # --- SfM (steps 0-9) ---
    if preset.upper() == "GLOBAL":
        from hcmvs_tpu.sfm.global_sfm import global_sfm
        result = global_sfm(images, K, sfm_cfg, verbose=verbose)
    else:
        result = incremental_sfm(images, K, sfm_cfg, verbose=verbose)
    names = [f"im{i:04d}" for i in range(len(images))]
    scene = sfm_to_scene(result, K, names, w, h)
    scene_path = os.path.join(out_dir, "scene.mvs")
    write_mvs(scene_path, scene)

    return _dense_mesh_texture(result, scene, images, K, out_dir,
                               dense_cfg, with_mesh, with_texture,
                               fusion_mode, verbose)


def _dense_mesh_texture(result, scene, images, K, out_dir, dense_cfg,
                        with_mesh, with_texture, fusion_mode, verbose):
    """Steps 10-13 from a finished SfM result (shared by the in-memory
    and the photo-directory entry points)."""
    # --- dense (step 10) ---
    from hcmvs_tpu.dense.fusion import compact_point_cloud, fuse_point_cloud
    from hcmvs_tpu.dense.scene_driver import estimate_scene, finalize
    from hcmvs_tpu.pipeline.densify import build_scene_tensors
    import jax.numpy as jnp
    reg = sorted(result.poses)
    grays = [images[i] for i in reg]
    tensors = build_scene_tensors(scene, grays, dense_cfg)
    if fusion_mode < 0:
        from hcmvs_tpu.dense.sgm import sgm_scene
        depth, normal, conf = sgm_scene(tensors)
    else:
        state = estimate_scene(jax.random.PRNGKey(0), tensors, dense_cfg,
                               verbose=verbose)
        depth, normal, conf = finalize(state, dense_cfg)
    priority = jnp.arange(len(reg), dtype=jnp.float32)
    fused = fuse_point_cloud(depth, normal, conf, tensors.cams,
                             tensors.nbr_idx, tensors.nbr_valid, priority,
                             dense_cfg)
    cloud = compact_point_cloud(fused)
    from hcmvs_tpu.io.ply import write_ply_points
    write_ply_points(os.path.join(out_dir, "scene_dense.ply"),
                     cloud["points"], cloud["normals"])
    out = {"sfm": result, "cloud": cloud, "depth": np.asarray(depth)}

    if with_mesh and len(cloud["points"]) >= 50:
        # --- mesh (steps 11-12) ---
        from hcmvs_tpu.mesh.delaunay import reconstruct_mesh
        from hcmvs_tpu.mesh.mesh_ops import clean_mesh
        keep = np.asarray(fused["keep"])
        owner = np.nonzero(keep.reshape(len(reg), -1))[0]
        centers = np.stack([result.poses[i][1] for i in reg])
        mesh = reconstruct_mesh(cloud["points"], centers, owner)
        mv, mf = clean_mesh(mesh.vertices, mesh.faces,
                            min_component_faces=10)
        write_ply_mesh(os.path.join(out_dir, "scene_mesh.ply"), mv, mf)
        out["mesh"] = (mv, mf)

        if with_texture and len(mf) > 0:
            # --- texture (step 13) ---
            from hcmvs_tpu.mesh.texture import texture_mesh, \
                write_textured_obj
            Ks = np.tile(K[None], (len(reg), 1, 1))
            Rs = np.stack([result.poses[i][0] for i in reg])
            tm = texture_mesh(mv, mf, grays, Ks, Rs, centers)
            write_textured_obj(os.path.join(out_dir,
                                            "scene_textured.obj"), tm)
            out["textured"] = tm
    return out


def run_pipeline_photos(images_dir: str, out_dir: str,
                        K: Optional[np.ndarray] = None,
                        sfm_cfg=None, dense_cfg=None,
                        with_mesh: bool = True, with_texture: bool = True,
                        preset: str = "SEQUENTIAL", fusion_mode: int = 0,
                        estimate_distortion: bool = True,
                        verbose: bool = True) -> Dict:
    """Full reconstruction from a directory of photographs — no K needed.

    The reference's step 0: EXIF focal bootstrap + sensor-width DB (ref:
    MvgMvsPipeline.py:181-183 SfMInit_ImageListing); radial distortion is
    then estimated jointly with the bundle (sfm/distortion.py) and the
    images are undistorted before the MVS stages, exactly as OpenMVG
    undistorts at `.mvs` export (ref: MvgMvsPipeline.py:208-210).
    """
    from hcmvs_tpu.io.exif import scene_intrinsics_from_photos
    from hcmvs_tpu.io.images import list_images, load_image, to_gray
    from hcmvs_tpu.sfm.distortion import (refine_with_distortion,
                                          undistort_image)
    from hcmvs_tpu.sfm.incremental import incremental_sfm, sfm_to_scene

    os.makedirs(out_dir, exist_ok=True)
    paths = list_images(images_dir)
    if len(paths) < 2:
        raise ValueError(f"need >= 2 images in {images_dir}, "
                         f"found {len(paths)}")
    imgs = [load_image(p) for p in paths]
    grays = [to_gray(im).astype(np.float32) if im.ndim == 3 else im
             for im in imgs]
    h, w = grays[0].shape
    if K is None:
        K, src = scene_intrinsics_from_photos(
            paths, [w] * len(paths), [h] * len(paths))
        if verbose:
            print(f"[photos] intrinsics bootstrap ({src}): "
                  f"f = {K[0, 0]:.1f}px")

    # SfM on the raw (possibly distorted) photos
    if preset.upper() == "GLOBAL":
        from hcmvs_tpu.sfm.global_sfm import global_sfm
        result = global_sfm(grays, K, sfm_cfg, verbose=verbose)
    else:
        result = incremental_sfm(grays, K, sfm_cfg, verbose=verbose)

    k = np.zeros(3, np.float32)
    if estimate_distortion:
        result, k = refine_with_distortion(result, K, verbose=verbose)
        if verbose:
            print(f"[photos] radial distortion k = {k}, "
                  f"rms {result.reproj_rms:.3f}px")
        if np.abs(k).max() > 1e-4:
            # undistort the working images so the MVS stages see pinhole
            # cameras (the reference's undistorted-export contract)
            grays = [undistort_image(g, K, k) for g in grays]

    names = [os.path.basename(p) for p in paths]
    scene = sfm_to_scene(result, K, names, w, h)
    write_mvs(os.path.join(out_dir, "scene.mvs"), scene)
    out = _dense_mesh_texture(result, scene, grays, K, out_dir, dense_cfg
                              or DenseConfig(), with_mesh, with_texture,
                              fusion_mode, verbose)
    out["K"] = K
    out["distortion"] = k
    return out


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description="images-directory reconstruction pipeline "
                    "(MvgMvsPipeline.py equivalent: EXIF intrinsics, "
                    "SfM + radial distortion, dense, mesh, texture)")
    ap.add_argument("images_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--preset", default="SEQUENTIAL",
                    choices=["SEQUENTIAL", "GLOBAL"])
    ap.add_argument("--fusion-mode", type=int, default=0)
    ap.add_argument("--focal-px", type=float, default=None,
                    help="override the EXIF focal bootstrap")
    ap.add_argument("--no-distortion", action="store_true",
                    help="skip radial-distortion estimation")
    ap.add_argument("--no-mesh", action="store_true")
    ap.add_argument("--flags", nargs="*", default=[],
                    help="reference-style dense flag=value pairs")
    args = ap.parse_args(argv)
    from hcmvs_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    from hcmvs_tpu.core.config import config_from_cli_flags
    dense_cfg = config_from_cli_flags(
        dict(f.split("=", 1) for f in args.flags))
    K = None
    if args.focal_px is not None:
        from hcmvs_tpu.io.images import list_images, load_image
        im0 = load_image(list_images(args.images_dir)[0])
        h, w = im0.shape[:2]
        K = np.array([[args.focal_px, 0, w / 2.0],
                      [0, args.focal_px, h / 2.0], [0, 0, 1.0]])
    out = run_pipeline_photos(
        args.images_dir, args.out_dir, K=K, dense_cfg=dense_cfg,
        preset=args.preset, fusion_mode=args.fusion_mode,
        with_mesh=not args.no_mesh, with_texture=not args.no_mesh,
        estimate_distortion=not args.no_distortion)
    print({"n_cams": len(out["sfm"].poses),
           "n_points": len(out["cloud"]["points"]),
           "rms_px": out["sfm"].reproj_rms,
           "distortion": list(map(float, out["distortion"]))})


if __name__ == "__main__":
    main()
