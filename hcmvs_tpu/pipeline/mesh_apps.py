"""CLI drivers for the mesh stages: the ReconstructMesh / RefineMesh /
TextureMesh app equivalents.

(ref: frame_main/apps/ReconstructMesh/ReconstructMesh.cpp:107-127 flags +
:278 Clean pipeline; apps/RefineMesh/RefineMesh.cpp:109-125;
apps/TextureMesh/TextureMesh.cpp:103-114.)  Each reads the dense scene
(`scene_dense.mvs` + images) like the reference apps and writes
PLY / OBJ artifacts.

Usage:
  python -m hcmvs_tpu.pipeline.mesh_apps reconstruct -i scene_dense.mvs ...
  python -m hcmvs_tpu.pipeline.mesh_apps refine -i scene_dense.mvs -m m.ply
  python -m hcmvs_tpu.pipeline.mesh_apps texture -i scene_dense.mvs -m m.ply
"""

from __future__ import annotations

import argparse
import os
from typing import List

import numpy as np

from hcmvs_tpu.io.mvs import SceneMVS, read_mvs
from hcmvs_tpu.io.ply import read_ply, write_ply_mesh
from hcmvs_tpu.utils.profiling import get_logger, log_report, stage_timer


def _scene_cams(scene: SceneMVS, w: int, h: int):
    Ks, Rs, Cs = [], [], []
    for i in range(len(scene.images)):
        R, C = scene.pose_of(i)
        Ks.append(scene.intrinsics_of(i, w, h))
        Rs.append(R)
        Cs.append(C)
    return np.stack(Ks), np.stack(Rs), np.stack(Cs)


def _load_images(scene: SceneMVS, images_dir: str) -> List[np.ndarray]:
    from hcmvs_tpu.io.images import load_image
    out = []
    for im in scene.images:
        path = im.name if os.path.isabs(im.name) else os.path.join(
            images_dir, os.path.basename(im.name))
        out.append(load_image(path, gray=True))
    return out


def cmd_reconstruct(args) -> None:
    """Graph-cut surface from the dense cloud + clean pipeline
    (ref: ReconstructMesh.cpp:278 — reconstruct, remove-spurious,
    close-holes, smooth, optional decimate)."""
    from hcmvs_tpu.mesh.delaunay import reconstruct_mesh
    from hcmvs_tpu.mesh.mesh_ops import clean_mesh
    scene = read_mvs(args.input_file)
    pts = scene.points
    offs = np.concatenate([[0], np.cumsum(scene.point_view_counts)])
    owner = np.zeros(len(pts), np.int64)
    for p in range(len(pts)):
        if offs[p + 1] > offs[p]:
            owner[p] = scene.point_view_ids[offs[p]]
    centers = np.stack([scene.pose_of(i)[1]
                        for i in range(len(scene.images))])
    # full per-point visibility: one ray per (point, supporting view),
    # conf-weighted — the reference accumulates every view's ray
    # (SceneReconstruct.cpp ray votes over PointCloud.pointViews)
    obs_pt = obs_cam = obs_w = None
    if len(scene.point_view_ids) == offs[-1] and offs[-1] > len(pts):
        obs_pt = np.repeat(np.arange(len(pts)),
                           np.asarray(scene.point_view_counts))
        obs_cam = scene.point_view_ids.astype(np.int64)
        if len(scene.point_view_confs) == offs[-1]:
            obs_w = np.maximum(scene.point_view_confs, 0.1)
    with stage_timer("reconstruct.graph_cut", log=True):
        mesh = reconstruct_mesh(pts.astype(np.float64), centers, owner,
                                obs_pt=obs_pt, obs_cam=obs_cam,
                                obs_weight=obs_w)
    with stage_timer("reconstruct.clean", log=True):
        v, f = clean_mesh(mesh.vertices, mesh.faces,
                          decimate=args.decimate,
                          min_component_faces=args.remove_spurious,
                          smooth_iters=args.smooth,
                          max_hole_size=args.close_holes)
    out = args.output_file or os.path.join(
        os.path.dirname(args.input_file), "scene_dense_mesh.ply")
    write_ply_mesh(out, v, f)
    get_logger().info("mesh: %d vertices, %d faces -> %s", len(v), len(f),
                      out)
    log_report()


def cmd_refine(args) -> None:
    """Photometric mesh refinement (ref: RefineMesh.cpp --scales 3
    --scale-step 0.5 --regularity-weight 0.2)."""
    from hcmvs_tpu.mesh.refine import refine_mesh
    scene = read_mvs(args.input_file)
    verts, extra = read_ply(args.mesh_file)
    faces = extra["faces"]
    images = _load_images(scene, args.images_dir
                          or os.path.dirname(args.input_file))
    h, w = images[0].shape
    Ks, Rs, Cs = _scene_cams(scene, w, h)
    n = len(images)
    pairs = np.array([(i, (i + 1) % n) for i in range(n)], np.int32)
    with stage_timer("refine", log=True):
        v2 = refine_mesh(verts, faces, np.stack(images), Ks, Rs, Cs, pairs,
                         scales=args.scales, scale_step=args.scale_step,
                         reg_weight=args.regularity_weight)
    out = args.output_file or args.mesh_file.replace(".ply",
                                                     "_refine.ply")
    write_ply_mesh(out, v2, faces)
    get_logger().info("refined mesh -> %s", out)
    log_report()


def cmd_texture(args) -> None:
    """Texture the mesh (ref: TextureMesh.cpp — labeling, seam leveling,
    atlas packing) and write OBJ + MTL + atlas PNG."""
    from hcmvs_tpu.mesh.texture import texture_mesh, write_textured_obj
    scene = read_mvs(args.input_file)
    verts, extra = read_ply(args.mesh_file)
    faces = extra["faces"]
    images = _load_images(scene, args.images_dir
                          or os.path.dirname(args.input_file))
    h, w = images[0].shape
    Ks, Rs, Cs = _scene_cams(scene, w, h)
    with stage_timer("texture", log=True):
        tm = texture_mesh(verts, faces, images, Ks, Rs, Cs,
                          atlas_size=args.atlas_size,
                          seam_leveling=not args.no_seam_leveling,
                          solver=args.solver)
    out = args.output_file or args.mesh_file.replace(".ply",
                                                     "_texture.obj")
    write_textured_obj(out, tm)
    get_logger().info("textured mesh -> %s", out)
    log_report()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("reconstruct")
    r.add_argument("-i", "--input-file", required=True)
    r.add_argument("-o", "--output-file", default=None)
    r.add_argument("--decimate", type=float, default=1.0)
    r.add_argument("--remove-spurious", type=int, default=20)
    r.add_argument("--close-holes", type=int, default=30)
    r.add_argument("--smooth", type=int, default=2)
    r.set_defaults(fn=cmd_reconstruct)

    f = sub.add_parser("refine")
    f.add_argument("-i", "--input-file", required=True)
    f.add_argument("-m", "--mesh-file", required=True)
    f.add_argument("-o", "--output-file", default=None)
    f.add_argument("--images-dir", default=None)
    f.add_argument("--scales", type=int, default=3)
    f.add_argument("--scale-step", type=float, default=0.5)
    f.add_argument("--regularity-weight", type=float, default=0.2)
    f.set_defaults(fn=cmd_refine)

    t = sub.add_parser("texture")
    t.add_argument("-i", "--input-file", required=True)
    t.add_argument("-m", "--mesh-file", required=True)
    t.add_argument("-o", "--output-file", default=None)
    t.add_argument("--images-dir", default=None)
    t.add_argument("--atlas-size", type=int, default=1024)
    t.add_argument("--no-seam-leveling", action="store_true")
    t.add_argument("--solver", default="lbp",
                   choices=("lbp", "trws", "icm"),
                   help="face-labeling MRF solver (ref: the TRWS/LBP "
                        "dispatch, SceneTexture.cpp:65-88)")
    t.set_defaults(fn=cmd_texture)

    args = ap.parse_args(argv)
    from hcmvs_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
