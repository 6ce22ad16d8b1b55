"""The hierarchical-cross schedule: multi-level alternating-variant dense
reconstruction.

Replaces the reference's run.sh orchestration (ref: /root/reference/run.sh
— frame_main@resize3 -> restore@resize2 -> frame_main@resize2 ->
restore@resize1 -> frame_main@resize1, with `mv depthmap normalmap`
between stages) and the per-stage flag sets (data/*/resize*/run.py).

Re-design: the five separate OS processes + filesystem handoff become one
driver where each stage's output maps stay on device and are
upsampled into the next stage's initialization (variant A, "read-init";
ref: frame_main InitDepthMap SceneDensify.cpp:522-558) or attached as
cross-scale priors (variant B, "triangulate-init + cross-scale prior";
ref: restore/libs/MVS/SceneDensify.cpp:500-533 and the cross-scale
hypothesis injection restore/DepthMap.cpp:1527-1549 — here the previous
level's maps enter through the prior term, the functionally equivalent
channel).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from hcmvs_tpu.core.config import DenseConfig
from hcmvs_tpu.dense.scene_driver import (SceneState, SceneTensors,
                                          finalize, init_scene_state,
                                          scene_sweeps)


@dataclasses.dataclass(frozen=True)
class Stage:
    """One hierarchical-cross stage (one run.py invocation analog)."""

    level: int           # resolution level (3 = coarsest)
    variant: str         # "A" (frame_main) | "B" (restore)
    cfg: DenseConfig


def default_schedule(base: DenseConfig,
                     finest_level: int = 1) -> List[Stage]:
    """The 5-stage schedule of run.sh with each stage's flag profile
    (ref: data/frame_main/resize{3,2,1}/run.py, data/restore/resize{2,1}/
    run.py — frame_main stages run geometric consistency with read-init,
    restore stages triangulate-init without geo).

    The two finest stages run at ``finest_level`` and the ladder climbs
    two levels above it: levels 3/2/2/1/1 by default, 2/1/1/0/0 with
    ``finest_level=0`` (full-resolution final stages)."""
    a = base.replace(init_triangulate=0, use_geo_consistency=1,
                     photo2geo=1)
    b = base.replace(init_triangulate=1, use_geo_consistency=0,
                     photo2geo=99, use_semantic=True)
    top = finest_level
    return [
        Stage(level=top + 2, variant="A", cfg=a),
        Stage(level=top + 1, variant="B", cfg=b),
        Stage(level=top + 1, variant="A", cfg=a),
        Stage(level=top, variant="B", cfg=b),
        Stage(level=top, variant="A",
              cfg=a.replace(use_semantic=True)),
    ]


def _resize_maps(depth: jax.Array, normal: jax.Array,
                 h: int, w: int) -> Tuple[jax.Array, jax.Array]:
    """Upsample (N, H0, W0) depth + (N, 3, H0, W0) normals to (h, w)."""
    n = depth.shape[0]
    d = jax.image.resize(depth, (n, h, w), method="bilinear")
    nm = jax.image.resize(normal, (n, 3, h, w), method="bilinear")
    nm = nm / jnp.maximum(jnp.linalg.norm(nm, axis=1, keepdims=True),
                          1e-9)
    return d, nm


def run_hierarchy(tensors_per_level: Dict[int, SceneTensors],
                  base_cfg: DenseConfig,
                  schedule: Optional[List[Stage]] = None,
                  key: Optional[jax.Array] = None,
                  checkpoint_dir: Optional[str] = None,
                  resume: bool = True,
                  verbose: bool = False) -> SceneState:
    """Run the alternating multi-level schedule.

    ``tensors_per_level`` maps resolution level -> SceneTensors at that
    level's image size (build once per level with
    pipeline.densify.build_scene_tensors on resized images).

    ``checkpoint_dir``: when set, each stage's output state (depth,
    normal, cost, keys) is saved as ``stage<k>.npz`` there, and
    ``resume`` restarts from the last completed stage.  This replaces
    run.sh's `mv depthmap normalmap` handoff (ref:
    /root/reference/run.sh:1-20) — same per-stage resumability, with the
    full solver state instead of loose .dmap files (which
    pipeline.densify still writes for interop).
    """
    key = key if key is not None else jax.random.PRNGKey(0)
    schedule = schedule or default_schedule(base_cfg)
    state = None
    prev_maps = None     # (depth, normal) from the previous stage
    start_stage = 0
    if checkpoint_dir is not None:
        os.makedirs(checkpoint_dir, exist_ok=True)
        latest = _latest_stage(checkpoint_dir) if resume else None
        if latest is not None and latest < len(schedule):
            state = load_stage_state(_stage_path(checkpoint_dir, latest))
            prev_maps = (state.depth, state.normal)
            start_stage = latest + 1
            if verbose:
                print(f"[hierarchy] resumed after stage {latest}")
    for si, stage in enumerate(schedule):
        if si < start_stage:
            continue
        tensors = tensors_per_level[stage.level]
        n, h, w = tensors.gray.shape
        cfg = stage.cfg
        # per-stage key derived from the stage index (not a running
        # split) so a resumed run reproduces the uninterrupted one
        sub = jax.random.fold_in(key, si)
        if prev_maps is not None:
            d_up, n_up = _resize_maps(prev_maps[0], prev_maps[1], h, w)
            if stage.variant == "A":
                # read-init: previous maps ARE the starting hypotheses
                st0 = init_scene_state(sub, tensors)
                state = SceneState(
                    depth=jnp.where(d_up > 0, d_up, st0.depth),
                    normal=jnp.where((d_up > 0)[:, None], n_up, st0.normal),
                    cost=st0.cost, keys=st0.keys)
                state = _run_stage(state, tensors, cfg, verbose)
            else:
                # variant B (restore): keep triangulate/seed init; the
                # upsampled previous-level maps enter through BOTH channels
                # the reference uses — the soft prior term (resize_ maps,
                # restore/SceneDensify.cpp:500-533) and the scored
                # hypothesis injection at the final iteration with a 0.1
                # bonus (nresize_ maps, restore/DepthMap.cpp:1527-1549) —
                # each gated by its config knob.
                updates = {}
                if cfg.cross_scale_prior:
                    updates["prior_depth"] = d_up
                if cfg.cross_scale_inject:
                    updates["inject_depth"] = d_up
                    updates["inject_normal"] = n_up
                tensors = dataclasses.replace(tensors, **updates)
                state = init_scene_state(sub, tensors)
                state = _run_stage(state, tensors, cfg, verbose)
        else:
            state = init_scene_state(sub, tensors)
            state = _run_stage(state, tensors, cfg, verbose)
        prev_maps = (state.depth, state.normal)
        if checkpoint_dir is not None:
            save_stage_state(_stage_path(checkpoint_dir, si), state)
        if verbose:
            print(f"[hierarchy] stage {si} (level {stage.level}, "
                  f"variant {stage.variant}) done")
    return state


_STAGE_FIELDS = ("depth", "normal", "cost", "keys")


def _stage_path(checkpoint_dir: str, si: int) -> str:
    return os.path.join(checkpoint_dir, f"stage{si}.npz")


def _latest_stage(checkpoint_dir: str) -> Optional[int]:
    done = [int(n[5:-4]) for n in os.listdir(checkpoint_dir)
            if n.startswith("stage") and n.endswith(".npz")
            and n[5:-4].isdigit()]
    return max(done) if done else None


def save_stage_state(path: str, state: SceneState) -> None:
    """One stage's solver state as an .npz, written atomically (a run
    killed mid-write leaves the previous stage as the latest)."""
    tmp = path + ".tmp.npz"
    np.savez(tmp, **{f: np.asarray(getattr(state, f)) for f in _STAGE_FIELDS})
    os.replace(tmp, path)


def load_stage_state(path: str) -> SceneState:
    with np.load(path) as z:
        return SceneState(**{f: jnp.asarray(z[f]) for f in _STAGE_FIELDS})


def _run_stage(state: SceneState, tensors: SceneTensors, cfg: DenseConfig,
               verbose: bool) -> SceneState:
    """One stage's external-iteration schedule — the per-stage twin of
    dense.scene_driver.estimate_scene, including the semantic/superpixel
    prior pass at iteration n-2 (ref: GenerateDepthPrior at
    it_external == n-2, SceneDensify.cpp:983-1031) and the cross-scale
    hypothesis injection at the final iteration (restore variant)."""
    from hcmvs_tpu.core.config import window_cfg_for_width
    from hcmvs_tpu.dense.scene_driver import (attach_volumes,
                                              compute_scene_priors,
                                              optimize_maps, phase_cfg,
                                              want_prior_pass)
    from hcmvs_tpu.utils.profiling import stage_timer
    cfg = window_cfg_for_width(cfg, tensors.gray.shape[2])
    with stage_timer("stage.attach_volumes", block_on=lambda: tensors.vols,
                     log=verbose):
        tensors = attach_volumes(tensors, cfg)
    n_ext = cfg.estimation_iters_external
    priors_done = False
    for it_ext in range(n_ext):
        phase = 1 if it_ext >= cfg.photo2geo else 0
        if want_prior_pass(tensors, cfg) \
                and it_ext == max(n_ext - 2, 1) and not priors_done:
            # superpixel/semantic RANSAC planes replace the (cross-scale)
            # bootstrap prior for the final iterations, mirroring the
            # reference's GenerateFinalPrior overwrite of depthMapPrior;
            # an external --priors-dir channel merges in (external wins
            # where nonzero, SceneDensify.cpp:1079-1161).  SLIC
            # self-priors (no real masks) are gated off by default —
            # measured -0.21 on wide-FOV geometry (want_prior_pass)
            with stage_timer("stage.priors", log=verbose):
                tensors = compute_scene_priors(
                    state, dataclasses.replace(tensors, prior_depth=None),
                    cfg=cfg,
                    with_super=cfg.use_semantic and (
                        tensors.semantic is not None
                        or bool(cfg.self_priors)))
            priors_done = True
        inject = (bool(cfg.cross_scale_inject) and it_ext == n_ext - 1
                  and tensors.inject_depth is not None)
        with stage_timer("stage.sweeps", block_on=lambda: state.depth,
                         log=verbose):
            state = scene_sweeps(state, tensors,
                                 phase_cfg(cfg, phase, it_ext == n_ext - 1),
                                 phase, cfg.estimation_iters, phase >= 1,
                                 inject=inject)
        if cfg.optimize and it_ext in (1, 2):
            with stage_timer("stage.optimize", log=verbose):
                state = optimize_maps(state, tensors, cfg)
    return state


def densify_hierarchical(scene_path: str, images_dir: str, out_dir: str,
                         base_cfg: Optional[DenseConfig] = None,
                         schedule: Optional[List[Stage]] = None,
                         resume: bool = True,
                         verbose: bool = True,
                         masks_dir: Optional[str] = None,
                         priors_dir: Optional[str] = None) -> dict:
    """Full hierarchical-cross densification of a `.mvs` scene — the
    run.sh top-level entry (ref: /root/reference/run.sh:1-20): builds the
    per-level scene tensors from resized images, runs the alternating
    5-stage schedule with per-stage checkpoints, and writes the final
    .dmap maps + fused cloud like pipeline.densify."""
    import os as _os
    from hcmvs_tpu.io.images import (compute_resolution_scale, load_image,
                                     resize_image)
    from hcmvs_tpu.io.mvs import read_mvs
    from hcmvs_tpu.pipeline.densify import build_scene_tensors
    from hcmvs_tpu.utils.profiling import stage_timer

    base_cfg = base_cfg or DenseConfig()
    schedule = schedule or default_schedule(base_cfg)
    _os.makedirs(out_dir, exist_ok=True)
    scene = read_mvs(scene_path)
    n = len(scene.images)
    raw = []
    for i in range(n):
        name = scene.images[i].name
        path = name if _os.path.isabs(name) else _os.path.join(
            images_dir, _os.path.basename(name))
        raw.append(load_image(path, gray=True))

    # semantic-mask files feed the RANSAC planar priors of any stage
    # running use_semantic (the reference's final stage: --use-semantic 1,
    # data/frame_main/resize1/run.py; masks named by Image::maskName)
    mask_paths = None
    if any(s.cfg.use_semantic for s in schedule):
        from hcmvs_tpu.pipeline.densify import (find_scene_masks,
                                                load_scene_masks)
        mask_paths = find_scene_masks(scene, images_dir, masks_dir)
        if verbose and mask_paths is not None:
            print(f"[hierarchy] semantic masks on "
                  f"{sum(p is not None for p in mask_paths)}/{n} images")

    levels = sorted({s.level for s in schedule}, reverse=True)
    tensors_per_level: Dict[int, SceneTensors] = {}
    with stage_timer("hierarchy.build_levels", log=verbose):
        for lvl in levels:
            scale = compute_resolution_scale(
                raw[0].shape[1], raw[0].shape[0], lvl,
                base_cfg.max_resolution, base_cfg.min_resolution)
            grays = [resize_image(g, scale) for g in raw]
            flows = None
            if base_cfg.use_optical_flow:
                # per-level ref->best-neighbor flow fields (ref: InitViews
                # Farneback flow, SceneDensify.cpp:404-508; the reference's
                # always-on --n-opticalflow 1 applies at every stage)
                from hcmvs_tpu.dense.flow import scene_flows
                from hcmvs_tpu.dense.view_selection import (pair_scores,
                                                            select_neighbors)
                centers = np.stack([scene.pose_of(i)[1] for i in range(n)])
                score = pair_scores(scene.points, scene.point_view_counts,
                                    scene.point_view_ids, centers, n)
                nbr1, _ = select_neighbors(score, 1)
                flows = scene_flows(np.stack(grays), nbr1,
                                    base_cfg.flow_backend)
            semantic = None
            if mask_paths is not None:
                semantic = load_scene_masks(mask_paths, grays[0].shape)
            tensors_per_level[lvl] = build_scene_tensors(
                scene, grays, base_cfg, flows, semantic=semantic)
            if priors_dir is not None:
                # external prior-map channel resized per level (the
                # meanshift analog — ref: GenerateFinalPrior resize +
                # merge, SceneDensify.cpp:1088-1161)
                from hcmvs_tpu.pipeline.densify import load_prior_maps
                ext = load_prior_maps(priors_dir, scene, grays[0].shape)
                if ext is not None:
                    tensors_per_level[lvl] = dataclasses.replace(
                        tensors_per_level[lvl],
                        ext_prior_depth=jnp.asarray(ext))

    with stage_timer("hierarchy.schedule", log=verbose):
        state = run_hierarchy(
            tensors_per_level, base_cfg, schedule=schedule,
            checkpoint_dir=_os.path.join(out_dir, "stage_ckpt"),
            resume=resume, verbose=verbose)

    # final artifacts at the finest level
    final_cfg = schedule[-1].cfg
    depth, normal, conf = finalize(state, final_cfg)
    tensors = tensors_per_level[schedule[-1].level]
    h, w = tensors.gray.shape[1:]
    from hcmvs_tpu.dense.fusion import compact_point_cloud, fuse_point_cloud
    from hcmvs_tpu.io.dmap import DepthMapData, write_dmap
    from hcmvs_tpu.io.ply import write_ply_points
    dmap_dir = _os.path.join(out_dir, "depthmap")
    _os.makedirs(dmap_dir, exist_ok=True)
    depth_np = np.asarray(depth)
    normal_np = np.asarray(normal)
    conf_np = np.asarray(conf)
    for i in range(n):
        R, C = scene.pose_of(i)
        write_dmap(_os.path.join(dmap_dir, f"depth{i:04d}.dmap"),
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
    priority = jnp.arange(n, dtype=jnp.float32)
    fused = fuse_point_cloud(depth, normal, conf, tensors.cams,
                             tensors.nbr_idx, tensors.nbr_valid, priority,
                             final_cfg)
    cloud = compact_point_cloud(fused, nbr_idx=np.asarray(tensors.nbr_idx),
                                confs=conf_np)
    write_ply_points(_os.path.join(out_dir, "scene_dense.ply"),
                     cloud["points"], cloud["normals"])
    return {"n_views": n, "n_points": len(cloud["points"]),
            "valid_frac": float((depth_np > 0).mean()),
            "depth": depth_np, "normal": normal_np, "conf": conf_np,
            "cloud": cloud}


def main(argv=None):
    import argparse
    from hcmvs_tpu.core.config import config_from_cli_flags
    from hcmvs_tpu.utils.profiling import log_report
    ap = argparse.ArgumentParser(
        description="Hierarchical-cross densification (run.sh equivalent)")
    ap.add_argument("--input-file", required=True)
    ap.add_argument("--images-dir", default=None)
    ap.add_argument("-w", "--working-dir", default="mvs_hc_out")
    ap.add_argument("--flags", nargs="*", default=[])
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--finest-level", type=int, default=1,
                    help="resolution level of the two final stages (the "
                         "schedule climbs two levels above it)")
    ap.add_argument("--masks-dir", default=None,
                    help="directory of per-image semantic masks for the "
                         "use-semantic stages")
    ap.add_argument("--priors-dir", default=None,
                    help="directory of external prior depth maps "
                         "(depth%%04d.dmap / <stem>.dmap — the meanshift "
                         "prior channel, merged by GenerateFinalPrior "
                         "semantics)")
    args = ap.parse_args(argv)
    from hcmvs_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    cfg = config_from_cli_flags(dict(f.split("=", 1) for f in args.flags))
    images_dir = args.images_dir or os.path.dirname(args.input_file)
    stats = densify_hierarchical(args.input_file, images_dir,
                                 args.working_dir, cfg,
                                 schedule=default_schedule(
                                     cfg, args.finest_level),
                                 resume=not args.no_resume,
                                 masks_dir=args.masks_dir,
                                 priors_dir=args.priors_dir)
    print({k: v for k, v in stats.items()
           if k not in ("depth", "normal", "conf", "cloud")})
    log_report()


if __name__ == "__main__":
    main()
