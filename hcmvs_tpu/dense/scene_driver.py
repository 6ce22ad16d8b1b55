"""Scene-level dense reconstruction driver.

The batched analog of Scene::DenseReconstruction / ComputeDepthMaps
(ref: frame_main/libs/MVS/SceneDensify.cpp:3532-3821) and its event-queue
worker model (:3831-4006): instead of two pthreads pipelining per-image
estimation, *all* reference views are estimated simultaneously as one
batched program (vmap over the view axis, shardable over a device mesh),
and the external iteration loop exchanges neighbor depth maps between
phases — the functional replacement for the reference's racy cross-view
reads (SURVEY §5.2) and for the filesystem-based stage handoff.

Schedule (mirroring SceneDensify.cpp:3684-3713, :3914-3958):
  for it_ext in range(estimation_iters_external):
      phase = geometric if it_ext >= photo2geo else photometric
      neighbor maps <- snapshot of all views' current state
      run `estimation_iters` red/black sweeps on every view
      if it_ext in {1, 2} and cfg.optimize: cross-view filter + gap fill
  final: confidence threshold (EndDepthMapTmp analog)
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from hcmvs_tpu.core.camera import Camera
from hcmvs_tpu.core.config import DenseConfig
from hcmvs_tpu.dense import score as S
from hcmvs_tpu.dense.fusion import cross_view_filter, gap_interpolate
from hcmvs_tpu.dense.patchmatch import (ScoreContext, half_sweep,
                                        propagation_offsets)
from hcmvs_tpu.dense.types import (PatchMatchState, init_state,
                                   make_view_geometry, pixel_rays)
from hcmvs_tpu.ops.gradients import sobel_magnitude


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SceneTensors:
    """Batched device-side scene: everything static across sweeps."""

    gray: jax.Array        # (N, H, W)
    cams: Camera           # batched (N)
    nbr_idx: jax.Array     # (N, V) neighbor image indices
    nbr_valid: jax.Array   # (N, V)
    d_min: jax.Array       # (N,)
    d_max: jax.Array       # (N,)
    seed_depth: Optional[jax.Array] = None   # (N, H, W) sparse-splat init
    flows: Optional[jax.Array] = None        # (N, 2, H, W) ref->best nbr
    prior_depth: Optional[jax.Array] = None  # (N, H, W)
    ext_prior_depth: Optional[jax.Array] = None  # (N, H, W) externally
                                       # ingested prior maps (the meanshift
                                       # channel, DepthMap.h:294-297 /
                                       # --priors-dir); merged with the
                                       # superpixel prior by
                                       # compute_scene_priors
    semantic: Optional[jax.Array] = None     # (N, H, W) int32 mask labels
    inject_depth: Optional[jax.Array] = None   # (N, H, W) cross-scale maps
    inject_normal: Optional[jax.Array] = None  # (N, 3, H, W) for injection
    vols: Optional[object] = None      # ops.volume.VolumeTables, leading
                                       # (N, V) dims — exact-scoring sweep
                                       # tables, built once per stage


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SceneState:
    depth: jax.Array    # (N, H, W)
    normal: jax.Array   # (N, 3, H, W) planes-first
    cost: jax.Array     # (N, H, W)
    keys: jax.Array     # (N, 2) PRNG keys


def _per_view_context(scene: SceneTensors, i: jax.Array,
                      nbr_depth: Optional[jax.Array],
                      nbr_normal: Optional[jax.Array],
                      cfg: DenseConfig) -> ScoreContext:
    """Build the ScoreContext of view ``i`` (traced index)."""
    cam_i = jax.tree.map(lambda x: x[i], scene.cams)
    cams_nbr = jax.tree.map(lambda x: x[scene.nbr_idx[i]], scene.cams)
    geom = make_view_geometry(cam_i, cams_nbr)
    h, w = scene.gray.shape[1:]
    gra = sobel_magnitude(scene.gray[i])
    hw = S.halfwin_map(gra, cfg)
    offsets = S.patch_offsets(cfg)
    stats = S.ref_patch_stats(scene.gray[i], hw, offsets)
    rays = pixel_rays(geom.K_inv_ref, h, w)
    if scene.vols is not None:
        vol_i = jax.tree.map(lambda x: x[i], scene.vols)
    elif cfg.volume_streaming and S.use_volume_tables(cfg):
        # streamed tables: build view i's per-neighbor sigma tables
        # inside its own sweep iteration — only ONE reference view's
        # tables are ever live (the 10-neighbor memory-wall escape; see
        # cfg.volume_streaming)
        from hcmvs_tpu.ops.volume import (build_volume_tables,
                                          build_volume_tables_rect,
                                          use_rect_volume_build)
        if use_rect_volume_build(cfg, h, w):
            vol_i = build_volume_tables_rect(
                geom, scene.gray[scene.nbr_idx[i]],
                scene.d_min[i], scene.d_max[i])
        else:
            vol_i = build_volume_tables(
                geom, scene.gray[scene.nbr_idx[i]],
                scene.d_min[i], scene.d_max[i],
                n_chunks=max(cfg.volume_planes // 128, 1))
    else:
        vol_i = None
    return ScoreContext(
        geom=geom, src_grays=scene.gray[scene.nbr_idx[i]], stats=stats,
        hw=hw, rays=rays, gra=gra, d_min=scene.d_min[i],
        d_max=scene.d_max[i],
        flow=None if scene.flows is None else scene.flows[i],
        prior_depth=(None if scene.prior_depth is None
                     else scene.prior_depth[i]),
        nbr_depth=nbr_depth, nbr_normal=nbr_normal,
        inject_depth=(None if scene.inject_depth is None
                      else scene.inject_depth[i]),
        inject_normal=(None if scene.inject_normal is None
                       else scene.inject_normal[i]),
        vol=vol_i)


@partial(jax.jit, static_argnames=("cfg", "phase", "n_iters", "use_nbr",
                                   "inject"))
def scene_sweeps(state: SceneState, scene: SceneTensors, cfg: DenseConfig,
                 phase: int, n_iters: int, use_nbr: bool,
                 inject: bool = False) -> SceneState:
    """``n_iters`` red/black sweeps on every view, batched.

    Neighbor depth/normal snapshots are taken once at entry (double
    buffering at external-iteration granularity).  With ``inject`` (set by
    the caller at the LAST external iteration when cross-scale maps are
    attached), the last inner sweep scores the upsampled previous-stage
    hypothesis with a 0.1 bonus (ref: restore/libs/MVS/
    DepthMap.cpp:1527-1549).
    """
    offsets = S.patch_offsets(cfg)
    prop_offsets = propagation_offsets(cfg)
    # explore-until-last: within a full-sampling call, all but the LAST
    # inner iteration may still use the coarse explore sampling — only
    # the final sweep's scores gate the confidence threshold
    split = (cfg.explore_until_last and cfg.explore_patch_step
             and cfg.patch_step != cfg.explore_patch_step and n_iters > 1)
    cfg_x = (cfg.replace(patch_step=cfg.explore_patch_step) if split
             else cfg)
    offsets_x = S.patch_offsets(cfg_x)
    # snapshot for cross-view reads: frozen for the whole call
    depth0, normal0 = state.depth, state.normal
    inject = inject and scene.inject_depth is not None

    def per_view(i, st_leaves):
        st = PatchMatchState(depth=st_leaves[0], normal=st_leaves[1],
                             cost=st_leaves[2], key=st_leaves[3])
        if use_nbr:
            nbr_depth = depth0[scene.nbr_idx[i]]
            nbr_normal = normal0[scene.nbr_idx[i]]
        else:
            nbr_depth = nbr_normal = None
        ctx = _per_view_context(scene, i, nbr_depth, nbr_normal, cfg)
        if use_rect and nbr_depth is not None:
            # rectified-epipolar lookup engine for the geo term /
            # view-spread: warp the frozen neighbor snapshot into the
            # per-pair rect frames once per external iteration
            # (ops/rect_gather.py)
            from hcmvs_tpu.ops.rect_gather import (build_rect_context,
                                                   pack_depth_normals)
            rect = build_rect_context(
                ctx.geom, pack_depth_normals(nbr_depth, nbr_normal))
            ctx = dataclasses.replace(ctx, rect=rect)
        if split:
            ctx_x = dataclasses.replace(
                ctx, stats=S.ref_patch_stats(scene.gray[i], ctx.hw,
                                             offsets_x))
        else:
            ctx_x = ctx

        def one_iter(s, inj, c_, ctx_, off_):
            s = half_sweep(s, ctx_, c_, phase, 0, off_, prop_offsets,
                           inject=inj)
            if cfg.sweep_mode != "jacobi":
                s = half_sweep(s, ctx_, c_, phase, 1, off_, prop_offsets,
                               inject=inj)
            return s

        st = jax.lax.fori_loop(
            0, n_iters - 1,
            lambda _, s: one_iter(s, False, cfg_x, ctx_x, offsets_x), st)
        st = one_iter(st, inject, cfg, ctx, offsets)
        return st.depth, st.normal, st.cost, st.key

    h, w = state.depth.shape[1:]
    idx = jnp.arange(state.depth.shape[0])
    leaves = (state.depth, state.normal, state.cost, state.keys)
    use_rect = (use_nbr and S.use_rect_backend(cfg, h, w)
                and (cfg.use_geo_consistency or cfg.view_spread))
    streaming = (scene.vols is None and cfg.volume_streaming
                 and S.use_volume_tables(cfg))
    if h * w > 640 * 480 or streaming:
        # large images: serialize the view axis (lax.map) — the vmapped
        # working set (N x per-candidate (S, H, W) intermediates) grows
        # with the view count at reference-scale resolutions
        d, n, c, k = jax.lax.map(lambda a: per_view(a[0], a[1]),
                                 (idx, leaves))
    else:
        d, n, c, k = jax.vmap(per_view)(idx, leaves)
    return SceneState(depth=d, normal=n, cost=c, keys=k)


def init_scene_state(key: jax.Array, scene: SceneTensors) -> SceneState:
    """Random init, optionally seeded by sparse depths (splatted or
    Delaunay-interpolated — dense/init_tri.py; ref: InitDepthMap
    triangulation / read-init, SceneDensify.cpp:514-578)."""
    n, h, w = scene.gray.shape
    keys = jax.random.split(key, n)

    def per_view(i, k):
        cam_i = jax.tree.map(lambda x: x[i], scene.cams)
        rays = pixel_rays(cam_i.K_inv, h, w)
        st = init_state(k, rays, scene.d_min[i], scene.d_max[i])
        if scene.seed_depth is not None:
            seed = scene.seed_depth[i]
            st = PatchMatchState(
                depth=jnp.where(seed > 0, seed, st.depth),
                normal=st.normal, cost=st.cost, key=st.key)
        return st

    sts = jax.vmap(per_view)(jnp.arange(n), keys)
    return SceneState(depth=sts.depth, normal=sts.normal, cost=sts.cost,
                      keys=sts.key)


@partial(jax.jit, static_argnames=("rect_build", "n_chunks"))
def _build_scene_volumes(scene: SceneTensors, rect_build: bool = False,
                         n_chunks: int = 1):
    from hcmvs_tpu.ops.volume import (build_volume_tables,
                                      build_volume_tables_rect)
    if rect_build:
        build = build_volume_tables_rect          # 128-plane engine
    else:
        import functools as _ft
        build = _ft.partial(build_volume_tables, n_chunks=n_chunks)

    def per_view(i):
        cam_i = jax.tree.map(lambda x: x[i], scene.cams)
        cams_nbr = jax.tree.map(lambda x: x[scene.nbr_idx[i]], scene.cams)
        geom = make_view_geometry(cam_i, cams_nbr)
        return build(geom, scene.gray[scene.nbr_idx[i]],
                     scene.d_min[i], scene.d_max[i])

    # unrolled over the (static) reference-view axis; per-view working
    # sets are ~120MB at 1280x960 so the unrolled liveness is cheap
    outs = [per_view(i) for i in range(scene.gray.shape[0])]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *outs)


def attach_volumes(scene: SceneTensors, cfg: DenseConfig) -> SceneTensors:
    """Build the exact-scoring sigma-volume tables (once per stage — the
    tables depend only on images + geometry + depth range; see
    ops/volume.py).  No-op unless cfg routes exact scoring through them.
    With the rect-frame build (ops/volume.py build_volume_tables_rect)
    the tables' pixel order follows to_volume_order, which the scoring
    consumer keys off the same use_rect_volume_build gate.
    """
    from hcmvs_tpu.dense.score import use_volume_tables
    from hcmvs_tpu.ops.volume import use_rect_volume_build
    if scene.vols is not None or not use_volume_tables(cfg) \
            or cfg.volume_streaming:
        # streaming mode defers the build into each view's own sweep
        # iteration (scene_sweeps/_per_view_context)
        return scene
    h, w = scene.gray.shape[1:]
    return dataclasses.replace(scene, vols=_build_scene_volumes(
        scene, rect_build=use_rect_volume_build(cfg, h, w),
        n_chunks=max(cfg.volume_planes // 128, 1)))


def phase_cfg(cfg: DenseConfig, phase: int,
              is_final: bool = False) -> DenseConfig:
    """Per-phase config: every external iteration except the FINAL one may
    use coarse patch sampling (cfg.explore_patch_step) — hypothesis
    ranking converges equally well with 9-sample patches (ridge golden
    scene: 0.919 vs 0.922 full); only the last iteration's scores gate the
    confidence threshold and need full sampling."""
    del phase
    if not is_final and cfg.explore_patch_step:
        return cfg.replace(patch_step=cfg.explore_patch_step)
    return cfg


def estimate_scene(key: jax.Array, scene: SceneTensors, cfg: DenseConfig,
                   verbose: bool = False) -> SceneState:
    """Full multi-view estimation with the HC-MVS external schedule."""
    from hcmvs_tpu.core.config import window_cfg_for_width
    cfg = window_cfg_for_width(cfg, scene.gray.shape[2])
    state = init_scene_state(key, scene)
    scene = attach_volumes(scene, cfg)
    n_ext = cfg.estimation_iters_external
    for it_ext in range(n_ext):
        phase = 1 if it_ext >= cfg.photo2geo else 0
        use_nbr = phase >= 1
        # planar priors computed one iteration before the last, feeding the
        # final sweeps (ref: GenerateDepthPrior at it_external == n-2 + two
        # extra prior-guided iterations, SceneDensify.cpp:983-1031).  An
        # external prior channel (--priors-dir, the meanshift analog)
        # activates the pass even without use_semantic, exactly like the
        # reference's GenerateFinalPrior merge (SceneDensify.cpp:1079-1161).
        # Self-priors without real masks are gated off (want_prior_pass)
        if want_prior_pass(scene, cfg) and it_ext == max(n_ext - 2, 1) \
                and scene.prior_depth is None:
            scene = compute_scene_priors(
                state, scene, cfg=cfg,
                with_super=cfg.use_semantic and (
                    scene.semantic is not None or bool(cfg.self_priors)))
        inject = (bool(cfg.cross_scale_inject) and it_ext == n_ext - 1
                  and scene.inject_depth is not None)
        state = scene_sweeps(state, scene,
                             phase_cfg(cfg, phase, it_ext == n_ext - 1),
                             phase, cfg.estimation_iters, use_nbr,
                             inject=inject)
        if cfg.optimize and it_ext in (1, 2):
            state = optimize_maps(state, scene, cfg)
        if verbose:
            print(f"[dense] it_ext={it_ext} phase={phase} "
                  f"mean_cost={float(jnp.mean(state.cost)):.4f}")
    return state


@partial(jax.jit, static_argnames=("n_semantic", "cfg"))
def _priors_batched(key: jax.Array, gray: jax.Array, depth: jax.Array,
                    cams: Camera, semantic: Optional[jax.Array],
                    n_semantic: int,
                    cfg: Optional[DenseConfig] = None) -> jax.Array:
    from hcmvs_tpu.dense.priors import generate_priors
    n, h, w = gray.shape
    keys = jax.random.split(key, n)
    # the fransac* knob family drives every prior-plane threshold
    # (ref: DensifyPointCloud.cpp:195-198 CLI flags ->
    # SceneDensify.cpp:1350-1375 CGAL parameter block)
    kw = {}
    if cfg is not None:
        kw = dict(epsilon_mul=cfg.ransac_epsilon_mul,
                  min_points_div=cfg.ransac_min_points_div,
                  probability=cfg.ransac_probability)

    def per_view(k, g, d, cam, sem):
        rays = pixel_rays(cam.K_inv, h, w)
        return generate_priors(g, d, rays, semantic=sem,
                               n_semantic_labels=n_semantic, key=k, **kw)

    if semantic is None:
        return jax.vmap(lambda k, g, d, c: generate_priors(
            g, d, pixel_rays(c.K_inv, h, w), **kw))(keys, gray, depth,
                                                    cams)
    return jax.vmap(per_view)(keys, gray, depth, cams, semantic)


def want_prior_pass(scene: SceneTensors, cfg: DenseConfig) -> bool:
    """Whether the superpixel/semantic prior pass should run at all.

    Self-priors (SLIC planes fit on the solver's OWN depth, no real
    masks) are gated OFF by default: measured -0.21 depth accuracy on
    wide-FOV geometry (BASELINE.md r4 ablation — planes fit on
    border-distorted depth pull scores the wrong way).  The reference
    applies the same discipline by enabling --use-semantic only at its
    final stage WITH mask files present (data/frame_main/resize1/run.py).
    ``cfg.self_priors`` forces the old always-on behavior."""
    return ((cfg.use_semantic and (scene.semantic is not None
                                   or bool(cfg.self_priors)))
            or scene.ext_prior_depth is not None)


def compute_scene_priors(state: SceneState,
                         scene: SceneTensors,
                         with_super: bool = True,
                         cfg: Optional[DenseConfig] = None
                         ) -> SceneTensors:
    """Attach per-view planar-prior depth maps to the scene (with the
    semantic-mask RANSAC path when masks are present — nUseSemantic).

    When the scene carries an external prior channel (ext_prior_depth,
    the meanshift-analog maps fed by --priors-dir), the two channels are
    merged per pixel with GenerateFinalPrior's semantics — external wins
    where nonzero, superpixel/semantic fills the rest (ref:
    SceneDensify.cpp:1079-1161).  ``with_super=False`` skips the
    superpixel RANSAC pass and feeds the external channel alone."""
    from hcmvs_tpu.dense.priors import merge_final_prior
    if with_super:
        n_sem = (int(jnp.max(scene.semantic)) + 1
                 if scene.semantic is not None else 0)
        priors = _priors_batched(jax.random.PRNGKey(7), scene.gray,
                                 state.depth, scene.cams, scene.semantic,
                                 n_sem, cfg)
        if scene.ext_prior_depth is not None:
            priors = merge_final_prior(scene.ext_prior_depth, priors)
    else:
        priors = scene.ext_prior_depth
    return dataclasses.replace(scene, prior_depth=priors)


@partial(jax.jit, static_argnames=("cfg",))
def optimize_maps(state: SceneState, scene: SceneTensors,
                  cfg: DenseConfig) -> SceneState:
    """Mid-pipeline filter: cross-view consistency + the two
    GapInterpolation phases (ref: EVT_OPTIMIZEDEPTHMAP at it_ext in
    {1,2}, SceneDensify.cpp:3929-3958):

    1. row/col interpolation on the fused maps — similar-depth fills for
       small gaps, texture-ratio-gated fills for large ones, with normal
       interpolation (SceneDensify.cpp:2295-2785);
    2. gradient-guided re-propagation over the remaining fused holes with
       the cross candidate pattern (SceneDensify.cpp:2791-2983);
    then the copy-back of valid fused pixels into the working maps
    (:2988-2998).  Unfilled invalid pixels fall back to the pre-filter
    hypothesis so PatchMatch can re-score them.
    """
    from hcmvs_tpu.dense.fusion import gap_repropagate
    conf = jnp.maximum(1.0 - state.cost, 0.01)
    filt, fused, support = cross_view_filter(
        state.depth, state.normal, conf, scene.cams, scene.nbr_idx,
        scene.nbr_valid, cfg)
    depth_fuse = jnp.where(filt > 0, fused, 0.0)
    n, h, w = depth_fuse.shape

    def per_view(i):
        gra = sobel_magnitude(scene.gray[i])
        d, c, nrm = gap_interpolate(depth_fuse[i], conf[i], cfg,
                                    gra=gra, normal=state.normal[i])
        cam_i = jax.tree.map(lambda x: x[i], scene.cams)
        rays = pixel_rays(cam_i.K_inv, h, w)
        d, nrm, c = gap_repropagate(d, nrm, state.depth[i],
                                    state.normal[i], c, gra, rays, cfg)
        return d, nrm, c

    depth2, normal2, conf2 = jax.lax.map(per_view, jnp.arange(n))
    # copy-back: valid fused pixels win; holes revert to the hypothesis
    depth = jnp.where(depth2 > 0, depth2, state.depth)
    normal = jnp.where((depth2 > 0)[:, None], normal2, state.normal)
    return SceneState(depth=depth, normal=normal, cost=state.cost,
                      keys=state.keys)


def finalize(state: SceneState, cfg: DenseConfig
             ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Threshold on the final cost (ref: EndDepthMapTmp,
    SceneDensify.cpp:688-744): returns (depth, normal, conf)."""
    keep = state.cost <= cfg.ncc_threshold_keep
    depth = jnp.where(keep, state.depth, 0.0)
    conf = jnp.where(keep, jnp.maximum(1.0 - state.cost, 0.0), 0.0)
    return depth, state.normal, conf


def splat_sparse_depths(points: np.ndarray, view_counts: np.ndarray,
                        view_ids: np.ndarray, cams_np: list,
                        n_images: int, h: int, w: int,
                        radius: int = 1) -> np.ndarray:
    """Host-side: project sparse points into each view and splat their
    depths into (N, H, W) seed maps (0 elsewhere)."""
    seed = np.zeros((n_images, h, w), np.float32)
    offsets = np.concatenate([[0], np.cumsum(view_counts)])
    for p in range(len(points)):
        ids = view_ids[offsets[p]:offsets[p + 1]]
        for i in ids:
            K, R, C = cams_np[i]
            Xc = R @ (points[p] - C)
            if Xc[2] <= 0:
                continue
            uv = K @ Xc
            x = int(round(uv[0] / uv[2]))
            y = int(round(uv[1] / uv[2]))
            if 0 <= x < w and 0 <= y < h:
                y0, y1 = max(0, y - radius), min(h, y + radius + 1)
                x0, x1 = max(0, x - radius), min(w, x + radius + 1)
                region = seed[i, y0:y1, x0:x1]
                region[region == 0] = Xc[2]
    return seed
