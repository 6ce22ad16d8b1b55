"""Dense-reconstruction configuration.

Single frozen dataclass mirroring the reference's OPTDENSE config space
(ref: frame_main/libs/MVS/DepthMap.h:110-198 externs and
frame_main/libs/MVS/DepthMap.cpp:67-143 defaults), including every HC-MVS
addition, so the per-stage flag sets in ``data/*/resize*/run.py`` map 1:1
for parity runs.  Being frozen + hashable, a ``DenseConfig`` is passed as a
static argument to jitted stages: changing a knob recompiles, using one is
free at runtime.

Defaults follow the canonical HC-MVS parameterization used by the driver
scripts (ref: data/frame_main/resize2/run.py:36-78) where they differ from
the compiled-in defaults, since the run.py layer is the de-facto ground
truth for what the reference actually runs.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional


@dataclasses.dataclass(frozen=True)
class DenseConfig:
    # --- resolution / view selection (ref: DepthMap.cpp:70-86) -------------
    resolution_level: int = 1          # nResolutionLevel
    max_resolution: int = 3200         # nMaxResolution
    min_resolution: int = 640          # nMinResolution
    min_views: int = 2                 # nMinViews
    max_views: int = 12                # nMaxViews
    min_views_fuse: int = 2            # nMinViewsFuse
    min_views_filter: int = 2          # nMinViewsFilter
    min_views_filter_adjust: int = 1   # nMinViewsFilterAdjust
    min_views_trust_point: int = 2     # nMinViewsTrustPoint
    num_views: int = 10                # nNumViews (run.py --number-views 10)
    filter_adjust: bool = True         # bFilterAdjust
    add_corners: bool = True           # bAddCorners
    view_min_score: float = 0.0        # fViewMinScore
    view_min_score_ratio: float = 0.3  # fViewMinScoreRatio
    min_angle: float = 3.0             # fMinAngle (degrees)
    optim_angle: float = 10.0          # fOptimAngle
    max_angle: float = 65.0            # fMaxAngle
    min_area: float = 0.01             # fMinArea

    # --- patch matching core (ref: DepthMap.cpp:120-134, DepthMap.h:124) ---
    patch_half_window: int = 5         # nSizeHalfWindow (stock)
    patch_step: int = 2                # nSizeStep
    adapt_half_window: int = 7         # adapthalfwin — weak-texture half win
    propagate_half_window: int = 5     # propagatehalfwin
    propagate_step: int = 4            # propagatestep
    estimation_iters: int = 3          # nEstimationIters (inner)
    estimation_iters_external: int = 4 # nEstimationIters_external (outer)
    random_iters: int = 6              # nRandomIters
    random_max_scale: int = 2          # nRandomMaxScale
    random_depth_ratio: float = 0.003  # fRandomDepthRatio
    random_angle1_range: float = 16.0  # fRandomAngle1Range (degrees)
    random_angle2_range: float = 10.0  # fRandomAngle2Range (degrees)
    random_smooth_depth: float = 0.02  # fRandomSmoothDepth
    random_smooth_normal: float = 13.0 # fRandomSmoothNormal (degrees)
    random_smooth_bonus: float = 0.93  # fRandomSmoothBonus
    ncc_threshold_keep: float = 0.55   # fNCCThresholdKeep
    min_patch_variance: float = 0.01   # fDescriptorMinMagnitudeThreshold
    depth_diff_threshold: float = 0.01 # fDepthDiffThreshold
    normal_diff_threshold: float = 25. # fNormalDiffThreshold (degrees)

    # --- HC-MVS cost-term schedule (ref: DepthMap.cpp:96-117) --------------
    photo2geo: int = 1                 # outer iter at which geo switches on
    use_geo_consistency: int = 1       # usegeoconsistency
    use_part_consistency: int = 0      # usepartconsistency
    use_optical_flow: int = 1          # opticalflow
    view_spread: int = 0               # viewspread
    init_triangulate: int = 0          # initTriangulate (0: load prev stage)
    tx_threshold: float = 150.0        # txthreshold (gradient split 1)
    tx_threshold2: float = 175.0       # txthreshold2 (gradient split 2)
    para_part: float = 0.1             # local-smoothness weight
    para_part2: float = 0.05           # local-smoothness weight 2
    para_tapa: float = 0.26            # geometric-consistency weight
    para_tapa2: float = 0.26           # geometric-consistency weight 2
    para_prior: float = 0.4            # planar-prior weight
    photometric_flow: float = 0.26     # flow cross-consistency weight
    maxgeo_proportion: float = 5.0     # epipolar-distance normalizer scale
    sigma_texture: float = 0.05        # fsigmaTexture
    sigma_prior: float = 0.2           # fsigmaPrior

    # --- priors (ref: DepthMap.cpp:135-141) --------------------------------
    use_semantic: bool = False         # nUseSemantic
    self_priors: int = 0               # force SLIC self-priors (planes fit
                                       # on the solver's own depth) even
                                       # WITHOUT real semantic masks.
                                       # Default OFF: measured -0.21
                                       # depth-acc on wide-FOV geometry
                                       # (BASELINE.md r4 ablation); the
                                       # reference's own discipline runs
                                       # use-semantic only with mask
                                       # files (resize1/run.py).  With
                                       # masks present, use_semantic
                                       # alone enables the full pass.
    semantic_consistency_mul: float = 0.1  # fSemanticConsistencyMul
    ransac_probability: float = 0.005  # ransacprobability
    ransac_epsilon_mul: float = 1.4    # fransacEpsilonMul
    ransac_cluster_mul: float = 7.0    # fransacClusterMul
    ransac_min_points_div: float = 40. # fransacMinPointsDiv

    # --- filtering / fusion (ref: DepthMap.cpp:101,142-143) ---------------
    optimize: int = 1                  # nOptimize (inter-frame filter flag)
    speckle_size: int = 100            # nSpeckleSize
    ipol_gap_size: int = 7             # nIpolGapSize
    depth_weight: float = 1.0          # depthweight (fusion threshold scale)
    normal_weight: float = 1.0         # normalweight
    estimate_colors: int = 2           # nEstimateColors
    estimate_normals: int = 2          # nEstimateNormals

    # --- implementation knobs (no reference analog) -------------------------
    explore_patch_step: int = 4        # patch sample step during every
                                       # external iteration EXCEPT the
                                       # final one (photometric and
                                       # geometric alike); 0 disables.
                                       # Coarse 9-sample patches rank
                                       # hypotheses just as well (ridge
                                       # golden scene: 0.922 == full-
                                       # sampling budget) at ~4x fewer
                                       # scoring gathers; only the final
                                       # iteration — whose scores gate the
                                       # confidence threshold — uses the
                                       # full patch_step sampling.
    explore_until_last: bool = True    # within a FULL-sampling sweep
                                       # call (the final external
                                       # iteration), run all but the
                                       # LAST inner iteration at the
                                       # coarse explore_patch_step
                                       # sampling too — only the final
                                       # sweep's scores gate the
                                       # confidence threshold.  Measured
                                       # r5 (ridge golden 640x480 full
                                       # schedule + 1280x960 fixed-FOV
                                       # ladder): accuracy unchanged
                                       # (see BASELINE.md r5) at ~40%
                                       # less full-sampling work.
    cross_scale_inject: int = 1        # B stages: score the upsampled
                                       # previous-level (depth, normal) as a
                                       # PatchMatch candidate at the last
                                       # inner x external iteration with a
                                       # 0.1 score bonus — the reference's
                                       # restore-variant semantics
                                       # (restore/libs/MVS/
                                       # DepthMap.cpp:1527-1549)
    cross_scale_prior: int = 1         # B stages: ALSO feed the upsampled
                                       # previous-level depth through the
                                       # soft prior term until semantic
                                       # priors replace it (ref: restore
                                       # resize_/nresize_ maps feeding
                                       # GenerateFinalPrior).
                                       # Measured A/B (3-stage hierarchy):
                                       # ridge golden inject/prior/both =
                                       # 0.969/0.970/0.969; occlusion box
                                       # = 0.931/0.934/0.931 — the two
                                       # channels are equivalent within
                                       # noise, injection slightly denser
                                       # (valid 0.992 vs 0.989); both stay
                                       # on to match the reference.
    geo_max_neighbors: int = 4         # neighbor depth maps gathered for
                                       # geo consistency / scoring.
                                       # Measured A/B on a 9-view ridge
                                       # scene (72x96, full schedule):
                                       # V=2 acc 0.992, V=4 0.997,
                                       # V=8 0.996 — quality saturates at
                                       # 4 while scoring cost grows
                                       # linearly in V, so the reference's
                                       # 10-view set buys nothing here
    agg_top_k: int = 0                 # 0: min-mean aggregation over views
                                       # (ref DENSE_AGGNCC_MINMEAN), else top-k
    flow_backend: str = "lk"           # optical flow for the flow term:
                                       # "lk" = pyramidal Lucas-Kanade in
                                       # JAX (dense/flow.py); "farneback"
                                       # = OpenCV on the host, exactly
                                       # like the reference (needs cv2)
    sweep_mode: str = "jacobi"         # "jacobi" (default): one full sweep
                                       # updating every pixel per iteration
                                       # — in this data-parallel
                                       # formulation costs are evaluated
                                       # image-wide regardless of parity,
                                       # so a full Jacobi update costs HALF
                                       # a red/black pair.  Measured on the
                                       # ridge golden scene: equal quality
                                       # at equal eval budget (0.947 vs
                                       # 0.949), -0.027 at half budget.
                                       # "redblack": two checkerboard half
                                       # sweeps per iteration (Gauss-Seidel
                                       # data flow, fresher neighbors).
    batch_candidates: bool = False     # score all propagation candidates
                                       # in one vmapped graph instead of
                                       # lax.scan (materializes every
                                       # candidate's intermediates; the
                                       # scan reuses one set)
    score_mode: str = "exact"          # "exact": warp every patch sample
                                       # through the pixel's own plane
                                       # homography (reference semantics;
                                       # 0.95 vs warped's 0.41
                                       # 2%-accuracy on the ridge golden
                                       # scene) — the production default.
                                       # "warped": sample each src view
                                       # once per candidate at the warp
                                       # center and take patch values from
                                       # the warped image at static
                                       # offsets (exact only for locally-
                                       # planar hypothesis fields).
                                       # "hybrid": warped while
                                       # photometric, exact after.
    exact_backend: str = "auto"        # how exact scoring fetches source
                                       # samples.  "bilinear": direct
                                       # per-sample bilinear gathers.
                                       # "volume": per-pixel sigma-plane
                                       # tables (ops/volume.py) read
                                       # with a lerp.  "auto": the engine
                                       # resolve_engines picks.
    geo_backend: str = "auto"          # how the geo-consistency term and
                                       # view-spread fetch neighbor
                                       # (depth, normal) samples.
                                       # "direct": per-index nearest
                                       # gathers (reference semantics).
                                       # "rect": the rectified-epipolar
                                       # engine (ops/rect_gather.py;
                                       # lookups that miss a tile's
                                       # window read invalid).  "auto":
                                       # the engine resolve_engines picks.
    volume_planes: int = 128           # sigma planes in the exact-scoring
                                       # tables (multiple of 128).
                                       # Measured A/B at 1280x960
                                       # fixed-FOV: 256 planes scored
                                       # 0.8501 vs 128's 0.8521 —
                                       # identical within noise, so 128
                                       # stays.  Values > 128 route the
                                       # table BUILD through the
                                       # per-plane warp path (the
                                       # rect-frame builder is 128-plane
                                       # only).
    candidate_kernel: str = "auto"     # "on": score ALL propagation
                                       # candidates through ONE batched
                                       # table lookup per view
                                       # (score.photometric_scores_volume
                                       # _batched) instead of one lookup
                                       # per candidate; needs the volume
                                       # backend.  "auto" resolves off
                                       # (score.use_candidate_batch).
    refine_batched: bool = False       # random-refinement ladder scored
                                       # as ONE batched candidate set
                                       # (all annealed scales perturbed
                                       # from the post-propagation best,
                                       # carry-free argmin) instead of
                                       # sequentially accepted steps.
                                       # Off keeps the reference's
                                       # sequential-acceptance semantics
                                       # (ref: DepthMap.cpp:1441-1501).
    window_ref_width: int = 0          # resolution-aware patch windows:
                                       # when set, images at least 2x
                                       # this width DOUBLE
                                       # adapt/patch_half_window and
                                       # patch_step (same sample count,
                                       # 2x spatial extent).  Measured
                                       # ladder (ridge fixed-FOV,
                                       # iters=3, base windows 5/3/2):
                                       # extent-doubled 6/4 windows
                                       # score 0.9615@640 / 0.9528@1280
                                       # vs 0.928 / 0.908 at the base
                                       # windows.  At 192 the doubled
                                       # extent HURTS (0.894 vs 0.943),
                                       # hence the width gate; the
                                       # explore step must NOT scale
                                       # (explore 8: 0.9424).
                                       # 0 = off (reference-stock
                                       # windows at every size).
    volume_streaming: bool = False     # build each reference view's
                                       # sigma tables INSIDE its sweep
                                       # iteration (the lax.map body)
                                       # instead of once per stage for
                                       # the whole scene — for the
                                       # reference's 10-neighbor
                                       # operating point
                                       # (data/*/resize2/run.py
                                       # --number-views 10), where
                                       # scene-wide u16 tables at
                                       # 1280x960 x 11 views x 10 nbrs
                                       # would take ~35GB.  Cost: tables
                                       # rebuild once per sweep call
                                       # instead of once per stage.
    volume_build: str = "auto"         # how the exact-scoring sigma
                                       # tables are BUILT.  "planes": one
                                       # bilinear warp per sigma plane
                                       # (ops/volume.py
                                       # build_view_volume).  "rect": one
                                       # warp of the source into the
                                       # rectified frame, then strided
                                       # reads along each row
                                       # (build_volume_tables_rect).
                                       # "auto": the engine
                                       # resolve_engines picks.

    @property
    def num_patch_samples(self) -> int:
        """Sample count along one patch axis (static for jit)."""
        return self.patch_half_window * 2 // self.patch_step + 1

    def replace(self, **kw) -> "DenseConfig":
        return dataclasses.replace(self, **kw)


def window_cfg_for_width(cfg: DenseConfig, w: int) -> DenseConfig:
    """Resolution-aware patch windows (see ``window_ref_width``): double
    the adapt/patch window and step — same sample count, 2x extent — for
    images >= 2x the reference width.  Applied by the scene drivers
    (estimate_scene / hierarchy per-stage) so each hierarchy level gets
    the extent its resolution calls for."""
    if not cfg.window_ref_width or w < 2 * cfg.window_ref_width:
        return cfg
    return cfg.replace(
        adapt_half_window=cfg.adapt_half_window * 2,
        patch_half_window=cfg.patch_half_window * 2,
        patch_step=cfg.patch_step * 2)


class Engines(NamedTuple):
    exact: str   # "bilinear" | "volume"
    geo: str     # "direct" | "rect"
    build: str   # "planes" | "rect"


# What "auto" means for each engine knob.  Direct gathers won the on-card
# A/B of one photometric + geometric round (PERF.md, engine A/B): the
# source images sit in L2, so per-index gathers need no table.
_AUTO_ENGINES = Engines(exact="bilinear", geo="direct", build="planes")


def resolve_engines(cfg: DenseConfig) -> Engines:
    """The one place "auto" engine knobs resolve; explicit values win."""
    def pick(value: str, auto: str) -> str:
        return auto if value == "auto" else value
    return Engines(exact=pick(cfg.exact_backend, _AUTO_ENGINES.exact),
                   geo=pick(cfg.geo_backend, _AUTO_ENGINES.geo),
                   build=pick(cfg.volume_build, _AUTO_ENGINES.build))


# CLI flag name -> field name, for parity with the reference's run.py layer
# (ref: apps/DensifyPointCloud/DensifyPointCloud.cpp:140-199).
CLI_FLAG_MAP = {
    "resolution-level": "resolution_level",
    "max-resolution": "max_resolution",
    "min-resolution": "min_resolution",
    "number-views": "num_views",
    "number-views-fuse": "min_views_fuse",
    "n-EstimationIters": "estimation_iters",
    "n-EstimationIters-external": "estimation_iters_external",
    "n-photo2geo": "photo2geo",
    "n-viewspread": "view_spread",
    "n-opticalflow": "use_optical_flow",
    "n-initTriangulate": "init_triangulate",
    "n-photometric_flow": "photometric_flow",
    "n-nOptimize": "optimize",
    "n-usepartconsistency": "use_part_consistency",
    "n-usegeoconsistency": "use_geo_consistency",
    "use-semantic": "use_semantic",
    "n-maxgeo_proportion": "maxgeo_proportion",
    "n-txthreshold": "tx_threshold",
    "n-txthreshold2": "tx_threshold2",
    "n-para_part": "para_part",
    "n-para_part2": "para_part2",
    "n-para_tapa": "para_tapa",
    "n-para_tapa2": "para_tapa2",
    "n-para_prior": "para_prior",
    "n-adapthalfwin": "adapt_half_window",
    "n-propagatehalfwin": "propagate_half_window",
    "n-propagatestep": "propagate_step",
    "ransac-probability": "ransac_probability",
    "ransac-epsilon": "ransac_epsilon_mul",
    "ransac-cluster": "ransac_cluster_mul",
    "ransac-min-points": "ransac_min_points_div",
    "estimate-normals": "estimate_normals",
}


def config_from_cli_flags(flags: dict, base: Optional[DenseConfig] = None
                          ) -> DenseConfig:
    """Build a DenseConfig from reference-style CLI flags.

    ``flags`` maps flag names (without leading dashes, e.g. from parsing a
    reference ``run.py``) to string/number values.
    """
    cfg = base or DenseConfig()
    fields = {f.name: f.type for f in dataclasses.fields(DenseConfig)}
    updates = {}
    for flag, value in flags.items():
        name = CLI_FLAG_MAP.get(flag)
        if name is None:
            continue
        ftype = fields[name]
        if ftype in ("int", int):
            updates[name] = int(value)
        elif ftype in ("float", float):
            updates[name] = float(value)
        elif ftype in ("bool", bool):
            updates[name] = bool(int(value))
        else:
            updates[name] = value
    return cfg.replace(**updates)
