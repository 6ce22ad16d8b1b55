"""Checkerboard PatchMatch sweeps — the core depth-map estimator.

Data-parallel re-design of the reference's sequential zig-zag PatchMatch
(ref: frame_main/libs/MVS/DepthMap.cpp:1050-1668 ProcessPixel and
frame_main/libs/MVS/SceneDensify.cpp:758-1072 EstimateDepthMap):

- The reference sweeps pixels sequentially (intra-row dependency, pthread
  work-stealing).  Here every pixel updates in parallel in red/black
  (checkerboard) phases: a pixel's propagation candidates come from the
  opposite parity, which was updated in the previous half-sweep — the
  Gauss-Seidel data flow of the zig-zag sweep without its serialization
  (Gipuma/ACMM lineage).
- Long-range candidates use the HC-MVS cross pattern: offsets at distance
  1 and 1+k*propagatestep up to propagatehalfwin along both axes
  (ref: DepthMap.cpp:1064-1274).
- Random refinement uses the annealed scale ladder
  (ref: DepthMap.cpp:384 scaleRanges, :1441-1501).
- Neighbor-view depth/normal maps for the geometric term are frozen for
  the duration of an external iteration (double-buffered) instead of the
  reference's benignly-racy live reads (SURVEY §5.2).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from hcmvs_tpu.core.config import DenseConfig
from hcmvs_tpu.dense import score as S
from hcmvs_tpu.dense.types import (PatchMatchState, ViewGeometry,
                                   face_camera_t, init_state, normalize3,
                                   pixel_rays, tangent_frame)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ScoreContext:
    """Everything the cost function reads besides the hypothesis itself."""

    geom: ViewGeometry
    src_grays: jax.Array               # (V, H, W)
    stats: S.RefPatchStats
    hw: jax.Array                      # (H, W) adaptive half-window
    rays: jax.Array                    # (H, W, 3)
    gra: jax.Array                     # (H, W) gradient map
    d_min: jax.Array                   # scalar
    d_max: jax.Array                   # scalar
    flow: Optional[jax.Array]          # (2, H, W) or None
    prior_depth: Optional[jax.Array]   # (H, W) or None (0 = no prior)
    nbr_depth: Optional[jax.Array]     # (V, H, W) or None
    nbr_normal: Optional[jax.Array]    # (V, 3, H, W) or None
    inject_depth: Optional[jax.Array] = None   # (H, W) cross-scale
    inject_normal: Optional[jax.Array] = None  # (3, H, W) hypothesis maps
    vol: Optional[object] = None       # ops.volume.VolumeTables (V-batched)
                                       # routing exact scoring through the
                                       # sigma-sweep tables
    rect: Optional[object] = None      # ops.rect_gather.RectContext —
                                       # rectified-epipolar neighbor-map
                                       # lookups for the geo term and
                                       # view-spread (rebuilt per external
                                       # iteration with the snapshot)


def propagation_offsets(cfg: DenseConfig) -> list:
    """Static candidate offsets: the HC-MVS cross pattern
    (ref: DepthMap.cpp:1193-1199 — ±1 then ±(1+k*step) up to halfwin)."""
    dists = [1]
    d = 1 + cfg.propagate_step
    while d <= max(cfg.propagate_half_window, 1) + cfg.propagate_step - 1:
        dists.append(d)
        d += cfg.propagate_step
    offs = []
    for dist in dists:
        offs += [(0, dist), (0, -dist), (dist, 0), (-dist, 0)]
    return offs


def finish_cost(ctx: ScoreContext, ncc: jax.Array, bad: jax.Array,
                depth: jax.Array, normal: jax.Array,
                cur_depth_map: jax.Array, cur_normal_map: jax.Array,
                delta_c2pmax: jax.Array, cfg: DenseConfig,
                phase: int) -> jax.Array:
    """Everything after the photometric term: smoothness bonus, geometric
    / flow / local-smoothness blends, view aggregation, prior
    (ref: ScorePixelImage blending DepthMap.cpp:890-958 + ScorePixel
    aggregation :987-1046).  ``ncc``/``bad`` are (V, H, W)."""
    bonus = S.smoothness_bonus(cur_depth_map, cur_normal_map, ctx.rays,
                               depth, normal, cfg)
    # the bonus applies only to real matches: thRobust placeholders for
    # OOB/textureless views stay flat (ref early-returns, DepthMap.cpp:558)
    ncc = jnp.where(bad, ncc, ncc * bonus[None])

    use_geo = (phase >= 1 and cfg.use_geo_consistency
               and ctx.nbr_depth is not None)
    if use_geo:
        geo = S.geometric_scores(ctx.geom, depth, normal, ctx.rays,
                                 ctx.nbr_depth, ctx.nbr_normal, cfg,
                                 rect=ctx.rect)
        para_tapa, para_part = S.texture_weights(ctx.gra, cfg)
        gra_s = S.local_smoothness_score(cur_depth_map, cur_normal_map,
                                         ctx.rays, depth, normal, ctx.d_max,
                                         delta_c2pmax)
        per_view = (1.0 - para_tapa)[None] * ncc + para_tapa[None] * geo
        per_view = ((1.0 - para_part)[None] * per_view
                    + para_part[None] * gra_s[None])
    else:
        per_view = ncc

    if cfg.use_optical_flow and ctx.flow is not None:
        fs = S.flow_score(ctx.geom, depth, ctx.rays, ctx.flow, view_idx=0)
        w = cfg.photometric_flow
        per_view = per_view.at[0].set((1.0 - w) * per_view[0] + w * fs)

    agg = S.aggregate_scores(per_view, cfg)

    if phase >= 1 and ctx.prior_depth is not None:
        agg = S.prior_blend(agg, depth, ctx.prior_depth, cfg)
    return agg


def compute_cost(ctx: ScoreContext, depth: jax.Array, normal: jax.Array,
                 cur_depth_map: jax.Array, cur_normal_map: jax.Array,
                 delta_c2pmax: jax.Array, cfg: DenseConfig,
                 phase: int, offsets: np.ndarray) -> jax.Array:
    """Aggregated per-pixel cost of a hypothesis field (H, W) -> (H, W).

    ``phase`` 0 = photometric (it_ext < photo2geo), 1 = geometric.
    """
    ncc, bad = S.score_photometric(ctx.geom, ctx.src_grays, ctx.stats,
                                   ctx.hw, depth, normal, ctx.rays,
                                   offsets, cfg, phase, vol=ctx.vol)
    return finish_cost(ctx, ncc, bad, depth, normal, cur_depth_map,
                       cur_normal_map, delta_c2pmax, cfg, phase)


def _propagate_from(state_depth: jax.Array, state_normal: jax.Array,
                    rays: jax.Array, dy: int, dx: int):
    """Plane-propagate the hypothesis at (y+dy, x+dx) to (y, x):
    d = (n_nbr . X_nbr) / (n_nbr . ray)  (ref: InterpolatePixel /
    DepthMap.cpp:1277-1391 candidate harvesting)."""
    h, w = state_depth.shape
    pad = max(abs(dy), abs(dx))
    ys = slice(pad + dy, pad + dy + h)
    xs = slice(pad + dx, pad + dx + w)
    dm = jnp.pad(state_depth, pad, mode="edge")
    nm = jnp.pad(state_normal, ((0, 0), (pad, pad), (pad, pad)), mode="edge")
    rm = jnp.pad(rays, ((0, 0), (pad, pad), (pad, pad)), mode="edge")
    d_n = dm[ys, xs]
    n_n = nm[:, ys, xs]
    num = (n_n[0] * rm[0, ys, xs] + n_n[1] * rm[1, ys, xs]
           + n_n[2] * rm[2, ys, xs]) * d_n
    den = n_n[0] * rays[0] + n_n[1] * rays[1] + n_n[2] * rays[2]
    d_prop = num / jnp.where(jnp.abs(den) < 1e-9, 1e-9, den)
    return d_prop, n_n


def _perturb(key: jax.Array, depth: jax.Array, normal: jax.Array,
             rays: jax.Array, scale: float, cfg: DenseConfig):
    """Random plane perturbation at one refinement scale
    (ref: DepthMap.cpp:1441-1501 random assignment ladder)."""
    kd, k1, k2 = jax.random.split(key, 3)
    h, w = depth.shape
    # depth: multiplicative jitter; starts ~8x fRandomDepthRatio, anneals
    u = jax.random.uniform(kd, (h, w), minval=-1.0, maxval=1.0)
    d_new = depth * (1.0 + cfg.random_depth_ratio * 8.0 * scale * u)
    # normal: tilt by two annealed random angles in the tangent frame
    a1 = jnp.radians(cfg.random_angle1_range) * scale
    a2 = jnp.radians(cfg.random_angle2_range) * scale
    t1_ang = jax.random.uniform(k1, (h, w), minval=-a1, maxval=a1)
    t2_ang = jax.random.uniform(k2, (h, w), minval=-a2, maxval=a2)
    n = (normal[0], normal[1], normal[2])
    t1, t2 = tangent_frame(n)
    tt1 = jnp.tan(t1_ang)
    tt2 = jnp.tan(t2_ang)
    n_new = tuple(n[i] + t1[i] * tt1 + t2[i] * tt2 for i in range(3))
    n_new = normalize3(n_new)
    return d_new, jnp.stack(face_camera_t(n_new, (rays[0], rays[1],
                                                  rays[2])))


def _select_by_index(stack: jax.Array, k_star: jax.Array) -> jax.Array:
    """stack[k_star[p], ..., p] via an unrolled where-chain.

    The unrolled chain fuses into one elementwise pass over the K panels
    instead of a per-pixel gather along the candidate axis."""
    k_n = stack.shape[0]
    sel = stack[0]
    for k in range(1, k_n):
        m = k_star == k
        if stack.ndim == 4:                        # (K, 3, H, W) normals
            m = m[None]
        sel = jnp.where(m, stack[k], sel)
    return sel


def _batched_best(ctx: ScoreContext, cd: jax.Array, cn: jax.Array,
                  cv: jax.Array, biases, init, cur_d: jax.Array,
                  cur_n: jax.Array, delta_c2pmax: jax.Array,
                  cfg: DenseConfig, phase: int, offsets) -> tuple:
    """Score a (K, ...) candidate stack through the batched volume lookup
    and fold to (best_cost, best_index).

    The photometric term of all K candidates rides one multi-column
    lookup call per view; the remaining cost terms fold in a scan whose
    carry is just (cost, index) — the best candidate's fields are
    reconstructed from the stack by the caller.  ``biases`` (K,) are
    acceptance bonuses (the restore-variant 0.1 injection rule: candidate
    k wins when cost_k - bias_k beats the incumbent's RAW cost, and the
    raw cost is what gets stored).  ``init``: None starts from
    (inf, index -1); (cost0, None) starts from an incumbent cost with
    index -1 (callers treat -1 as "keep incumbent fields").
    """
    ncc_all, bad_all = S.photometric_scores_volume_batched(
        ctx.geom, ctx.vol, ctx.stats, ctx.hw, cd, cn, ctx.rays, offsets,
        cfg)
    k_n = cd.shape[0]
    h, w = cur_d.shape
    if biases is None:
        biases = jnp.zeros((k_n,), jnp.float32)
    if init is None:
        init = (jnp.full((h, w), jnp.inf, jnp.float32),
                jnp.full((h, w), -1, jnp.int32))
    elif init[1] is None:
        init = (init[0], jnp.full((h, w), -1, jnp.int32))

    def step(carry, xs):
        bc, bk = carry
        ncc_k, bad_k, d_k, n_k, v_k, b_k, kidx = xs
        c_k = finish_cost(ctx, ncc_k, bad_k, d_k, n_k, cur_d, cur_n,
                          delta_c2pmax, cfg, phase)
        c_k = jnp.where(v_k, c_k, jnp.inf)
        better = (c_k - b_k) < bc
        return (jnp.where(better, c_k, bc),
                jnp.where(better, kidx, bk)), None

    (bc, bk), _ = jax.lax.scan(
        step, init, (ncc_all, bad_all, cd, cn, cv, biases,
                     jnp.arange(k_n, dtype=jnp.int32)))
    return bc, bk


def half_sweep(state: PatchMatchState, ctx: ScoreContext, cfg: DenseConfig,
               phase: int, parity: int, offsets: np.ndarray,
               prop_offsets: list, inject: bool = False) -> PatchMatchState:
    """One checkerboard phase: pixels with (y+x)%2 == parity update.

    With cfg.sweep_mode == "jacobi", ``parity`` is ignored and EVERY pixel
    updates from the previous full state (Jacobi relaxation): the cost
    evaluations — which this data-parallel formulation computes over the
    whole image regardless of parity — all land on updated pixels, so a
    full update costs HALF of a red/black pair.  Propagation uses one-step
    staler neighbors; measured quality is equivalent at equal eval budget
    (tests/test_scene_dense.py), making it the production default.
    """
    h, w = state.depth.shape
    delta_c2pmax = jnp.max(jnp.abs(
        (state.normal[0] * ctx.rays[0] + state.normal[1] * ctx.rays[1]
         + state.normal[2] * ctx.rays[2]) * state.depth))
    cur_d, cur_n = state.depth, state.normal

    def cost_of(d, n):
        return compute_cost(ctx, d, n, cur_d, cur_n, delta_c2pmax, cfg,
                            phase, offsets)

    def consider(best, d_cand, n_cand, valid):
        bd, bn, bc = best
        c = jnp.where(valid, cost_of(d_cand, n_cand), jnp.inf)
        better = c < bc
        return (jnp.where(better, d_cand, bd),
                jnp.where(better[None], n_cand, bn),
                jnp.where(better, c, bc))

    # batched-lookup candidate path: the photometric term of EVERY
    # candidate rides one multi-column volume-lookup call per view
    # (score.photometric_scores_volume_batched); only active when exact
    # scoring would route through the tables for this phase
    exact_phase = (cfg.score_mode == "exact"
                   or (cfg.score_mode == "hybrid" and phase >= 1))
    use_batch = (S.use_candidate_batch(cfg) and ctx.vol is not None
                 and exact_phase)

    # propagation: stack the (cheap) candidate fields, scan the (expensive)
    # scoring so its graph is emitted once — compile time stays flat in the
    # number of candidates
    cand_d, cand_n, cand_v = [], [], []
    for dy, dx in prop_offsets:
        d_p, n_p = _propagate_from(cur_d, cur_n, ctx.rays, dy, dx)
        cand_d.append(d_p)
        cand_n.append(n_p)
        cand_v.append((d_p >= ctx.d_min * 0.8) & (d_p <= ctx.d_max * 1.2))

    # view-spread: harvest each neighbor view's hypothesis at this pixel's
    # projection and reproject it into the ref frame (ref:
    # OPTDENSE::viewspread, DepthMap.cpp:1504-1608).  Scored through the
    # same graph as the propagation candidates.
    if cfg.view_spread and ctx.nbr_depth is not None:
        vs_d, vs_n, vs_ok = S.view_spread_candidates(
            ctx.geom, cur_d, ctx.rays, ctx.nbr_depth, ctx.nbr_normal,
            rect=ctx.rect)
        vs_n = jnp.stack([jnp.stack(face_camera_t(
            (vs_n[v, 0], vs_n[v, 1], vs_n[v, 2]),
            (ctx.rays[0], ctx.rays[1], ctx.rays[2])))
            for v in range(vs_d.shape[0])])
        for v in range(vs_d.shape[0]):
            cand_d.append(vs_d[v])
            cand_n.append(vs_n[v])
            cand_v.append(vs_ok[v] & (vs_d[v] >= ctx.d_min * 0.8)
                          & (vs_d[v] <= ctx.d_max * 1.2))

    inject_fields = None
    if inject and ctx.inject_depth is not None:
        # cross-scale hypothesis fields (ref: restore/libs/MVS/
        # DepthMap.cpp:1527-1549): the upsampled previous-stage
        # (depth, normal), accepted with a 0.1 score bonus against the
        # incumbent's raw cost (conf > nconf - 0.1); stored cost stays
        # unbonused.
        d_i = ctx.inject_depth
        n_i = jnp.stack(face_camera_t(
            (ctx.inject_normal[0], ctx.inject_normal[1],
             ctx.inject_normal[2]),
            (ctx.rays[0], ctx.rays[1], ctx.rays[2])))
        ok_i = ((d_i > 0) & (d_i >= ctx.d_min * 0.8)
                & (d_i <= ctx.d_max * 1.2))
        inject_fields = (d_i, n_i, ok_i)

    if use_batch:
        # current state is candidate 0; every candidate's photometric
        # term comes from ONE batched table lookup per view, and the
        # fold carries only (cost, argmin-index) — the 5-plane best-state
        # scan carry of the per-candidate path was measured at ~20% of
        # the flagship device round (r4 roofline)
        cd = jnp.concatenate([cur_d[None], jnp.stack(cand_d)])
        cn = jnp.concatenate([cur_n[None], jnp.stack(cand_n)])
        cv = jnp.concatenate([jnp.ones_like(cur_d, bool)[None],
                              jnp.stack(cand_v)])
        bc, bk = _batched_best(ctx, cd, cn, cv, None, None, cur_d, cur_n,
                               delta_c2pmax, cfg, phase, offsets)
        bk = jnp.maximum(bk, 0)
        best = (_select_by_index(cd, bk), _select_by_index(cn, bk), bc)
    elif cfg.batch_candidates:
        best = (state.depth, state.normal,
                cost_of(state.depth, state.normal))
        # evaluate every propagation candidate in ONE vmapped cost graph:
        # bigger fused ops keep the VPU fed (the scan variant evaluates
        # candidates serially); memory cost is C x (V, H, W) intermediates
        cd = jnp.stack(cand_d)
        cn = jnp.stack(cand_n)
        cv = jnp.stack(cand_v)
        costs = jax.vmap(cost_of)(cd, cn)            # (C, H, W)
        costs = jnp.where(cv, costs, jnp.inf)
        bd, bn, bc = best
        all_c = jnp.concatenate([bc[None], costs])
        all_d = jnp.concatenate([bd[None], cd])
        all_n = jnp.concatenate([bn[None], cn])
        k = jnp.argmin(all_c, axis=0)                # (H, W)
        kn = jnp.broadcast_to(k[None, None], (1, 3) + k.shape)
        best = (jnp.take_along_axis(all_d, k[None], 0)[0],
                jnp.take_along_axis(all_n, kn, 0)[0],
                jnp.take_along_axis(all_c, k[None], 0)[0])
    else:
        # carry-FREE candidate scan: emit each candidate's cost as a
        # stacked output and reconstruct the winner from the candidate
        # stacks by argmin index.  The former fold carried the 5-plane
        # (depth, normal, cost) best state through every step — measured
        # at 0.90s of scan-carry copies per flagship round (r4 roofline).
        cd = jnp.concatenate([cur_d[None], jnp.stack(cand_d)])
        cn = jnp.concatenate([cur_n[None], jnp.stack(cand_n)])
        cv = jnp.concatenate([jnp.ones_like(cur_d, bool)[None],
                              jnp.stack(cand_v)])

        def prop_step(_, cand):
            d_p, n_p, valid = cand
            return None, jnp.where(valid, cost_of(d_p, n_p), jnp.inf)

        _, costs = jax.lax.scan(prop_step, None, (cd, cn, cv))
        k = jnp.argmin(costs, axis=0)                # (H, W)
        best = (_select_by_index(cd, k), _select_by_index(cn, k),
                jnp.min(costs, axis=0))

    # annealed random refinement: scan with traced per-step scale
    key, *subs = jax.random.split(state.key, cfg.random_iters + 1)
    scales = 0.5 ** jnp.arange(cfg.random_iters, dtype=jnp.float32)

    if use_batch and cfg.refine_batched:
        # all annealed scales perturb the POST-PROPAGATION best and score
        # as one batched candidate set (one more table pass instead
        # of R); the cross-scale injection joins this batch with its 0.1
        # bias, so it is still compared against the refined incumbent
        bd, bn, bc = best
        r_d, r_n, r_v, r_b = [], [], [], []
        if cfg.random_iters:
            rd, rn = jax.vmap(
                lambda kk, sc: _perturb(kk, bd, bn, ctx.rays, sc, cfg))(
                    jnp.stack(subs), scales)
            for r in range(cfg.random_iters):
                r_d.append(rd[r])
                r_n.append(rn[r])
                r_v.append((rd[r] >= ctx.d_min * 0.8)
                           & (rd[r] <= ctx.d_max * 1.2))
                r_b.append(0.0)
        if inject_fields is not None:
            r_d.append(inject_fields[0])
            r_n.append(inject_fields[1])
            r_v.append(inject_fields[2])
            r_b.append(0.1)
        if r_d:
            rd_s = jnp.stack(r_d)
            rn_s = jnp.stack(r_n)
            rv_s = jnp.stack(r_v)
            bc2, bk2 = _batched_best(
                ctx, rd_s, rn_s, rv_s,
                jnp.asarray(r_b, jnp.float32), (bc, None), cur_d, cur_n,
                delta_c2pmax, cfg, phase, offsets)
            sel = jnp.maximum(bk2, 0)
            nd = _select_by_index(rd_s, sel)
            nn = _select_by_index(rn_s, sel)
            upd = bk2 >= 0
            best = (jnp.where(upd, nd, bd),
                    jnp.where(upd[None], nn, bn), bc2)
    elif cfg.refine_batched:
        # same batched-from-base refinement semantics on the scan path:
        # all annealed scales perturb the post-propagation best, scored
        # by a carry-free scan, winner by (bias-adjusted) argmin
        bd, bn, bc = best
        r_d, r_n, r_v, r_b = [], [], [], []
        if cfg.random_iters:
            rd, rn = jax.vmap(
                lambda kk, sc: _perturb(kk, bd, bn, ctx.rays, sc, cfg))(
                    jnp.stack(subs), scales)
            for r in range(cfg.random_iters):
                r_d.append(rd[r])
                r_n.append(rn[r])
                r_v.append((rd[r] >= ctx.d_min * 0.8)
                           & (rd[r] <= ctx.d_max * 1.2))
                r_b.append(0.0)
        if inject_fields is not None:
            r_d.append(inject_fields[0])
            r_n.append(inject_fields[1])
            r_v.append(inject_fields[2])
            r_b.append(0.1)
        if r_d:
            rd_s = jnp.stack(r_d)
            rn_s = jnp.stack(r_n)
            rv_s = jnp.stack(r_v)
            rb_s = jnp.asarray(r_b, jnp.float32)

            def r_step(_, x):
                d_r, n_r, v_r = x
                return None, jnp.where(v_r, cost_of(d_r, n_r), jnp.inf)

            _, rc = jax.lax.scan(r_step, None, (rd_s, rn_s, rv_s))
            eff = jnp.concatenate([bc[None],
                                   rc - rb_s[:, None, None]])
            raw = jnp.concatenate([bc[None], rc])
            all_d = jnp.concatenate([bd[None], rd_s])
            all_n = jnp.concatenate([bn[None], rn_s])
            k2 = jnp.argmin(eff, axis=0)
            best = (_select_by_index(all_d, k2),
                    _select_by_index(all_n, k2),
                    _select_by_index(raw, k2))
    else:
        def refine_step(best, inp):
            sub, scale = inp
            d_r, n_r = _perturb(sub, best[0], best[1], ctx.rays, scale, cfg)
            valid = (d_r >= ctx.d_min * 0.8) & (d_r <= ctx.d_max * 1.2)
            return consider(best, d_r, n_r, valid), None

        if cfg.random_iters:
            best, _ = jax.lax.scan(refine_step, best,
                                   (jnp.stack(subs), scales))

        if inject_fields is not None:
            d_i, n_i, ok = inject_fields
            c_i = jnp.where(ok, cost_of(d_i, n_i), jnp.inf)
            bd, bn, bc = best
            better = (c_i - 0.1) < bc
            best = (jnp.where(better, d_i, bd),
                    jnp.where(better[None], n_i, bn),
                    jnp.where(better, c_i, bc))

    bd, bn, bc = best
    if cfg.sweep_mode == "jacobi":
        return PatchMatchState(depth=bd, normal=bn, cost=bc, key=key)
    yy, xx = jnp.meshgrid(jnp.arange(h), jnp.arange(w), indexing="ij")
    mask = ((yy + xx) % 2) == parity
    return PatchMatchState(
        depth=jnp.where(mask, bd, state.depth),
        normal=jnp.where(mask[None], bn, state.normal),
        cost=jnp.where(mask, bc, state.cost),
        key=key)


@partial(jax.jit, static_argnames=("cfg", "phase", "n_iters"))
def run_sweeps(state: PatchMatchState, ctx: ScoreContext, cfg: DenseConfig,
               phase: int, n_iters: int) -> PatchMatchState:
    """``n_iters`` full red/black sweeps at a fixed phase (jitted; the
    external loop lives in the driver so phases keep static configs)."""
    offsets = S.patch_offsets(cfg)
    prop_offsets = propagation_offsets(cfg)

    def one_iter(i, st):
        st = half_sweep(st, ctx, cfg, phase, 0, offsets, prop_offsets)
        if cfg.sweep_mode != "jacobi":
            st = half_sweep(st, ctx, cfg, phase, 1, offsets, prop_offsets)
        return st

    return jax.lax.fori_loop(0, n_iters, one_iter, state)


def make_context(geom: ViewGeometry, ref_gray: jax.Array,
                 src_grays: jax.Array, d_min: float, d_max: float,
                 cfg: DenseConfig, flow: Optional[jax.Array] = None,
                 prior_depth: Optional[jax.Array] = None,
                 nbr_depth: Optional[jax.Array] = None,
                 nbr_normal: Optional[jax.Array] = None) -> ScoreContext:
    from hcmvs_tpu.ops.gradients import sobel_magnitude
    h, w = ref_gray.shape
    gra = sobel_magnitude(ref_gray)
    hw = S.halfwin_map(gra, cfg)
    offsets = S.patch_offsets(cfg)
    stats = S.ref_patch_stats(ref_gray, hw, offsets)
    rays = pixel_rays(geom.K_inv_ref, h, w)
    return ScoreContext(
        geom=geom, src_grays=src_grays, stats=stats, hw=hw, rays=rays,
        gra=gra, d_min=jnp.asarray(d_min, jnp.float32),
        d_max=jnp.asarray(d_max, jnp.float32), flow=flow,
        prior_depth=prior_depth, nbr_depth=nbr_depth, nbr_normal=nbr_normal)


def estimate_depth_map(key: jax.Array, geom: ViewGeometry,
                       ref_gray: jax.Array, src_grays: jax.Array,
                       d_min: float, d_max: float, cfg: DenseConfig,
                       init: Optional[PatchMatchState] = None,
                       **ctx_kwargs) -> PatchMatchState:
    """Single-view estimation driver: the minimum end-to-end slice
    (ref: DepthMapsData::EstimateDepthMap, SceneDensify.cpp:758-1072).

    Runs ``estimation_iters`` inner sweeps per external iteration; the
    geometric phase switches on at external iteration ``photo2geo``.
    Multi-view coupling (neighbor maps, priors, fusion) is orchestrated by
    the scene-level driver in dense/pipeline.py.
    """
    ctx = make_context(geom, ref_gray, src_grays, d_min, d_max, cfg,
                       **ctx_kwargs)
    state = init if init is not None else init_state(
        key, ctx.rays, d_min, d_max)
    for it_ext in range(cfg.estimation_iters_external):
        phase = 1 if it_ext >= cfg.photo2geo else 0
        state = run_sweeps(state, ctx, cfg, phase, cfg.estimation_iters)
    return state


def confidence_from_cost(state: PatchMatchState,
                         cfg: DenseConfig) -> tuple:
    """Final thresholding: conf = 1 - cost, invalidate weak matches
    (ref: EndDepthMapTmp, SceneDensify.cpp:688-744)."""
    keep = state.cost <= cfg.ncc_threshold_keep
    depth = jnp.where(keep, state.depth, 0.0)
    conf = jnp.where(keep, jnp.maximum(1.0 - state.cost, 0.0), 0.0)
    return depth, state.normal, conf
