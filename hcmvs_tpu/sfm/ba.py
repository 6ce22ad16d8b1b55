"""Bundle adjustment: LM with a matrix-free Schur complement + PCG.

Replaces the incremental BA inside OpenMVG (ref: MvgMvsPipeline.py:190-192
openMVG_main_IncrementalSfM, which uses Ceres on CPU).  Accelerator shape:

- Per-observation reprojection Jacobians come from ``jax.jacfwd`` of the
  single-observation residual, vmapped over all observations at once —
  everything is O(M) in the observation count, no per-point tables, no
  observation truncation.
- The point blocks (3x3) are eliminated analytically.  The reduced camera
  system S = U + lam*diag - W V^-1 W^T is NEVER materialized: S @ x is
  three segment-sum passes over the observations (camera-gather ->
  point-reduce -> camera-reduce), so memory stays O(M + P + C) at any
  scale.  Under a sharded mesh the segment sums become psums over
  observation shards — the distributed Schur complement (SURVEY §2.3).
- The reduced system is solved with block-Jacobi-preconditioned CG on the
  matrix-free operator (Ceres' ITERATIVE_SCHUR + SCHUR_JACOBI analog).
  Small problems (C <= 24) instead materialize S by applying the operator
  to the 6C identity basis and solve directly — exact, still O(M) memory.

All shapes are static: observations are padded to M slots with a validity
mask.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def rodrigues(rvec: jax.Array) -> jax.Array:
    """(3,) axis-angle -> (3, 3) rotation.

    Smooth (autodiff-safe) formulation: R = I + sinc(t) K + c(t) K^2 with
    the *unnormalized* skew — the normalized-axis form has a NaN gradient
    at rvec = 0 (d||v||/dv), which silently poisons Gauss-Newton steps
    that start at the identity.
    """
    t2 = jnp.sum(rvec ** 2)
    theta = jnp.sqrt(t2 + 1e-16)
    a = jnp.sin(theta) / theta
    b = (1.0 - jnp.cos(theta)) / (t2 + 1e-16)
    K = jnp.array([[0.0, -rvec[2], rvec[1]],
                   [rvec[2], 0.0, -rvec[0]],
                   [-rvec[1], rvec[0], 0.0]])
    return jnp.eye(3) + a * K + b * (K @ K)


def rotation_to_rvec(R: np.ndarray) -> np.ndarray:
    """Host-side inverse Rodrigues (stable across the full angle range).

    The antisymmetric-part formula divides by sin(theta) and collapses
    near theta = pi (half-turns — e.g. cameras on the far side of an
    orbit); there the axis comes from the dominant column of R + I
    instead, with signs disambiguated by the antisymmetric part.
    """
    cos_t = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos_t)
    if theta < 1e-8:
        return np.zeros(3)
    anti = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                     R[1, 0] - R[0, 1]])
    na = np.linalg.norm(anti)
    # branch on cos_t, NOT theta: arccos amplifies float noise near -1,
    # so a theta test can route a true half-turn into the sin branch
    # (where anti ~ 0 silently yields rvec ~ 0)
    if cos_t > -0.999:
        # anti = 2 sin(t) * axis: direction is robust; NORMALIZE rather
        # than divide by sin(theta) (theta noise inflates the norm)
        return anti / na * theta
    # near pi: R + I = (1 + cos t) I + (1 - cos t) a a^T -> columns are
    # ~parallel to the axis; take the largest diagonal for conditioning,
    # and recover theta from |anti| = 2 sin(t) (arcsin is well-behaved
    # where arccos is not)
    A = R + np.eye(3)
    k = int(np.argmax(np.diag(A)))
    axis = A[:, k]
    axis = axis / np.linalg.norm(axis)
    # sign: slightly below pi the antisymmetric part is still 2 sin(t) a
    # — align with it (at exactly pi either sign is valid)
    if np.dot(axis, anti) < 0:
        axis = -axis
    theta = np.pi - np.arcsin(np.clip(na / 2.0, 0.0, 1.0))
    return axis * theta


class BAProblem(NamedTuple):
    """Static-shape BA problem (host-assembled)."""

    K: jax.Array            # (C, 3, 3) fixed intrinsics
    obs_cam: jax.Array      # (M,) int32
    obs_pt: jax.Array       # (M,) int32
    obs_uv: jax.Array       # (M, 2)
    obs_valid: jax.Array    # (M,) bool
    fixed_cams: jax.Array   # (C,) bool — gauge fixing
    dist: jax.Array         # (3,) shared Brown radial k1..k3 applied to
                            # the PREDICTED projection so residuals live
                            # in the raw (distorted) measurement space —
                            # zeros = pinhole (the pre-round-4 behavior)


class BAState(NamedTuple):
    rvecs: jax.Array        # (C, 3)
    tvecs: jax.Array        # (C, 3)  (world->cam: X_c = R X + t)
    points: jax.Array       # (P, 3)


def build_problem(K, obs_cam, obs_pt, obs_uv, n_points,
                  fixed_cams, dist=None) -> BAProblem:
    """Host-side assembly (``n_points`` fixes the point-state size).

    ``dist``: optional (3,) Brown radial coefficients held FIXED during
    the pose/point solve (the distortion half of the alternation lives in
    sfm/distortion.py); with it set, ``obs_uv`` must be the RAW distorted
    pixel observations."""
    del n_points
    obs_cam = np.asarray(obs_cam, np.int32)
    obs_pt = np.asarray(obs_pt, np.int32)
    obs_uv = np.asarray(obs_uv, np.float32)
    # observations sorted by point id: the point-side segment reductions
    # in ba_step (the Schur operator runs two per CG iteration) then
    # lower with indices_are_sorted=True instead of scatter-adds
    order = np.argsort(obs_pt, kind="stable")
    obs_cam, obs_pt, obs_uv = obs_cam[order], obs_pt[order], obs_uv[order]
    return BAProblem(
        K=jnp.asarray(K, jnp.float32),
        obs_cam=jnp.asarray(obs_cam), obs_pt=jnp.asarray(obs_pt),
        obs_uv=jnp.asarray(obs_uv),
        obs_valid=jnp.ones(len(obs_cam), bool),
        fixed_cams=jnp.asarray(np.asarray(fixed_cams, bool)),
        dist=(jnp.zeros(3, jnp.float32) if dist is None
              else jnp.asarray(dist, jnp.float32)))


def _residual_one(K, dist, rvec, tvec, X, uv):
    R = rodrigues(rvec)
    Xc = R @ X + tvec
    z = jnp.where(jnp.abs(Xc[2]) < 1e-9, 1e-9, Xc[2])
    xn0 = Xc[0] / z
    xn1 = Xc[1] / z
    # Brown radial distortion of the prediction (dist == 0 -> identity)
    r2 = xn0 * xn0 + xn1 * xn1
    fac = 1.0 + r2 * (dist[0] + r2 * (dist[1] + r2 * dist[2]))
    xn0 = xn0 * fac
    xn1 = xn1 * fac
    u = K[0, 0] * xn0 + K[0, 1] * xn1 + K[0, 2]
    v = K[1, 1] * xn1 + K[1, 2]
    return jnp.stack([u, v]) - uv


def _huber_weight(r2: jax.Array, delta: float) -> jax.Array:
    r = jnp.sqrt(jnp.maximum(r2, 1e-18))
    return jnp.where(r <= delta, 1.0, delta / r)


def _highest_precision(fn):
    """Trace-time matmul-precision pin: accelerator f32 matmuls may run
    at reduced input precision (TF32 on Hopper), and at reduced precision
    the PCG inner products / tiny 3x3 point solves stall LM convergence.
    Pinned, an LM step matches the CPU's cost (checked on the GPU by
    chip_smoke.py)."""
    from functools import wraps

    @wraps(fn)
    def wrapper(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)
    return wrapper


@partial(jax.jit, static_argnames=("huber_delta",))
@_highest_precision
def ba_cost(problem: BAProblem, state: BAState,
            huber_delta: float = 4.0) -> jax.Array:
    def res(o_cam, o_pt, o_uv):
        return _residual_one(problem.K[o_cam], problem.dist,
                             state.rvecs[o_cam],
                             state.tvecs[o_cam], state.points[o_pt], o_uv)

    r = jax.vmap(res)(problem.obs_cam, problem.obs_pt, problem.obs_uv)
    r2 = jnp.sum(r ** 2, axis=-1)
    w = _huber_weight(r2, huber_delta)
    rho = jnp.where(jnp.sqrt(r2) <= huber_delta, r2,
                    2 * huber_delta * jnp.sqrt(r2) - huber_delta ** 2)
    return jnp.sum(rho * problem.obs_valid)


@partial(jax.jit, static_argnames=("huber_delta", "solver", "cg_iters"))
@_highest_precision
def ba_step(problem: BAProblem, state: BAState, lam: jax.Array,
            huber_delta: float = 4.0, solver: str = "auto",
            cg_iters: int = 0) -> BAState:
    """One damped Gauss-Newton step via Schur elimination of the points.

    ``solver``: "cg" = block-Jacobi-preconditioned CG on the matrix-free
    reduced operator (scales to hundreds of cameras / millions of
    observations); "dense" = materialize S through the operator and solve
    exactly (small problems); "auto" = dense when 6C <= 144 else cg.
    """
    C = state.rvecs.shape[0]
    P = state.points.shape[0]
    if solver == "auto":
        solver = "dense" if C <= 24 else "cg"

    def res_jac(o_cam, o_pt, o_uv):
        def f(cam6, X):
            return _residual_one(problem.K[o_cam], problem.dist,
                                 cam6[:3], cam6[3:], X, o_uv)
        cam6 = jnp.concatenate([state.rvecs[o_cam], state.tvecs[o_cam]])
        X = state.points[o_pt]
        r = f(cam6, X)
        Jc, Jp = jax.jacfwd(f, argnums=(0, 1))(cam6, X)
        return r, Jc, Jp

    r, Jc, Jp = jax.vmap(res_jac)(problem.obs_cam, problem.obs_pt,
                                  problem.obs_uv)     # (M,2) (M,2,6) (M,2,3)
    w = _huber_weight(jnp.sum(r ** 2, -1), huber_delta)
    w = w * problem.obs_valid
    # zero out fixed cameras' jacobians (gauge)
    free = ~problem.fixed_cams[problem.obs_cam]
    Jc = Jc * free[:, None, None]

    wJc = Jc * w[:, None, None]
    wJp = Jp * w[:, None, None]
    U = jax.ops.segment_sum(jnp.einsum("mri,mrj->mij", wJc, Jc),
                            problem.obs_cam, C)        # (C, 6, 6)
    V = jax.ops.segment_sum(jnp.einsum("mri,mrj->mij", wJp, Jp),
                            problem.obs_pt, P,
                            indices_are_sorted=True)         # (P, 3, 3)
    Wm = jnp.einsum("mri,mrj->mij", wJc, Jp)           # (M, 6, 3)
    bc = -jax.ops.segment_sum(jnp.einsum("mri,mr->mi", wJc, r),
                              problem.obs_cam, C)      # (C, 6)
    bp = -jax.ops.segment_sum(jnp.einsum("mri,mr->mi", wJp, r),
                              problem.obs_pt, P,
                              indices_are_sorted=True)       # (P, 3)

    # damp + invert point blocks (LM: scale-aware diagonal damping)
    diagV = jnp.maximum(jax.vmap(jnp.diag)(V), 1e-6)    # (P, 3)
    V = V + lam * jax.vmap(jnp.diag)(diagV)
    V_inv = jnp.linalg.inv(V + 1e-9 * jnp.eye(3)[None])

    # LM-damped camera blocks; fixed cameras become identity rows
    fixed = problem.fixed_cams
    diagU = jax.vmap(jnp.diag)(U)
    U_damp = U + lam * jax.vmap(jnp.diag)(jnp.maximum(diagU, 1e-6))

    obs_cam, obs_pt = problem.obs_cam, problem.obs_pt

    def schur_apply(x):                                 # x (C, 6) -> (C, 6)
        """S @ x matrix-free: S = U' - W V^-1 W^T with identity rows for
        fixed cameras.  Three O(M) passes; a camera never observes a point
        twice, so no same-pair corrections are needed."""
        x_free = jnp.where(fixed[:, None], 0.0, x)
        ux = jnp.einsum("cij,cj->ci", U_damp, x_free)
        y = jnp.einsum("mij,mi->mj", Wm, x_free[obs_cam])      # (M, 3)
        s = jax.ops.segment_sum(y, obs_pt, P, indices_are_sorted=True)                   # (P, 3)
        z = jnp.einsum("pij,pj->pi", V_inv, s)                  # (P, 3)
        back = jax.ops.segment_sum(
            jnp.einsum("mij,mj->mi", Wm, z[obs_pt]), obs_cam, C)
        out = ux - back
        return jnp.where(fixed[:, None], x, out)

    # rhs_c' = bc - sum_m W_m (V^-1 bp)[pt_m]
    vb = jnp.einsum("pij,pj->pi", V_inv, bp)            # (P, 3)
    rhs_c = bc - jax.ops.segment_sum(
        jnp.einsum("mij,mj->mi", Wm, vb[obs_pt]), obs_cam, C)
    rhs_c = jnp.where(fixed[:, None], 0.0, rhs_c)

    if solver == "dense":
        # exact: materialize S by applying the operator to the 6C basis
        basis = jnp.eye(6 * C).reshape(6 * C, C, 6)
        Sd = jax.vmap(schur_apply)(basis).reshape(6 * C, 6 * C).T
        dc = jnp.linalg.solve(Sd + 1e-9 * jnp.eye(6 * C),
                              rhs_c.reshape(-1)).reshape(C, 6)
    else:
        # block-Jacobi preconditioner: diag blocks of S are
        # U' - sum_{m in c} W_m V^-1 W_m^T (each point seen once per cam)
        WVW = jnp.einsum("mij,mjk,mlk->mil", Wm, V_inv[obs_pt], Wm)
        D = U_damp - jax.ops.segment_sum(WVW, obs_cam, C)   # (C, 6, 6)
        D = jnp.where(fixed[:, None, None], jnp.eye(6)[None], D)
        D_inv = jnp.linalg.inv(D + 1e-8 * jnp.eye(6)[None])

        def precond(x):
            return jnp.einsum("cij,cj->ci", D_inv, x)

        # CG budget (200 cams / 1M obs, sorted layout): cg=60/24/16/10
        # ALL converge to the identical 0.5911 px after 8 LM iterations
        # — the block-Jacobi preconditioner is strong enough that tol
        # never triggers and maxiter is the real control, and the step
        # time grows with it.  16 = 2x safety margin; LM's
        # accept/reject loop protects against a truncated step on
        # harder problems (inexact-Newton).
        n_cg = cg_iters if cg_iters else min(16, 6 * C)
        dc, _ = jax.scipy.sparse.linalg.cg(
            schur_apply, rhs_c, M=precond, tol=1e-6, maxiter=n_cg)

    # back-substitute points: dp_j = V^-1 (bp - sum_i W_ij^T dc_i)
    dc_obs = dc[obs_cam]                                # (M, 6)
    Wt_dc = jnp.einsum("mij,mi->mj", Wm, dc_obs)        # (M, 3)
    acc = jax.ops.segment_sum(Wt_dc, obs_pt, P, indices_are_sorted=True)
    dp = jnp.einsum("pij,pj->pi", V_inv, bp - acc)

    return BAState(rvecs=state.rvecs + dc[:, :3],
                   tvecs=state.tvecs + dc[:, 3:],
                   points=state.points + dp)


def run_ba(problem: BAProblem, state: BAState, n_iters: int = 20,
           init_lambda: float = 1e-3, verbose: bool = False,
           cg_iters: int = 0) -> Tuple[BAState, float]:
    """LM driver (host loop; each trial step is one jitted program)."""
    lam = init_lambda
    cost = float(ba_cost(problem, state))
    for it in range(n_iters):
        trial = ba_step(problem, state, jnp.float32(lam),
                        cg_iters=cg_iters)
        new_cost = float(ba_cost(problem, trial))
        if new_cost < cost:
            state = trial
            cost = new_cost
            lam = max(lam * 0.5, 1e-8)
        else:
            lam = min(lam * 4.0, 1e4)
        if verbose:
            print(f"[ba] iter {it} cost {cost:.4f} lam {lam:.1e}")
        if lam >= 1e4:
            break
    return state, cost
