"""BA scalability benchmark: 200 cameras / 200k points / ~1M observations.

The reference delegates BA to Ceres inside OpenMVG
(ref: frame_main/MvgMvsPipeline.py:190-192 openMVG_main_IncrementalSfM);
its problems reach hundreds of cameras and millions of observations.  The
matrix-free Schur + PCG solver (sfm/ba.py) must converge such sizes in
seconds per LM iteration — this harness measures it.

    python -m hcmvs_tpu.eval.ba_bench            # default device
"""

from __future__ import annotations

import json
import time

import numpy as np


def make_problem(n_cams: int = 200, n_pts: int = 200_000,
                 obs_per_pt: int = 5, seed: int = 0,
                 noise_px: float = 0.5, init_pt_noise: float = 0.02,
                 init_cam_noise: float = 0.002):
    """Synthetic city-block scene: cameras on a ring looking inward,
    points in the interior, each point seen by ``obs_per_pt`` nearby
    cameras."""
    from hcmvs_tpu.sfm.ba import BAState, build_problem, rotation_to_rvec
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    # cameras on a circle of radius 6, looking at the origin
    ang = np.linspace(0, 2 * np.pi, n_cams, endpoint=False)
    C = np.stack([6 * np.cos(ang), 6 * np.sin(ang),
                  rng.normal(0, 0.2, n_cams)], axis=1)
    fwd = -C / np.linalg.norm(C, axis=1, keepdims=True)
    up = np.tile(np.array([0.0, 0.0, 1.0]), (n_cams, 1))
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right, axis=1, keepdims=True)
    up2 = np.cross(right, fwd)
    R = np.stack([right, -up2, fwd], axis=1)          # world->cam rows
    X = rng.uniform(-2.5, 2.5, (n_pts, 3))
    K = np.array([[800.0, 0, 640], [0, 800.0, 480], [0, 0, 1]], np.float32)

    # each point observed by obs_per_pt cameras nearest its azimuth
    pt_ang = np.arctan2(X[:, 1], X[:, 0])
    base = np.round(pt_ang / (2 * np.pi) * n_cams).astype(int)
    offs = np.arange(obs_per_pt) - obs_per_pt // 2
    obs_cam = ((base[:, None] + offs[None]) % n_cams).reshape(-1)
    obs_pt = np.repeat(np.arange(n_pts), obs_per_pt)

    Xc = np.einsum("mij,mj->mi", R[obs_cam], X[obs_pt] - C[obs_cam])
    uv = (Xc[:, :2] / Xc[:, 2:]) * K[0, 0] + np.array([K[0, 2], K[1, 2]])
    ok = Xc[:, 2] > 0.5
    obs_cam, obs_pt, uv = obs_cam[ok], obs_pt[ok], uv[ok]
    uv = uv + rng.normal(0, noise_px, uv.shape)

    problem = build_problem(np.tile(K[None], (n_cams, 1, 1)), obs_cam,
                            obs_pt, uv, n_pts,
                            fixed_cams=[i < 2 for i in range(n_cams)])
    rvecs = np.stack([rotation_to_rvec(R[i]) for i in range(n_cams)])
    rvecs = rvecs + rng.normal(0, init_cam_noise, rvecs.shape)
    rvecs[:2] = np.stack([rotation_to_rvec(R[i]) for i in range(2)])
    tvecs = -np.einsum("mij,mj->mi", R, C)
    tvecs[2:] += rng.normal(0, init_cam_noise * 10, tvecs[2:].shape)
    pts0 = X + rng.normal(0, init_pt_noise, X.shape)
    state = BAState(rvecs=jnp.asarray(rvecs, jnp.float32),
                    tvecs=jnp.asarray(tvecs, jnp.float32),
                    points=jnp.asarray(pts0, jnp.float32))
    return problem, state, len(obs_cam)


def main(n_cams: int = 200, n_pts: int = 200_000, n_iters: int = 8):
    import jax
    from hcmvs_tpu.sfm.ba import ba_cost, ba_step, run_ba
    from hcmvs_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    problem, state, m = make_problem(n_cams, n_pts)
    c0 = float(ba_cost(problem, state))

    # warm the executable, then time one LM trial step (the unit the
    # reference's Ceres logs report per-iteration)
    import jax.numpy as jnp
    jax.block_until_ready(ba_step(problem, state, jnp.float32(1e-3)))
    t0 = time.time()
    jax.block_until_ready(ba_step(problem, state, jnp.float32(1e-3)))
    step_s = time.time() - t0

    t0 = time.time()
    state, cost = run_ba(problem, state, n_iters=n_iters)
    total_s = time.time() - t0
    rms0 = (c0 / m) ** 0.5
    rms = (cost / m) ** 0.5
    print(json.dumps({
        "metric": "ba_iteration_time",
        "cams": n_cams, "points": n_pts, "observations": m,
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "step_seconds": step_s,
        "iters": n_iters, "total_seconds": total_s,
        "rms_px_before": round(rms0, 3), "rms_px_after": round(rms, 3),
    }))


if __name__ == "__main__":
    main()
