"""Multi-chip sharding tests on a virtual 8-device CPU mesh.

The driver's dryrun_multichip covers compile+execute; these tests verify
that the sharded computation produces the SAME numbers as single-device
execution (GSPMD inserting collectives must not change semantics)."""

import os

import numpy as np
import pytest

# must be set before the first jax device query; conftest already forces
# the cpu platform
os.environ.setdefault("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in os.environ["XLA_FLAGS"]:
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402

from hcmvs_tpu.core.camera import Camera                     # noqa: E402
from hcmvs_tpu.core.config import DenseConfig                # noqa: E402
from hcmvs_tpu.dense.scene_driver import (SceneTensors,      # noqa: E402
                                          init_scene_state, scene_sweeps)
from hcmvs_tpu.parallel.sharding import (make_device_mesh,   # noqa: E402
                                         shard_scene)

from synthetic import make_plane_scene                       # noqa: E402


def _tiny_scene(n_views=8, h=32, w=48):
    sc = make_plane_scene(np.random.default_rng(0), h=h, w=w,
                          n_views=n_views)
    cams = Camera(K=jnp.stack([c.K for c in sc.cameras]),
                  R=jnp.stack([c.R for c in sc.cameras]),
                  C=jnp.stack([c.C for c in sc.cameras]))
    v = 2
    nbr = np.array([[j for j in range(n_views) if j != i][:v]
                    for i in range(n_views)], np.int32)
    return SceneTensors(
        gray=jnp.stack([jnp.asarray(im) for im in sc.images]),
        cams=cams, nbr_idx=jnp.asarray(nbr),
        nbr_valid=jnp.ones((n_views, v), bool),
        d_min=jnp.full((n_views,), sc.d_min, jnp.float32),
        d_max=jnp.full((n_views,), sc.d_max, jnp.float32))


@pytest.mark.parametrize("n_view,n_tile,backends",
                         [(8, 1, "direct"), (4, 2, "direct"),
                          (8, 1, "rect")])
def test_sharded_sweeps_match_single_device(n_view, n_tile, backends,
                                            eight_devices):
    """scene_sweeps under a (view, tile) mesh == unsharded execution.

    The "rect" variant forces the rectified-epipolar geo backend and the
    rect-frame volume build (their XLA replicas on CPU) so GSPMD
    partitioning of the blocked/padded rect layouts is exercised too."""
    scene = _tiny_scene()
    cfg = DenseConfig(adapt_half_window=3, patch_half_window=3,
                      patch_step=2, estimation_iters=1, random_iters=1,
                      use_optical_flow=0, use_geo_consistency=1,
                      use_part_consistency=0)
    if backends == "rect":
        cfg = cfg.replace(geo_backend="rect", volume_build="rect",
                          exact_backend="volume")
    state0 = init_scene_state(jax.random.PRNGKey(0), scene)

    ref = scene_sweeps(state0, scene, cfg, 0, 1, False)
    ref = scene_sweeps(ref, scene, cfg, 1, 1, True)

    mesh = make_device_mesh(n_view=n_view, n_tile=n_tile)
    scene_s, state_s = shard_scene(scene, state0, mesh)
    with jax.set_mesh(mesh):
        out = scene_sweeps(state_s, scene_s, cfg, 0, 1, False)
        out = scene_sweeps(out, scene_s, cfg, 1, 1, True)

    # candidate selection is an argmin cascade: a float-ulp difference in
    # a near-tied score (sharded reductions associate differently) can flip
    # one pixel's winner — require bulk agreement, not bitwise equality
    d_ref = np.asarray(ref.depth)
    d_out = np.asarray(out.depth)
    mismatch = np.abs(d_out - d_ref) > (2e-4 + 2e-4 * np.abs(d_ref))
    assert mismatch.mean() < 0.02, mismatch.mean()
    c_ref = np.asarray(ref.cost)
    c_out = np.asarray(out.cost)
    bad_c = np.abs(c_out - c_ref) > (2e-3 + 2e-3 * np.abs(c_ref))
    assert bad_c.mean() < 0.02, bad_c.mean()


def test_distributed_ba_matches_single_device(eight_devices):
    """Bundle adjustment with observations + points sharded over the mesh
    reproduces the single-device solution (distributed Schur: GSPMD
    reduces the camera system across shards)."""
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    from test_incremental_sfm import _synthetic_observations, K_TEST
    from hcmvs_tpu.sfm.ba import (BAState, build_problem, rotation_to_rvec,
                                  run_ba)
    from hcmvs_tpu.parallel.sharding import shard_ba
    rng = np.random.default_rng(3)
    xy, pair_matches, gt_C, X_gt = _synthetic_observations(
        rng, n_cams=4, n_pts=64, mismatch_frac=0.0)
    # observations: all points in all cams (abstract), perturbed init
    obs_cam, obs_pt, obs_uv = [], [], []
    for c in range(4):
        for p in range(64):
            obs_cam.append(c)
            obs_pt.append(p)
            obs_uv.append(xy[c][p])
    Ks = np.tile(np.asarray(K_TEST)[None], (4, 1, 1))
    problem = build_problem(Ks, obs_cam, obs_pt, obs_uv, 64,
                            fixed_cams=[c == 0 for c in range(4)])
    R0 = np.eye(3)
    rvecs = np.zeros((4, 3), np.float32)
    tvecs = np.stack([-R0 @ gt_C[c] for c in range(4)]).astype(np.float32)
    pts0 = (X_gt + rng.normal(0, 0.02, X_gt.shape)).astype(np.float32)
    state = BAState(rvecs=jnp.asarray(rvecs), tvecs=jnp.asarray(tvecs),
                    points=jnp.asarray(pts0))

    ref_state, ref_cost = run_ba(problem, state, n_iters=5)

    mesh = make_device_mesh(n_view=4, n_tile=2)
    problem_s, state_s = shard_ba(problem, state, mesh)
    with jax.set_mesh(mesh):
        out_state, out_cost = run_ba(problem_s, state_s, n_iters=5)

    assert out_cost == pytest.approx(ref_cost, rel=1e-3, abs=1e-4)
    np.testing.assert_allclose(np.asarray(out_state.points),
                               np.asarray(ref_state.points),
                               rtol=1e-3, atol=1e-4)
