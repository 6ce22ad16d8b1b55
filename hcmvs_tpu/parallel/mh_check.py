"""Multi-host value-check worker (CI analog of a pod-slice run).

Run one process per "host":

    python -m hcmvs_tpu.parallel.mh_check --process-id 0 --num-processes 2 \
        --port 9911 &
    python -m hcmvs_tpu.parallel.mh_check --process-id 1 --num-processes 2 \
        --port 9911

Each process owns 4 virtual CPU devices; the 8-device global (view, tile)
mesh runs a photometric + geometric scene_sweeps pass, the mid-pipeline
cross-view filter, and depth-map fusion with the view axis sharded ACROSS
processes — the geometric phase's neighbor-map reads and fusion's
reprojections become cross-process collectives (the DCN traffic of a real
pod).  Process 0 re-runs the identical schedule on one local device and
value-checks the global result (prints "MHCHECK OK ...", exit 0).

Used by tests/test_multihost.py; also a template for real pod bring-up
(drop --port etc. and call distributed.initialize() with no args).
"""

from __future__ import annotations

import argparse
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--port", type=int, default=9911)
    ap.add_argument("--devices-per-process", type=int, default=4)
    ap.add_argument("--bench-reps", type=int, default=0,
                    help="also time N reps of the sharded schedule and "
                         "print an MHBENCH line (cross-process "
                         "collective-overhead measurement)")
    ap.add_argument("--backend", default="direct",
                    choices=["direct", "volume"],
                    help="volume = exact scoring through the sigma-volume "
                         "tables, sharded across processes")
    args = ap.parse_args()

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count="
            f"{args.devices_per_process}").strip()

    import jax
    jax.config.update("jax_platforms", "cpu")
    from hcmvs_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from hcmvs_tpu.parallel import distributed as D
    D.initialize(coordinator_address=f"localhost:{args.port}",
                 num_processes=args.num_processes,
                 process_id=args.process_id)
    assert jax.process_count() == args.num_processes

    import jax.numpy as jnp
    import numpy as np
    from hcmvs_tpu.core.camera import Camera
    from hcmvs_tpu.core.config import DenseConfig
    from hcmvs_tpu.dense.fusion import fuse_point_cloud
    from hcmvs_tpu.dense.scene_driver import (SceneTensors, init_scene_state,
                                              optimize_maps, scene_sweeps)
    from hcmvs_tpu.utils.synth import make_plane_scene

    # identical on every process (same seed -> same host data)
    n_views, h, w, v = 8, 32, 48, 2
    sc = make_plane_scene(np.random.default_rng(0), h=h, w=w,
                          n_views=n_views)
    cams = Camera(K=jnp.stack([c.K for c in sc.cameras]),
                  R=jnp.stack([c.R for c in sc.cameras]),
                  C=jnp.stack([c.C for c in sc.cameras]))
    nbr = np.array([[j for j in range(n_views) if j != i][:v]
                    for i in range(n_views)], np.int32)
    scene = SceneTensors(
        gray=jnp.stack([jnp.asarray(im) for im in sc.images]),
        cams=cams, nbr_idx=jnp.asarray(nbr),
        nbr_valid=jnp.ones((n_views, v), bool),
        d_min=jnp.full((n_views,), sc.d_min, jnp.float32),
        d_max=jnp.full((n_views,), sc.d_max, jnp.float32))
    cfg = DenseConfig(adapt_half_window=3, patch_half_window=3,
                      patch_step=2, estimation_iters=1, random_iters=1,
                      use_optical_flow=0, use_geo_consistency=1,
                      use_part_consistency=0,
                      **({"exact_backend": "volume"}
                         if args.backend == "volume" else {}))
    if args.backend == "volume":
        # sigma-volume tables attach BEFORE distribution so the (N, V)
        # leading-dim tables shard over the cross-process view axis
        from hcmvs_tpu.dense.scene_driver import attach_volumes
        scene = attach_volumes(scene, cfg)
    state0 = init_scene_state(jax.random.PRNGKey(0), scene)
    view_ids = jnp.arange(n_views, dtype=jnp.float32)

    @jax.jit
    def schedule(st, sc_t, vids):
        st = scene_sweeps(st, sc_t, cfg, 0, 1, False)
        st = scene_sweeps(st, sc_t, cfg, 1, 1, True)
        st = optimize_maps(st, sc_t, cfg)
        fused = fuse_point_cloud(st.depth, st.normal,
                                 jnp.maximum(1.0 - st.cost, 0.01),
                                 sc_t.cams, sc_t.nbr_idx, sc_t.nbr_valid,
                                 vids, cfg)
        return st, fused

    # global run: view axis sharded across BOTH processes.  AOT-compile
    # BEFORE any dispatch, then barrier: Gloo's context init times out at
    # 30s, so the processes must reach the first collective together —
    # compile-time skew (e.g. one process hitting the persistent cache)
    # would otherwise kill the run.
    from jax.experimental import multihost_utils
    mesh = D.global_mesh(n_tile=2)
    scene_g, state_g = D.distribute_scene(scene, state0, mesh)
    vids_g = D.replicated(mesh, np.arange(n_views, dtype=np.float32))
    with jax.set_mesh(mesh):
        compiled = schedule.lower(state_g, scene_g, vids_g).compile()
        multihost_utils.sync_global_devices("hcmvs_mh_compiled")
        state_out, fused_out = compiled(state_g, scene_g, vids_g)
    depth_g = D.fetch(state_out.depth)
    pts_g = D.fetch(fused_out["points"])
    keep_g = D.fetch(fused_out["keep"])

    if args.bench_reps:
        # cross-process collective overhead: barrier, then time reps of
        # the same global executable (Gloo carries the view-axis traffic
        # that DCN would carry on a pod)
        import time
        with jax.set_mesh(mesh):
            multihost_utils.sync_global_devices("hcmvs_mh_bench0")
            t0 = time.perf_counter()
            for _ in range(args.bench_reps):
                st_b, fu_b = compiled(state_g, scene_g, vids_g)
                jax.block_until_ready(st_b.depth)
            wall = (time.perf_counter() - t0) / args.bench_reps
        print(f"MHBENCH wall_s={wall:.3f} reps={args.bench_reps} "
              f"procs={args.num_processes}", flush=True)

    # single-device reference (local device 0; no collectives).  BOTH
    # processes compute it so they reach distributed shutdown together
    # (a lone long-running process would trip heartbeat/shutdown timers).
    dev0 = jax.local_devices()[0]
    scene_l = jax.device_put(scene, dev0)
    state_l = jax.device_put(state0, dev0)
    vids_l = jax.device_put(jnp.asarray(view_ids), dev0)
    state_ref, fused_ref = schedule(state_l, scene_l, vids_l)
    d_ref = np.asarray(state_ref.depth)

    # argmin cascades: near-tied scores may flip a pixel's winner under
    # differently-associated sharded reductions — bulk agreement
    mism = np.abs(depth_g - d_ref) > (2e-4 + 2e-4 * np.abs(d_ref))
    keep_ref = np.asarray(fused_ref["keep"])
    keep_agree = float((keep_g == keep_ref).mean())
    kb = keep_g & keep_ref                       # (N, H, W)
    pts_ref = np.asarray(fused_ref["points"])    # (N, 3, H, W) planes
    kb3 = np.broadcast_to(kb[:, None], pts_ref.shape)
    pt_diff = float(np.abs(pts_g[kb3] - pts_ref[kb3]).max()) \
        if kb.any() else 0.0
    ok = mism.mean() < 0.02 and keep_agree > 0.98 and pt_diff < 1e-2
    print(f"[p{args.process_id}] MHCHECK {'OK' if ok else 'FAIL'} "
          f"depth_mismatch={mism.mean():.4f} "
          f"keep_agree={keep_agree:.4f} pt_diff={pt_diff:.2e} "
          f"kept={int(kb.sum())}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
