"""Quality-vs-resolution instrumentation: per-external-iteration depth
accuracy on the ridge golden scene at configurable size / focal length /
schedule knobs (default device, or --cpu).

    python -m hcmvs_tpu.eval.quality_ladder --h 480 --w 640 --fx 600

This is the harness behind BASELINE.md's round-3 cliff root-cause row:
the r2 "resolution cliff" (0.97 -> 0.77) was the fixed-fx=180 harness
turning 640x480 into a 121-degree ultra-wide camera; at fixed FOV
(fx scaled with width) accuracy holds ~0.91 at 640x480, and at fx=180
the volume and direct-bilinear exact backends agree to 4 decimal places
(the scene geometry, not the engine, is the limiter)."""
import argparse
import json
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--h", type=int, default=480)
    ap.add_argument("--w", type=int, default=640)
    ap.add_argument("--fx", type=float, default=180.0)
    ap.add_argument("--views", type=int, default=5)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--ext", type=int, default=3)
    ap.add_argument("--photo2geo", type=int, default=1)
    ap.add_argument("--adapt-hw", type=int, default=5)
    ap.add_argument("--patch-hw", type=int, default=3)
    ap.add_argument("--patch-step", type=int, default=2)
    ap.add_argument("--explore-step", type=int, default=4)
    ap.add_argument("--random-iters", type=int, default=3)
    ap.add_argument("--optimize", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--geo-backend", default="auto")
    ap.add_argument("--exact-backend", default="auto")
    ap.add_argument("--volume-planes", type=int, default=128)
    ap.add_argument("--cfg", default="",
                    help="JSON dict of extra DenseConfig field overrides "
                         "(applied last) — the annealing-ladder sweep "
                         "hook (VERDICT r4 #8)")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from hcmvs_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np
    from hcmvs_tpu.core.camera import Camera
    from hcmvs_tpu.core.config import DenseConfig
    from hcmvs_tpu.dense.scene_driver import (SceneTensors, attach_volumes,
                                              finalize, init_scene_state,
                                              optimize_maps, phase_cfg,
                                              scene_sweeps)
    from hcmvs_tpu.utils.synth import make_ridge_scene

    rng = np.random.default_rng(0)
    sc = make_ridge_scene(rng, h=args.h, w=args.w, n_views=args.views,
                          spacing=0.25, fx=args.fx)
    n_views = args.views
    cams = Camera(K=jnp.stack([c.K for c in sc.cameras]),
                  R=jnp.stack([c.R for c in sc.cameras]),
                  C=jnp.stack([c.C for c in sc.cameras]))
    v = min(3, n_views - 1)
    nbr = np.array([[j for j in range(n_views) if j != i][:v]
                    for i in range(n_views)], np.int32)
    zs = sc.depth_gt[sc.depth_gt > 0]
    scene = SceneTensors(
        gray=jnp.stack([jnp.asarray(im) for im in sc.images]),
        cams=cams, nbr_idx=jnp.asarray(nbr),
        nbr_valid=jnp.ones((n_views, v), bool),
        d_min=jnp.full((n_views,), float(zs.min()) * 0.7, jnp.float32),
        d_max=jnp.full((n_views,), float(zs.max()) * 1.4, jnp.float32))
    cfg = DenseConfig(adapt_half_window=args.adapt_hw,
                      patch_half_window=args.patch_hw,
                      patch_step=args.patch_step,
                      explore_patch_step=args.explore_step,
                      estimation_iters=args.iters,
                      estimation_iters_external=args.ext,
                      photo2geo=args.photo2geo,
                      random_iters=args.random_iters,
                      use_optical_flow=0, use_geo_consistency=1,
                      use_part_consistency=0, optimize=args.optimize,
                      geo_backend=args.geo_backend,
                      exact_backend=args.exact_backend,
                      volume_planes=args.volume_planes)
    if args.cfg:
        cfg = cfg.replace(**json.loads(args.cfg))

    def acc_of(depth0):
        d0 = np.asarray(depth0)
        valid = (d0 > 0) & (sc.depth_gt > 0)
        rel = np.abs(d0 - sc.depth_gt) / np.maximum(sc.depth_gt, 1e-9)
        return (float(((rel < 0.02) & valid).sum() / max(valid.sum(), 1)),
                float(((rel < 0.01) & valid).sum() / max(valid.sum(), 1)))

    t00 = time.time()
    state = init_scene_state(jax.random.PRNGKey(0), scene)
    scene = attach_volumes(scene, cfg)
    n_ext = cfg.estimation_iters_external
    for it_ext in range(n_ext):
        phase = 1 if it_ext >= cfg.photo2geo else 0
        t0 = time.time()
        state = scene_sweeps(state, scene,
                             phase_cfg(cfg, phase, it_ext == n_ext - 1),
                             phase, cfg.estimation_iters, phase >= 1)
        a2, a1 = acc_of(state.depth[0])
        print(json.dumps({"it_ext": it_ext, "phase": phase,
                          "acc2pct": round(a2, 4), "acc1pct": round(a1, 4),
                          "wall": round(time.time() - t0, 1)}), flush=True)
        if cfg.optimize and it_ext in (1, 2):
            state = optimize_maps(state, scene, cfg)
            a2, a1 = acc_of(state.depth[0])
            print(json.dumps({"it_ext": it_ext, "stage": "optimize",
                              "acc2pct": round(a2, 4),
                              "acc1pct": round(a1, 4)}), flush=True)
    depth, normal, conf = finalize(state, cfg)
    a2, a1 = acc_of(depth[0])
    d0 = np.asarray(depth[0])
    valid_frac = float((d0 > 0).mean())
    print(json.dumps({"final": True, "acc2pct": round(a2, 4),
                      "acc1pct": round(a1, 4),
                      "valid": round(valid_frac, 3),
                      "size": f"{args.w}x{args.h}", "fx": args.fx,
                      "total_wall": round(time.time() - t00, 1)}),
          flush=True)


if __name__ == "__main__":
    main()
