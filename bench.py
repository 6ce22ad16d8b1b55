"""Benchmark: views densified per second on the flagship dense round.

Workload (the reference's per-depth-map measurement unit — the TD_TIMER
log at frame_main/libs/MVS/SceneDensify.cpp:1066-1070): N=4 reference
views at 1280x960, 3 neighbor views each; one round is a photometric and
a geometric ``scene_sweeps`` call of 2 inner sweeps each (36-sample
adaptive ZNCC patches, 4-step annealed random refinement, cross-view
geometric consistency).  views/s = N / median round wall.

One process on the default device.  Compilation (AOT ``lower().compile()``)
is reported as set-up time; one warm-up round follows; each timed round
ends in ``block_until_ready``.  With the sigma-volume engine the tables
are built once per stage in production (4 external x 3 inner sweeps), so
each 4-sweep round is charged 4/12 of the measured build.  depth
acc_2pct compares view 0 after the warm-up round with the synthetic
ground truth.  Without a GPU the bench exits non-zero and prints no
result.

    python bench.py                                  # flagship line
    python bench.py --engines direct,volume,rect     # engine A/B
    python bench.py --views 11 --nbrs 10 --engines volume \\
        --cfg '{"volume_streaming": true}'           # 10-neighbor point

Prints one JSON line per engine.
"""

import argparse
import json
import os
import sys
import time

# explicit engine configurations behind --engines (see core/config.py
# resolve_engines for what "auto" picks)
ENGINES = {
    "auto": {},
    "direct": {"exact_backend": "bilinear", "geo_backend": "direct"},
    "volume": {"exact_backend": "volume", "volume_build": "planes",
               "geo_backend": "direct"},
    "rect": {"exact_backend": "bilinear", "geo_backend": "rect"},
}


def _build(n_views, h, w, v_nbr, overrides=None):
    import numpy as np
    import jax
    import jax.numpy as jnp
    from hcmvs_tpu.core.camera import Camera
    from hcmvs_tpu.core.config import DenseConfig
    from hcmvs_tpu.dense.scene_driver import SceneTensors, init_scene_state
    from hcmvs_tpu.utils.synth import make_plane_scene
    sc = make_plane_scene(np.random.default_rng(0), h=h, w=w,
                          n_views=n_views)
    cams = Camera(K=jnp.stack([c.K for c in sc.cameras]),
                  R=jnp.stack([c.R for c in sc.cameras]),
                  C=jnp.stack([c.C for c in sc.cameras]))
    nbr = np.array([[j for j in range(n_views) if j != i][:v_nbr]
                    for i in range(n_views)], np.int32)
    scene = SceneTensors(
        gray=jnp.stack([jnp.asarray(im) for im in sc.images]),
        cams=cams, nbr_idx=jnp.asarray(nbr),
        nbr_valid=jnp.ones((n_views, v_nbr), bool),
        d_min=jnp.full((n_views,), sc.d_min, jnp.float32),
        d_max=jnp.full((n_views,), sc.d_max, jnp.float32))
    cfg = DenseConfig(adapt_half_window=5, patch_half_window=3, patch_step=2,
                      estimation_iters=2, random_iters=4,
                      use_optical_flow=0, use_geo_consistency=1,
                      use_part_consistency=1)
    if overrides:
        cfg = cfg.replace(**overrides)
    state = init_scene_state(jax.random.PRNGKey(0), scene)
    return state, scene, cfg, sc.depth_gt


def run(n_views=4, h=960, w=1280, v_nbr=3, engine="auto", rounds=5,
        overrides=None) -> dict:
    """Compile, warm up and time one engine; returns the result line."""
    import dataclasses
    import numpy as np
    import jax
    from hcmvs_tpu.dense.scene_driver import (_build_scene_volumes,
                                              phase_cfg, scene_sweeps)
    from hcmvs_tpu.dense.score import use_volume_tables
    from hcmvs_tpu.ops.volume import use_rect_volume_build

    state, scene, cfg, depth_gt = _build(
        n_views, h, w, v_nbr, {**ENGINES[engine], **(overrides or {})})
    use_vol = use_volume_tables(cfg) and not cfg.volume_streaming
    t0 = time.perf_counter()
    c_vol = None
    if use_vol:
        c_vol = _build_scene_volumes.lower(
            scene, rect_build=use_rect_volume_build(cfg, h, w),
            n_chunks=max(cfg.volume_planes // 128, 1)).compile()
        scene_raw = scene
        scene = dataclasses.replace(
            scene, vols=jax.block_until_ready(c_vol(scene_raw)))
    c_photo = scene_sweeps.lower(state, scene, phase_cfg(cfg, 0), 0,
                                 cfg.estimation_iters, False).compile()
    c_geo = scene_sweeps.lower(state, scene, phase_cfg(cfg, 1, True), 1,
                               cfg.estimation_iters, True).compile()
    compile_s = time.perf_counter() - t0

    def one_round(st):
        return jax.block_until_ready(c_geo(c_photo(st, scene), scene))

    t0 = time.perf_counter()
    state = one_round(state)
    warmup_s = time.perf_counter() - t0
    d0 = np.asarray(state.depth[0])
    acc = float((np.abs(d0 - depth_gt) / depth_gt < 0.02).mean())

    build_share = 0.0
    if use_vol:
        t0 = time.perf_counter()
        jax.block_until_ready(c_vol(scene_raw))
        build_share = ((time.perf_counter() - t0)
                       * (2 * cfg.estimation_iters) / 12.0)
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        state = one_round(state)
        times.append(time.perf_counter() - t0)
    round_s = float(np.median(times)) + build_share
    dev = jax.devices()[0]
    mem = dev.memory_stats() or {}
    return {
        "metric": "views_densified_per_s",
        "value": n_views / round_s,
        "unit": "views/s",
        "engine": engine, "overrides": overrides or {},
        "views": n_views, "h": h, "w": w, "nbrs": v_nbr,
        "round_s_median": round_s, "round_s_all": times,
        "build_share_s": build_share,
        "compile_s": compile_s, "warmup_s": warmup_s,
        "acc_2pct": acc,
        "peak_bytes_in_use": mem.get("peak_bytes_in_use"),
        "platform": dev.platform, "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--h", type=int, default=960)
    ap.add_argument("--w", type=int, default=1280)
    ap.add_argument("--nbrs", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--engines", default="auto",
                    help="comma list of " + ",".join(ENGINES))
    ap.add_argument("--cfg", default="",
                    help="JSON dict of DenseConfig field overrides")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from hcmvs_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax
    if jax.devices()[0].platform != "gpu":
        print(f"bench: no GPU (JAX found {jax.devices()[0].platform}); "
              "refusing to measure elsewhere", file=sys.stderr)
        return 2
    overrides = json.loads(args.cfg) if args.cfg else None
    for engine in args.engines.split(","):
        print(json.dumps(run(args.views, args.h, args.w, args.nbrs, engine,
                             args.rounds, overrides)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
