"""Per-stage accounting for the flagship dense bench.

Measures, per stage of one bench round (the 2-sweeps x 2-phases unit of
bench.py): wall time to ``block_until_ready`` (median of rounds) and the
analytic sample volume (patch samples / sigma-table lookups / neighbor
lookups) with the rate it implies.  Peak-rate tables and roofline shares
belong with the benchmark, keyed by device kind.

    python -m hcmvs_tpu.eval.roofline             # default device
    python -m hcmvs_tpu.eval.roofline --h 480 --w 640 --cpu   # smoke

Prints one JSON report.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--h", type=int, default=960)
    ap.add_argument("--w", type=int, default=1280)
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--nbrs", type=int, default=3)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--batch-candidates", action="store_true",
                    help="A/B the batched propagation-candidate scoring "
                         "(one vmapped cost graph, no scan carries)")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from hcmvs_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    import bench
    from hcmvs_tpu.dense import score as S
    from hcmvs_tpu.dense.patchmatch import propagation_offsets
    from hcmvs_tpu.dense.scene_driver import (_build_scene_volumes,
                                              phase_cfg, scene_sweeps)
    from hcmvs_tpu.ops.volume import D_PLANES, use_rect_volume_build

    n, h, w, v = args.views, args.h, args.w, args.nbrs
    state, scene, cfg = bench._build(n, h, w, v)
    if args.batch_candidates:
        cfg = cfg.replace(batch_candidates=True)

    # --- AOT compile the three stage executables ---
    use_vol = S.use_volume_tables(cfg)
    rect_b = use_rect_volume_build(cfg, h, w)
    t0 = time.perf_counter()
    c_vol = (_build_scene_volumes.lower(scene, rect_build=rect_b).compile()
             if use_vol else None)
    scene_v = (dataclasses.replace(scene, vols=c_vol(scene)) if use_vol
               else scene)
    c_photo = scene_sweeps.lower(state, scene_v, phase_cfg(cfg, 0), 0,
                                 cfg.estimation_iters, False).compile()
    c_geo = scene_sweeps.lower(state, scene_v, phase_cfg(cfg, 1, True), 1,
                               cfg.estimation_iters, True).compile()
    print(f"[roofline] AOT {time.perf_counter() - t0:.1f}s",
          file=sys.stderr, flush=True)

    # warmup
    st = jax.block_until_ready(c_geo(c_photo(state, scene_v), scene_v))

    def timed(fn, *a):
        times = []
        out = None
        for _ in range(args.rounds):
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn(*a))
            times.append(time.perf_counter() - t0)
        return float(np.median(times)), out

    dev = jax.devices()[0]
    report = {"w": w, "h": h, "views": n, "nbrs": v,
              "platform": dev.platform, "device_kind": dev.device_kind,
              "device_count": len(jax.devices())}

    # --- stage 1: sigma-table build ---
    if use_vol:
        t_build, vols = timed(c_vol, scene)
        tab_bytes = sum(int(np.prod(x.shape)) * x.dtype.itemsize
                        for x in jax.tree.leaves(vols))
        # build reads: 2x cross-epipolar oversampled bicubic warp =
        # 1 packed gather per output sample (16-wide rows), 2 samples
        # per table entry
        n_entries = n * v * h * w * D_PLANES
        report["table_build"] = {
            "wall_s": t_build,
            "bytes_written": tab_bytes,
            "entries": n_entries,
            "entries_per_s_G": n_entries / t_build / 1e9,
        }

    # --- stage 2: photometric sweeps ---
    p_cfg = phase_cfg(cfg, 0)
    n_patch = len(S.patch_offsets(p_cfg))
    n_prop = len(propagation_offsets(p_cfg))
    # candidates scored per pixel per inner iteration: current + prop +
    # random ladder
    n_cand = 1 + n_prop + p_cfg.random_iters
    iters = cfg.estimation_iters
    t_photo, _ = timed(c_photo, state, scene_v)
    lookups_photo = n * v * h * w * n_patch * n_cand * iters
    report["photometric"] = {
        "wall_s": t_photo,
        "candidates_per_px": n_cand, "patch_taps": n_patch,
        "patch_samples": lookups_photo,
        "samples_per_s_G": lookups_photo / t_photo / 1e9,
    }

    # --- stage 3: geometric sweeps (adds rect-engine neighbor reads) ---
    g_cfg = phase_cfg(cfg, 1, True)
    n_patch_g = len(S.patch_offsets(g_cfg))
    n_cand_g = 1 + n_prop + g_cfg.random_iters
    t_geo, _ = timed(c_geo, st, scene_v)
    lookups_geo = n * v * h * w * n_patch_g * n_cand_g * iters
    # geo term: one neighbor-map lookup (depth + normal) per candidate
    # per view
    nbr_lookups = n * v * h * w * n_cand_g * iters
    report["geometric"] = {
        "wall_s": t_geo,
        "candidates_per_px": n_cand_g, "patch_taps": n_patch_g,
        "patch_samples": lookups_geo,
        "nbr_lookups": nbr_lookups,
        "samples_per_s_G": (lookups_geo + nbr_lookups) / t_geo / 1e9,
    }

    round_s = t_photo + t_geo
    build_share = (report.get("table_build", {}).get("wall_s", 0.0)
                   * (2 * cfg.estimation_iters) / 12.0)
    report["round"] = {
        "wall_s": round_s,
        "views_per_s": n / (round_s + build_share),
        "build_share_s": build_share,
    }
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
