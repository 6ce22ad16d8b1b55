"""Sharded-execution scaling curve on the virtual device mesh.

A COLLECTIVE-OVERHEAD smoke test without multi-device hardware: run the
identical scene workload jitted over 1, 2, 4, 8 virtual CPU devices (XLA_FLAGS=--xla_force_host_platform_device_count)
and compare wall times.  Virtual devices share the same physical cores —
ideal behavior is a ratio near 1.0 (the extra partitions add only
collective/halo overhead); a blow-up flags pathological GSPMD placement
(SURVEY §5.8, BASELINE.md multi-host target).

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python -m hcmvs_tpu.eval.scaling
"""

from __future__ import annotations

import json
import time

import numpy as np


def run(h: int = 64, w: int = 96, n_views: int = 8,
        n_reps: int = 3) -> dict:
    import jax
    import jax.numpy as jnp
    from hcmvs_tpu.core.config import DenseConfig
    from hcmvs_tpu.dense.scene_driver import (init_scene_state,
                                              scene_sweeps)
    from hcmvs_tpu.parallel.sharding import make_device_mesh, shard_scene
    import __graft_entry__ as g

    cfg = DenseConfig(adapt_half_window=3, patch_half_window=3,
                      patch_step=2, estimation_iters=2, random_iters=2,
                      use_optical_flow=0, use_geo_consistency=1,
                      use_part_consistency=0)
    scene = g._build_scene(n_views=n_views, h=h, w=w)
    state0 = init_scene_state(jax.random.PRNGKey(0), scene)
    n_dev_avail = len(jax.devices())
    results = {}
    for n_dev in (1, 2, 4, 8):
        if n_dev > n_dev_avail or n_views % n_dev:
            continue
        mesh = make_device_mesh(n_view=n_dev, n_tile=1)
        sc, st = shard_scene(scene, state0, mesh)
        with jax.set_mesh(mesh):
            run_fn = lambda s: scene_sweeps(  # noqa: E731
                scene_sweeps(s, sc, cfg, 0, cfg.estimation_iters, False),
                sc, cfg, 1, cfg.estimation_iters, True)
            out = run_fn(st)
            jax.block_until_ready(out.depth)          # compile + warm
            t0 = time.perf_counter()
            for _ in range(n_reps):
                out = run_fn(st)
                jax.block_until_ready(out.depth)
            results[n_dev] = (time.perf_counter() - t0) / n_reps
    base = results.get(1)
    report = {f"wall_s_{k}dev": round(v, 3) for k, v in results.items()}
    if base:
        report.update({f"ratio_{k}dev": round(v / base, 2)
                       for k, v in results.items()})
    return report


def run_multiprocess(reps: int = 5, timeout: int = 900) -> dict:
    """Cross-PROCESS overhead: the mh_check schedule (sweeps + filter +
    fusion on an 8-view scene) timed under 2 processes x 4 devices, where
    the view-axis collectives cross process boundaries over Gloo — the
    CI-measurable analog of the DCN hop on a multi-host pod (SURVEY
    §5.8).  Returns per-rep wall seconds reported by process 0."""
    import os
    import re
    import socket
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)

    def spawn(pid):
        return subprocess.Popen(
            [sys.executable, "-m", "hcmvs_tpu.parallel.mh_check",
             "--process-id", str(pid), "--num-processes", "2",
             "--port", str(port), "--bench-reps", str(reps)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env, cwd=repo)

    procs = [spawn(0), spawn(1)]
    outs = [p.communicate(timeout=timeout)[0] for p in procs]
    m = re.search(r"MHBENCH wall_s=([0-9.]+)", outs[0])
    ok = "MHCHECK OK" in outs[0]
    return {"wall_s_2proc_4dev": float(m.group(1)) if m else None,
            "value_check": "OK" if ok else "FAIL"}


def main():
    import sys
    from hcmvs_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    out = run()
    if "--multiprocess" in sys.argv:
        out.update(run_multiprocess())
    print(json.dumps(out))


if __name__ == "__main__":
    main()
