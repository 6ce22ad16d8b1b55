"""Mesh-refinement benchmark: the raster ZNCC-gradient step at
reference-class size (640x480, 8 views) — the direct analog of the
reference's only GPU code (ref: SceneRefineCUDA.cpp:62-1944 kernel list;
RefineMesh app defaults --scales 3 --resolution-level ...).

    python -m hcmvs_tpu.eval.refine_bench             # default device
    python -m hcmvs_tpu.eval.refine_bench --cpu --iters 2

Prints one JSON line: seconds per raster_refine_grad iteration (the
jitted on-device part) and per host rasterization pass (once per scale in
the driver), plus the quality delta of a short refine on the noisy mesh.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def build_case(h=480, w=640, n_views=8, grid=96, noise=0.01, seed=0):
    """Ridge scene + a noisy surface mesh to refine: GT view-0 depth grid
    triangulated at ``grid`` resolution, vertices jittered along the view
    ray (what refinement must undo)."""
    import jax.numpy as jnp
    from hcmvs_tpu.utils.synth import make_ridge_scene
    rng = np.random.default_rng(seed)
    sc = make_ridge_scene(rng, h=h, w=w, n_views=n_views, spacing=0.25,
                          fx=180.0 * w / 192.0)
    K = np.asarray(sc.cameras[0].K)
    # regular grid over view 0, backprojected at GT depth
    gy = np.linspace(4, h - 5, grid)
    gx = np.linspace(4, w - 5, int(grid * w / h))
    vv, uu = np.meshgrid(gy, gx, indexing="ij")
    d = sc.depth_gt[vv.astype(int), uu.astype(int)]
    rays = np.linalg.inv(K) @ np.stack(
        [uu.ravel(), vv.ravel(), np.ones(uu.size)])
    V = (rays * d.ravel()).T
    n_gy, n_gx = vv.shape
    faces = []
    for r in range(n_gy - 1):
        for c in range(n_gx - 1):
            a = r * n_gx + c
            faces.append([a, a + 1, a + n_gx])
            faces.append([a + 1, a + n_gx + 1, a + n_gx])
    faces = np.asarray(faces, np.int32)
    V_noisy = V * (1.0 + rng.normal(0, noise, (len(V), 1)))
    imgs = np.stack([im for im in sc.images]).astype(np.float32)
    Ks = np.stack([np.asarray(c.K) for c in sc.cameras])
    Rs = np.stack([np.asarray(c.R) for c in sc.cameras])
    Cs = np.stack([np.asarray(c.C) for c in sc.cameras])
    pairs = np.asarray([[0, i] for i in range(1, n_views)]
                       + [[i, 0] for i in range(1, n_views)], np.int32)
    return sc, V, V_noisy, faces, imgs, Ks, Rs, Cs, pairs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--h", type=int, default=480)
    ap.add_argument("--w", type=int, default=640)
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args()
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from hcmvs_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    from hcmvs_tpu.mesh.mesh_ops import rasterize_attributes
    from hcmvs_tpu.mesh.refine import raster_refine_grad

    sc, _V_gt, V0, faces, imgs, Ks, Rs, Cs, pairs = build_case(
        args.h, args.w, args.views)
    h, w = args.h, args.w
    t0 = time.time()
    rasters, fids, bars = [], [], []
    for i in range(len(imgs)):
        d, fi, ba = rasterize_attributes(V0.astype(np.float64), faces,
                                         Ks[i], Rs[i], Cs[i], h, w)
        rasters.append(d)
        fids.append(fi)
        bars.append(ba)
    t_raster = time.time() - t0

    V = jnp.asarray(V0, jnp.float32)
    fid = jnp.asarray(np.stack(fids))
    bar = jnp.asarray(np.stack(bars).astype(np.float32))
    raster = jnp.asarray(np.stack(rasters).astype(np.float32))
    imgs_j = jnp.asarray(imgs)
    gx = (jnp.roll(imgs_j, -1, 2) - jnp.roll(imgs_j, 1, 2)) * 0.5
    gy = (jnp.roll(imgs_j, -1, 1) - jnp.roll(imgs_j, 1, 1)) * 0.5
    fj = jnp.asarray(faces)
    Kj, Rj, Cj = (jnp.asarray(x, jnp.float32) for x in (Ks, Rs, Cs))
    pa, pb = jnp.asarray(pairs[:, 0]), jnp.asarray(pairs[:, 1])

    def grad_step(Vv):
        return raster_refine_grad(Vv, fj, fid, bar, raster, imgs_j, gx,
                                  gy, Kj, Rj, Cj, pa, pb, len(pairs))

    t0 = time.time()
    jax.block_until_ready(grad_step(V))
    t_first = time.time() - t0
    times = []
    for _i in range(args.iters):
        t0 = time.time()
        jax.block_until_ready(grad_step(V))
        times.append(time.time() - t0)

    # (refinement QUALITY is gated by tests/test_refine.py through the
    # full multi-scale driver; this harness measures the per-iteration
    # cost of its two stages)
    print(json.dumps({
        "metric": "mesh_refine_grad_iteration",
        "grad_s": float(np.median(times)), "first_exec_s": t_first,
        "host_raster_s_per_scale": round(t_raster, 1),
        "size": f"{args.w}x{args.h}", "views": args.views,
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "pairs": int(len(pairs)), "verts": int(len(V0)),
    }), flush=True)


if __name__ == "__main__":
    main()
