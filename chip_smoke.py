#!/usr/bin/env python3
"""Smoke test of the dense main path on one GPU.

    python chip_smoke.py

Runs in one process and needs one GPU.  Phases, in order; any failure
exits non-zero and no result line is printed:

1. device: JAX's first device must be a GPU (no CPU fallback); the card's
   name and power limit are printed as nvidia-smi reports them.
2. parity at 1280x960 with 3 neighbours on a seeded ridge scene: the
   direct exact photometric scores, the geometric scores, the sigma-table
   lookup, the rectified neighbor lookup and one photometric + geometric
   ``scene_sweeps`` call, each on the GPU and on the host CPU device.
3. main path: a seeded 6-view 1280x960 ridge scene is written as
   scene.mvs (ground-truth poses) + PNGs and densified through
   ``pipeline.hierarchy.main`` with the default 5-stage schedule at levels
   2/1/1/0/0; the final depth map must reach acc_2pct >= 0.90 against
   ground truth and the fused cloud must be non-empty.
4. BA: one LM step at 50 cameras / 20k points on the GPU and on the CPU;
   the costs must agree to rel 1e-3 (the matmul-precision pin in
   sfm/ba.py holds under TF32).
5. last line: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

H, W = 960, 1280

# Parity tolerances.  The scoring path is float32 elementwise math (3x3
# algebra is scalar-expanded, dense/types.py; no matmul), and the scan
# accumulates in the same order on both devices, so GPU and CPU differ
# only by FMA contraction and division/transcendental rounding: a few ulp
# in each warp position.  Values then agree to ~1e-4 except where a
# sample crosses a decision boundary (image-border validity, the geo
# term's nearest-pixel rounding, score clamps), which flips a rare pixel.
SCORE_ATOL = 1e-3
SCORE_RTOL = 1e-3
SCORE_MAX_FLIP = 1e-3     # fraction of elements allowed beyond tolerance
# The sweep ends in an argmin over candidates: a near-tie can flip a
# pixel's winner and propagate to its neighbours — bulk agreement, the
# rule of tests/test_sharding.py.
SWEEP_DEPTH_TOL = 2e-4
SWEEP_COST_TOL = 2e-3
SWEEP_MAX_FLIP = 0.02
ACC_GATE = 0.90
BA_RTOL = 1e-3


def log(msg):
    print(msg, flush=True)


# --------------------------------------------------------------------------
# phase 2: parity helpers (device-agnostic; a CPU-vs-CPU test runs them at
# small size)
# --------------------------------------------------------------------------

def _ridge(h, w, n_views, seed, texture_fn=None):
    import numpy as np
    from hcmvs_tpu.utils.synth import make_ridge_scene
    # FOV-preserving focal length (eval/golden.py contract)
    return make_ridge_scene(np.random.default_rng(seed), h=h, w=w,
                            n_views=n_views, spacing=0.25,
                            fx=180.0 * w / 192.0, texture_fn=texture_fn)


def parity_inputs(h, w, seed=0):
    """Host inputs for the parity cases: a 4-view ridge scene (ref view 0,
    neighbours 1..3), a fixed hypothesis field near ground truth, and the
    same scene as SceneTensors for the sweep.

    The texture is the sinusoid pattern at ~10-30 px wavelengths.  ZNCC's
    variance term is a difference of two nearly equal sums, so on
    low-texture patches one ulp of input moves the score by far more than
    one ulp: with the default blob texture at 1280x960, perturbing the
    CPU's own input by one ulp already moves 3.8 % of scores by more than
    1e-3.  A well-textured scene keeps the comparison about the device."""
    import numpy as np
    from hcmvs_tpu.core.camera import Camera
    from hcmvs_tpu.dense.scene_driver import SceneTensors
    from hcmvs_tpu.utils.synth import wave_texture_fn
    tex = wave_texture_fn(np.random.default_rng(seed + 7), scale=15.0)
    sc = _ridge(h, w, 4, seed, texture_fn=tex)
    rng = np.random.default_rng(seed + 1)
    depth = (sc.depth_gt * (1 + 0.01 * rng.standard_normal((h, w)))
             ).astype(np.float32)
    normal = np.zeros((3, h, w), np.float32)
    normal[2] = -1.0
    nbr_depth = np.stack([depth * (1 + 0.005 * k) for k in range(1, 4)])
    cams = Camera(K=np.stack([np.asarray(c.K) for c in sc.cameras]),
                  R=np.stack([np.asarray(c.R) for c in sc.cameras]),
                  C=np.stack([np.asarray(c.C) for c in sc.cameras]))
    gray = np.stack(sc.images).astype(np.float32)
    x = {
        "K": cams.K, "R": cams.R, "C": cams.C, "gray": gray,
        "depth": depth, "normal": normal,
        "nbr_depth": nbr_depth.astype(np.float32),
        "nbr_normal": np.broadcast_to(normal, (3, 3, h, w)).copy(),
        "tab": rng.integers(0, 65536, (h * w, 128)).astype(np.uint16),
        "f": (rng.random((h * w, 16)) * 127).astype(np.float32),
    }
    nbr = np.array([[j for j in range(4) if j != i] for i in range(4)],
                   np.int32)
    scene = SceneTensors(
        gray=gray, cams=cams, nbr_idx=nbr, nbr_valid=np.ones((4, 3), bool),
        d_min=np.full(4, sc.depth_gt.min() * 0.7, np.float32),
        d_max=np.full(4, sc.depth_gt.max() * 1.3, np.float32))
    return x, scene


def _geom_and_stats(x, cfg):
    from hcmvs_tpu.core.camera import Camera
    from hcmvs_tpu.dense import score as S
    from hcmvs_tpu.dense.types import make_view_geometry, pixel_rays
    from hcmvs_tpu.ops.gradients import sobel_magnitude
    import jax
    cams = Camera(K=x["K"], R=x["R"], C=x["C"])
    geom = make_view_geometry(jax.tree.map(lambda a: a[0], cams),
                              jax.tree.map(lambda a: a[1:], cams))
    h, w = x["gray"].shape[1:]
    hw = S.halfwin_map(sobel_magnitude(x["gray"][0]), cfg)
    offsets = S.patch_offsets(cfg)
    stats = S.ref_patch_stats(x["gray"][0], hw, offsets)
    return geom, stats, hw, offsets, pixel_rays(geom.K_inv_ref, h, w)


def _case_photometric(x):
    from hcmvs_tpu.core.config import DenseConfig
    from hcmvs_tpu.dense import score as S
    cfg = DenseConfig()
    geom, stats, hw, offsets, rays = _geom_and_stats(x, cfg)
    scores, _ = S.photometric_scores(geom, x["gray"][1:], stats, hw,
                                     x["depth"], x["normal"], rays,
                                     offsets, cfg)
    return scores


def _case_geometric(x):
    from hcmvs_tpu.core.config import DenseConfig
    from hcmvs_tpu.dense import score as S
    cfg = DenseConfig()
    geom, _, _, _, rays = _geom_and_stats(x, cfg)
    return S.geometric_scores(geom, x["depth"], x["normal"], rays,
                              x["nbr_depth"], x["nbr_normal"], cfg)


def _case_volume_lookup(x):
    from hcmvs_tpu.ops.volume import volume_lookup_xla
    return volume_lookup_xla(x["tab"], x["f"])


def _case_rect_lookup(x):
    import jax.numpy as jnp
    from hcmvs_tpu.core.config import DenseConfig
    from hcmvs_tpu.ops.rect_gather import build_rect_context, rect_lookup_xla
    geom, _, _, _, _ = _geom_and_stats(x, DenseConfig())
    maps = jnp.concatenate([x["nbr_depth"][:, None], x["nbr_normal"]],
                           axis=1)
    ctx = build_rect_context(geom, maps)
    return rect_lookup_xla(ctx, 1.0 / x["depth"])


SCORE_CASES = {
    "photometric_scores": _case_photometric,
    "geometric_scores": _case_geometric,
    "volume_lookup_xla": _case_volume_lookup,
    "rect_lookup_xla": _case_rect_lookup,
}


def _sweep(scene):
    import jax
    from hcmvs_tpu.core.config import DenseConfig
    from hcmvs_tpu.dense.scene_driver import init_scene_state, scene_sweeps
    # the bench round's patch (36 samples) and one inner sweep per phase:
    # the host CPU has to run the same call at full width
    cfg = DenseConfig(adapt_half_window=5, patch_half_window=3,
                      estimation_iters=1, random_iters=2)
    state = init_scene_state(jax.random.PRNGKey(0), scene)
    state = scene_sweeps(state, scene, cfg, 0, 1, False)
    return scene_sweeps(state, scene, cfg, 1, 1, True)


def _mismatch(a, b, atol, rtol):
    import numpy as np
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    diff = np.abs(a - b)
    return float(diff.max()), float((diff > atol + rtol * np.abs(b)).mean())


def run_parity(dev_test, dev_ref, h=H, w=W, seed=0):
    """Run every parity case on ``dev_test`` and ``dev_ref``; returns a
    list of (name, max_abs_diff, frac_beyond_tol, limit, ok, seconds)."""
    import jax
    import numpy as np
    results = []
    x, scene = parity_inputs(h, w, seed)
    for name, fn in SCORE_CASES.items():
        t0 = time.perf_counter()
        f = jax.jit(fn)
        got = np.asarray(f(jax.device_put(x, dev_test)))
        ref = np.asarray(f(jax.device_put(x, dev_ref)))
        assert got.shape == ref.shape and np.isfinite(got).all(), name
        mx, frac = _mismatch(got, ref, SCORE_ATOL, SCORE_RTOL)
        results.append((name, mx, frac, SCORE_MAX_FLIP,
                        frac <= SCORE_MAX_FLIP, time.perf_counter() - t0))
    t0 = time.perf_counter()
    got = _sweep(jax.device_put(scene, dev_test))
    ref = _sweep(jax.device_put(scene, dev_ref))
    for field, tol in (("depth", SWEEP_DEPTH_TOL), ("cost", SWEEP_COST_TOL)):
        a = np.asarray(getattr(got, field))
        b = np.asarray(getattr(ref, field))
        assert np.isfinite(a).all(), field
        mx, frac = _mismatch(a, b, tol, tol)
        results.append((f"scene_sweeps.{field}", mx, frac, SWEEP_MAX_FLIP,
                        frac < SWEEP_MAX_FLIP, time.perf_counter() - t0))
    return results


# --------------------------------------------------------------------------
# phase 3: main path through the normal entry point
# --------------------------------------------------------------------------

def run_main_path(work_dir, card, h=H, w=W, n_views=6, seed=0):
    """Densify a seeded ridge scene through pipeline.hierarchy.main;
    returns (acc_2pct, valid_frac, n_points)."""
    import jax
    import numpy as np
    from hcmvs_tpu.io.dmap import read_dmap
    from hcmvs_tpu.io.ply import read_ply
    from hcmvs_tpu.pipeline import hierarchy
    from hcmvs_tpu.utils import profiling
    from hcmvs_tpu.utils.synth import write_scene_mvs

    sc = _ridge(h, w, n_views, seed)
    mvs, img_dir = write_scene_mvs(sc, work_dir, seed=seed)
    out = os.path.join(work_dir, "out")
    compile_s = [0.0]

    def on_event(event, duration, **_):
        if "backend_compile" in event:
            compile_s[0] += duration
    jax.monitoring.register_event_duration_secs_listener(on_event)
    profiling.reset_report()
    t0 = time.perf_counter()
    hierarchy.main(["--input-file", mvs, "--images-dir", img_dir,
                    "-w", out, "--no-resume", "--finest-level", "0",
                    "--flags", "resolution-level=0"])
    wall = time.perf_counter() - t0
    for name, s in sorted(profiling.report().items()):
        log(f"  stage {name}: {s['total_s']:.3f} s x{int(s['calls'])} "
            f"[{card}]")
    mem = jax.devices()[0].memory_stats() or {}
    log(f"  hierarchy wall {wall:.3f} s, compile {compile_s[0]:.3f} s, "
        f"peak_bytes_in_use {mem.get('peak_bytes_in_use')} [{card}]")
    depth = read_dmap(os.path.join(out, "depthmap", "depth0000.dmap")).depth
    gt = sc.depth_gt
    valid = (depth > 0) & (gt > 0)
    rel = np.abs(depth - gt) / np.maximum(gt, 1e-9)
    acc = float(((rel < 0.02) & valid).sum() / max(valid.sum(), 1))
    pts, _ = read_ply(os.path.join(out, "scene_dense.ply"))
    return acc, float(valid.mean()), int(len(pts))


# --------------------------------------------------------------------------
# phase 4: BA precision
# --------------------------------------------------------------------------

def run_ba_check(dev_test, dev_ref, n_cams=50, n_pts=20_000):
    """One LM step on both devices; returns (cost_test, cost_ref, rel)."""
    import jax
    import jax.numpy as jnp
    from hcmvs_tpu.eval.ba_bench import make_problem
    from hcmvs_tpu.sfm.ba import ba_cost, ba_step
    problem, state, _ = make_problem(n_cams, n_pts)
    costs = []
    for dev in (dev_test, dev_ref):
        p, s = jax.device_put(problem, dev), jax.device_put(state, dev)
        s1 = ba_step(p, s, jax.device_put(jnp.float32(1e-3), dev))
        costs.append(float(ba_cost(p, s1)))
    rel = abs(costs[0] - costs[1]) / max(abs(costs[1]), 1e-12)
    return costs[0], costs[1], rel


def _card():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def main():
    from hcmvs_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax

    # -- phase 1: device ----------------------------------------------------
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX's first device is {dev.platform}); "
              "nothing runs elsewhere", file=sys.stderr)
        return 2
    card = _card()
    print(card, flush=True)
    log(f"[1] device {dev.platform} {dev.device_kind} x{len(jax.devices())}"
        f" | card: {card}")
    cpu = jax.devices("cpu")[0]

    # -- phase 2: parity at real width ---------------------------------------
    t0 = time.perf_counter()
    results = run_parity(dev, cpu)
    for name, mx, frac, limit, ok, secs in results:
        log(f"[2] {name}: max_abs_diff {mx:.3e}, beyond-tol fraction "
            f"{frac:.3e} (limit {limit}) {'ok' if ok else 'FAIL'} "
            f"[{secs:.1f} s]")
    log(f"[2] parity {time.perf_counter() - t0:.1f} s [{card}]")
    if not all(r[4] for r in results):
        raise SystemExit("parity failed")

    # -- phase 3: main path ----------------------------------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        acc, valid_frac, n_pts = run_main_path(work, card)
    log(f"[3] hierarchy 6x{W}x{H}: depth acc_2pct {acc:.4f} (gate "
        f"{ACC_GATE}), valid {valid_frac:.4f}, fused points {n_pts}")
    if acc < ACC_GATE or n_pts == 0:
        raise SystemExit("main path failed its gate")

    # -- phase 4: BA precision ------------------------------------------------
    c_gpu, c_cpu, rel = run_ba_check(dev, cpu)
    log(f"[4] BA LM step 50 cams / 20k pts: cost gpu {c_gpu:.6e} cpu "
        f"{c_cpu:.6e} rel {rel:.3e} (limit {BA_RTOL})")
    if not rel <= BA_RTOL:
        raise SystemExit("BA cost disagrees")

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
