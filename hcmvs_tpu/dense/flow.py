"""Dense optical flow for the cross-consistency term.

The reference computes Farneback flow from each reference image to its
best neighbor during InitViews (ref: frame_main/libs/MVS/SceneDensify.cpp:
404-508, cv::calcOpticalFlowFarneback at :470) and scores PatchMatch
hypotheses against it (score_flow, dense/score.py flow_score).

Two backends, chosen by ``DenseConfig.flow_backend``:
- ``lk`` (default): pyramidal Lucas-Kanade in JAX — coarse-to-fine warp
  + windowed normal equations, all jittable (box sums via
  lax.reduce_window, warps via the packed-tap bilinear sampler).
- ``farneback``: OpenCV on the host, exactly like the reference; needs
  the optional OpenCV install.
"""

from __future__ import annotations

from functools import partial
import jax
import jax.numpy as jnp
import numpy as np


def farneback_flow(ref_gray: np.ndarray, nbr_gray: np.ndarray,
                   pyr_scale: float = 0.5, levels: int = 3,
                   winsize: int = 15, iterations: int = 3) -> np.ndarray:
    """(2, H, W) planes-first flow ref -> neighbor (u, v)."""
    try:
        import cv2
    except ImportError:
        raise RuntimeError(
            "flow_backend='farneback' needs OpenCV (pip install "
            "'hcmvs-tpu[io]'); use flow_backend='lk' without it") from None
    a = np.clip(ref_gray * 255, 0, 255).astype(np.uint8)
    b = np.clip(nbr_gray * 255, 0, 255).astype(np.uint8)
    flow = cv2.calcOpticalFlowFarneback(
        a, b, None, pyr_scale, levels, winsize, iterations, 5, 1.2, 0)
    return np.moveaxis(flow, -1, 0).astype(np.float32)


def _box_sum(x, r: int):
    return jax.lax.reduce_window(x, 0.0, jax.lax.add,
                                 (2 * r + 1, 2 * r + 1), (1, 1), "SAME")


@partial(jax.jit, static_argnames=("levels", "iters", "radius"))
def lk_flow(ref: jax.Array, nbr: jax.Array, levels: int = 3,
            iters: int = 5, radius: int = 7) -> jax.Array:
    """Dense pyramidal Lucas-Kanade: (2, H, W) flow ref->nbr.

    Coarse-to-fine: at each pyramid level the neighbor is warped by the
    upsampled flow (packed-tap bilinear gather), image gradients and the
    temporal difference feed per-pixel 2x2 windowed normal equations
    (box sums via reduce_window), and the increment accumulates.
    """
    from hcmvs_tpu.ops.sampling import bilinear_sample_xy
    h, w = ref.shape
    # pyramids (downsample by striding after a small blur)
    pyr_r, pyr_n = [ref], [nbr]
    for _ in range(levels - 1):
        def down(x):
            x = (x + jnp.roll(x, 1, 0) + jnp.roll(x, 1, 1)
                 + jnp.roll(jnp.roll(x, 1, 0), 1, 1)) * 0.25
            return x[::2, ::2]
        pyr_r.append(down(pyr_r[-1]))
        pyr_n.append(down(pyr_n[-1]))

    flow = jnp.zeros((2,) + pyr_r[-1].shape, jnp.float32)
    for lvl in range(levels - 1, -1, -1):
        r_img, n_img = pyr_r[lvl], pyr_n[lvl]
        hh, ww = r_img.shape
        if flow.shape[1:] != (hh, ww):
            flow = 2.0 * jax.image.resize(flow, (2, hh, ww), "bilinear")
        yy, xx = jnp.meshgrid(jnp.arange(hh, dtype=jnp.float32),
                              jnp.arange(ww, dtype=jnp.float32),
                              indexing="ij")
        ix = (jnp.roll(r_img, -1, 1) - jnp.roll(r_img, 1, 1)) * 0.5
        iy = (jnp.roll(r_img, -1, 0) - jnp.roll(r_img, 1, 0)) * 0.5
        a11 = _box_sum(ix * ix, radius)
        a12 = _box_sum(ix * iy, radius)
        a22 = _box_sum(iy * iy, radius)
        det = a11 * a22 - a12 * a12
        ok = det > 1e-9
        inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)

        def step(flow, _):
            warped, valid = bilinear_sample_xy(n_img, xx + flow[0],
                                               yy + flow[1])
            it = jnp.where(valid, warped - r_img, 0.0)
            b1 = -_box_sum(ix * it, radius)
            b2 = -_box_sum(iy * it, radius)
            du = (a22 * b1 - a12 * b2) * inv_det
            dv = (a11 * b2 - a12 * b1) * inv_det
            lim = 2.0 ** 3
            return flow + jnp.stack([jnp.clip(du, -lim, lim),
                                     jnp.clip(dv, -lim, lim)]), None

        flow, _ = jax.lax.scan(step, flow, None, length=iters)
    return flow


def scene_flows(grays: np.ndarray, nbr_idx: np.ndarray,
                backend: str = "lk") -> np.ndarray:
    """(N, 2, H, W) flow from each view to its best (first) neighbor —
    the flow_images analog (ref: DepthData.flow_images, DepthMap.h:242)."""
    if backend not in ("lk", "farneback"):
        raise ValueError(f"unknown flow backend {backend!r}")
    n = len(grays)
    flows = np.zeros((n, 2) + grays[0].shape, np.float32)
    for i in range(n):
        j = int(nbr_idx[i, 0])
        if backend == "farneback":
            flows[i] = farneback_flow(grays[i], grays[j])
        else:
            flows[i] = np.asarray(lk_flow(jnp.asarray(grays[i]),
                                          jnp.asarray(grays[j])))
    return flows
