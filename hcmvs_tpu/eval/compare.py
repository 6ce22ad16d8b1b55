"""Evaluation utilities: depth/normal map comparison and point-cloud
F-score.

Analogs of the reference's built-in eval tools
(ref: frame_main/libs/MVS/DepthMap.cpp:2931 CompareDepthMaps and :3011
CompareNormalMaps — the closest thing the reference has to tests, SURVEY
§4), plus the ETH3D/Tanks&Temples-style point-cloud F-score that the
benchmark targets (BASELINE.md) are defined in.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def compare_depth_maps(depth: np.ndarray, depth_gt: np.ndarray,
                       threshold: float = 0.01) -> Dict[str, float]:
    """Per-pixel depth error stats (ref: CompareDepthMaps semantics:
    relative error against GT, plus extra/missing coverage)."""
    from hcmvs_tpu.io.images import resize_to
    if depth_gt.shape != depth.shape:
        depth_gt = resize_to(depth_gt, depth.shape[0], depth.shape[1])
    est = depth > 0
    gt = depth_gt > 0
    both = est & gt
    rel = np.zeros_like(depth)
    rel[both] = np.abs(depth[both] - depth_gt[both]) / depth_gt[both]
    errors = rel[both]
    return {
        "n_both": int(both.sum()),
        "n_extra": int((est & ~gt).sum()),
        "n_missing": int((~est & gt).sum()),
        "completeness": float(both.sum() / max(gt.sum(), 1)),
        "mean_rel_err": float(errors.mean()) if len(errors) else np.nan,
        "median_rel_err": float(np.median(errors)) if len(errors) else np.nan,
        "frac_error_gt_threshold": (float((errors > threshold).mean())
                                    if len(errors) else np.nan),
    }


def compare_normal_maps(normal: np.ndarray, normal_gt: np.ndarray
                        ) -> Dict[str, float]:
    """Angular error stats between (3, H, W) normal maps
    (ref: CompareNormalMaps)."""
    n1 = normal / np.maximum(np.linalg.norm(normal, axis=0), 1e-12)
    n2 = normal_gt / np.maximum(np.linalg.norm(normal_gt, axis=0), 1e-12)
    cos = np.clip(np.abs((n1 * n2).sum(0)), -1, 1)
    ang = np.degrees(np.arccos(cos))
    valid = np.isfinite(ang)
    return {
        "mean_angle_deg": float(ang[valid].mean()),
        "median_angle_deg": float(np.median(ang[valid])),
        "frac_below_10deg": float((ang[valid] < 10).mean()),
    }


def point_cloud_fscore(points: np.ndarray, points_gt: np.ndarray,
                       threshold: float) -> Dict[str, float]:
    """ETH3D/T&T-style F-score: precision = fraction of reconstructed
    points within ``threshold`` of GT, recall = fraction of GT points
    within ``threshold`` of the reconstruction."""
    from scipy.spatial import cKDTree
    if len(points) == 0 or len(points_gt) == 0:
        return {"precision": 0.0, "recall": 0.0, "fscore": 0.0}
    tree_gt = cKDTree(points_gt)
    d_est, _ = tree_gt.query(points, k=1)
    precision = float((d_est <= threshold).mean())
    tree_est = cKDTree(points)
    d_gt, _ = tree_est.query(points_gt, k=1)
    recall = float((d_gt <= threshold).mean())
    f = (2 * precision * recall / (precision + recall)
         if precision + recall > 0 else 0.0)
    return {"precision": precision, "recall": recall, "fscore": f}
