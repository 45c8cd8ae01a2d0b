"""Evaluation metrics (counterpart of `smart_tree_tpu/train/metrics.py`):
per-point segmentation IoU, radius MAE, direction cosine, and skeleton-vs-
skeleton comparison via sampled tube distances."""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..data.cloud import Cloud
from ..data.tree import TreeSkeleton
from ..data.tube import collate_tubes
from ..utils.queries import skeleton_to_points


def segmentation_iou(pred_class: np.ndarray, true_class: np.ndarray, num_classes=2):
    pred = np.asarray(pred_class).reshape(-1).astype(int)
    true = np.asarray(true_class).reshape(-1).astype(int)
    ious = {}
    for c in range(num_classes):
        inter = np.sum((pred == c) & (true == c))
        union = np.sum((pred == c) | (true == c))
        ious[c] = float(inter / union) if union else float("nan")
    return ious


def medial_errors(pred: Cloud, truth: Cloud) -> Dict[str, float]:
    """Per-point medial regression errors; clouds must be row-aligned."""
    pr = np.asarray(pred.radius)
    tr = np.asarray(truth.radius)
    pd = np.asarray(pred.medial_vector)
    td = np.asarray(truth.medial_vector)
    pdn = pd / np.maximum(np.linalg.norm(pd, axis=1, keepdims=True), 1e-9)
    tdn = td / np.maximum(np.linalg.norm(td, axis=1, keepdims=True), 1e-9)
    return {
        "radius_mae": float(np.abs(pr - tr).mean()),
        "radius_rel_mae": float((np.abs(pr - tr) / np.maximum(tr, 1e-6)).mean()),
        "direction_cos": float((pdn * tdn).sum(1).mean()),
    }


def skeleton_distance(
    got: TreeSkeleton, truth: TreeSkeleton, spacing: float = 0.02, device=None
) -> Dict[str, float]:
    """Symmetric sampled point->tube distances between two skeletons, plus
    coverage (fraction of truth within its own radius of the estimate). The
    point-to-tube queries run on `device` (absent = the card)."""
    from ..data.tube import sample_tubes

    got_tubes = got.to_tubes()
    true_tubes = truth.to_tubes()
    if not got_tubes or not true_tubes:
        return {"precision_dist": float("inf"), "recall_dist": float("inf"),
                "coverage": 0.0}
    gp, _ = sample_tubes(got_tubes, spacing)
    tp, t_r = sample_tubes(true_tubes, spacing)
    d_g2t, _, _ = skeleton_to_points(gp, collate_tubes(true_tubes), device=device)
    d_t2g, r_t2g, _ = skeleton_to_points(tp, collate_tubes(got_tubes), device=device)
    return {
        # how far estimated skeleton strays from truth
        "precision_dist": float(np.mean(d_g2t)),
        # how far truth is from the estimate (missed structure shows here)
        "recall_dist": float(np.mean(d_t2g)),
        # fraction of truth samples within their local radius of the estimate
        "coverage": float(np.mean(d_t2g < np.maximum(t_r, spacing))),
        "length_ratio": float(got.length / max(truth.length, 1e-9)),
    }
