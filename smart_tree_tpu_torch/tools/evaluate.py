"""End-to-end quality evaluation (counterpart of `tools/evaluate.py`): run a
checkpoint on held-out synthetic trees through the forward and the
skeletonizer and report the quality metrics BASELINE.md tracks: branch and
foliage IoU, radius MAE, direction cosine, and the skeleton's precision /
recall distances, coverage and length ratio against the ground truth.

    python -m smart_tree_tpu_torch.tools.evaluate runs/local-run/best_weights.npz --seeds 100 101

Runs on the card; `--device cpu` runs the plain PyTorch versions on the CPU.
A caller picks bf16 by handing `evaluate_tree` a
`ModelInference(precision="bfloat16")`.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..data.augmentations import CentreCloud
from ..data.branch import BranchSkeleton
from ..data.synthetic import generate_tree
from ..data.tree import TreeSkeleton
from ..infer.inference import ModelInference
from ..neighbors.knn import nn as nn_query
from ..skeleton.skeletonize import Skeletonizer
from ..train.metrics import segmentation_iou, skeleton_distance

_DEFAULT = object()  # sentinel: follow the Skeletonizer class default


def centred_tree(seed: int, height=8.0, trunk_radius=0.15, points=3000.0, foliage=4000):
    """A synthetic tree through `CentreCloud`, and its ground-truth skeleton
    moved into the same (centred) frame: the predicted skeleton lives there,
    so skeleton distances would otherwise measure the centring translation."""
    cloud, gt_skel = generate_tree(
        seed=seed, height=height, trunk_radius=trunk_radius,
        points_per_m2=points, foliage_points=foliage,
    )
    raw_xyz0 = np.asarray(cloud.xyz[0])
    cloud = CentreCloud()(cloud)
    offset = np.asarray(cloud.xyz[0]) - raw_xyz0
    gt_skel = TreeSkeleton(
        gt_skel._id,
        {
            k: BranchSkeleton(b._id, b.parent_id, b.xyz + offset, b.radii, b.child_id)
            for k, b in gt_skel.branches.items()
        },
    )
    return cloud, gt_skel


def aligned_truth(lc, cloud, device):
    """Predicted rows matched to their nearest ground-truth point within
    0.05 m: (rows matched [N] bool, the matched ground-truth rows)."""
    _, idx = nn_query(np.asarray(lc.xyz), np.asarray(cloud.xyz), 0.05, device=device)
    idx = idx.cpu().numpy()
    ok = idx >= 0
    return ok, idx[ok]


def evaluate_tree(mi: ModelInference, seed: int, height=8.0, trunk_radius=0.15,
                  points=3000.0, foliage=4000, min_filter_radius=_DEFAULT):
    """Quality metrics of `mi` on one synthetic tree; the alignment, the
    skeletonizer and the skeleton distances run on `mi`'s device."""
    dev = mi.device
    cloud, gt_skel = centred_tree(seed, height, trunk_radius, points, foliage)
    t0 = time.perf_counter()
    lc = mi.forward(cloud)
    t_inf = time.perf_counter() - t0

    ok, rows = aligned_truth(lc, cloud, dev)
    gt_cls = np.asarray(cloud.class_l).reshape(-1)[rows]
    pr_cls = np.asarray(lc.class_l).reshape(-1)[ok]
    iou = segmentation_iou(pr_cls, gt_cls)

    gt_mv = np.asarray(cloud.medial_vector)[rows]
    gt_r = np.linalg.norm(gt_mv, axis=1)
    pr_r = np.asarray(lc.radius)[ok]
    pr_d = np.asarray(lc.medial_vector)[ok]
    pr_dn = pr_d / np.maximum(np.linalg.norm(pr_d, axis=1, keepdims=True), 1e-9)
    gt_dn = gt_mv / np.maximum(np.linalg.norm(gt_mv, axis=1, keepdims=True), 1e-9)

    branch = gt_cls == 0
    metrics = {
        "n_points": len(cloud),
        "inference_s": round(t_inf, 2),
        "points_per_s": round(len(cloud) / t_inf, 1),
        "iou_branch": round(iou[0], 4),
        "iou_foliage": round(iou.get(1, float("nan")), 4),
        "radius_mae": round(float(np.abs(pr_r - gt_r)[branch].mean()), 4),
        "radius_rel_mae": round(
            float((np.abs(pr_r - gt_r) / np.maximum(gt_r, 1e-6))[branch].mean()), 4
        ),
        "direction_cos": round(float((pr_dn * gt_dn).sum(1)[branch].mean()), 4),
    }

    t0 = time.perf_counter()
    sk = (
        Skeletonizer(device=dev)
        if min_filter_radius is _DEFAULT
        else Skeletonizer(min_filter_radius=min_filter_radius, device=dev)
    )
    skel = sk.forward(lc.filter_by_class([0]))
    metrics["skeletonize_s"] = round(time.perf_counter() - t0, 2)
    if skel.skeletons:
        metrics.update(
            {k: round(v, 4) for k, v in
             skeleton_distance(skel.skeletons[0], gt_skel, device=dev).items()}
        )
        metrics["n_branches"] = len(skel.skeletons[0].branches)
    return metrics


def filter_radius(arg):
    """`--min-filter-radius` as `evaluate_tree` takes it: absent follows the
    Skeletonizer default, 'none' switches the clamp off, else a float."""
    if arg is None:
        return _DEFAULT
    if str(arg).lower() == "none":
        return None
    return float(arg)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("weights")
    ap.add_argument("--seeds", type=int, nargs="+", default=[100, 101])
    ap.add_argument("--out", default=None)
    ap.add_argument(
        "--min-filter-radius", default=None,
        help="Skeletonizer min_filter_radius extension (skeleton/filter.py):"
        " a float clamp, 'none' for reference-faithful filtering, or omit"
        " to follow the Skeletonizer class default",
    )
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    mi = ModelInference(args.weights, device=args.device)
    mfr = filter_radius(args.min_filter_radius)
    results = []
    for seed in args.seeds:
        m = evaluate_tree(mi, seed, min_filter_radius=mfr)
        m["seed"] = seed
        print(json.dumps(m))
        results.append(m)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
