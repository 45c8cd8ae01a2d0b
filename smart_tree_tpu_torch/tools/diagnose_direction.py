"""Direction-head quality by ground-truth radius bucket (counterpart of
`tools/diagnose_direction.py`).

A low overall direction cosine has two very different causes: (a) the head
is broken everywhere, or (b) direction is geometrically unlearnable for
sub-voxel twigs (opposite surface points share one 0.01 m voxel, so the
target is ambiguous in sign) and fine on the thick branches that carry the
skeleton. Bucketing the cosine and the radius error by the ground-truth
radius tells them apart.

    python -m smart_tree_tpu_torch.tools.diagnose_direction smart_tree_tpu/weights/synthetic-v3.npz --seed 100

Runs on the card; `--device cpu` runs the plain PyTorch versions on the CPU.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..data.augmentations import CentreCloud
from ..data.synthetic import generate_tree
from ..infer.inference import ModelInference
from .evaluate import aligned_truth

BUCKETS = [0.0, 0.005, 0.01, 0.02, 0.04, 0.08, 10.0]


def direction_buckets(cloud, lc, device) -> dict:
    """The report for predictions `lc` of the ground-truth cloud `cloud`
    (both in one frame), rows aligned on `device`."""
    ok, rows = aligned_truth(lc, cloud, device)
    gt_cls = np.asarray(cloud.class_l).reshape(-1)[rows]
    gt_mv = np.asarray(cloud.medial_vector)[rows]
    gt_r = np.linalg.norm(gt_mv, axis=1)
    pr_r = np.asarray(lc.radius)[ok]
    pr_d = np.asarray(lc.medial_vector)[ok]
    pr_dn = pr_d / np.maximum(np.linalg.norm(pr_d, axis=1, keepdims=True), 1e-9)
    gt_dn = gt_mv / np.maximum(gt_r[:, None], 1e-9)
    cos = (pr_dn * gt_dn).sum(1)
    branch = gt_cls == 0

    # medial point error relative to the ground-truth radius: the quantity
    # that drives skeleton quality (a wrong direction on a 3 mm twig still
    # lands within 6 mm of the axis)
    medial_err = np.linalg.norm(pr_r[:, None] * pr_dn - gt_mv, axis=1)

    out = {"overall_cos": round(float(cos[branch].mean()), 4),
           "n_branch_pts": int(branch.sum())}
    rows_out = []
    for lo, hi in zip(BUCKETS[:-1], BUCKETS[1:]):
        m = branch & (gt_r >= lo) & (gt_r < hi)
        if m.sum() == 0:
            continue
        rows_out.append({
            "r_lo": lo, "r_hi": hi, "n": int(m.sum()),
            "frac": round(float(m.mean() / max(branch.mean(), 1e-9)), 3),
            "cos": round(float(cos[m].mean()), 3),
            "radius_rel_mae": round(
                float((np.abs(pr_r - gt_r) / np.maximum(gt_r, 1e-6))[m].mean()), 3),
            "medial_err_mm": round(float(medial_err[m].mean() * 1000), 2),
            "medial_err_over_r": round(
                float((medial_err[m] / np.maximum(gt_r[m], 1e-6)).mean()), 2),
        })
    out["buckets"] = rows_out
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("weights")
    ap.add_argument("--seed", type=int, default=100)
    ap.add_argument("--height", type=float, default=8.0)
    ap.add_argument("--trunk-radius", type=float, default=0.15)
    ap.add_argument("--points", type=float, default=3000.0)
    ap.add_argument("--foliage", type=int, default=4000)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    mi = ModelInference(args.weights, device=args.device)  # raises first without a card
    cloud, _ = generate_tree(
        seed=args.seed, height=args.height, trunk_radius=args.trunk_radius,
        points_per_m2=args.points, foliage_points=args.foliage,
    )
    cloud = CentreCloud()(cloud)
    lc = mi.forward(cloud)
    print(json.dumps(direction_buckets(cloud, lc, mi.device), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
