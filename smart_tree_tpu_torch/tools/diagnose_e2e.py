"""Where skeleton length is lost, stage by stage (counterpart of
`tools/diagnose_e2e.py`), on the workload of tests/test_e2e_quality.py:

  model:    class IoU, direction cosine and radius MAE by ground-truth
            radius bucket
  filter:   points surviving outlier_removal
  graph:    components of at least minimum_graph_vertices against all, and
            the mass dropped with the small ones
  tracer:   recovered length per component against the ground truth, plus
            an ORACLE run (ground-truth medial vectors and classes through
            the same skeletonizer) to separate model quality from the
            skeleton machinery.

    python -m smart_tree_tpu_torch.tools.diagnose_e2e smart_tree_tpu/weights/synthetic-r2.npz

Runs on the card; `--device cpu` runs the plain PyTorch versions on the CPU.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..data.augmentations import CentreCloud
from ..data.cloud import Cloud
from ..data.synthetic import generate_tree
from ..device import resolve_device
from ..graph import component_sizes, connected_components
from ..infer.inference import ModelInference
from ..skeleton.filter import outlier_removal
from ..skeleton.graph import nn_graph
from ..skeleton.skeletonize import Skeletonizer
from ..train.metrics import segmentation_iou
from .evaluate import aligned_truth


def bucket_stats(gt_r, cos, abs_err, buckets=(0.0, 0.005, 0.01, 0.02, 0.04, 10.0)):
    rows = []
    for lo, hi in zip(buckets[:-1], buckets[1:]):
        m = (gt_r >= lo) & (gt_r < hi)
        if m.sum() == 0:
            continue
        rows.append({
            "r_lo": lo, "r_hi": hi, "n": int(m.sum()),
            "dir_cos": round(float(cos[m].mean()), 3),
            "radius_mae": round(float(abs_err[m].mean()), 4),
        })
    return rows


def skeleton_accounting(cloud_branch, sk: Skeletonizer, gt_len, label):
    """Print one line of stage counts for `cloud_branch` through `sk`'s
    filter, graph and components (on `sk`'s device, the full graph without
    the cell reduction) and the skeleton `sk.forward` recovers; returns that
    skeleton."""
    dev = resolve_device(sk.device)
    medial_pts = torch.as_tensor(np.asarray(cloud_branch.medial_pts, np.float32), device=dev)
    radii = torch.as_tensor(np.asarray(cloud_branch.radius, np.float32), device=dev).reshape(-1)
    n = medial_pts.shape[0]
    keep = outlier_removal(medial_pts, radii, nb_points=8)
    graph = nn_graph(medial_pts, radii.clamp_min(sk.min_connection_length), k=sk.K,
                     valid=keep)
    labels = connected_components(graph.edges, graph.valid, n, vertex_valid=keep)
    sizes = component_sizes(labels, keep).cpu().numpy()
    big = sizes[sizes >= sk.minimum_graph_vertices]
    small_mass = int(sizes[(sizes > 0) & (sizes < sk.minimum_graph_vertices)].sum())
    out = sk.forward(cloud_branch)
    got = sum(s.length for s in out.skeletons)
    per_comp = [round(sum(b.length for b in s.branches.values()), 2)
                for s in out.skeletons]
    print(json.dumps({
        "stage": label,
        "medial_pts": int(n),
        "after_outlier_removal": int(keep.sum()),
        "components_kept": int(len(big)),
        "component_sizes_top10": sizes[np.argsort(-sizes)][:10].tolist(),
        "small_component_mass": small_mass,
        "recovered_len": round(float(got), 2),
        "gt_len": round(float(gt_len), 2),
        "recovery_pct": round(100 * float(got) / gt_len, 1),
        "per_component_len": per_comp[:10],
    }))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("weights")
    ap.add_argument("--seed", type=int, default=1000)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    mi = ModelInference(str(args.weights), device=args.device)  # raises first without a card
    cloud, gt = generate_tree(seed=args.seed, height=7.0, trunk_radius=0.14,
                              points_per_m2=4000.0, foliage_points=3000)
    cloud = CentreCloud()(cloud)
    gt_len = gt.length
    lc = mi.forward(cloud)

    ok, rows = aligned_truth(lc, cloud, mi.device)
    gt_cls = np.asarray(cloud.class_l).reshape(-1)[rows]
    pr_cls = np.asarray(lc.class_l).reshape(-1)[ok]
    iou = segmentation_iou(pr_cls, gt_cls)
    gt_mv = np.asarray(cloud.medial_vector)[rows]
    gt_r = np.linalg.norm(gt_mv, axis=1)
    pr_mv = np.asarray(lc.medial_vector)[ok]
    pr_r = np.linalg.norm(pr_mv, axis=1)
    gdn = gt_mv / np.maximum(gt_r[:, None], 1e-9)
    pdn = pr_mv / np.maximum(pr_r[:, None], 1e-9)
    cos = (gdn * pdn).sum(1)
    branch = gt_cls == 0
    print(json.dumps({
        "stage": "model",
        "n_points": len(cloud),
        "iou": {str(k): round(v, 3) for k, v in iou.items()},
        "branch_buckets": bucket_stats(
            gt_r[branch], cos[branch], np.abs(pr_r - gt_r)[branch]
        ),
    }))

    sk = Skeletonizer(hop_cap=16384, strict=False, device=mi.device)
    skeleton_accounting(lc.filter_by_class([0]), sk, gt_len, "predicted")

    # oracle: ground-truth medial vectors and classes through the same machinery
    gt_branch_mask = np.asarray(cloud.class_l).reshape(-1) == 0
    oracle = Cloud(
        xyz=np.asarray(cloud.xyz)[gt_branch_mask],
        rgb=(np.asarray(cloud.rgb)[gt_branch_mask] if cloud.rgb is not None else None),
        medial_vector=np.asarray(cloud.medial_vector)[gt_branch_mask],
    )
    skeleton_accounting(oracle, sk, gt_len, "oracle")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
