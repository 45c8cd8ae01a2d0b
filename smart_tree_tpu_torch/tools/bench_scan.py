"""Multi-tree forest scan (counterpart of `tools/bench_scan.py`, BASELINE
config 5): a procedural forest of several trees, millions of points over
tens of metres, through the block-tiled bf16 forward with the download
culled to the branch class, and optionally the multi-component skeleton
stage. Reports points/s and trees/min as the JAX tool does, plus the peak
device memory, the skeleton stage's seconds and counts, the reduced graph's
vertex count and the route its KNN took. Batches are as large as
`ModelInference` sizes them for the device; the JAX tool's 131,072-voxel
ceiling served its TPU host's compile helper, which the port does not have.

    python -m smart_tree_tpu_torch.tools.bench_scan [--trees 6] [--points-per-m2 8000] [--skeletonize]

Runs on the card; `--device cpu` runs the plain PyTorch versions on the CPU
(at the defaults that is hours: use a few trees at a low density).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..data.cloud import Cloud
from ..data.synthetic import generate_tree
from ..device import resolve_device
from ..infer.inference import ModelInference
from ..skeleton.graph import GRID_KNN_THRESHOLD
from ..skeleton.skeletonize import Skeletonizer

WEIGHTS = Path(__file__).resolve().parents[2] / "smart_tree_tpu/weights/noble-elevator-58.npz"


def make_forest(n_trees: int, points_per_m2: float, seed: int = 0) -> Cloud:
    rng = np.random.default_rng(seed)
    xyz, rgb = [], []
    for i in range(n_trees):
        cloud, _ = generate_tree(
            seed=seed + i, height=float(rng.uniform(8, 14)),
            trunk_radius=float(rng.uniform(0.15, 0.3)),
            points_per_m2=points_per_m2, foliage_points=30000,
        )
        offset = np.asarray(
            [rng.uniform(-20, 20), 0.0, rng.uniform(-20, 20)], np.float32
        )
        xyz.append(np.asarray(cloud.xyz) + offset)
        rgb.append(np.asarray(cloud.rgb))
    return Cloud(xyz=np.concatenate(xyz), rgb=np.concatenate(rgb))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak(dev: torch.device):
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None


def scan(cloud: Cloud, n_trees: int, weights=WEIGHTS, skeletonize: bool = False,
         device=None, precision: str = "bfloat16"):
    """One warm-up forward, one timed forward and, with `skeletonize`, the
    skeleton stage over the branch points: (the report, the timed forward's
    cloud, the skeleton or None). Wall clock around work ended by a device
    synchronise. `precision` is the tool's bf16 unless a caller asks for
    fp32, as the CPU parity test against the JAX package does."""
    mi = ModelInference(weights, precision=precision, medial_classes=(0,), device=device)
    dev = mi.device
    n = len(cloud)
    t0 = time.perf_counter()
    mi.forward(cloud)  # warm-up: first launches, allocator growth
    _sync(dev)
    warm = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    lc = mi.forward(cloud)
    _sync(dev)
    dt = time.perf_counter() - t0
    out = {
        "metric": "tiled scan inference points/sec",
        "value": round(n / dt, 1),
        "unit": "points/sec",
        "n_points": n,
        "warm_s": round(dt, 2),
        "cold_s": round(warm, 2),
        "trees_per_min": round(n_trees / dt * 60, 2),
        "forward_peak_bytes": _peak(dev),
    }
    skel = None
    if skeletonize:
        sk = Skeletonizer(max_components=n_trees * 4, strict=False, device=dev)
        branch = lc.filter_by_class([0])
        stats: dict = {}
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        skel = sk.forward(branch, stats=stats)
        _sync(dev)
        t_sk = time.perf_counter() - t0
        vertices = stats.get("graph_vertices", 0)
        out.update({
            "skeletonize_s": round(t_sk, 2),
            "skeletons": len(skel.skeletons),
            "end_to_end_trees_per_min": round(n_trees / (dt + t_sk) * 60, 2),
            "branch_points": len(branch),
            "branches": sum(len(s.branches) for s in skel.skeletons),
            "graph_vertices": vertices,
            "knn_route": "grid" if vertices > GRID_KNN_THRESHOLD else "brute force",
            "skeletonize_peak_bytes": _peak(dev),
            "stage_stats": stats,
        })
    return out, lc, skel


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", type=int, default=6)
    ap.add_argument("--points-per-m2", type=float, default=8000.0)
    ap.add_argument("--weights", default=str(WEIGHTS))
    ap.add_argument("--skeletonize", action="store_true",
                    help="also run the full skeleton stage (grid KNN path)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    resolve_device(args.device)  # raises before minutes of forest making without a card
    cloud = make_forest(args.trees, args.points_per_m2)
    print(f"# forest: {len(cloud) / 1e6:.2f}M points, {args.trees} trees", file=sys.stderr)
    out, _, _ = scan(cloud, args.trees, args.weights, args.skeletonize, args.device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
