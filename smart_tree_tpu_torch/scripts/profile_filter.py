"""Where the outlier filter's time goes on the card, by route.

    python3 -m smart_tree_tpu_torch.scripts.profile_filter [--count xla grid] [--clouds bench forest]

The clouds are the skeleton stage's inputs: the branch points (class 0) of a
bf16 forward of noble-elevator-58, culled as `tools/bench_scan.py` runs it,
over the bench tree (chip_smoke.py's, centred as the pipeline centres it)
and over the forest scan (`bench_scan.make_forest` at its defaults, six
trees, 8,000 points/m^2), with the radii the network predicts and the
skeletonizer's `min_filter_radius` 0.02 m.

For each cloud and counting route it splits the filter as
`skeleton/filter.py::outlier_removal` composes it: the count, the shell of
rows it cannot decide (`possible >= 8 > certain`) and `_exact_keep` on that
shell, each timed on the host around a synchronised card. The routes:
  - `xla`: `neighbors/knn.py::radius_count`, the JAX formulation (N^2 pairs
    in tiles, a margin from the cloud's extent), which the filter called
    before the grid count;
  - `grid`: `neighbors/grid_count.py::grid_radius_count`, the cell-sorted
    count with its CUDA kernel.
Then `outlier_removal` as a whole, as the imported package defines it. With
both routes it requires equal keep masks. One JSON line a cloud.

The `xla` route and the whole filter use only names that older trees of the
package have too, so the script also runs against one:
`PYTHONPATH=<that tree> python3 smart_tree_tpu_torch/scripts/profile_filter.py --count xla`.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from smart_tree_tpu_torch.data.augmentations import CentreCloud
from smart_tree_tpu_torch.data.synthetic import generate_tree
from smart_tree_tpu_torch.infer.inference import ModelInference
from smart_tree_tpu_torch.neighbors.knn import radius_count
from smart_tree_tpu_torch.skeleton import filter as filter_mod
from smart_tree_tpu_torch.tools.bench_scan import make_forest

WEIGHTS = Path(filter_mod.__file__).resolve().parents[2] / "smart_tree_tpu" / "weights" / \
    "noble-elevator-58.npz"
BENCH_TREE = dict(seed=0, height=12.0, trunk_radius=0.25, points_per_m2=12000.0,
                  foliage_points=20000)
NB_POINTS = 8
MIN_RADIUS = 0.02


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def medial_points(name: str):
    """(points [N,3], radii [N]) on the card: the branch class of a bf16 forward."""
    cloud = (CentreCloud()(generate_tree(**BENCH_TREE)[0]) if name == "bench"
             else make_forest(6, 8000.0))
    lc = ModelInference(WEIGHTS, precision="bfloat16", medial_classes=(0,)).forward(cloud)
    branch = lc.filter_by_class([0])
    up = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()
          for a in (branch.medial_pts, branch.radius)]
    return up[0], up[1].reshape(-1)


def _clock():
    torch.cuda.synchronize()
    return time.perf_counter()


def split(points, radii, route: str) -> tuple:
    """(seconds and counts of the count, the shell and _exact_keep; the keep mask)."""
    count = radius_count
    if route == "grid":
        from smart_tree_tpu_torch.neighbors.grid_count import grid_radius_count as count
    radii = radii.clamp_min(MIN_RADIUS)
    valid = torch.ones(points.shape[0], dtype=torch.bool, device=points.device)
    t0 = _clock()
    certain, possible = count(points, points, radii, src_valid=valid, dst_valid=valid,
                              cap=NB_POINTS)
    t1 = _clock()
    sure = certain >= NB_POINTS
    keep = sure & valid
    shell = torch.nonzero((possible >= NB_POINTS) & ~sure & valid).squeeze(1)
    t2 = _clock()
    if shell.numel():
        keep[shell] = filter_mod._exact_keep(points, radii, points[shell], radii[shell],
                                             NB_POINTS, valid)
    t3 = _clock()
    return {"count_s": t1 - t0, "shell_rows": int(shell.numel()), "shell_s": t2 - t1,
            "exact_keep_s": t3 - t2, "total_s": t3 - t0, "kept": int(keep.sum())}, keep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--count", nargs="+", choices=("xla", "grid"), default=["xla", "grid"])
    ap.add_argument("--clouds", nargs="+", choices=("bench", "forest"),
                    default=["bench", "forest"])
    ap.add_argument("--repeats", type=int, default=2,
                    help="timed runs of each split and of the whole filter")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_filter needs a CUDA card")
    name = card()
    for cloud in args.clouds:
        points, radii = medial_points(cloud)
        line = {"cloud": cloud, "card": name, "medial_points": int(points.shape[0]),
                "radius_quantiles": torch.quantile(
                    radii.clamp_min(MIN_RADIUS).double().cpu(),
                    torch.tensor([0.0, 0.5, 0.99, 1.0], dtype=torch.float64)).tolist(),
                "routes": {}}
        keeps = {}
        for route in args.count:
            split(points[:4096], radii[:4096], route)        # warm-up: first launches
            runs = []
            for _ in range(args.repeats):
                row, keeps[route] = split(points, radii, route)
                runs.append(row)
            line["routes"][route] = runs
        filter_mod.outlier_removal(points[:4096], radii[:4096], NB_POINTS, min_radius=MIN_RADIUS)
        whole = []
        for _ in range(args.repeats):
            t0 = _clock()
            keep = filter_mod.outlier_removal(points, radii, NB_POINTS, min_radius=MIN_RADIUS)
            whole.append(_clock() - t0)
        line["outlier_removal_s"] = whole
        for route, k in keeps.items():
            if not torch.equal(k, keep):
                raise AssertionError(f"{cloud}: the {route} split keeps other rows than "
                                     "outlier_removal")
        line["keep_equal"] = True
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
