"""Generate a synthetic-trees style dataset and its split json, so that
`train-smart-tree-torch` runs without the external dataset (counterpart of
`tools/make_synthetic_dataset.py`; the reference split is 480/60/60 over 6
species, here 6 parameter families). The same arguments write the same
files, bit for bit. Host numpy only: nothing here runs on a device.

    python -m smart_tree_tpu_torch.tools.make_synthetic_dataset data/synthetic-trees --per-family 10
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..data.file import save_data_npz
from ..data.synthetic import generate_tree

FAMILIES = {
    "cherry": dict(height=8.0, trunk_radius=0.15, max_depth=4),
    "apple": dict(height=6.0, trunk_radius=0.14, max_depth=4),
    "ginkgo": dict(height=10.0, trunk_radius=0.18, max_depth=3),
    "walnut": dict(height=12.0, trunk_radius=0.25, max_depth=4),
    "pine": dict(height=14.0, trunk_radius=0.3, max_depth=3),
    "eucalyptus": dict(height=16.0, trunk_radius=0.28, max_depth=3),
}


def _bucket(i: int, per_family: int) -> str:
    """The second-to-last tree of a family is a test tree and the last a
    validation tree (with at least 3 a family); otherwise 80/10/10 by
    position."""
    if per_family >= 3 and i == per_family - 2:
        return "test"
    if per_family >= 3 and i == per_family - 1:
        return "validation"
    frac = i / max(per_family, 1)
    return "train" if frac < 0.8 else ("test" if frac < 0.9 else "validation")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--per-family", type=int, default=10)
    ap.add_argument("--points-per-m2", type=float, default=4000.0)
    ap.add_argument("--foliage", type=int, default=4000)
    ap.add_argument(
        "--vary",
        action="store_true",
        help="randomize density/noise/foliage per tree (log-uniform around "
        "the nominal values) so the model can't key on one sampling pattern",
    )
    args = ap.parse_args(argv)

    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    split = {"train": [], "validation": [], "test": []}
    seed = 0
    for fam, kw in FAMILIES.items():
        for i in range(args.per_family):
            pts = args.points_per_m2
            fol = args.foliage
            noise = 0.002
            if args.vary:
                vrng = np.random.default_rng(10_000 + seed)
                pts = float(args.points_per_m2 * np.exp(vrng.uniform(-0.9, 0.9)))
                fol = int(args.foliage * np.exp(vrng.uniform(-0.9, 0.9)))
                noise = float(vrng.uniform(0.001, 0.004))
            cloud, skel = generate_tree(
                seed=seed, points_per_m2=pts, foliage_points=fol, noise=noise, **kw
            )
            name = f"{fam}_{i:03d}.npz"
            save_data_npz(out / name, skel, cloud)
            bucket = _bucket(i, args.per_family)
            split[bucket].append(name)
            seed += 1
            print(f"{name}: {len(cloud)} pts, {len(skel.branches)} branches -> {bucket}")
    with open(out / "split.json", "w") as f:
        json.dump(split, f, indent=1)
    print(f"wrote {out}/split.json")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
