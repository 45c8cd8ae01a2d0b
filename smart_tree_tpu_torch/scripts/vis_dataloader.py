"""Render training batches to PNGs with the software renderer (counterpart
of `smart_tree_tpu/scripts/vis_dataloader.py`; no open3d): each batch's
voxelised points, coloured by class.

    python -m smart_tree_tpu_torch.scripts.vis_dataloader DIR --json-path DIR/split.json --out OUT
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..data.augmentations import AugmentationPipeline, RandomCubicCrop
from ..data.dataset import TreeDataset
from ..viz.render import Renderer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("directory")
    ap.add_argument("--json-path", required=True)
    ap.add_argument("--out", type=Path, default=Path("batch_vis"))
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=4)
    args = ap.parse_args(argv)

    ds = TreeDataset(
        voxel_size=0.01,
        json_path=args.json_path,
        directory=args.directory,
        mode="train",
        input_features=["xyz"],
        target_features=["radius", "direction", "class_l"],
        augmentation=AugmentationPipeline([RandomCubicCrop(4.0)]),
    )
    args.out.mkdir(parents=True, exist_ok=True)
    r = Renderer(640, 480)
    cmap = np.asarray([[0.45, 0.325, 0.164], [0.541, 0.67, 0.164]])
    for i, vb in enumerate(ds.batches(args.batch_size)):
        if i >= args.batches:
            break
        pts = vb.feats[vb.valid][:, :3]
        cls = vb.targets[vb.valid][:, -1].astype(int)
        r.capture_to_file(args.out / f"batch{i:03d}.png", pts, cmap[np.clip(cls, 0, 1)])
        print(f"batch {i}: {int(vb.valid.sum())} voxels -> {args.out}/batch{i:03d}.png")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
