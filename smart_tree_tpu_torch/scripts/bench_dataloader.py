"""Input-pipeline throughput of training (counterpart of
`smart_tree_tpu/scripts/bench_dataloader.py`): whole epochs of
`TreeDataset.batches` (4 m cubic crops, voxelised on the host) on the host's
clock, items and voxels per second.

    python -m smart_tree_tpu_torch.scripts.bench_dataloader DIR --json-path DIR/split.json
"""

from __future__ import annotations

import argparse
import time

from ..data.augmentations import AugmentationPipeline, RandomCubicCrop
from ..data.dataset import TreeDataset


def main(argv=None, stats: list | None = None) -> int:
    """`stats`, when given, receives one dict per epoch (seconds, items,
    voxels, items_per_s, voxels_per_s)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("directory")
    ap.add_argument("--json-path", required=True)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--voxel-size", type=float, default=0.01)
    args = ap.parse_args(argv)

    ds = TreeDataset(
        voxel_size=args.voxel_size,
        json_path=args.json_path,
        directory=args.directory,
        mode="train",
        input_features=["xyz"],
        target_features=["radius", "direction", "class_l"],
        augmentation=AugmentationPipeline([RandomCubicCrop(4.0)]),
        cache=True,
    )
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        n_items, n_voxels = 0, 0
        for vb in ds.batches(args.batch_size):
            n_items += vb.batch_size
            n_voxels += int(vb.valid.sum())
        dt = time.perf_counter() - t0
        print(f"epoch {epoch}: {dt:.2f}s, {n_items / dt:.1f} items/s, "
              f"{n_voxels / dt / 1e6:.2f}M voxels/s")
        if stats is not None:
            stats.append({"seconds": dt, "items": n_items, "voxels": n_voxels,
                          "items_per_s": n_items / dt, "voxels_per_s": n_voxels / dt})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
