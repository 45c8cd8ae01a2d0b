"""Small training probe over augmented or varied batches (counterpart of
`tools/cpu_probe.py`, whose name it keeps).

Reproduces in minutes the direction head's constant-solution stall seen in
full training, for A/B tests of recipe variables: the augmentation, the
learning rate, the direction loss, the input features, the widths.

    python -m smart_tree_tpu_torch.tools.cpu_probe --steps 400 --aug full|crop|none \\
        [--trees 6] [--lr 0.01] [--direction-loss l2raw] [--features local]

Despite its name it runs on the card; `--device cpu` runs the plain PyTorch
versions on the CPU, as the JAX tool runs. One numpy generator seeded 0
draws the augmentation parameters and the trees in the JAX tool's order, so
equal weights see equal batches.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable

import numpy as np

from ..data.augmentations import (AugmentationPipeline, RandomCubicCrop, RandomDropout,
                                  RandomRotateY, RandomScale)
from ..data.dataset import collate, voxelize_host
from ..data.synthetic import generate_tree
from ..device import resolve_device
from ..train.step import StepConfig, TrainState, train_step
from .overfit_probe import VOXEL, device_batch, fetched, initial_model, labelled, logged

SPATIAL = (256, 256, 256)


def augmentation(aug: str) -> AugmentationPipeline:
    if aug == "full":
        return AugmentationPipeline([RandomRotateY(), RandomScale(0.8, 1.2),
                                     RandomCubicCrop(1.5), RandomDropout(0.3)])
    # "crop", and "none", which bounds the voxels with the same crop of each
    # tree every time (a generator seeded by the tree's index)
    return AugmentationPipeline([RandomCubicCrop(1.5)])


def line(rec: dict) -> str:
    return (f"{rec['step']:4d} dir {rec['direction']:.4f} rad {rec['radius']:.4f} "
            f"cls {rec['class_l']:.4f} [{rec['seconds']:.0f}s]")


def run(steps: int = 400, aug: str = "full", trees: int = 6, lr: float = 0.01,
        direction_loss: str = "l2raw", features: str = "local", items: int = 2,
        log_every: int = 25, cap: int = 8192, dir_weight: float = 1.0,
        planes=(8, 16, 32), variables=None, device=None,
        echo: Callable[[str], None] | None = None) -> list:
    """Train `steps` Adam steps, each on `items` augmented crops of the
    `trees` small trees; every step's losses, as {"step", "radius",
    "direction", "class_l", "seconds"}. `echo`, when given, receives the
    tool's line of every logged step."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    clouds = [
        generate_tree(seed=s, height=4.0, trunk_radius=0.12, points_per_m2=4000.0,
                      foliage_points=1000, max_depth=3)[0]
        for s in range(trees)
    ]
    pipeline = augmentation(aug)

    def item(cloud, det_seed=None):
        r = np.random.default_rng(det_seed) if det_seed is not None else rng
        xyz, targets = labelled(pipeline(cloud, r))
        co, da, o = voxelize_host(xyz, np.concatenate([xyz, targets], 1), VOXEL)
        return co, da[:, :3], da[:, 3:], "x", o

    state = TrainState(initial_model(features, planes, variables).to(device), lr=lr)
    sc = StepConfig(spatial_shape=SPATIAL, device_batch=items, voxel_size=VOXEL,
                    direction_loss=direction_loss, feature_mode=features,
                    direction_weight=dir_weight)
    records = []
    t0 = time.time()
    for i in range(steps):
        if aug == "none":
            if items == trees:
                idxs = list(range(trees))  # the same batch every step
            else:
                idxs = [int(rng.integers(0, trees)) for _ in range(items)]
            batch_items = [item(clouds[j], det_seed=j) for j in idxs]
        else:
            batch_items = [item(clouds[rng.integers(0, trees)]) for _ in range(items)]
        vb = collate(batch_items, items, capacity=cap, on_overflow="truncate",
                     voxel_size=VOXEL)
        records.append(fetched(i, train_step(state, device_batch(vb, device), sc), t0))
        if echo and logged(i, steps, log_every):
            echo(line(records[-1]))
    return records


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--aug", default="full", choices=["full", "crop", "none"])
    ap.add_argument("--trees", type=int, default=6)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--direction-loss", default="l2raw")
    ap.add_argument("--features", default="local")
    ap.add_argument("--items", type=int, default=2)
    ap.add_argument("--log-every", type=int, default=25)
    ap.add_argument("--cap", type=int, default=8192)
    ap.add_argument("--dir-weight", type=float, default=1.0)
    ap.add_argument("--planes", default="8,16,32")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the CPU)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    run(steps=args.steps, aug=args.aug, trees=args.trees, lr=args.lr,
        direction_loss=args.direction_loss, features=args.features, items=args.items,
        log_every=args.log_every, cap=args.cap, dir_weight=args.dir_weight,
        planes=tuple(int(x) for x in args.planes.split(",")), device=args.device,
        echo=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
