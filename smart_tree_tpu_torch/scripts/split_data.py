"""Split a directory of tree `.npz` files into train / test / validation
lists (counterpart of `smart_tree_tpu/scripts/split_data.py`): a random
80/10/10 split, or the same per species (`--stratified`; the species is
the file name before its last `_`), written as JSON.

    python -m smart_tree_tpu_torch.scripts.split_data DIR -o DIR/split.json [--stratified]
"""

from __future__ import annotations

import argparse
import json
import random
from collections import defaultdict
from pathlib import Path


def random_sample(files, train=0.8, test=0.1, seed=0):
    files = sorted(files)
    random.Random(seed).shuffle(files)
    n_train = int(len(files) * train)
    n_test = int(len(files) * test)
    return {
        "train": files[:n_train],
        "test": files[n_train : n_train + n_test],
        "validation": files[n_train + n_test :],
    }


def stratified_sample(files, train=0.8, test=0.1, seed=0):
    """random_sample within each species, the lists joined in species order."""
    groups = defaultdict(list)
    for f in files:
        groups[Path(f).stem.rsplit("_", 1)[0]].append(f)
    out = {"train": [], "test": [], "validation": []}
    for _, members in sorted(groups.items()):
        split = random_sample(members, train, test, seed)
        for k in out:
            out[k] += split[k]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("directory")
    ap.add_argument("-o", "--output", default="split.json")
    ap.add_argument("--stratified", action="store_true")
    ap.add_argument("--train", type=float, default=0.8)
    ap.add_argument("--test", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    files = [p.name for p in sorted(Path(args.directory).glob("*.npz"))]
    if not files:
        print(f"no .npz files in {args.directory}")
        return 1
    fn = stratified_sample if args.stratified else random_sample
    split = fn(files, args.train, args.test, args.seed)
    with open(args.output, "w") as f:
        json.dump(split, f, indent=1)
    print(f"wrote {args.output}: {len(split['train'])}/{len(split['test'])}/"
          f"{len(split['validation'])} train/test/val")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
