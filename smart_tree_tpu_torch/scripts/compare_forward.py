"""Time the bench tree's bf16 forward of two copies of this package in one
process, alternating, so that a parent and a change of the code meet the same
card, host and warm state (card only).

    python3 -m smart_tree_tpu_torch.scripts.compare_forward OTHER/smart_tree_tpu_torch \
        [--rounds 10]

OTHER is the package directory of another tree (for example a `git archive`
of the parent commit). It is copied under `build/compare/` as the package
`stt_other` and imported beside this one. Each round times one forward of
each package with the default configuration's download cull
(`medial_classes=[0]`, mode `culled`) and without it (`medial_classes=None`,
mode `compact`), the order of the two packages alternating by round.
Prints one JSON line: per mode both packages' seconds, their medians, the
rounds this package was faster, and the other's inter-quartile range.
"""

from __future__ import annotations

import argparse
import importlib
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
WEIGHTS = REPO / "smart_tree_tpu" / "weights" / "noble-elevator-58.npz"
BENCH_TREE = dict(seed=0, height=12.0, trunk_radius=0.25, points_per_m2=12000.0,
                  foliage_points=20000)
MODES = {"culled": dict(medial_classes=[0]), "compact": dict(medial_classes=None)}


def _forwards(pkg: str) -> dict:
    """Per mode, a warmed-up ModelInference of package `pkg` and its cloud."""
    importlib.import_module(f"{pkg}.core.kernels").load()
    inf = importlib.import_module(f"{pkg}.infer.inference")
    syn = importlib.import_module(f"{pkg}.data.synthetic")
    aug = importlib.import_module(f"{pkg}.data.augmentations")
    cloud = aug.CentreCloud()(syn.generate_tree(**BENCH_TREE)[0])
    out = {}
    for mode, kw in MODES.items():
        mi = inf.ModelInference(WEIGHTS, batch_size=4, precision="bfloat16", **kw)
        mi.forward(cloud)
        mi.forward(cloud)
        out[mode] = (mi, cloud)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path)
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_forward needs a CUDA card", file=sys.stderr)
        return 2
    staging = REPO / "build" / "compare"
    shutil.rmtree(staging, ignore_errors=True)
    shutil.copytree(args.other, staging / "stt_other")
    sys.path.insert(0, str(staging))
    runs = {pkg: _forwards(pkg) for pkg in ("stt_other", "smart_tree_tpu_torch")}
    times = {(pkg, mode): [] for pkg in runs for mode in MODES}
    for r in range(args.rounds):
        order = ["stt_other", "smart_tree_tpu_torch"][:: 1 if r % 2 == 0 else -1]
        for mode in MODES:
            for pkg in order:
                mi, cloud = runs[pkg][mode]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mi.forward(cloud)
                torch.cuda.synchronize()
                times[(pkg, mode)].append(time.perf_counter() - t0)
    result = {"card": torch.cuda.get_device_name(0)}
    for mode in MODES:
        other = np.asarray(times[("stt_other", mode)])
        this = np.asarray(times[("smart_tree_tpu_torch", mode)])
        result[mode] = {
            "other_s": other.tolist(), "this_s": this.tolist(),
            "other_median_s": float(np.median(other)), "this_median_s": float(np.median(this)),
            "rounds_this_faster": int((this < other).sum()),
            "other_iqr_s": float(np.percentile(other, 75) - np.percentile(other, 25)),
        }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
