"""Where the time goes in one bf16 forward of the bench tree on the card.

    python3 -m smart_tree_tpu_torch.scripts.profile_forward          # the default path
    python3 -m smart_tree_tpu_torch.scripts.profile_forward --full   # predict()

The bench tree and model configuration are chip_smoke.py's (generate_tree
seed 0, 12 m, 12000 points/m2, 20000 foliage points, noble-elevator-58,
bf16, batches sized by `ModelInference`). The default path is the default
configuration's: `forward` with the download cull to `medial_classes=[0]`;
`--full` profiles `predict()`, the full fp32 download. After one warm-up
pass it prints one JSON line with:
  - host block tiling with the native dedup (`voxelize_host`) and with the
    numpy one (`voxelize_host_plain`), and whether the two tilings agree
    (`predict()`'s tiler); the forward's device tiling (core/tiler.py) and
    its grouping into batches;
  - per batch, each ended by a device synchronise: the run half (slot
    table, gather or upload, the exact plan with its count reads, UNet,
    partition) and the collect half (fetch, download, host rows), the
    plan's level rows, and the bytes the forward moved each way;
  - whole passes at max_in_flight 1 and 2;
  - torch.profiler's device time by kernel over one more pass, its sum,
    and the device's busy share of that pass's wall time (the profiler
    adds host overhead, so the busy share is a lower bound).
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..data.augmentations import CentreCloud
from ..data.dataset import BlockTiler, voxelize_host_plain
from ..data.synthetic import generate_tree
from ..infer.inference import ModelInference

WEIGHTS = Path(__file__).resolve().parents[2] / "smart_tree_tpu" / "weights" / "noble-elevator-58.npz"
BENCH_TREE = dict(seed=0, height=12.0, trunk_radius=0.25, points_per_m2=12000.0,
                  foliage_points=20000)


class NumpyTiler(BlockTiler):
    """The tiler with the numpy dedup, for timing against the native one."""

    dedup = staticmethod(voxelize_host_plain)


def _kernel_us(evt) -> float:
    """Device microseconds of a kernel row of key_averages(); 0 for the
    host-op rows, which repeat their kernels' time."""
    if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
        return 0.0
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def tilings_agree(a: BlockTiler, b: BlockTiler) -> bool:
    """Equal blocks: voxel coords, features and interior masks, in order."""
    return len(a.blocks) == len(b.blocks) and all(
        np.array_equal(x.coords, y.coords) and np.array_equal(x.feats, y.feats)
        and np.array_equal(x.interior, y.interior) for x, y in zip(a.blocks, b.blocks))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--full", action="store_true",
                        help="profile predict() instead of the default forward")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_forward needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    cloud = CentreCloud()(generate_tree(**BENCH_TREE)[0])
    mi = ModelInference(WEIGHTS, batch_size=4, precision="bfloat16", medial_classes=[0])
    if args.full:
        entry, run, collect = mi.predict, mi._run_batch, mi._collect
    else:
        entry, run, collect = mi.forward, mi._run_batch_culled, mi._collect_culled
    entry(cloud)  # warm-up

    tiler, native_s = _sync_time(lambda: BlockTiler(cloud, 0.01, 4.0, 0.4))
    plain, numpy_s = _sync_time(lambda: NumpyTiler(cloud, 0.01, 4.0, 0.4))
    host_batches, batch_s = _sync_time(
        lambda: list(tiler.batches(4, max_capacity=mi.max_batch_capacity)))
    device_batches, device_s = _sync_time(lambda: mi._tile_batches(cloud))
    batches = host_batches if args.full else device_batches
    phases = {"tiling_native_s": native_s + batch_s, "tiling_numpy_s": numpy_s + batch_s,
              "tilings_agree": tilings_agree(tiler, plain), "tiling_device_s": device_s,
              "run_s": 0.0, "collect_s": 0.0}
    mi.link_bytes.update(upload=0, download=0)
    sinks = ([], [], [], [])
    per_batch = []
    mi.plan_rows = []
    for vb in batches:
        out, t_run = _sync_time(lambda: run(vb))
        _, t_collect = _sync_time(lambda: collect(vb, out, sinks))
        phases["run_s"] += t_run
        phases["collect_s"] += t_collect
        per_batch.append({"capacity": vb.capacity, "level_rows": mi.plan_rows[-1],
                          "run_s": t_run, "collect_s": t_collect})
    phases["link_bytes"] = dict(mi.link_bytes)
    forward_s = {}
    for k in (1, 2):
        mi.max_in_flight = k
        _, forward_s[f"in_flight_{k}"] = _sync_time(lambda: entry(cloud))

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, wall = _sync_time(lambda: entry(cloud))
    rows = [(e.key, e.count, _kernel_us(e)) for e in prof.key_averages()]
    rows = [r for r in rows if r[2] > 0]
    busy_us = sum(r[2] for r in rows)
    rows.sort(key=lambda r: -r[2])
    print(json.dumps({
        "card": card,
        "path": "predict" if args.full else "forward",
        "points": len(cloud),
        "batches": len(batches),
        "phases": phases,
        "per_batch": per_batch,
        "forward_s": forward_s,
        "profiled_forward_s": wall,
        "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / wall,
        "top_device_kernels": [
            {"name": k[:90], "calls": c, "ms": us / 1e3} for k, c, us in rows[:15]
        ],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
