"""Where the time goes in one bf16 forward of the bench tree on the card.

    python3 -m smart_tree_tpu_torch.scripts.profile_forward

The bench tree and model configuration are chip_smoke.py's (generate_tree
seed 0, 12 m, 12000 points/m2, 20000 foliage points, noble-elevator-58,
bf16, batch capacity <= 262144). After one warm-up forward it prints one
JSON line with:
  - host phases of one forward, each ended by a device synchronise:
    block tiling, per batch the plan build (upload, sort, rulebooks), the
    UNet and the download (which reruns a batch whose level overflowed);
  - torch.profiler's device time by kernel over a second forward, its sum,
    and the device's busy share of that forward's wall time (the profiler
    adds host overhead, so the busy share is a lower bound).
Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from ..core.sparse_ops import ConvConfig
from ..data.augmentations import CentreCloud
from ..data.dataset import BlockTiler
from ..data.synthetic import generate_tree
from ..infer.inference import ModelInference

WEIGHTS = Path(__file__).resolve().parents[2] / "smart_tree_tpu" / "weights" / "noble-elevator-58.npz"
BENCH_TREE = dict(seed=0, height=12.0, trunk_radius=0.25, points_per_m2=12000.0,
                  foliage_points=20000)


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
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_forward needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    cloud = CentreCloud()(generate_tree(**BENCH_TREE)[0])
    mi = ModelInference(WEIGHTS, batch_size=4, precision="bfloat16")
    mi.max_batch_capacity = min(mi.max_batch_capacity, 262144)
    mi.predict(cloud)  # warm-up

    phases = {"tiling_s": 0.0, "plan_s": 0.0, "unet_s": 0.0, "download_s": 0.0}
    t_all = time.perf_counter()
    tiler, dt = _sync_time(lambda: BlockTiler(cloud, 0.01, 4.0, 0.4))
    batches, dt2 = _sync_time(lambda: list(tiler.batches(4, max_capacity=mi.max_batch_capacity)))
    phases["tiling_s"] = dt + dt2
    sinks = ([], [], [], [])
    per_batch = []
    with torch.no_grad():
        for vb in batches:
            (x, plan, order), t_plan = _sync_time(lambda: mi._plan_batch(vb))
            cfg = ConvConfig(mi.precision, cap_hint=x.capacity, fused=mi.fused)
            preds, t_unet = _sync_time(lambda: mi.model(plan, x.feats, cfg))
            counts = torch.stack([lv.count for lv in plan.levels])
            caps = tuple(lv.keys.shape[0] for lv in plan.levels)
            _, t_down = _sync_time(
                lambda: mi._collect(vb, (preds, order, x.active, counts, caps), sinks))
            phases["plan_s"] += t_plan
            phases["unet_s"] += t_unet
            phases["download_s"] += t_down
            per_batch.append({"capacity": len(vb.coords), "plan_s": t_plan,
                              "unet_s": t_unet, "download_s": t_down})
    phases["forward_s"] = time.perf_counter() - t_all

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, wall = _sync_time(lambda: mi.predict(cloud))
    rows = [(e.key, e.count, _kernel_us(e)) for e in prof.key_averages()]
    rows = [r for r in rows if r[2] > 0]
    busy_us = sum(r[2] for r in rows)
    rows.sort(key=lambda r: -r[2])
    print(json.dumps({
        "card": card,
        "points": len(cloud),
        "batches": len(batches),
        "phases": phases,
        "per_batch": per_batch,
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
