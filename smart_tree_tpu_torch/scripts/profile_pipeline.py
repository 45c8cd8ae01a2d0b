"""Where the time goes in the whole pipeline on the card: bench tree in,
skeleton PLYs out.

    python3 -m smart_tree_tpu_torch.scripts.profile_pipeline

The bench tree and model configuration are chip_smoke.py's (generate_tree
seed 0, 12 m, 12000 points/m2, 20000 foliage points, noble-elevator-58,
bf16); everything else, batch sizing included, is the default pipeline
configuration (`utils.configs.DEFAULT_PIPELINE`), saving into a temporary
directory. After one warm-up run it prints one JSON line with:
  - the seconds of each stage of one run (inference, outlier filter, reduce,
    KNN graph, table + shortcuts, components, SSSP + predecessors + root
    distances, tracer, post-process, save), the stage's counts (medial
    points, graph vertices, rounds, branches) and clouds per minute;
  - torch.profiler's device time by kernel over one more
    `Skeletonizer.forward` on the same labelled cloud: the ten largest, their
    sum, and the device's busy share of that call's wall time (the profiler
    adds host overhead, so the busy share is a lower bound).
Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from ..data.synthetic import generate_tree
from ..utils.configs import default_pipeline_config, instantiate

WEIGHTS = Path(__file__).resolve().parents[2] / "smart_tree_tpu" / "weights" / "noble-elevator-58.npz"
BENCH_TREE = dict(seed=0, height=12.0, trunk_radius=0.25, points_per_m2=12000.0,
                  foliage_points=20000)
STAGES = ("inference_s", "upload_s", "outlier_filter_s", "reduce_s", "knn_graph_s",
          "table_shortcuts_s", "components_s", "sssp_s", "tracer_s", "post_process_s",
          "save_s")


def bench_pipeline(save_path, precision: str = "bfloat16", device: str | None = None):
    """The default pipeline at the bench settings, saving into `save_path`."""
    cfg = default_pipeline_config()
    cfg["model_inference"].update(weights_path=str(WEIGHTS), precision=precision)
    cfg["save_path"] = str(save_path)
    if device is not None:
        cfg["model_inference"]["device"] = device
        cfg["skeletonizer"]["device"] = device
    return instantiate(cfg)


def process_raising_hop_cap(pipeline, cloud, stats: dict | None = None):
    """process_cloud, doubling the skeletonizer's hop_cap for as long as its
    strict check reports a truncated trace."""
    while True:
        if stats is not None:
            stats.clear()
        try:
            return pipeline.process_cloud(cloud=cloud, stats=stats)
        except RuntimeError as err:
            if "raise hop_cap" not in str(err) or pipeline.skeletonizer.hop_cap >= 1 << 20:
                raise
            pipeline.skeletonizer.hop_cap *= 2


def timed_run(pipeline, cloud):
    """One synchronised run: (the stage seconds and counts, the total and
    clouds per minute; the skeleton)."""
    stats: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    skeleton = process_raising_hop_cap(pipeline, cloud, stats)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    stats.update(
        total_s=total,
        clouds_per_minute=60.0 / total,
        hop_cap=pipeline.skeletonizer.hop_cap,
        skeletons=len(skeleton.skeletons),
        kept_branches=sum(len(s.branches) for s in skeleton.skeletons),
    )
    return stats, skeleton


def _kernel_us(evt) -> float:
    """Device microseconds of a kernel row of key_averages(); 0 for the
    host-op rows, which repeat their kernels' time."""
    if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
        return 0.0
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_pipeline needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    cloud = generate_tree(**BENCH_TREE)[0]
    with tempfile.TemporaryDirectory() as out:
        pipeline = bench_pipeline(out)
        process_raising_hop_cap(pipeline, cloud)  # warm-up
        stats, _ = timed_run(pipeline, cloud)

        labelled = pipeline.model_inference.forward(pipeline.preprocessing(cloud))
        branch_cloud = labelled.filter_by_class(pipeline.branch_classes)
        # device activity only: the stage launches tens of thousands of
        # kernels, and host-op events would multiply the trace
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pipeline.skeletonizer.forward(branch_cloud)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    rows = [(e.key, e.count, _kernel_us(e)) for e in prof.key_averages()]
    rows = sorted((r for r in rows if r[2] > 0), key=lambda r: -r[2])
    busy_us = sum(r[2] for r in rows)
    print(json.dumps({
        "card": card,
        "points": len(cloud),
        "pipeline": stats,
        "profiled_skeletonize_s": wall,
        "skeletonize_device_busy_s": busy_us / 1e6,
        "skeletonize_device_busy_share": busy_us / 1e6 / wall,
        "skeletonize_device_kernels": sum(r[1] for r in rows),
        "top_device_kernels": [
            {"name": k[:90], "calls": c, "ms": us / 1e3} for k, c, us in rows[:10]
        ],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
