"""Where the time goes in one train step at the default training
configuration on the card (planes 8/16/32/64, capacity 98,304, 416^3 grid,
fp32, `feature_mode: local`).

    python3 -m smart_tree_tpu_torch.scripts.profile_train

Batches come from the real host path: a few synthetic trees (chip_smoke.py's
corpus tree) through `TreeDataset`, the training augmentation and
`_device_batches`. After two warm-up steps it prints one JSON line with:
  - the host's seconds to make one batch (augment, voxelise, pack, encode);
  - phases of a step, each ended by a device synchronise: upload, decode +
    sort + plan, forward + losses, backward, Adam;
  - the same steps run back to back with one synchronise at the end;
  - torch.profiler's device time by kernel over one more step, its sum, and
    the device's busy share of that step's wall time (a lower bound: the
    profiler slows the host);
  - peak device bytes.
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

from ..core.sparse_ops import ConvConfig
from ..data.file import save_data_npz
from ..data.synthetic import generate_tree
from ..device import resolve_device
from ..train import step as step_mod
from ..train import train as train_mod
from ..train.losses import compute_loss
from ..utils.configs import default_training_config, instantiate, resolve
from .profile_forward import _kernel_us, _sync_time

CORPUS_TREE = dict(height=10.0, trunk_radius=0.2, points_per_m2=8000.0, foliage_points=8000)
TREES = 8


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_train needs a CUDA card", file=sys.stderr)
        return 2
    dev = resolve_device(None)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as work:
        work = Path(work)
        names = []
        for i in range(TREES):
            cloud, skel = generate_tree(seed=100 + i, **CORPUS_TREE)
            names.append(f"tree_{i}.npz")
            save_data_npz(str(work / names[-1]), skel, cloud)
        (work / "split.json").write_text(
            json.dumps({"train": names, "validation": names[:1], "test": names[:1]}))
        cfg = default_training_config()
        cfg.update(directory=str(work), json_path=str(work / "split.json"))
        cfg = resolve(cfg, cfg)
        dataset = instantiate(cfg["train_dataset"])
        t0 = time.perf_counter()
        batches = list(train_mod._device_batches(dataset, cfg))
        batch_s = (time.perf_counter() - t0) / len(batches)

    sc = train_mod.step_config(cfg, int(cfg["batch_size"]))
    state = step_mod.TrainState(train_mod.build_model(cfg["model"], cfg["seed"]).to(dev),
                                lr=cfg["lr"])
    model, levels = state.model, len(cfg["model"]["unet_planes"])
    for b in batches[:2]:  # warm-up
        step_mod.train_step(state, step_mod.batch_to_device(b, dev), sc)
    torch.cuda.synchronize()

    phases = {"upload_s": 0.0, "plan_s": 0.0, "forward_s": 0.0, "backward_s": 0.0,
              "adam_s": 0.0}
    torch.cuda.reset_peak_memory_stats()
    for b in batches:
        tb, dt = _sync_time(lambda: step_mod.batch_to_device(b, dev))
        phases["upload_s"] += dt
        model.train()
        (x, plan, targets, mask), dt = _sync_time(
            lambda: step_mod._prepare(tb, sc, levels, sc.compute_dtype))
        phases["plan_s"] += dt

        def forward():
            preds = model(plan, x.feats, ConvConfig(sc.matmul_precision, cap_hint=x.capacity))
            return sum(compute_loss(preds, targets, mask, direction_loss=sc.direction_loss,
                                    direction_min_radius=sc.direction_min_radius).values())

        total, dt = _sync_time(forward)
        phases["forward_s"] += dt
        state.optimizer.zero_grad(set_to_none=True)
        _, dt = _sync_time(total.backward)
        phases["backward_s"] += dt
        _, dt = _sync_time(state.optimizer.step)
        phases["adam_s"] += dt
    peak = torch.cuda.max_memory_allocated()
    phases = {k: v / len(batches) for k, v in phases.items()}
    phases["step_s"] = sum(phases.values())

    def run_all():
        for b in batches:
            step_mod.train_step(state, step_mod.batch_to_device(b, dev), sc)

    _, chained = _sync_time(run_all)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, wall = _sync_time(lambda: step_mod.train_step(
            state, step_mod.batch_to_device(batches[0], dev), sc))
    rows = [(e.key, e.count, _kernel_us(e)) for e in prof.key_averages()]
    rows = [r for r in rows if r[2] > 0]
    busy_us = sum(r[2] for r in rows)
    rows.sort(key=lambda r: -r[2])
    voxels = [int(b[4].sum()) for b in batches]
    print(json.dumps({
        "card": card,
        "batches": len(batches),
        "voxels_per_batch": voxels,
        "capacity": int(cfg["batch_capacity"]),
        "host_batch_s": batch_s,
        "phases_per_step": phases,
        "chained_step_s": chained / len(batches),
        "chained_voxels_per_s": sum(voxels) / chained,
        "peak_bytes": peak,
        "profiled_step_s": wall,
        "device_kernels": sum(r[1] for r in rows),
        "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / wall,
        "top_device_kernels": [
            {"name": k[:90], "calls": c, "ms": us / 1e3} for k, c, us in rows[:15]
        ],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
