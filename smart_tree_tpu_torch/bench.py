"""The port's benchmark: points per second of `ModelInference.forward` on the
bench tree, the clouds per minute of one cloud-to-skeleton pass, and the
forward's device time. The counterpart of the root `bench.py`, which stays
the JAX package's TPU bench.

    python -m smart_tree_tpu_torch.bench                     # on the card
    python -m smart_tree_tpu_torch.bench --tiny --device cpu # small, on the CPU
    python -m smart_tree_tpu_torch.bench --profile DIR       # + a Chrome trace

Workload: `generate_tree(seed=0, height=12, trunk_radius=0.25,
points_per_m2=12000, foliage_points=20000)`, centred, through
noble-elevator-58 at bf16 (voxel 0.01 m, block 4 m, buffer 0.4 m, batch 4,
`level_capacity_factor=0.5` as the JAX bench passes it (unused: the port's
plans are exact), culled to class 0, batches sized by `ModelInference`'s
budget). `batch_capacities` are the batches' pow2 capacities (the host's
batching), `batch_level_rows` the level rows of each batch's exact plan,
which the roofline (tools/roofline.py) counts.

`main` is a supervisor. It runs the measurement once, in the shipped
configuration, in a child process, and always prints one JSON line as the
last line of its standard output, also when the child raises, dies or times
out: the line then carries `error` and whatever the child checkpointed
(`partial`). It exits non-zero whenever the line carries `error` or
`skeleton_error`. There is no second attempt and no fallback: without a card
the child raises (`--device cpu` asks for the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from .core import slab_conv
from .data.augmentations import CentreCloud
from .data.dataset import BlockTiler
from .data.synthetic import generate_tree
from .device import resolve_device
from .infer.inference import ModelInference
from .skeleton.skeletonize import Skeletonizer

ROOT = Path(__file__).resolve().parents[1]
DEFAULT_WEIGHTS = str(ROOT / "smart_tree_tpu" / "weights" / "noble-elevator-58.npz")
METRIC = "sparse-unet inference points/sec"
UNIT = "points/sec"
# BASELINE.md:158: the JAX package's reference-semantics forward of this
# workload on a CPU (`bench.py --record-cpu-baseline`); not a TPU figure
CPU_BASELINE_POINTS_PER_SEC = 8_873.0
TINY = dict(points_per_m2=120.0, foliage_points=200, height=6.0, reps=1, dev_reps=1)
FAULTS = ("raise", "exit-after-warmup")
ATTEMPT_TIMEOUT_S = 2700.0


def _note(msg: str) -> None:
    print(f"# {time.strftime('%H:%M:%S')} {msg}", file=sys.stderr, flush=True)


def _write_partial(path: str | None, data: dict) -> None:
    """Checkpoint `data` to `path` whole: written aside, then renamed over,
    so a child killed mid-write leaves the previous checkpoint readable."""
    if path:
        aside = Path(f"{path}.tmp")
        aside.write_text(json.dumps(data))
        os.replace(aside, path)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _device_name(dev: torch.device) -> str:
    if dev.type != "cuda":
        return dev.type
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _timed_forward(mi: ModelInference, cloud, dev: torch.device):
    """(seconds, output cloud) of one forward, the card synchronised on both
    sides."""
    _sync(dev)
    t0 = time.perf_counter()
    out = mi.forward(cloud)
    _sync(dev)
    return time.perf_counter() - t0, out


def union_s(intervals) -> float:
    """Seconds covered by at least one of the (start, end) intervals: the
    union, so that overlapping intervals count once."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def kernel_busy_s(events) -> float:
    """Seconds during which at least one CUDA kernel ran, from a
    torch.profiler event list: the union of the kernel intervals (copies and
    memsets left out; they run on the copy stream beside the kernels)."""
    return union_s(
        (e.time_range.start / 1e6, e.time_range.end / 1e6)
        for e in events
        if str(e.device_type).endswith("CUDA") and not e.name.startswith(("Memcpy", "Memset"))
    )


def _profiled_forward(mi: ModelInference, cloud, dev: torch.device, trace: Path | None = None):
    """One forward under torch.profiler: (wall seconds, its events). With
    `trace`, the Chrome trace is written there."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        wall, _ = _timed_forward(mi, cloud, dev)
    if trace is not None:
        trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace))
        _note(f"trace written to {trace}")
    return wall, prof.events()


def run_bench(
    points_per_m2: float = 12000.0,
    foliage_points: int = 20000,
    height: float = 12.0,
    reps: int = 3,
    dev_reps: int = 5,
    profile: str | None = None,
    weights: str = DEFAULT_WEIGHTS,
    partial_path: str | None = None,
    device: str = "cuda",
    fault: str | None = None,
) -> dict:
    """One measurement; returns the bench's JSON dict.

    `value` is points per second of the median of `reps` timed forwards
    after one warm-up (`end_to_end_reps_s` holds each). The skeleton stage
    times one forward plus `filter_by_class([0])` and `Skeletonizer.forward`
    after one warm pass; a failure there becomes `skeleton_error`.

    Device time (the card only; `None` on the CPU): `dev_reps` more warm
    forwards, each under torch.profiler. `device_step_s` is the median of
    their kernel busy time, the union of the CUDA kernel intervals, not their
    sum. `dispatch_overhead_s` is the median of a profiled forward's wall
    time less its busy time: host work and idle time of the card, the
    profiler's own cost included. `profile` names a directory for the Chrome
    trace of the first profiled forward.

    `partial_path` receives the metrics measured so far after each stage.
    `fault` injects a failure for the tests: `raise` before any work,
    `exit-after-warmup` ends the process (code 3) after the warm-up."""
    if fault == "raise":
        raise RuntimeError("injected fault: raise")
    if fault not in (None, *FAULTS):
        raise ValueError(f"unknown fault {fault!r}")
    dev = resolve_device(device)
    card = _device_name(dev)

    cloud, _ = generate_tree(seed=0, height=height, trunk_radius=0.25,
                             points_per_m2=points_per_m2, foliage_points=foliage_points)
    cloud = CentreCloud()(cloud)
    n_points = len(cloud)
    partial = {"n_points": n_points, "device": card, "stage": "setup"}
    _write_partial(partial_path, partial)

    mi = ModelInference(
        weights, voxel_size=0.01, block_size=4.0, buffer_size=0.4, batch_size=4,
        precision="bfloat16", level_capacity_factor=0.5, medial_classes=(0,), device=dev,
    )
    # the batches' pow2 capacities (their level rows come from the warm-up)
    capacities = [len(vb.coords) for vb in BlockTiler(cloud, 0.01, 4.0, 0.4).batches(
        4, max_capacity=mi.max_batch_capacity)]

    _note(f"warm-up forward ({n_points} points, batch capacities {capacities})")
    _timed_forward(mi, cloud, dev)
    level_rows = [list(rows) for rows in mi.plan_rows]   # one exact plan a batch
    partial["stage"] = "warmed"
    _write_partial(partial_path, partial)
    if fault == "exit-after-warmup":
        os._exit(3)

    launches = slab_conv.slab_gather_conv.launches
    times = []
    for r in range(reps):
        dt, _ = _timed_forward(mi, cloud, dev)
        times.append(dt)
        _note(f"forward {r + 1}/{reps}: {dt:.4f} s")
    slab_per_forward = (slab_conv.slab_gather_conv.launches - launches) / reps
    dt = statistics.median(times)
    pps = n_points / dt
    partial.update(
        stage="end_to_end_done", value=pps, vs_baseline=pps / CPU_BASELINE_POINTS_PER_SEC,
        end_to_end_s=dt, end_to_end_reps_s=times, slab_launches_per_forward=slab_per_forward,
        batch_capacities=capacities, batch_level_rows=level_rows,
    )
    _write_partial(partial_path, partial)

    # clouds per minute, cloud in, skeleton out: the north star's second half
    try:
        sk = Skeletonizer(device=dev)
        _note("skeleton stage: warm pass")
        sk.forward(mi.forward(cloud).filter_by_class([0]))
        _sync(dev)
        t0 = time.perf_counter()
        branch = mi.forward(cloud).filter_by_class([0])
        skel = sk.forward(branch)
        _sync(dev)
        pipeline_s = time.perf_counter() - t0
        skel_fields = {
            "n_branch_points": len(branch),
            "n_skeletons": len(skel.skeletons),
            "pipeline_s": pipeline_s,
            "clouds_per_min_e2e": 60.0 / pipeline_s,
        }
        _note(f"cloud -> skeleton {pipeline_s:.3f} s")
    except Exception as e:  # noqa: BLE001 — reported in the line, and the exit code
        import traceback

        traceback.print_exc()
        skel_fields = {"skeleton_error": f"{type(e).__name__}: {e}"}
    partial.update(stage="skeleton_done", **skel_fields)
    _write_partial(partial_path, partial)

    trace_dir = Path(profile) if profile else None
    dev_fields = dict(device_step_s=None, device_step_reps_s=None, device_busy_share=None,
                      device_points_per_sec=None, device_vs_cpu_baseline=None,
                      dispatch_overhead_s=None)
    if dev.type == "cuda":
        walls, busy = [], []
        for r in range(max(1, dev_reps)):
            trace = trace_dir / "forward_trace.json" if trace_dir and r == 0 else None
            wall, events = _profiled_forward(mi, cloud, dev, trace)
            b = kernel_busy_s(events)
            if b <= 0.0:
                raise RuntimeError("torch.profiler recorded no CUDA kernel in a forward")
            walls.append(wall)
            busy.append(b)
            _note(f"profiled forward {r + 1}: wall {wall:.4f} s, kernels busy {b:.4f} s")
        step = statistics.median(busy)
        dev_fields.update(
            device_step_s=step, device_step_reps_s=busy,
            device_busy_share=step / statistics.median(walls),
            device_points_per_sec=n_points / step,
            device_vs_cpu_baseline=n_points / step / CPU_BASELINE_POINTS_PER_SEC,
            dispatch_overhead_s=statistics.median(w - b for w, b in zip(walls, busy)),
        )
    elif trace_dir:
        _profiled_forward(mi, cloud, dev, trace_dir / "forward_trace.json")
    partial.update(stage="device_done", **dev_fields)
    _write_partial(partial_path, partial)

    return {
        "metric": METRIC,
        "value": pps,
        "unit": UNIT,
        "vs_baseline": pps / CPU_BASELINE_POINTS_PER_SEC,
        **dev_fields,
        "n_points": n_points,
        "end_to_end_s": dt,
        "end_to_end_reps_s": times,
        "slab_launches_per_forward": slab_per_forward,
        "batch_capacities": capacities,
        "batch_level_rows": level_rows,
        "device": card,
        **skel_fields,
    }


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m smart_tree_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiny", action="store_true",
                    help="a small tree and one rep each (the tests' size)")
    ap.add_argument("--weights", default=DEFAULT_WEIGHTS)
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="write a torch.profiler Chrome trace of one forward into DIR")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--fault", choices=FAULTS, default=None,
                    help="inject a failure into the child (for the tests)")
    ap.add_argument("--attempt-timeout", type=float, default=ATTEMPT_TIMEOUT_S,
                    help="seconds before the child is killed")
    ap.add_argument("--record-cpu-baseline", action="store_true",
                    help="run the full workload on the CPU in this process")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--partial", default=None, help=argparse.SUPPRESS)
    return ap


def _child_main(args: argparse.Namespace) -> int:
    """One measurement in this (fresh) process; prints the dict as one JSON line."""
    kwargs = dict(TINY) if args.tiny else {}
    out = run_bench(profile=args.profile, weights=args.weights, partial_path=args.partial,
                    device=args.device, fault=args.fault, **kwargs)
    print(json.dumps(out), flush=True)
    return 0


def _supervise(args: argparse.Namespace) -> int:
    """Run the measurement in a child process; always print one JSON line,
    and return non-zero when it carries `error` or `skeleton_error`."""
    passthrough = ["--weights", args.weights, "--device", args.device]
    if args.tiny:
        passthrough.append("--tiny")
    if args.profile:
        passthrough += ["--profile", args.profile]
    if args.fault:
        passthrough += ["--fault", args.fault]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    out, error = None, None
    with tempfile.TemporaryDirectory(prefix="smart_tree_bench_") as tmp:
        partial_file = Path(tmp) / "partial.json"
        cmd = [sys.executable, "-m", "smart_tree_tpu_torch.bench", "--child",
               "--partial", str(partial_file), *passthrough]
        _note(f"bench: {' '.join(cmd[1:])}")
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, env=env, stdout=subprocess.PIPE, stderr=None,
                                  timeout=args.attempt_timeout, text=True)
        except subprocess.TimeoutExpired:
            error = f"timeout after {args.attempt_timeout:.0f} s"
        else:
            for line in proc.stdout.splitlines():
                line = line.strip()
                if line.startswith("{"):
                    try:
                        out = json.loads(line)
                    except json.JSONDecodeError:
                        print(f"# child: {line}", file=sys.stderr)
                elif line:
                    print(f"# child: {line}", file=sys.stderr)
            if proc.returncode != 0 or out is None:
                error = (f"rc={proc.returncode} in {time.perf_counter() - t0:.0f} s "
                         "(stderr above)")
        partial: dict = {}
        if error is not None and partial_file.exists():
            partial = json.loads(partial_file.read_text())
    if error is not None:
        out = {
            "metric": METRIC,
            "value": partial.get("value", 0.0),
            "unit": UNIT,
            "vs_baseline": partial.get("vs_baseline", 0.0),
            "error": error,
            "partial": partial,
        }
    print(json.dumps(out), flush=True)
    return 1 if "error" in out or "skeleton_error" in out else 0


def main(argv: list[str] | None = None) -> int:
    args = _parser().parse_args(argv)
    if args.child:
        return _child_main(args)
    if args.record_cpu_baseline:
        print(json.dumps(run_bench(weights=args.weights, device="cpu")), flush=True)
        return 0
    return _supervise(args)


if __name__ == "__main__":
    raise SystemExit(main())
