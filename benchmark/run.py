"""The benchmark of `smart_tree_tpu_torch` on one NVIDIA card: one cell, one
run, one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run makes its cloud pool from the seed (traffic/<mix>.json; the
generator's clouds are cached under build/ of the checkout), builds the
cell's entry from its configuration (configs/<config>.json: its
architecture arch/<arch>.py, its weights a checkpoint of the repository or
the architecture's seeded draw, cached under build/), warms it up on
the pool's largest cloud, and drives it in a closed loop (one caller, the
next cloud when the last one returns, the pool cycled in order) for
`--seconds`; the window ends with the pass over the pool that crosses the
deadline.
With `--trace 0` the line carries the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics (metrics/<name>.py), the profiler's
reading of the window's first clouds and the host's stage clocks. Either
way it then frees the program, runs the plain reference (reference/, the
architecture's forward) on a seeded sample of the window's clouds, and
sets `correct` by the limits in limits/<cell>.json, printing each number
beside its limit.

Without a card, or with fewer cards than the cell asks for, it exits 2 and
prints no result. It fails (exit 3, no result) if JAX, flax or the JAX
package is loaded after set-up or after the window.
"""

from __future__ import annotations

import os
import time

T_START = time.perf_counter()

# One host thread in each of the host's thread pools (OpenMP, so PyTorch's
# CPU ops; OpenBLAS and MKL under numpy and scipy), set before they load:
# pools as wide as the machine spin beside the one caller that drives the
# card, on cores the machine shares, and the runs' rates spread with them.
HOST_THREADS = 1
THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
if __name__ == "__main__":
    os.environ.update(dict.fromkeys(THREAD_VARS, str(HOST_THREADS)))

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from stbench import check, entries, flops, spec, traffic, window  # noqa: E402
from stbench.record import Record  # noqa: E402
from stbench.weights import weights_path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "smart_tree_tpu")


class ForbiddenImport(RuntimeError):
    pass


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (`smart_tree_tpu_torch` is not `smart_tree_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def guard_imports(when):
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(f"{when}: loaded {found}")


def _card(on_card):
    import torch

    if not on_card:
        return {"platform": "cpu", "kind": "cpu", "count": 0, "power_limit": None}
    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        limit = None
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "power_limit": limit}


def traffic_cache(root):
    """The checkout's directory for the generator's clouds (build/, which
    also holds the program's kernel builds)."""
    return Path(root) / "build" / "benchmark_pools"


def run_cell(cell, seed, seconds, trace, device="cuda", t_start=None, log=print):
    """One run of `cell`: the result's dict (`correct`, `attempted`,
    `failed`, `metrics`, `device`, `breakdown`, `checks`)."""
    import torch

    t_start = T_START if t_start is None else t_start
    mix, cfg = cell.traffic, cell.config
    precision = cfg["model"]["precision"]
    on_card = str(device).startswith("cuda")
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    prepare = entries.ENTRIES[mix["entry"]].prepare
    pool = traffic.make_pool(mix, seed, traffic_cache(cell.root))
    entry = entries.make_entry(cfg, mix, device, cell.root)
    biggest = max(range(len(pool)), key=lambda k: len(pool[k][0]))
    entry(*pool[biggest])                       # warm-up: first launches, builds
    sync()
    guard_imports("after set-up")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    n_traced = int(mix.get("trace_clouds", 1)) if trace else 0
    prof = None
    if n_traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    kept, failures, stats_of, passes = {}, [], {}, {}
    traced_wall = [0.0]

    def call(k, i):
        stats = {} if trace else None
        if prof is not None and i == 0:
            prof.start()
            traced_wall[0] = -time.perf_counter()
        try:
            out = entry(*pool[k], stats=stats)
        except Exception as e:  # noqa: BLE001 - a failed cloud is counted, the loop goes on
            failures.append(f"cloud {i} (pool {k}): {type(e).__name__}: {e}")
            out = None
        kept[i] = out
        stats_of[i] = stats
        passes[i] = entry.unet_passes()

    def between(i):
        if prof is not None and i == n_traced - 1:
            sync()
            traced_wall[0] += time.perf_counter()
            prof.stop()

    gc_s = {"start": 0.0, "s": 0.0, "full": 0}

    def gc_clock(phase, info):
        # the collector's pauses in the window, for the log
        if phase == "start":
            gc_s["start"] = time.perf_counter()
        else:
            gc_s["s"] += time.perf_counter() - gc_s["start"]
            gc_s["full"] += info["generation"] == 2

    r0 = resource.getrusage(resource.RUSAGE_SELF)
    gc.callbacks.append(gc_clock)
    try:
        done, window_s = window.closed_loop(call, len(pool), seconds, sync, between)
    finally:
        gc.callbacks.remove(gc_clock)
    r1 = resource.getrusage(resource.RUSAGE_SELF)
    log(f"host over the window: {window_s:.3f} s wall, user {r1.ru_utime - r0.ru_utime:.3f} s, "
        f"system {r1.ru_stime - r0.ru_stime:.3f} s, {torch.get_num_threads()} threads, "
        f"gc {gc_s['s']:.3f} s ({gc_s['full']} full collections)")
    if prof is not None and len(done) < n_traced:
        between(n_traced - 1)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    guard_imports("after the window")

    log("cloud seconds: " + " ".join(f"{k}:{dt:.3f}" for k, dt in done))
    clouds = []
    for i, (k, dt) in enumerate(done):
        st = stats_of[i]
        clouds.append({"pool": k, "points": len(pool[k][0]), "seconds": dt,
                       "forward_s": st.get("inference_s", dt) if st else dt,
                       "unet_passes": passes[i], "stats": st})
    del entry
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    card = _card(on_card)
    card["memory_peak_bytes"] = int(peak)
    result = {"attempted": len(done), "failed": len(failures)}
    levels_of = {}
    arch = spec.arch_module(spec.arch_name(cfg["model"]), cell.root)

    def inventory(k):
        if k not in levels_of:
            ops = arch.inventory(prepare(pool[k][0]), cfg["model"], device)
            width = flops.WIDTH[precision]
            log(f"inventory of pool cloud {k}: {len(ops)} operations, "
                f"{sum(o.flops() for o in ops)} flops, {sum(o.bytes(width) for o in ops)} bytes, "
                f"bound {sum(o.bound_s(precision) for o in ops)!r} s")
            levels_of[k] = ops
        return levels_of[k]

    if trace:
        summary = None
        if prof is not None:
            summary = window.trace_summary(prof.events(), traced_wall[0])
            card["busy_s"] = summary["busy_s"]
            card["window_s"] = summary["window_s"]
            result["breakdown"] = {"device_ops": summary["device_ops"],
                                   "idle_gaps": summary["idle_gaps"]}
        # the stage clocks and the rate of the clouds the profiler left alone
        rest = clouds[n_traced:] or clouds
        rest_s = window_s - traced_wall[0] if clouds[n_traced:] else window_s
        rec = Record(rest, rest_s, precision, summary,
                     [c["pool"] for c in clouds[:n_traced]], inventory)
        metrics = {}
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"], cell.root)(rec)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        levels_of.clear()
    else:
        total_points = sum(c["points"] for c in clouds)
        values = {"points_per_s": total_points / window_s, "setup_s": setup_s}
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}

    numbers = compare(cell, pool, done, kept, seed, device, prepare, log)
    ok, rows = check.verdict(numbers, cell.limits)
    correct = ok and not failures and len(done) > 0
    for f in failures[:5]:
        log(f"failed: {f}")
    result.update(correct=correct, metrics=metrics, device=card)
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result


def compare(cell, pool, done, kept, seed, device, prepare, log):
    """The correctness numbers over a seeded sample of the window's clouds,
    the largest among them: the worst of each, rows_bad summed."""
    from reference.forward import forward
    from reference.skeleton import skeletonize

    cfg, mix = cell.config, cell.traffic
    m = cfg["model"]
    model = dict(m, weights=str(weights_path(cfg, cell.root)))
    answered = [i for i in range(len(done)) if kept.get(i) is not None]
    if not answered:
        return {}
    picks = check.sample([len(pool[done[i][0]][0]) for i in answered],
                         mix.get("check_clouds", 2), seed)
    sample = [answered[j] for j in picks]
    numbers = {}
    heads_of = {}
    for i in sample:
        k = done[i][0]
        xyz = prepare(pool[k][0])
        if k not in heads_of:
            heads_of[k] = forward(xyz, model, device, root=cell.root)
        heads = heads_of[k]
        lab, skel = kept[i]
        got = check.forward_numbers(*entries.labelled_arrays(lab), xyz, heads,
                                    m["medial_classes"])
        if skel is not None:
            cls, mv = check.encode_output(heads, m["medial_classes"])
            ref = skeletonize(xyz[heads.point], mv, cls,
                              dict(cfg["skeletonizer"], **cfg["pipeline"]))
            got["skeleton_miss"] = check.skeleton_miss(skel, ref)
        log(f"check cloud {i} (pool {k}, {len(pool[k][0])} points): {got}")
        for name, v in got.items():
            numbers[name] = numbers.get(name, 0) + v if name == "rows_bad" \
                else max(numbers.get(name, 0.0), v)
    return numbers


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)

    import torch

    torch.set_num_threads(HOST_THREADS)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"this cell needs {cell.chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    def log(msg):
        print(f"# {msg}", file=sys.stderr, flush=True)

    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", log=log)
        guard_imports("before the result")
    except ForbiddenImport as e:
        print(f"forbidden import: {e}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
