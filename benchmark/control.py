"""The readings the limits of limits/<cell>.json are set from: the program's
correctness numbers over many seeds, and its control's over a few, in one
process at the cell's own sizes. The benchmark's runs never run this.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 ... --control-seeds 101 102 103

For each seed it makes the cell's pool and takes the sample a run checks
(the pool's largest cloud and `check_clouds - 1` more drawn from the seed).
The program (the cell's entry) serves each sampled cloud and is judged as a
run judges it (run.compare). The control is the plain reference put in the
program's place at the precision below the configuration's (TF32 for
float32, fp8 e4m3 for bfloat16: the `mode` of reference/unet.py, which the
architecture's forward takes), its heads in the program's output format
and, in a pipeline cell, skeletonised by the reference; it is judged the
same way. One JSON line per seed and side, then the largest program
reading and the smallest control reading of each number.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import run  # noqa: E402
from stbench import check, entries, spec, traffic  # noqa: E402
from stbench.weights import weights_path  # noqa: E402

CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def sample_of(pool, mix, seed):
    """The pool clouds a run's check would draw (check.sample over one
    pass of the pool): the largest first."""
    return check.sample([len(x) for x, _ in pool], mix.get("check_clouds", 2), seed)


def control_output(cell, xyz, mode, device, with_skeleton):
    """The control's (labelled cloud, skeleton) for one prepared cloud."""
    from reference.forward import forward
    from reference.skeleton import skeletonize

    cfg = cell.config
    model = dict(cfg["model"], weights=str(weights_path(cfg, cell.root)))
    heads = forward(xyz, model, device, mode, root=cell.root)
    cls, mv = check.encode_output(heads, cfg["model"]["medial_classes"])
    lab = SimpleNamespace(xyz=xyz[heads.point], medial_vector=mv, class_l=cls)
    skel = skeletonize(lab.xyz, mv, cls, dict(cfg["skeletonizer"], **cfg["pipeline"])) \
        if with_skeleton else None
    return lab, skel


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(spec.ROOT), help="the checkout (tests: a tiny one)")
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload, args.root)
    mix, cfg = cell.traffic, cell.config
    prepare = entries.ENTRIES[mix["entry"]].prepare
    pipeline = mix["entry"] == "pipeline"

    def log(msg):
        print(f"# {msg}", file=sys.stderr, flush=True)

    readings = {"program": [], "control": []}
    entry = entries.make_entry(cfg, mix, args.device, cell.root) if args.seeds else None
    for side, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in seeds:
            pool = traffic.make_pool(mix, seed, run.traffic_cache(cell.root))
            sample = sample_of(pool, mix, seed)
            kept = {}
            for i, k in enumerate(sample):
                if side == "program":
                    kept[i] = entry(*pool[k])
                else:
                    kept[i] = control_output(cell, prepare(pool[k][0]),
                                             CONTROL[cfg["model"]["precision"]], args.device,
                                             pipeline)
            done = [(k, 0.0) for k in sample]
            got = run.compare(cell, pool, done, kept, seed, args.device, prepare, log)
            readings[side].append(got)
            print(json.dumps({"side": side, "seed": seed, "numbers": got}), flush=True)
        if side == "program" and entry is not None:
            del entry
    summary = {}
    for name in sorted({k for r in readings["program"] + readings["control"] for k in r}):
        prog = [r[name] for r in readings["program"] if name in r]
        ctrl = [r[name] for r in readings["control"] if name in r]
        summary[name] = {"program_max": max(prog) if prog else None,
                         "control_min": min(ctrl) if ctrl else None}
    print(json.dumps({"workload": cell.name, "summary": summary}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
