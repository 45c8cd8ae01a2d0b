"""What a run reads: `BENCHMARK.json` at the root of the checkout, and the
files each of its names leads to, all found by name:

  configs/<config>.json   one configuration: weights, precision, the
                          program's arguments, its architecture
                          (`model.arch`; SmartTree where it names none)
                          (`BENCHMARK.json` names it)
  arch/<arch>.py          one architecture: its plain reference forward,
                          its operation count and its seeded weights
  traffic/<mix>.json      one traffic mix: the entry, the generator and its
                          parameters, the pool
  limits/<cell>.json      the limits of one cell's correctness numbers
  metrics/<metric>.py     the reader of one per-layer metric

A later cell, mix, configuration, architecture or metric is a new file and
a new entry in `BENCHMARK.json`; nothing here names one.
"""

from __future__ import annotations

import functools
import hashlib
import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
DEFAULT_ARCH = "smart_tree"


def _json(path):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration's file
    traffic: dict         # the mix's file
    limits: dict          # {number: limit}
    end_to_end: list      # BENCHMARK.json entries this cell reports
    per_layer: list
    root: Path            # the checkout the files were read from


def _reports(metric, cell_name):
    return "workloads" not in metric or cell_name in metric["workloads"]


def load_cell(name, root=ROOT):
    """The cell `name` of `root`/BENCHMARK.json, with its files read."""
    bench = _json(Path(root) / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    bench_dir = Path(root) / BENCH_DIR.name
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=_json(Path(root) / conf["file"]),
        traffic=_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        limits=_json(bench_dir / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        root=Path(root),
    )


def metric_reader(name, root=ROOT):
    """The `read(record)` function of metrics/<name>.py."""
    path = Path(root) / BENCH_DIR.name / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def arch_name(model):
    """The architecture a configuration's `model` section names."""
    return model.get("arch", DEFAULT_ARCH)


def arch_module(name, root=ROOT):
    """arch/<name>.py of `root`, loaded once a process. It gives
    `forward(xyz, model, device, mode=None)` (the plain reference's heads,
    reference/forward.py's `Heads`), `inventory(xyz, model, device)` (the
    operations of one forward, each with `flops()`, `bytes(width)`,
    `bound_s(precision)` and `k3`, a conv's columns or None), `draw(model,
    seed)` ({checkpoint key: float32 array}, the layout the program's loader
    reads) and, where the program needs them, `inference_kwargs(model)`."""
    return _load_arch((Path(root) / BENCH_DIR.name / "arch" / f"{name}.py").resolve())


@functools.cache
def _load_arch(path):
    if not path.is_file():
        raise KeyError(f"no architecture file {path}")
    # each file its own module name, registered in sys.modules so that what
    # the file defines (a dataclass) finds its module
    stem = re.sub(r"\W", "_", path.stem)
    mod_name = f"bench_arch_{stem}_{hashlib.sha256(str(path).encode()).hexdigest()[:12]}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod
