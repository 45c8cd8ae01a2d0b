"""BENCHMARK.json keeps to its contract, every name leads to its files, and
a configuration, mix, cell and metric added as new files are found without
an edit to any file that is there."""

import json
import re
import shutil
from pathlib import Path

import pytest

from stbench import spec

ROOT = spec.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_names_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and len(BENCH["command"]) <= 32
    assert 1 <= BENCH["run_seconds"] <= 51
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["why"]) and LINE.match(c["source"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        assert NAME.match(w["traffic"]) and w["config"] in names
        names.append(w["name"])
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and LINE.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith(("_roofline", "mfu")):
            assert m["unit"] == "%"
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    assert "setup_s" in e2e
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fit_the_check():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(cell):
    c = spec.load_cell(cell)
    assert c.traffic["entry"] in ("segment", "pipeline")
    assert set(c.limits) >= {"rows_bad", "radius_off"} and c.limits["rows_bad"] == 0
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "points_per_s"}
    assert c.per_layer
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]))


def test_new_files_are_found_without_an_edit(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((ROOT / "benchmark/configs/noble58-bf16.json").read_text())
    cfg["name"] = "added-cfg"
    (root / "benchmark/configs/added-cfg.json").write_text(json.dumps(cfg))
    mix = json.loads((ROOT / "benchmark/traffic/tree-segment.json").read_text())
    mix["trees"] = 3
    (root / "benchmark/traffic/added-mix.json").write_text(json.dumps(mix))
    (root / "benchmark/limits/added-cfg.added-mix.json").write_text('{"rows_bad": 0}')
    (root / "benchmark/metrics/added.metric.py").write_text(
        "def read(rec):\n    return 2 * rec.window_s\n")
    bench["configs"].append(dict(bench["configs"][0], name="added-cfg",
                                 file="benchmark/configs/added-cfg.json"))
    bench["workloads"].append({"name": "added-cfg.added-mix", "config": "added-cfg",
                               "traffic": "added-mix", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "added.metric", "unit": "s", "better": "lower",
                               "source": "host_clock", "layer": "test",
                               "moves": "points_per_s", "workloads": ["added-cfg.added-mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.load_cell("added-cfg.added-mix", root)
    assert c.config["name"] == "added-cfg" and c.traffic["trees"] == 3
    assert [m["name"] for m in c.per_layer if m["name"] == "added.metric"]
    from stbench.record import Record

    assert spec.metric_reader("added.metric", root)(Record([], 1.5, "bfloat16")) == 3.0
    assert all(p.read_bytes() == b for p, b in before.items())
    # the harness itself names no cell, mix, configuration, metric or
    # architecture but the one a configuration gets where it names none
    code = "".join(p.read_text() for p in (ROOT / "benchmark/stbench").glob("*.py"))
    code += (ROOT / "benchmark/run.py").read_text() + (ROOT / "benchmark/control.py").read_text()
    code += (ROOT / "benchmark/reference/forward.py").read_text()
    archs = {p.stem for p in (ROOT / "benchmark/arch").glob("*.py")} | {"toy", "ptv3"}
    for n in [w["name"] for w in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]] \
            + [m["name"] for m in BENCH["per_layer"]] + ["tree-segment", "tree-pipeline"] \
            + sorted(archs - {spec.DEFAULT_ARCH}):
        assert n not in code, n


TOY = '''"""A toy architecture: SmartTree's reference and weights, one operation
counted, and a keyword for the program; each call noted in CALLS."""

from dataclasses import dataclass
from pathlib import Path

from stbench import flops, spec

ST = spec.arch_module("smart_tree", Path(__file__).resolve().parents[2])
CALLS = []


@dataclass
class Linear:
    rows: int
    cin: int
    cout: int
    k3: None = None

    def flops(self):
        return 2 * self.rows * self.cin * self.cout

    def bytes(self, width):
        return width * (self.rows * self.cin + self.cin * self.cout + self.rows * self.cout)

    def bound_s(self, precision):
        return max(self.flops() / flops.PEAK_FLOPS[precision],
                   self.bytes(flops.WIDTH[precision]) / flops.PEAK_BYTES)


def forward(xyz, model, device="cpu", mode=None):
    CALLS.append("forward")
    return ST.forward(xyz, model, device, mode)


def inventory(xyz, model, device="cpu"):
    CALLS.append("inventory")
    return [Linear(len(xyz), 3, 5)]


def draw(model, seed):
    CALLS.append(("draw", seed))
    return ST.draw(model, seed)


def inference_kwargs(model):
    CALLS.append("inference_kwargs")
    return {"upload_granularity": 2048}
'''


def test_new_architecture_is_found_without_an_edit(tmp_path):
    """A copied checkout with only benchmark/arch/toy.py, a configuration
    naming it, a limits file and BENCHMARK.json entries added runs its cell's
    entry, reference, check and inventory."""
    import time

    import run
    from _tiny import tiny_root

    root = tiny_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    (root / "benchmark/arch/toy.py").write_text(TOY)
    cfg = json.loads((ROOT / "benchmark/configs/noble58-fp32.json").read_text())
    cfg.update(name="toy-cfg", weights={"seed": 5})
    cfg["model"]["arch"] = "toy"
    (root / "benchmark/configs/toy-cfg.json").write_text(json.dumps(cfg))
    (root / "benchmark/limits/toy-cfg.tree-segment.json").write_text(
        (ROOT / "benchmark/limits/noble58-fp32.tree-segment.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="toy-cfg",
                                 file="benchmark/configs/toy-cfg.json"))
    bench["workloads"].append({"name": "toy-cfg.tree-segment", "config": "toy-cfg",
                               "traffic": "tree-segment", "chips": 1, "why": "a test"})
    for m in bench["per_layer"]:
        if m["name"] == "step.mfu":
            m["workloads"].append("toy-cfg.tree-segment")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("toy-cfg.tree-segment", root)
    toy = spec.arch_module(spec.arch_name(cell.config["model"]), root)
    assert toy is spec.arch_module("toy", root) and toy.__file__.startswith(str(root))
    res = run.run_cell(cell, 2**31 + 5, 1.0, True, "cpu", t_start=time.perf_counter(),
                       log=lambda m: None)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {"rows_bad", "class_flip", "radius_off", "direction_off"}
    assert ("draw", 5) in toy.CALLS and toy.CALLS.count(("draw", 5)) == 1
    assert {"inference_kwargs", "forward", "inventory"} <= set(toy.CALLS)
    # step.mfu over the toy's one operation a cloud
    assert res["metrics"]["step.mfu"]["value"] > 0
    assert [p.name for p in (root / "build/benchmark_weights").iterdir()][0].startswith(
        "toy-cfg.5.")
    assert all(p.read_bytes() == b for p, b in before.items())
