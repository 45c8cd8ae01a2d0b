"""Nothing the benchmark runs loads JAX, flax or the JAX package, names
compared whole; the reference, the architectures (arch/*.py) and their
seeded draws load nothing of the program either."""

import subprocess
import sys
import types

import run
from stbench import spec

PROBE = """
import sys
sys.path[:0] = [{bench!r}, {root!r}]
{imports}
names = {{m.split('.')[0] for m in sys.modules}}
print(sorted(names & {{'jax', 'jaxlib', 'flax', 'smart_tree_tpu', 'smart_tree_tpu_torch'}}))
"""


def _loaded(imports):
    code = PROBE.format(bench=str(spec.BENCH_DIR), root=str(spec.ROOT), imports=imports)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    return out.stdout.strip().splitlines()[-1]


def test_reference_loads_nothing_of_the_program():
    assert _loaded("import reference.forward, reference.skeleton, reference.tiling") == "[]"


def test_architectures_and_their_draws_load_nothing_of_the_program(tmp_path):
    imports = ("import json\nfrom pathlib import Path\nfrom stbench import spec, weights\n"
               "for p in sorted((spec.BENCH_DIR / 'arch').glob('*.py')):\n"
               "    spec.arch_module(p.stem)\n"
               "for p in sorted((spec.BENCH_DIR / 'configs').glob('*.json')):\n"
               "    cfg = json.loads(p.read_text())\n"
               "    spec.arch_module(spec.arch_name(cfg['model']))\n"
               f"    weights.weights_path(dict(cfg, weights={{'seed': 1}}), Path({str(tmp_path)!r}))")
    root = tmp_path / "benchmark"
    root.mkdir()
    (root / "arch").symlink_to(spec.BENCH_DIR / "arch")
    assert _loaded(imports) == "[]"
    assert len(list((tmp_path / "build/benchmark_weights").glob("*.npz"))) == 2


def test_harness_and_entries_load_no_jax():
    imports = ("import run, control\nfrom stbench import entries, spec\n"
               "entries.Segment; import smart_tree_tpu_torch.infer.pipeline\n"
               "import smart_tree_tpu_torch.skeleton.skeletonize")
    assert _loaded(imports) == "['smart_tree_tpu_torch']"


def test_names_are_compared_whole(monkeypatch):
    for name in ("smart_tree_tpu_torch", "smart_tree_tpu_torch.infer", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "smart_tree_tpu.core", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert run.forbidden_modules() == ["jaxlib", "smart_tree_tpu"]
