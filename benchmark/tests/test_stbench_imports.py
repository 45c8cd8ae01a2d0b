"""Nothing the benchmark runs loads JAX, flax or the JAX package, names
compared whole; the reference loads nothing of the program either."""

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
