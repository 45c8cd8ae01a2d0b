"""The port's training probes against the JAX tools of the same name,
imported from `tools/`: `smart_tree_tpu_torch/tools/{overfit_probe,
cpu_probe}.py`, on the CPU at fp32, from the JAX tool's own `init_template`
weights carried over with `params_from_jax`.

Tolerances, on the JAX tools' printed losses (4 decimals):
- step 0, before any update: rtol 1e-4 plus one step of the printed
  rounding (fp32 summation order only);
- steps 1 and 2: rtol 2e-2 plus that step, the five-Adam-step tolerance of
  tests/test_torch_train_step.py (Adam's first steps are sign-like, so
  last-bit gradient differences grow; the CPU backward of a gather is not
  bit-reproducible either).
- cpu_probe's collated batches: equal bit for bit at every step, which pins
  the shared numpy generator's stream (augmentation draws, tree indices,
  the truncating collate).

Only the overfit probe's tree is cut, for time: 3 m at 1,500 points/m^2
with 500 foliage points (7,341 points, 6,985 voxels; capacity 8192) in
place of the tool's 8 m tree. The JAX overfit tool runs on a one-device
mesh: on the conftest's eight CPU devices it would run in-process
all-reduces (see tests/test_torch_block_infer.py). Both are patched in the
test's view of the JAX tool only.
"""

import argparse
import functools
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import smart_tree_tpu.data.dataset as jdataset
from smart_tree_tpu.data.synthetic import generate_tree as jgenerate_tree
from smart_tree_tpu.infer.inference import init_template
from smart_tree_tpu.nn.model import SmartTree as JSmartTree
from smart_tree_tpu.parallel.mesh import make_mesh
from smart_tree_tpu_torch.core import fused_conv, slab_conv
from smart_tree_tpu_torch.data.synthetic import generate_tree
from smart_tree_tpu_torch.nn.convert import params_from_jax
from smart_tree_tpu_torch.tools import cpu_probe, overfit_probe

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

import cpu_probe as jcpu  # noqa: E402  (tools/, the JAX tools)
import overfit_probe as jprobe  # noqa: E402

SMALL_TREE = dict(height=3.0, points_per_m2=1500.0, foliage_points=500)
STEPS = 3
FIRST_RTOL = 1e-4
RTOL = 2e-2
PRINTED_ATOL = 1e-4 + 1e-9   # one step of the printed 4 decimals
OVERFIT_LINE = re.compile(r"step +(\d+)  radius (\S+)  direction (\S+) \(cos (\S+)\)  "
                          r"class (\S+)  \[(\S+)s\]$")
CPU_LINE = re.compile(r" *(\d+) dir (\S+) rad (\S+) cls (\S+) \[(\d+)s\]$")
BATCH_FIELDS = ("coords", "feats", "targets", "mask", "valid", "origins")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite's workers share the host's cores: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small(gen):
    return lambda seed=0, **kw: gen(seed=seed, **{**kw, **SMALL_TREE})


@functools.lru_cache(maxsize=None)
def _template(channels, planes=(8, 16, 32, 64)):
    """The JAX tools' initial weights, as a state dict of the port."""
    model = JSmartTree(bn_axis_name="dp", input_channels=channels, unet_planes=planes)
    return params_from_jax(jax.tree.map(np.array, init_template(model)))


def _parse(text, pattern):
    rows = [pattern.match(s) for s in text.strip().splitlines()]
    assert all(rows), text
    return rows


def _assert_losses(got, ref, where):
    """got: the port's records; ref: {step: {name: printed value}}."""
    assert [r["step"] for r in got] == sorted(ref), where
    for r in got:
        rtol = FIRST_RTOL if r["step"] == 0 else RTOL
        for k, want in ref[r["step"]].items():
            assert abs(r[k] - want) <= rtol * abs(want) + PRINTED_ATOL, (where, r["step"], k,
                                                                         r[k], want)
        assert all(np.isfinite(r[k]) for k in ("radius", "direction", "class_l"))


@pytest.mark.parametrize("features,direction_loss", [("xyz", "cosine"), ("local", "l2raw")])
def test_overfit_probe_matches_jax(monkeypatch, capsys, features, direction_loss):
    flags = ["--steps", str(STEPS), "--log-every", "1", "--capacity", "8192",
             "--features", features, "--direction-loss", direction_loss]
    monkeypatch.setattr(jprobe, "make_mesh", lambda *a: make_mesh(1))
    monkeypatch.setattr(jprobe, "generate_tree", _small(jgenerate_tree))
    monkeypatch.setattr(sys, "argv", ["overfit_probe.py", *flags])
    jprobe.main()
    jax_out = capsys.readouterr().out

    monkeypatch.setattr(overfit_probe, "generate_tree", _small(generate_tree))
    slab_conv.slab_gather_conv.launches = fused_conv.fused_gather_gemm.launches = 0
    got = overfit_probe.run(steps=STEPS, log_every=1, capacity=8192, features=features,
                            direction_loss=direction_loss,
                            variables=_template(4 if features == "local" else 3),
                            device="cpu", echo=print)
    port_out = capsys.readouterr().out
    assert slab_conv.slab_gather_conv.launches == fused_conv.fused_gather_gemm.launches == 0

    jlines, plines = jax_out.splitlines(), port_out.splitlines()
    assert plines[0] == jlines[0] and jlines[0].startswith("tree: 7341 pts -> ")
    ref = {int(m[1]): {"radius": float(m[2]), "direction": float(m[3]), "class_l": float(m[5])}
           for m in _parse("\n".join(jlines[1:]), OVERFIT_LINE)}
    assert len(_parse("\n".join(plines[1:]), OVERFIT_LINE)) == STEPS
    _assert_losses(got, ref, f"overfit {features} {direction_loss}")


def _recording(collate, into):
    def wrapped(*a, **k):
        vb = collate(*a, **k)
        into.append(vb)
        return vb
    return wrapped


@pytest.mark.parametrize("aug", ["full", "crop", "none"])
def test_cpu_probe_matches_jax(monkeypatch, capsys, aug):
    flags = ["--trees", "2", "--steps", str(STEPS), "--log-every", "1", "--aug", aug]
    jbatches, pbatches = [], []
    # the JAX tool imports collate inside its main: patch the module it reads
    monkeypatch.setattr(jdataset, "collate", _recording(jdataset.collate, jbatches))
    monkeypatch.setattr(sys, "argv", ["cpu_probe.py", *flags])
    jcpu.main()
    ref = {int(m[1]): {"direction": float(m[2]), "radius": float(m[3]), "class_l": float(m[4])}
           for m in _parse(capsys.readouterr().out, CPU_LINE)}

    monkeypatch.setattr(cpu_probe, "collate", _recording(cpu_probe.collate, pbatches))
    got = cpu_probe.run(steps=STEPS, aug=aug, trees=2, log_every=1,
                        variables=_template(4, (8, 16, 32)), device="cpu", echo=print)
    assert len(_parse(capsys.readouterr().out, CPU_LINE)) == STEPS

    assert len(pbatches) == len(jbatches) == STEPS
    for i, (p, j) in enumerate(zip(pbatches, jbatches)):
        assert p.spatial_shape == j.spatial_shape and p.batch_size == j.batch_size, i
        for name in BATCH_FIELDS:
            a, b = getattr(p, name), getattr(j, name)
            assert a.dtype == b.dtype, (i, name)
            np.testing.assert_array_equal(a, b, err_msg=f"step {i} {name}")
        for a, b in zip(p.compressed_xyz_upload(), j.compressed_xyz_upload()):
            np.testing.assert_array_equal(a, b, err_msg=f"step {i} upload")
    if aug == "none":   # --items == --trees: the same batch every step
        assert all(np.array_equal(p.feats, pbatches[0].feats) for p in pbatches)
    _assert_losses(got, ref, f"cpu_probe {aug}")


@pytest.mark.parametrize("tool", [overfit_probe, cpu_probe])
def test_probes_raise_without_a_card(monkeypatch, tool):
    """Without `--device cpu` and without a card neither probe carries on on
    the CPU: it raises before any tree is made."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tool, "generate_tree", lambda *a, **k: pytest.fail("made a tree"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])


class _Parsed(Exception):
    pass


@pytest.mark.parametrize("port,ref", [(overfit_probe, jprobe), (cpu_probe, jcpu)])
def test_parser_defaults_match_jax(monkeypatch, port, ref):
    parse = argparse.ArgumentParser.parse_args
    seen = {}

    def stop_after_parse(self, args=None, namespace=None):
        seen.update(vars(parse(self, args, namespace)))
        raise _Parsed

    monkeypatch.setattr(sys, "argv", ["tool.py"])
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop_after_parse)
    with pytest.raises(_Parsed):
        ref.main()
    monkeypatch.undo()
    ours = vars(port.parser().parse_args([]))
    assert ours.pop("device") is None
    assert ours == seen


@pytest.mark.parametrize("tool,flags,pattern", [
    (overfit_probe, ["--steps", "1", "--capacity", "8192"], OVERFIT_LINE),
    (cpu_probe, ["--steps", "2", "--trees", "2", "--log-every", "1"], CPU_LINE),
])
def test_main_prints_the_jax_lines_on_the_cpu(monkeypatch, capsys, tool, flags, pattern):
    """The entry points with `--device cpu`, from the port's own seeded
    weights: the JAX tool's lines, finite losses."""
    if tool is overfit_probe:
        monkeypatch.setattr(overfit_probe, "generate_tree", _small(generate_tree))
    assert tool.main([*flags, "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    if tool is overfit_probe:
        assert re.fullmatch(r"tree: 7341 pts -> \d+ voxels", lines.pop(0))
    rows = _parse("\n".join(lines), pattern)
    assert [int(m[1]) for m in rows] == list(range(len(rows))) and rows
    assert all(np.isfinite(float(v)) for m in rows for v in m.groups()[1:])
