"""The port's data tools against the JAX tools of the same name, imported
from `tools/`: `smart_tree_tpu_torch/tools/make_synthetic_dataset.py` and
`smart_tree_tpu_torch/tools/convert_checkpoint.py`.

Both are host numpy / torch with no arithmetic of their own beyond the
packages' generators and converters, so they are held equal bit for bit:
the dataset tool writes the same split.json text and npz files with the same
keys, dtypes and bytes; the converter writes a checkpoint equal, array for
array, to the JAX converter's and to the shipped one it was made from.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

from smart_tree_tpu_torch.data.dataset import TreeDataset
from smart_tree_tpu_torch.tools import convert_checkpoint, make_synthetic_dataset
from tests.test_torch_weights_pt import NPZ, _write_pt

TOOLS = Path(__file__).resolve().parent.parent / "tools"
sys.path.insert(0, str(TOOLS))

import convert_checkpoint as jconvert  # noqa: E402  (tools/, the JAX tool)
import make_synthetic_dataset as jmake  # noqa: E402

SMALL = ["--points-per-m2", "50", "--foliage", "50"]


def _assert_same_npz(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files), (a, b)
        for k in x.files:
            assert x[k].dtype == y[k].dtype, (a, k)
            np.testing.assert_array_equal(x[k], y[k], err_msg=f"{a}: {k}")


@pytest.mark.parametrize("per_family,vary", [(1, False), (1, True), (3, False), (3, True)])
def test_make_synthetic_dataset_matches_jax(tmp_path, monkeypatch, per_family, vary):
    flags = ["--per-family", str(per_family), *SMALL] + (["--vary"] if vary else [])
    port, ref = tmp_path / "port", tmp_path / "jax"
    assert make_synthetic_dataset.main([str(port), *flags]) == 0
    monkeypatch.setattr(sys, "argv", ["make_synthetic_dataset.py", str(ref), *flags])
    jmake.main()

    assert make_synthetic_dataset.FAMILIES == jmake.FAMILIES
    assert (port / "split.json").read_text() == (ref / "split.json").read_text()
    names = sorted(p.name for p in port.glob("*.npz"))
    assert names == sorted(p.name for p in ref.glob("*.npz"))
    assert len(names) == 6 * per_family
    for name in names:
        _assert_same_npz(port / name, ref / name)

    # every file loads through the trainer's dataset, in its split bucket
    split = json.loads((port / "split.json").read_text())
    assert sorted(sum(split.values(), [])) == names
    for mode, files in split.items():
        if not files:
            continue
        ds = TreeDataset(0.01, port / "split.json", port, mode, ["xyz"],
                         ["radius", "direction", "class_l"])
        assert len(ds) == len(files)
        for i in range(len(ds)):
            coords, inputs, targets, fname, _ = ds.item(i)
            assert fname == files[i] and len(coords) > 0
            assert inputs.shape == (len(coords), 3) and targets.shape == (len(coords), 5)
    if per_family >= 3:
        assert len(split["test"]) == len(split["validation"]) == 6


def test_convert_checkpoint_matches_jax_and_the_shipped_npz(tmp_path, capsys):
    pt = _write_pt(NPZ, tmp_path / "noble-elevator-58.pt")
    port, ref = tmp_path / "port.npz", tmp_path / "jax.npz"
    assert convert_checkpoint.main([str(pt), str(port)]) == 0
    port_log = capsys.readouterr().out
    jconvert.main(str(pt), str(ref))
    ref_log = capsys.readouterr().out
    # the same model line (widths recovered from the .pt's shapes)
    assert port_log.splitlines()[0] == ref_log.splitlines()[0]
    assert "planes=(8, 16, 32, 64)" in port_log
    _assert_same_npz(port, ref)
    _assert_same_npz(port, NPZ)
