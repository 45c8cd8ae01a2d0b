"""The control comes out not correct: the plain reference put in the
program's place at the precision below the configuration's (TF32 for
float32, fp8 for bfloat16), judged by the cell's own limits, on small trees
on the CPU (control.py reads the same at the cells' sizes on the card)."""

import numpy as np
import pytest
import torch

import control
import run
from stbench import check, entries, spec, traffic

from _tiny import tiny_root

torch.set_num_threads(4)


@pytest.mark.parametrize("cell_name", ["noble58-fp32.tree-pipeline",
                                       "noble58-bf16.tree-segment",
                                       "noble58-fp32.tree-segment"])
def test_control_fails(tmp_path, cell_name):
    cell = spec.load_cell(cell_name, tiny_root(tmp_path, density=800.0))
    mix, cfg = cell.traffic, cell.config
    prepare = entries.ENTRIES[mix["entry"]].prepare
    seed = 41
    pool = traffic.make_pool(mix, seed)
    sample = control.sample_of(pool, mix, seed)
    mode = control.CONTROL[cfg["model"]["precision"]]
    kept = {i: control.control_output(cell, prepare(pool[k][0]), mode, "cpu",
                                      mix["entry"] == "pipeline")
            for i, k in enumerate(sample)}
    numbers = run.compare(cell, pool, [(k, 0.0) for k in sample], kept, seed, "cpu",
                          prepare, lambda m: None)
    ok, rows = check.verdict(numbers, cell.limits)
    assert not ok, rows
    assert np.isfinite([v for _, v, _ in rows]).all()
