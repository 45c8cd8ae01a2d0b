"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, everything else as a run (run.run_cell)
on the CPU at a tiny size. One test for each fault a cell can have: a state
left unchanged (the last cloud's answer again), half of the rows left out,
an answer altered where it is produced (a skeleton's longest branch moved
5 cm; a labelled cloud's radii 20 % off: one row's error hides among the
rows that bfloat16 moves as far). The exchange between
cards does not exist in these one-card cells."""

import time

import numpy as np
import pytest
import torch

import run
from stbench import entries, spec

from _tiny import tiny_root

torch.set_num_threads(4)
CELLS = ["noble58-fp32.tree-pipeline", "noble58-bf16.tree-segment"]


def _broken(base, fault):
    class Broken(base):
        last = None

        def __call__(self, xyz, rgb, stats=None):
            lab, skel = super().__call__(xyz, rgb, stats)
            if fault == "stale":
                prev, Broken.last = Broken.last, (lab, skel)
                return prev if prev is not None else (lab, skel)
            if fault == "half":
                keep = np.arange(len(lab.xyz)) % 2 == 0
                return lab.filter(keep), skel
            if fault == "answer":
                if skel is not None:      # the longest branch moved 5 cm
                    br = max((b for s in skel for b in s), key=lambda b: len(b[0]))
                    br[0][:] += np.float32(0.05)
                else:                     # the cloud's radii 20 % larger
                    lab.medial_vector *= np.float32(1.2)
            return lab, skel

    return Broken


def _run(tmp_path, cell_name, seed=3):
    cell = spec.load_cell(cell_name, tiny_root(tmp_path))
    return run.run_cell(cell, seed, 3.0, False, "cpu", t_start=time.perf_counter(),
                        log=lambda m: None)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tmp_path, cell):
    res = _run(tmp_path, cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", ["stale", "half", "answer"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(tmp_path, monkeypatch, cell, fault):
    mix = spec.load_cell(cell).traffic["entry"]
    monkeypatch.setitem(entries.ENTRIES, mix, _broken(entries.ENTRIES[mix], fault))
    res = _run(tmp_path, cell)
    assert not res["correct"], res["checks"]
