"""The command as a check runs it. Without a card it exits 2 and prints
no result; on a card (marked `cuda`, skipped here) every cell runs a short
window and comes out correct."""

import json
import subprocess
import sys

import pytest

from stbench import spec

CELLS = [w["name"] for w in json.loads((spec.ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _run(cell, seconds, trace=0):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell,
                           "--seed", "2147483659", "--seconds", str(seconds),
                           "--trace", str(trace)],
                          cwd=spec.ROOT, capture_output=True, text=True, timeout=600)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(CELLS[0], 1)
    assert out.returncode == 2 and out.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = _run(cell, 5)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu", line
