"""The benchmark's own tests, on the CPU: `python -m pytest benchmark/tests -q`
from the root of the checkout. They put the benchmark's directory (for
`stbench`, `reference` and `run`) and the checkout (for the program) on the
path."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)
