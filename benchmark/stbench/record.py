"""What a per-layer metric's reader (metrics/<name>.py, `read(record)`)
gets from a traced run."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable


@dataclass
class Record:
    """The window's clouds, each a dict of `pool` (its index in the pool),
    `points`, `seconds` (the benchmark's clock, ended by a device
    synchronise), `forward_s`, `unet_passes` and `stats` (the program's
    stage clocks and counts); the window's seconds; the configuration's
    precision; the profiler's summary of the traced clouds (`trace`: busy_s,
    window_s, kernel_s by name; None without one) and their pool indices;
    and `inventory(k)`, the convs of pool cloud k (stbench/flops.py)."""

    clouds: list
    window_s: float
    precision: str
    trace: dict | None = None
    traced: list = field(default_factory=list)
    inventory: Callable | None = None

    def mean(self, key):
        vals = [c[key] for c in self.clouds]
        return sum(vals) / len(vals) if vals else None

    def stage_mean(self, *names):
        """Mean over the clouds of the sum of the named stage clocks, over the
        clouds that have any of them (None where none has)."""
        vals = [sum(c["stats"].get(n, 0.0) for n in names) for c in self.clouds
                if c["stats"] and any(n in c["stats"] for n in names)]
        return sum(vals) / len(vals) if vals else None
