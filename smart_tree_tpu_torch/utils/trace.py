"""Spans and counters at the port's layer boundaries, into the caller's
`stats` dict and onto torch.profiler's clock.

`span(stats, name, key)` wraps a block of host code. With `stats` given it
adds the block's host seconds to `stats[key]`; while torch.profiler records,
the block is also a host event named `name` on the profiler's clock, the
clock of the kernels, so that an idle gap of the device in a trace is named
by the span the host was in. The event is not a user annotation: the
profiler mirrors a user annotation onto the device's timeline as an event
spanning its first kernel to its last, which a reader of the trace would
count as device work. With `stats` None and the profiler off a span does one
check and nothing else. No span synchronises the device: a caller that wants
a stage's kernels inside its seconds synchronises inside the span.

Names are `<layer>.<stage>`; keys are the `stats` names the callers document
(`Pipeline.process_cloud`, `Skeletonizer.forward`, `ModelInference.forward`).
"""

from __future__ import annotations

import contextlib
import time

import torch

_NULL = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


class _Span:
    __slots__ = ("stats", "key", "name", "t0", "range")

    def __init__(self, stats, key, name):
        self.stats, self.key, self.name = stats, key, name
        self.range = None

    def __enter__(self):
        if self.name is not None:
            self.range = torch._C._profiler._RecordFunctionFast(self.name)
            self.range.__enter__()
        if self.key is not None:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.key is not None:
            self.stats[self.key] = self.stats.get(self.key, 0.0) + time.perf_counter() - self.t0
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(stats: dict | None, name: str, key: str | None = None):
    """A context manager: the block's host seconds added to `stats[key]`
    (when `stats` and `key` are given), and a profiler range `name` while
    the profiler records."""
    ranged = _profiling()
    if stats is None:
        key = None
    if key is None and not ranged:
        return _NULL
    return _Span(stats, key, name if ranged else None)


def count(stats: dict | None, key: str, n: int = 1) -> None:
    """Add `n` to the counter `stats[key]` (nothing when `stats` is None)."""
    if stats is not None:
        stats[key] = stats.get(key, 0) + n
