"""The measured window and the reduction of its clock and trace readings.

`union_s` and `kernel_busy_s` are frozen copies of the program's
`bench.py` arithmetic at the commit that defined this benchmark.
"""

from __future__ import annotations

import bisect
import time

import numpy as np


def union_s(intervals) -> float:
    """Seconds covered by at least one of the (start, end) intervals: the
    union, so that overlapping intervals count once."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _is_kernel(e):
    return str(e.device_type).endswith("CUDA") and not e.name.startswith(("Memcpy", "Memset"))


def kernel_busy_s(events) -> float:
    """Seconds during which at least one CUDA kernel ran, from a
    torch.profiler event list: the union of the kernel intervals (copies and
    memsets left out; they run on the copy stream beside the kernels)."""
    return union_s((e.time_range.start / 1e6, e.time_range.end / 1e6)
                   for e in events if _is_kernel(e))


def closed_loop(call, n_pool, seconds, sync, between=None):
    """One caller: cloud i % n_pool once the last returned, in whole passes
    over the pool: the window ends with the first pass that ends at or past
    `seconds` after the start, so every run serves the same clouds in the
    same proportions. The window lasts from the first cloud's start to the
    last one's end, less the time spent in `between(i)` (run after cloud i:
    the profiler's stop in a traced run). Returns ([(pool index, seconds,
    result)], window seconds)."""
    out = []
    t0 = time.perf_counter()
    paused = 0.0
    i = 0
    while True:
        k = i % n_pool
        s = time.perf_counter()
        call(k, i)
        sync()
        e = time.perf_counter()
        out.append((k, e - s))
        elapsed = e - t0 - paused
        if between is not None:
            between(i)
            paused += time.perf_counter() - e
        i += 1
        if elapsed >= seconds and i % n_pool == 0:
            return out, elapsed


def p90(values) -> float:
    """The 90th percentile (linear between the ranks, numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), 90))


def trace_summary(events, wall_s):
    """What the traced clouds' profile says: kernel busy seconds, seconds by
    kernel name, and the ten longest kinds of idle gap, each gap named by
    the innermost host op around its middle, or where no op covers it (host
    Python, numpy) by the ops on either side: `after <op> / before <op>`."""
    kernels = [(e.time_range.start / 1e6, e.time_range.end / 1e6, e.name)
               for e in events if _is_kernel(e)]
    by_name = {}
    for a, b, name in kernels:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    merged = []
    for a, b, _ in sorted(kernels):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    host = sorted((e.time_range.start / 1e6, e.time_range.end / 1e6, e.name)
                  for e in events if str(e.device_type).endswith("CPU"))
    # the host's first and last ops bound the traced span: idle before the
    # first kernel and after the last one are gaps too
    if host and merged:
        merged = [[host[0][0]] * 2] + merged + [[max(h[1] for h in host)] * 2]
    gaps = sorted(((merged[i + 1][0] - merged[i][1], (merged[i][1] + merged[i + 1][0]) / 2)
                   for i in range(len(merged) - 1)
                   if merged[i + 1][0] > merged[i][1]), reverse=True)[:200]
    starts = [h[0] for h in host]
    gap_by = {}
    for length, mid in gaps:
        j = bisect.bisect_right(starts, mid)
        label, best = None, None
        for a, b, name in reversed(host[max(0, j - 4000):j]):
            if b >= mid and (best is None or b - a < best):
                label, best = name, b - a
        if label is None:
            ended = [h for h in host[max(0, j - 4000):j] if h[1] < mid]
            before = f"after {max(ended, key=lambda h: h[1])[2]}" if ended else "start"
            after = f"before {host[j][2]}" if j < len(host) else "end"
            label = f"{before} / {after}"
        gap_by[label] = gap_by.get(label, 0.0) + length
    return {
        "busy_s": kernel_busy_s(events),
        "window_s": wall_s,
        "kernel_s": by_name,
        "device_ops": sorted(([k, v] for k, v in by_name.items()), key=lambda x: -x[1])[:10],
        "idle_gaps": sorted(([k, v] for k, v in gap_by.items()), key=lambda x: -x[1])[:10],
    }
