"""The 90th percentile of the seconds a cloud takes, by the benchmark's
clock (each cloud ended by a device synchronise), over the window's clouds
that the profiler left alone (numpy's linear rule, stbench/window.py)."""

from stbench.window import p90


def read(rec):
    secs = [c["seconds"] for c in rec.clouds]
    return p90(secs) if secs else None
