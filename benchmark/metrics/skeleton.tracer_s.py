"""Seconds per cloud of the branch tracer (skeleton/path.py),
the mean over the window's clouds of the program's own stage clocks (the
skeletoniser synchronises the card at each stage's end in a traced run)."""


def read(rec):
    return rec.stage_mean("tracer_s")
