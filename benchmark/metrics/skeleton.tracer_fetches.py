"""Host round trips per cloud of the branch tracer (`tracer_fetches`,
skeleton/path.py: one scalar fetch a greedy iteration, the last one's
finding no work included), the mean over the window's clouds of the
program's own counter. Nothing where the program keeps no such counter."""


def read(rec):
    return rec.stage_mean("tracer_fetches")
