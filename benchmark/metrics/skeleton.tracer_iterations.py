"""Greedy iterations per cloud of the branch tracer (`tracer_iterations`,
skeleton/path.py: the real iterations, read from the tracer's header at its
last fetch; over `tracer_fetches` it gives the iterations a fetch covers),
the mean over the window's clouds of the program's own counter. Nothing
where the program keeps no such counter."""


def read(rec):
    return rec.stage_mean("tracer_iterations")
