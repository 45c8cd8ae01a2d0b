"""Seconds per cloud of the graph stages (graph/: neighbour table and shortcuts, components, shortest paths),
the mean over the window's clouds of the program's own stage clocks (the
skeletoniser synchronises the card at each stage's end in a traced run)."""


def read(rec):
    return rec.stage_mean("table_shortcuts_s", "components_s", "sssp_s")
