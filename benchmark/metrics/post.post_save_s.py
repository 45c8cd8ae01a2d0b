"""Seconds per cloud of prune, repair and smooth and the four PLYs (data/tree.py, viz/mesh.py, data/file.py),
the mean over the window's clouds of the program's own stage clocks (the
skeletoniser synchronises the card at each stage's end in a traced run)."""


def read(rec):
    return rec.stage_mean("post_process_s", "save_s")
