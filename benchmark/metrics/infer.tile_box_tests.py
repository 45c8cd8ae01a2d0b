"""Point-box tests per cloud of the forward's tiling (`tile_box_tests`,
BlockTiler's one binning pass over the points: one test a block whose
buffered faces hold the point on every axis), the mean over the window's
clouds of the program's own counter. Nothing where the program keeps no such
counter."""


def read(rec):
    return rec.stage_mean("tile_box_tests")
