"""Host seconds per cloud of the forward's tiling (`infer.tile_s`:
BlockTiler's block ids, one binning pass of every point into the kept
blocks' halos (`native.tile_blocks`) and native dedup), the mean over the
window's clouds of the program's own span. Nothing where the program keeps
no such span."""


def read(rec):
    return rec.stage_mean("infer.tile_s")
