"""Host seconds per cloud of the forward's tiling (`infer.tile_s`:
BlockTiler's block ids, each block's cube filter and native dedup), the
mean over the window's clouds of the program's own span. Nothing where the
program keeps no such span."""


def read(rec):
    return rec.stage_mean("infer.tile_s")
