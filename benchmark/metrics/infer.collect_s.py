"""Host seconds per cloud of the forward's collects (`infer.collect_s`: the
waits for each batch's downloads and the host decode), the mean over the
window's clouds of the program's own span. Nothing where the program keeps
no such span."""


def read(rec):
    return rec.stage_mean("infer.collect_s")
