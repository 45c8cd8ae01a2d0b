"""Host seconds per cloud of the forward's upload staging (`infer.pack_s`:
each batch's `compact_upload_sorted`, the host key sort included), the mean
over the window's clouds of the program's own span. Nothing where the
program keeps no such span."""


def read(rec):
    return rec.stage_mean("infer.pack_s")
