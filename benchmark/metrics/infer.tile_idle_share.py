"""Share of the traced clouds' wall time in which the card sat idle while
the host tiled the cloud (`ModelInference.forward`'s `infer.tile` span:
BlockTiler's block ids, one binning pass (`native.tile_blocks`) and
dedup), in %: 100 x the seconds of the idle gaps the profile names
`infer.tile` over the traced wall time. A gap is named by the innermost
host event around its middle and counted whole (stbench/window.py).
Nothing without a trace, or where no gap bears that name (a program
without the span)."""


def read(rec):
    if not rec.trace or rec.trace["window_s"] <= 0:
        return None
    gaps = dict(rec.trace.get("idle_gaps", ()))
    if "infer.tile" not in gaps:
        return None
    return 100.0 * gaps["infer.tile"] / rec.trace["window_s"]
