"""Share of the traced clouds' wall time in which the card sat idle while
the host serialized a plan's levels (`ModelInference.forward`'s
`infer.serialize` span inside `infer.plan`: each level's offsets read, the
curve codes, the orders' sorts and inverses, the patch indices), in %: 100
x the seconds of the idle gaps the profile names `infer.serialize` over the
traced wall time. A gap is named by the innermost host event around its
middle and counted whole (stbench/window.py), and the summary keeps the ten
kinds of gap with the most seconds: 0 where the span's gaps are not among
them. Nothing without a trace."""


def read(rec):
    if not rec.trace or rec.trace["window_s"] <= 0:
        return None
    gaps = dict(rec.trace.get("idle_gaps", ()))
    return 100.0 * gaps.get("infer.serialize", 0.0) / rec.trace["window_s"]
