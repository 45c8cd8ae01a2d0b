"""Share of the traced clouds' wall time in which no CUDA kernel ran, in %:
100 (1 - union of the kernel intervals / the traced wall time), from
torch.profiler over the window's first `trace_clouds` clouds."""


def read(rec):
    if not rec.trace or rec.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec.trace["busy_s"] / rec.trace["window_s"])
