"""Seconds of `ModelInference.forward` per cloud, the mean over the window:
the pipeline's own `inference_s` clock (its forward ends with the
downloads), or the benchmark's clock around the call, which ends in a
device synchronise."""


def read(rec):
    return rec.mean("forward_s")
