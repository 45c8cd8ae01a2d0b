"""The readers of the program's spans and counters (metrics/infer.tile_*.py,
infer.pack_s, infer.collect_s, skeleton.tracer_fetches) on synthetic
records: what they read, and nothing where the program keeps no such span."""

import pytest

from stbench import spec
from stbench.record import Record


def _trace(gaps, window_s=4.0):
    return {"busy_s": 1.0, "window_s": window_s, "kernel_s": {}, "device_ops": [],
            "idle_gaps": [[k, v] for k, v in gaps.items()]}


def _rec(trace=None, stats=({},)):
    clouds = [{"pool": 0, "points": 10, "seconds": 1.0, "forward_s": 1.0, "unet_passes": 1,
               "stats": st} for st in stats]
    return Record(clouds, 2.0, "float32", trace)


def test_tile_idle_share_reads_the_exact_label_over_the_traced_wall():
    read = spec.metric_reader("infer.tile_idle_share")
    gaps = {"infer.tile": 1.5, "after infer.tile / before aten::empty": 0.7,
            "infer.tile_s": 0.3, "infer.collate": 0.2}
    assert read(_rec(_trace(gaps, window_s=5.0))) == pytest.approx(30.0)
    assert read(_rec(_trace(gaps, window_s=3.0))) == pytest.approx(50.0)


@pytest.mark.parametrize("trace", [
    None,                                                      # no trace
    _trace({"after aten::sum / before aten::pin_memory": 2.0}),  # no such span
    _trace({"infer.tile": 1.0}, window_s=0.0),
    {"busy_s": 1.0, "window_s": 4.0, "kernel_s": {}},          # no idle gaps
], ids=["untraced", "no-span", "no-window", "no-gaps"])
def test_tile_idle_share_reads_nothing_without_its_span(trace):
    assert spec.metric_reader("infer.tile_idle_share")(_rec(trace)) is None


@pytest.mark.parametrize("name,key", [
    ("infer.tile_s", "infer.tile_s"),
    ("infer.pack_s", "infer.pack_s"),
    ("infer.collect_s", "infer.collect_s"),
    ("skeleton.tracer_fetches", "tracer_fetches"),
])
def test_stage_readers_average_the_program_key(name, key):
    read = spec.metric_reader(name)
    rec = _rec(stats=[{key: 2.0, "inference_s": 9.0}, {key: 4.0}, None])
    assert read(rec) == pytest.approx(3.0)
    # a program without the span or counter: nothing, not zero
    assert read(_rec(stats=[{"inference_s": 1.0}, {}])) is None
    assert read(_rec(stats=[None])) is None
