"""The window's arithmetic: whole passes over the pool, the rate over all the work and all
the time, the 90th percentile over every cloud, the union of intervals."""

import time
from types import SimpleNamespace

import numpy as np
import pytest

from stbench import window


def test_union_counts_overlap_once():
    assert window.union_s([(0, 1), (0.5, 2), (3, 4)]) == pytest.approx(3.0)
    assert window.union_s([(2, 3), (0, 1)]) == pytest.approx(2.0)
    assert window.union_s([(0, 4), (1, 2)]) == pytest.approx(4.0)
    assert window.union_s([]) == 0.0


def test_closed_loop_spans_whole_passes():
    calls = []

    def call(k, i):
        calls.append((k, i))
        time.sleep(0.02)

    done, w = window.closed_loop(call, 3, 0.1, lambda: None)
    assert [k for k, _ in done] == [i % 3 for i in range(len(done))]
    assert len(done) % 3 == 0 and len(done) >= 6
    assert w >= 0.1 and w - sum(s for _, s in done) < 0.01
    assert w - sum(s for _, s in done[-3:]) < 0.1   # the last pass crossed the deadline


def test_closed_loop_leaves_out_time_between():
    def between(i):
        time.sleep(0.05)

    done, w = window.closed_loop(lambda k, i: time.sleep(0.01), 1, 0.05,
                                 lambda: None, between)
    assert w < 0.05 + 0.02 + 0.01 * 2 and len(done) >= 4


def test_rate_and_p90():
    secs = [0.5, 0.7, 0.9, 1.1, 2.0]
    assert window.p90(secs) == pytest.approx(np.percentile(secs, 90))
    points = [100, 200, 300, 400, 500]
    assert sum(points) / sum(secs) == pytest.approx(1500 / 5.2)


def _ev(name, a, b, dev):
    return SimpleNamespace(name=name, device_type=f"DeviceType.{dev}",
                           time_range=SimpleNamespace(start=a * 1e6, end=b * 1e6))


def test_trace_summary():
    ev = [_ev("k1", 0.0, 1.0, "CUDA"), _ev("k2", 0.5, 1.5, "CUDA"),
          _ev("Memcpy HtoD", 1.5, 3.0, "CUDA"), _ev("k1", 3.0, 3.5, "CUDA"),
          _ev("aten::item", 1.4, 2.9, "CPU"), _ev("cloud", 0.0, 4.0, "CPU")]
    s = window.trace_summary(ev, 4.0)
    assert s["busy_s"] == pytest.approx(2.0)
    assert dict(s["device_ops"]) == pytest.approx({"k1": 1.5, "k2": 1.0})
    assert s["idle_gaps"] == [["aten::item", pytest.approx(1.5)],
                              ["cloud", pytest.approx(0.5)]]
    ev = [_ev("k1", 0.0, 1.0, "CUDA"), _ev("k1", 3.0, 3.5, "CUDA"),
          _ev("aten::sum", 0.1, 0.9, "CPU"), _ev("aten::pin_memory", 2.5, 2.6, "CPU")]
    assert window.trace_summary(ev, 4.0)["idle_gaps"] == [
        ["after aten::sum / before aten::pin_memory", pytest.approx(2.0)]]
    ev.append(_ev("aten::nonzero", 3.6, 4.5, "CPU"))     # idle after the last kernel
    assert window.trace_summary(ev, 4.5)["idle_gaps"][1] == ["aten::nonzero",
                                                            pytest.approx(1.0)]
    assert window.kernel_busy_s(ev) == pytest.approx(1.5)
