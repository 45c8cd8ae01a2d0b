"""The reader of the tiling's point-box test counter
(metrics/infer.tile_box_tests.py) on synthetic records: the mean of the
program's `tile_box_tests` over the clouds that have it, and nothing where
the program keeps no such counter."""

import pytest

from stbench import spec
from stbench.record import Record


def _rec(stats):
    clouds = [{"pool": 0, "points": 10, "seconds": 1.0, "forward_s": 1.0, "unet_passes": 1,
               "stats": st} for st in stats]
    return Record(clouds, 2.0, "float32", None)


def test_tile_box_tests_reads_the_mean_of_the_counter():
    read = spec.metric_reader("infer.tile_box_tests")
    rec = _rec([{"tile_box_tests": 400_000, "infer.tile_s": 0.2}, {"tile_box_tests": 600_000},
                None])
    assert read(rec) == pytest.approx(500_000.0)


@pytest.mark.parametrize("stats", [[{"infer.tile_s": 0.5}, {}], [None], []],
                         ids=["no-counter", "no-stats", "no-clouds"])
def test_tile_box_tests_reads_nothing_without_the_counter(stats):
    assert spec.metric_reader("infer.tile_box_tests")(_rec(stats)) is None
