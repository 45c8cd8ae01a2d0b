"""The port's spans and counters (utils/trace.py) and where they sit: the
helper alone, its ranges in a CPU torch.profiler trace (host events, not
user annotations), the forward's and the pipeline's outputs unchanged by
`stats`, the forward's stage keys, and the tracer's fetch count. CPU only;
the card's side (no device-side event for a span) is in test_torch_cuda.py."""

import time

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from smart_tree_tpu_torch.data.augmentations import CentreCloud
from smart_tree_tpu_torch.data.cloud import Cloud
from smart_tree_tpu_torch.data.synthetic import generate_tree
from smart_tree_tpu_torch.infer.inference import ModelInference
from smart_tree_tpu_torch.skeleton import path as tpath
from smart_tree_tpu_torch.skeleton.skeletonize import Skeletonizer
from smart_tree_tpu_torch.utils import configs, trace

WEIGHTS = "smart_tree_tpu/weights/noble-elevator-58.npz"
TREE = dict(seed=3, height=2.0, trunk_radius=0.08, points_per_m2=3000.0,
            foliage_points=300)
# the forward's stages: they follow one another and do not nest
FORWARD_SPANS = ("infer.tile", "infer.collate", "infer.pack", "infer.upload",
                 "infer.plan", "infer.unet", "infer.collect")
PIPELINE_KEYS = ("inference_s", "skeletonize_s", "post_process_s", "save_s", "upload_s",
                 "outlier_filter_s", "reduce_s", "knn_graph_s", "table_shortcuts_s",
                 "components_s", "sssp_s", "tracer_s", "branches", "tracer_fetches",
                 "tracer_iterations")
# the entry point and the ModelInference keywords of each case: `predict`
# is the full download
MODES = {"full-download": ("predict", dict()),
         "compact": ("forward", dict()),
         "culled": ("forward", dict(medial_classes=[0]))}


@pytest.fixture(scope="module")
def tree():
    return CentreCloud()(generate_tree(**TREE)[0])


def _spans(prof):
    """(name, start, end) of the profile's program spans."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if "." in e.name and not e.name.startswith(("aten::", "cudaDevice"))]


def test_span_adds_seconds_and_count_adds():
    stats = {}
    with trace.span(stats, "test.sleep", "sleep_s"):
        time.sleep(0.01)
    with trace.span(stats, "test.sleep", "sleep_s"):
        pass
    with trace.span(stats, "test.range_only"):
        pass
    trace.count(stats, "n")
    trace.count(stats, "n", 3)
    assert stats.keys() == {"sleep_s", "n"}
    assert 0.01 <= stats["sleep_s"] < 1.0 and stats["n"] == 4


@pytest.mark.parametrize("stats,key", [(None, "k_s"), (None, None), ({}, None)],
                         ids=["no-stats", "no-stats-no-key", "no-key"])
def test_span_does_nothing_without_stats_or_profiler(monkeypatch, stats, key):
    def no_clock():
        raise AssertionError("a span read the clock")

    monkeypatch.setattr(trace.time, "perf_counter", no_clock)
    ctx = trace.span(stats, "test.off", key)
    assert ctx is trace._NULL
    with ctx:
        pass
    trace.count(None, "n")
    assert stats in (None, {})


def test_spans_are_profiler_host_events_not_user_annotations():
    import torch

    stats = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span(None, "test.outer"):
            with trace.span(stats, "test.inner", "inner_s"):
                torch.ones(16).sum()
    events = {e.name: e for e in prof.events() if e.name.startswith("test.")}
    assert events.keys() == {"test.outer", "test.inner"}
    for e in events.values():
        assert str(e.device_type).endswith("CPU") and e.is_user_annotation is False
    outer, inner = events["test.outer"].time_range, events["test.inner"].time_range
    assert outer.start <= inner.start <= inner.end <= outer.end
    assert stats["inner_s"] > 0


def _fields(out):
    """The arrays of a forward's Cloud or of predict's dict."""
    if isinstance(out, dict):
        return [np.asarray(v) for v in out.values()]
    return [np.asarray(getattr(out, f)) for f in ("xyz", "rgb", "medial_vector", "class_l")]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_forward_is_unchanged_by_stats_and_its_stages_tile_it(tree, mode):
    entry, kw = MODES[mode]
    run = getattr(ModelInference(WEIGHTS, device="cpu", **kw), entry)
    plain = run(tree)
    stats = {}
    timed = run(tree, stats=stats)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = run(tree)
    for a, b, c in zip(_fields(plain), _fields(timed), _fields(traced)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    # the forward's device tiler also counts its host reads
    fetches = {"tile_fetches"} if entry == "forward" else set()
    assert set(stats) == {f"{s}_s" for s in FORWARD_SPANS} | {"tile_box_tests"} | fetches
    assert all(v >= 0.0 for v in stats.values())
    assert 0 < stats["tile_box_tests"] <= 8 * len(tree)   # buffer under half a block
    assert stats.get("tile_fetches", 2) == 2
    spans = _spans(prof)
    stages = sorted(s for s in spans if s[0] in FORWARD_SPANS)
    assert {s[0] for s in stages} == set(FORWARD_SPANS)
    stages.sort(key=lambda s: s[1])
    for (_, _, end), (_, start, _) in zip(stages, stages[1:]):
        assert end <= start          # one after the other, none inside another
    assert stages[0][0] == "infer.tile"
    root = "infer.forward"           # forward's own range; predict has none
    assert [s[0] for s in spans].count(root) == (entry == "forward")
    if entry == "forward":
        _, r0, r1 = next(s for s in spans if s[0] == root)
        assert r0 <= stages[0][1] and stages[-1][2] <= r1


@pytest.fixture(scope="module")
def pipeline_runs(tmp_path_factory):
    """The default pipeline on the CPU over one small tree, without and with
    `stats`: (skeleton, output folder, stats) of each."""
    raw = generate_tree(**TREE)[0]
    runs = []
    for stats in (None, {}):
        out = tmp_path_factory.mktemp("out")
        cfg = configs.default_pipeline_config()
        cfg["model_inference"]["device"] = "cpu"
        cfg["skeletonizer"]["device"] = "cpu"
        cfg["save_path"] = str(out)
        skel = configs.instantiate(cfg).process_cloud(cloud=Cloud(xyz=raw.xyz, rgb=raw.rgb),
                                                      stats=stats)
        runs.append((skel, out, stats))
    return runs


def test_pipeline_is_unchanged_by_stats(pipeline_runs):
    (a, out_a, _), (b, out_b, _) = pipeline_runs
    assert [sorted(s.branches) for s in a.skeletons] == [sorted(s.branches) for s in b.skeletons]
    for sa, sb in zip(a.skeletons, b.skeletons):
        for key, x in sa.branches.items():
            np.testing.assert_array_equal(x.xyz, sb.branches[key].xyz)
            np.testing.assert_array_equal(x.radii, sb.branches[key].radii)
    for name in ("skeleton.ply", "mesh.ply", "cloud.ply", "seg_cld.ply"):
        assert (out_a / name).read_bytes() == (out_b / name).read_bytes()


def test_pipeline_stats_hold_the_forward_stages_within_inference(pipeline_runs):
    stats = pipeline_runs[1][2]
    for key in PIPELINE_KEYS + tuple(f"{s}_s" for s in FORWARD_SPANS):
        assert key in stats, key
    forward = sum(stats[f"{s}_s"] for s in FORWARD_SPANS)
    assert 0.0 < forward <= stats["inference_s"]
    assert stats["tracer_iterations"] >= stats["branches"]
    assert stats["tracer_fetches"] == stats["tracer_iterations"] // tpath.ROUND + 1


@pytest.mark.parametrize("max_branches,strict", [(1024, True), (3, False)],
                         ids=["all-branches", "branch-cap"])
def test_tracer_fetches_are_iterations_plus_the_last(monkeypatch, max_branches, strict):
    """One fetch a round of ROUND queued iterations, the round that finds
    no work (or the cap) included; the real iterations are the selections
    run."""
    c, _ = generate_tree(seed=10, height=2.0, points_per_m2=2500.0, max_depth=1)
    cloud = Cloud(xyz=c.xyz, medial_vector=c.medial_vector)
    iterations = []
    select = tpath._select_path_points_windowed

    def counted(*a):
        iterations.append(1)
        return select(*a)

    monkeypatch.setattr(tpath, "_select_path_points_windowed", counted)
    stats = {}
    Skeletonizer(device="cpu", max_branches=max_branches, strict=strict).forward(
        cloud, stats=stats)
    assert len(iterations) >= 3
    assert stats["tracer_iterations"] == len(iterations)
    assert stats["tracer_fetches"] == len(iterations) // tpath.ROUND + 1
    if max_branches == 3:
        assert stats["branches"] == 3
