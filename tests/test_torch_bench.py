"""The port's benchmark harness (smart_tree_tpu_torch/bench.py) and its
roofline (smart_tree_tpu_torch/tools/roofline.py) on the CPU: the bench's key
set at the tiny size, the supervisor's one JSON line and non-zero exit under
injected faults, the roofline's counts equal to tools/roofline.py's, and
neither module importing JAX."""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import pytest

from smart_tree_tpu_torch import bench
from smart_tree_tpu_torch.data.synthetic import generate_tree
from smart_tree_tpu_torch.tools import roofline

REPO = Path(__file__).resolve().parent.parent
BENCH_KEYS = (
    "metric", "value", "unit", "vs_baseline", "device_step_s", "device_points_per_sec",
    "device_vs_cpu_baseline", "dispatch_overhead_s", "n_points", "end_to_end_s",
    "end_to_end_reps_s", "slab_launches_per_forward", "batch_capacities", "batch_level_rows",
    "device",
    "n_branch_points", "n_skeletons", "pipeline_s", "clouds_per_min_e2e",
)
DEVICE_KEYS = ("device_step_s", "device_step_reps_s", "device_busy_share",
               "device_points_per_sec", "device_vs_cpu_baseline", "dispatch_overhead_s")


def _jax_roofline():
    spec = importlib.util.spec_from_file_location("jax_roofline", REPO / "tools" / "roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _supervise(*args):
    """The supervisor as a subprocess on the CPU: (rc, its last stdout line
    parsed, the number of JSON lines it printed)."""
    proc = subprocess.run(
        [sys.executable, "-m", "smart_tree_tpu_torch.bench", "--tiny", "--device", "cpu", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    assert lines, proc.stderr
    return proc.returncode, json.loads(lines[-1]), sum(ln.startswith("{") for ln in lines)


def test_run_bench_tiny_on_cpu():
    out = bench.run_bench(device="cpu", **bench.TINY)
    for key in BENCH_KEYS:
        assert key in out, key
    assert "skeleton_error" not in out, out.get("skeleton_error")
    assert out["metric"] == "sparse-unet inference points/sec"
    assert out["unit"] == "points/sec"
    assert out["value"] > 0
    assert out["vs_baseline"] == pytest.approx(out["value"] / 8873.0)
    cloud, _ = generate_tree(seed=0, height=6.0, trunk_radius=0.25, points_per_m2=120.0,
                             foliage_points=200)
    assert out["n_points"] == len(cloud)
    for key in DEVICE_KEYS:
        assert out[key] is None, key
    assert len(out["end_to_end_reps_s"]) == 1
    assert out["end_to_end_s"] == out["end_to_end_reps_s"][0]
    assert out["slab_launches_per_forward"] == 0  # the plain version on the CPU
    assert out["batch_capacities"] and all(c > 0 for c in out["batch_capacities"])
    # one exact plan a batch, level 0 the batch's voxels, within its capacity
    assert len(out["batch_level_rows"]) == len(out["batch_capacities"])
    for rows, cap in zip(out["batch_level_rows"], out["batch_capacities"]):
        assert len(rows) == 4 and 0 < rows[0] <= cap
    assert out["device"] == "cpu"
    assert out["clouds_per_min_e2e"] > 0
    assert out["clouds_per_min_e2e"] == pytest.approx(60.0 / out["pipeline_s"])
    json.dumps(out)


def test_supervisor_fault_raise_prints_error_line_and_fails():
    rc, out, n_json = _supervise("--fault", "raise")
    assert rc != 0
    assert n_json == 1
    assert "error" in out and out["value"] == 0.0
    assert out["metric"] == "sparse-unet inference points/sec"
    assert "fallback" not in out
    assert out["partial"] == {}


def test_supervisor_exit_after_warmup_carries_partial():
    rc, out, n_json = _supervise("--fault", "exit-after-warmup")
    assert rc != 0
    assert n_json == 1
    assert out["error"].startswith("rc=3")
    assert out["partial"]["stage"] == "warmed"
    cloud, _ = generate_tree(seed=0, height=6.0, trunk_radius=0.25, points_per_m2=120.0,
                             foliage_points=200)
    assert out["partial"]["n_points"] == len(cloud)


@pytest.mark.parametrize(
    "capacity,factor,itemsize,planes,input_channels",
    [(c, f, i, (8, 16, 32, 64), 3) for c in (256, 65536, 131072, 262144)
     for f in (0.25, 0.5) for i in (2, 4)]
    + [(65536, 0.5, 4, (8, 16, 32), 4)],
)
def test_roofline_analyze_matches_jax(capacity, factor, itemsize, planes, input_channels):
    ref = _jax_roofline().analyze(capacity, planes=planes, factor=factor, itemsize=itemsize,
                                  input_channels=input_channels)
    got = roofline.analyze(capacity, planes=planes, factor=factor, itemsize=itemsize,
                           input_channels=input_channels)
    assert got == ref


def test_roofline_forward_totals_sum_jax_batches():
    """The whole forward's totals are the JAX tool's per-batch totals summed
    (the bench tree's batch capacities)."""
    jax_rl = _jax_roofline()
    caps = [4096, 32768, 131072, 262144, 131072]
    want = {f: sum(jax_rl.analyze(c, itemsize=2)[2][f] for c in caps)
            for f in ("indices", "bytes", "flops")}
    total = roofline.forward_totals(caps, itemsize=2)
    assert total == want
    shares = roofline.achieved(total, 0.5, "bfloat16")
    assert shares["flop_share"] == pytest.approx(total["flops"] / 0.5 / 989e12)
    assert shares["bytes_share"] == pytest.approx(total["bytes"] / 0.5 / 3.35e12)


@pytest.mark.parametrize("capacity", [256, 4096, 131072])
def test_roofline_level_rows_form_is_the_schedule_form(capacity):
    """A batch given by its level rows counts as the JAX tool counts the
    capacity whose schedule gives those rows."""
    caps, _, total = _jax_roofline().analyze(capacity, itemsize=2)
    got_caps, _, got = roofline.analyze(tuple(caps), itemsize=2)
    assert got_caps == caps and got == total
    with pytest.raises(ValueError, match="level rows"):
        roofline.analyze((capacity, capacity))


def test_roofline_counts_the_rows_the_forward_ran(monkeypatch):
    """The roofline of a forward's exact level rows (`ModelInference.
    plan_rows`) is the work its convs did: the FLOPs of every gather conv and
    linear layer the forward called, counted as they run. The capacity
    schedule of the JAX tool counts other work: on this sparse tree the
    deeper levels hold more voxels than level 0, where it halves them."""
    from smart_tree_tpu_torch.data.augmentations import CentreCloud
    from smart_tree_tpu_torch.data.dataset import BlockTiler
    from smart_tree_tpu_torch.infer.inference import ModelInference
    from smart_tree_tpu_torch.nn import blocks

    ran = []
    gather_conv, linear = blocks.gather_conv, blocks.linear

    def counted_conv(feats, rb, w, cfg):
        ran.append(2 * rb.shape[0] * w.shape[0] * w.shape[1] * w.shape[2])
        return gather_conv(feats, rb, w, cfg)

    def counted_linear(feats, w, precision="float32"):
        ran.append(2 * feats.shape[0] * w.shape[0] * w.shape[1])
        return linear(feats, w, precision=precision)

    monkeypatch.setattr(blocks, "gather_conv", counted_conv)
    monkeypatch.setattr(blocks, "linear", counted_linear)
    cloud, _ = generate_tree(seed=0, height=bench.TINY["height"], trunk_radius=0.25,
                             points_per_m2=bench.TINY["points_per_m2"],
                             foliage_points=bench.TINY["foliage_points"])
    cloud = CentreCloud()(cloud)
    mi = ModelInference(bench.DEFAULT_WEIGHTS, precision="bfloat16", medial_classes=(0,),
                        device="cpu")
    mi.forward(cloud)
    caps = [len(vb.coords) for vb in BlockTiler(cloud, 0.01, 4.0, 0.4).batches(
        4, max_capacity=mi.max_batch_capacity)]
    assert len(mi.plan_rows) == len(caps) > 1
    exact = roofline.forward_totals(mi.plan_rows, itemsize=2)
    assert exact["flops"] == sum(ran)
    assert exact["flops"] != roofline.forward_totals(caps, itemsize=2)["flops"]
    assert all(rows[1] > rows[0] for rows in mi.plan_rows)


@pytest.mark.parametrize(
    "intervals,want",
    [([], 0.0), ([(0.0, 1.0)], 1.0), ([(0.0, 1.0), (0.5, 2.0)], 2.0),
     ([(0.0, 3.0), (1.0, 2.0)], 3.0), ([(2.0, 3.0), (0.0, 1.0)], 2.0),
     ([(0.0, 1.0), (1.0, 2.0), (0.2, 0.4)], 2.0)],
)
def test_union_counts_overlap_once(intervals, want):
    """device_step_s is the union of the kernel intervals: kernels on two
    streams that overlap count once, so the busy share stays within 1."""
    assert bench.union_s(intervals) == pytest.approx(want)


def test_bench_and_roofline_import_no_jax():
    code = (
        "import sys\n"
        "import smart_tree_tpu_torch.bench, smart_tree_tpu_torch.tools.roofline\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'smart_tree_tpu'))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
