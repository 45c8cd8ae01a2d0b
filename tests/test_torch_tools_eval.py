"""The port's quality and scan tools against the JAX tools of the same name,
imported from `tools/`: `smart_tree_tpu_torch/tools/{evaluate,
diagnose_direction,diagnose_e2e,bench_scan}.py`, on the CPU at fp32 with
`synthetic-r3.npz`.

Tolerances:
- `evaluate_tree` through each package's own forward and skeletonizer: every
  metric but the timings within 1e-4 absolute (the tools round to 4
  decimals: one rounding step) and `n_points` / `n_branches` exactly.
- `direction_buckets`, `bucket_stats` and `skeleton_accounting` on the same
  forward output: equal within 1e-5 (the rounded values, so equal), counts
  and component sizes exactly; the port's `diagnose_direction` main on its
  own forward against the JAX main within one step of each value's rounding.
- `make_forest`: equal bits.
- The scan path (forward culled to the branch class, multi-component
  skeletonizer) on a thinned two-tree forest: forward rows held as
  tests/test_torch_transfers.py holds the culled payload (classes equal,
  radius within an fp16 ulp, direction within an int8 step); the
  skeletonizers on the same branch points equal in skeletons, branches and
  parents, xyz / radii rtol 1e-5 / atol 1e-6; the port's whole path under
  tests/test_scan_stretch.py's structural assertions.

The held-out tree is 3 m tall at 3,000 points/m^2 (7,496 points): at a few
hundred points/m^2 synthetic-r3 finds no skeleton at all, and on this tree
the default filter radius and `None` give different skeletons.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from smart_tree_tpu.data.cloud import Cloud as JCloud
from smart_tree_tpu.infer import inference as jinf
from smart_tree_tpu.infer.inference import ModelInference as JModelInference
from smart_tree_tpu.skeleton.skeletonize import Skeletonizer as JSkeletonizer
from smart_tree_tpu_torch.data.cloud import Cloud
from smart_tree_tpu_torch.infer.inference import ModelInference
from smart_tree_tpu_torch.skeleton.skeletonize import Skeletonizer
from smart_tree_tpu_torch.tools import bench_scan, diagnose_direction, diagnose_e2e, evaluate
from tests.test_torch_skeleton import _assert_same_skeletons

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

import bench_scan as jscan  # noqa: E402  (tools/, the JAX tools)
import diagnose_direction as jdirection  # noqa: E402
import diagnose_e2e as je2e  # noqa: E402
import evaluate as jevaluate  # noqa: E402

R3 = "smart_tree_tpu/weights/synthetic-r3.npz"
SEED = 100
TREE = dict(height=3.0, trunk_radius=0.1, points=3000.0, foliage=500)
TIMING = {"inference_s", "points_per_s", "skeletonize_s"}
METRIC_ATOL = 1e-4 + 1e-9   # one step of round(x, 4), plus the float noise of the step
SAME_ATOL = 1e-5
SCAN_FOREST = dict(n_trees=2, points_per_m2=4000.0, seed=0)
SCAN_POINTS = 12_000
QUANT = dict(radius_rtol=2.0 ** -10, direction_atol=1.0 / 127 + 1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite's workers share the host's cores: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _one_jax_device():
    """The JAX forwards must take the one-device path: its multichip path
    over the conftest's 8 CPU devices runs in-process collectives (see
    tests/test_torch_block_infer.py). Every JAX forward here is one batch."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jinf.ModelInference, "_submit_multichip",
                   lambda *a, **k: pytest.fail("took the multichip path"))
        yield


@pytest.fixture(scope="module")
def jax_mi():
    return JModelInference(R3)


@pytest.fixture(scope="module")
def port_mi():
    return ModelInference(R3, device="cpu")


@pytest.fixture(scope="module")
def tree():
    return evaluate.centred_tree(SEED, **TREE)


@pytest.fixture(scope="module")
def port_out(port_mi, tree):
    return port_mi.forward(tree[0])


def _close(got, ref, atol, where=""):
    """Nested dicts / lists: equal keys and lengths; ints and strings equal;
    floats within atol (nan equal to nan)."""
    if isinstance(ref, dict):
        assert set(got) == set(ref), where
        for k in ref:
            _close(got[k], ref[k], atol, f"{where}.{k}")
    elif isinstance(ref, list):
        assert len(got) == len(ref), where
        for i, (a, b) in enumerate(zip(got, ref)):
            _close(a, b, atol, f"{where}[{i}]")
    elif isinstance(ref, float):
        assert (np.isnan(got) and np.isnan(ref)) or abs(got - ref) <= atol, (where, got, ref)
    else:
        assert got == ref, (where, got, ref)


@pytest.mark.parametrize("mfr", ["default", "none"])
def test_evaluate_tree_matches_jax(port_mi, jax_mi, mfr):
    port_mfr = evaluate._DEFAULT if mfr == "default" else None
    jax_mfr = jevaluate._DEFAULT if mfr == "default" else None
    got = evaluate.evaluate_tree(port_mi, SEED, **TREE, min_filter_radius=port_mfr)
    ref = jevaluate.evaluate_tree(jax_mi, SEED, **TREE, min_filter_radius=jax_mfr)
    assert got["n_branches"] >= 5 and got["iou_branch"] > 0.9
    _close({k: v for k, v in got.items() if k not in TIMING},
           {k: v for k, v in ref.items() if k not in TIMING}, METRIC_ATOL)
    assert set(got) == set(ref)


def test_filter_radius_argument_semantics():
    assert evaluate.filter_radius(None) is evaluate._DEFAULT
    assert evaluate.filter_radius("None") is None and evaluate.filter_radius("none") is None
    assert evaluate.filter_radius("0.03") == 0.03


@pytest.mark.parametrize("tool", [evaluate, diagnose_direction, diagnose_e2e, bench_scan])
def test_tools_raise_without_a_card(monkeypatch, tool):
    """Without `--device cpu` and without a card no tool carries on on the
    CPU: it raises before any tree is made."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [] if tool is bench_scan else [R3]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)


def _jax_cloud(c):
    return JCloud(xyz=c.xyz, rgb=c.rgb, medial_vector=c.medial_vector, class_l=c.class_l)


def _port_cloud(c):
    return Cloud(xyz=np.asarray(c.xyz), rgb=np.asarray(c.rgb),
                 medial_vector=np.asarray(c.medial_vector), class_l=np.asarray(c.class_l))


def test_diagnose_direction_matches_jax(jax_mi, tree, capsys, monkeypatch):
    flags = [R3, "--seed", str(SEED), "--height", str(TREE["height"]), "--trunk-radius",
             str(TREE["trunk_radius"]), "--points", str(TREE["points"]), "--foliage",
             str(TREE["foliage"])]
    # the JAX main on the fixture's (already compiled) JAX model
    monkeypatch.setattr(jdirection, "ModelInference", lambda weights: jax_mi)
    monkeypatch.setattr(sys, "argv", ["diagnose_direction.py", *flags])
    jdirection.main()
    ref = json.loads(capsys.readouterr().out)
    assert ref["n_branch_pts"] > 1000 and len(ref["buckets"]) >= 3

    # the port's function on the JAX forward's output: the same numbers
    lc = _port_cloud(jax_mi.forward(_jax_cloud(tree[0])))
    _close(diagnose_direction.direction_buckets(tree[0], lc, "cpu"), ref, SAME_ATOL)

    # the port's main on its own forward: within one step of each rounding
    assert diagnose_direction.main([*flags, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    _close({k: v for k, v in got.items() if k != "buckets"},
           {k: v for k, v in ref.items() if k != "buckets"}, 1e-4 + 1e-9)
    assert len(got["buckets"]) == len(ref["buckets"])
    for a, b in zip(got["buckets"], ref["buckets"]):
        assert {k: a[k] for k in ("r_lo", "r_hi", "n")} == {k: b[k] for k in ("r_lo", "r_hi", "n")}
        for k, step in (("frac", 1e-3), ("cos", 1e-3), ("radius_rel_mae", 1e-3),
                        ("medial_err_mm", 1e-2), ("medial_err_over_r", 1e-2)):
            assert abs(a[k] - b[k]) <= step + 1e-9, (k, a, b)


def test_bucket_stats_and_skeleton_accounting_match_jax(port_out, tree, capsys):
    cloud, gt_skel = tree
    ok, rows = evaluate.aligned_truth(port_out, cloud, "cpu")
    gt_mv = cloud.medial_vector[rows]
    gt_r = np.linalg.norm(gt_mv, axis=1)
    pr_mv = port_out.medial_vector[ok]
    pr_r = np.linalg.norm(pr_mv, axis=1)
    cos = ((gt_mv / np.maximum(gt_r[:, None], 1e-9))
           * (pr_mv / np.maximum(pr_r[:, None], 1e-9))).sum(1)
    err = np.abs(pr_r - gt_r)
    got = diagnose_e2e.bucket_stats(gt_r, cos, err)
    assert len(got) >= 3
    _close(got, je2e.bucket_stats(gt_r, cos, err), SAME_ATOL)

    branch = port_out.filter_by_class([0])
    gt_len = gt_skel.length
    sk_port = diagnose_e2e.skeleton_accounting(
        branch, Skeletonizer(hop_cap=16384, strict=False, device="cpu"), gt_len, "predicted")
    got = json.loads(capsys.readouterr().out)
    sk_ref = je2e.skeleton_accounting(
        _jax_cloud(branch), JSkeletonizer(hop_cap=16384, strict=False), gt_len, "predicted")
    ref = json.loads(capsys.readouterr().out)
    assert got["components_kept"] >= 1 and got["recovered_len"] > 0
    assert got["after_outlier_removal"] < got["medial_pts"] == len(branch)
    _close(got, ref, SAME_ATOL)
    _assert_same_skeletons(sk_port, sk_ref)


def test_make_forest_matches_jax():
    got = bench_scan.make_forest(2, 200.0, seed=0)
    ref = jscan.make_forest(2, 200.0, seed=0)
    for f in ("xyz", "rgb"):
        a, b = getattr(got, f), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert len(got) > 60_000   # 30,000 foliage points a tree


def _sorted_rows(c):
    xyz = np.asarray(c.xyz)
    order = np.lexsort(xyz.T[::-1])
    return {f: np.asarray(getattr(c, f))[order] for f in ("xyz", "medial_vector", "class_l")}


def test_forest_scan_path_matches_jax():
    """bench_scan's path on a forest thinned by a seeded subsample: several
    batches (7) and several components."""
    n_trees = SCAN_FOREST["n_trees"]
    forest = bench_scan.make_forest(**SCAN_FOREST)
    keep = np.sort(np.random.default_rng(0).choice(len(forest), SCAN_POINTS, replace=False))
    cloud = forest.filter(keep)

    report, lc, skel = bench_scan.scan(cloud, n_trees, R3, skeletonize=True, device="cpu",
                                       precision="float32")
    assert report["n_points"] == SCAN_POINTS and report["skeletons"] == len(skel.skeletons)
    assert report["knn_route"] == "brute force"
    assert report["graph_vertices"] == report["stage_stats"]["graph_vertices"]
    assert report["branches"] == report["stage_stats"]["branches"]
    assert report["forward_peak_bytes"] is None   # no card: no device memory to report

    # test_scan_stretch.py's structural assertions, on the port's whole path
    assert len(lc) > 0 and report["branch_points"] > 1000
    assert len(skel.skeletons) >= n_trees
    assert sum(len(s.branches) for s in skel.skeletons) >= n_trees
    pts = np.concatenate([b.xyz for s in skel.skeletons for b in s.branches.values()])
    lo, hi = cloud.xyz.min(0) - 1.0, cloud.xyz.max(0) + 1.0
    assert bool(((pts >= lo) & (pts <= hi)).all())

    # the JAX path: forward culled to the branch class, then the skeletonizer;
    # one batch of every block (the port's batches differ, eval-mode rows do not)
    jmi = JModelInference(R3, medial_classes=(0,), batch_size=32)
    ref_out = jmi.forward(JCloud(xyz=cloud.xyz, rgb=cloud.rgb))
    got_rows, ref_rows = _sorted_rows(lc), _sorted_rows(ref_out)
    np.testing.assert_array_equal(got_rows["xyz"], ref_rows["xyz"])
    np.testing.assert_array_equal(got_rows["class_l"], ref_rows["class_l"])
    gr, rr = (np.linalg.norm(r["medial_vector"], axis=1) for r in (got_rows, ref_rows))
    np.testing.assert_allclose(gr, rr, rtol=QUANT["radius_rtol"], atol=0)
    np.testing.assert_allclose(got_rows["medial_vector"] / np.maximum(gr, 1e-30)[:, None],
                               ref_rows["medial_vector"] / np.maximum(rr, 1e-30)[:, None],
                               rtol=0, atol=QUANT["direction_atol"])

    ref_branch = ref_out.filter_by_class([0])
    ref_skel = JSkeletonizer(max_components=4 * n_trees, strict=False).forward(ref_branch)
    got_skel = Skeletonizer(max_components=4 * n_trees, strict=False, device="cpu").forward(
        _port_cloud(ref_branch))
    _assert_same_skeletons(got_skel, ref_skel)
    # and the two whole paths, each skeletonizer on its own forward's rows
    _assert_same_skeletons(skel, ref_skel)
