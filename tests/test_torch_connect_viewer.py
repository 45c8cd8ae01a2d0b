"""The port's skeleton connection and viewers
(smart_tree_tpu_torch/skeleton/connect.py, viz/{viewer,view_npz}.py and
`Pipeline._view_*`) against the JAX package on the same numpy inputs.

`connect_skeletons` is held on tests/test_connect.py's cases and on a
secondary skeleton of several branches: equal skeleton counts, branch ids,
parents and lengths; xyz and radii within rtol 1e-5 / atol 1e-6 (the
prepended connection point is a fp32 point-tube projection, computed by
torch on one side and XLA on the other). `viewer_items` and `view_npz.main`
are numpy on both sides: names, kinds, arrays, printed lines and written
files are equal.
"""

import copy
import logging

import numpy as np
import pytest
import torch

from smart_tree_tpu.data.branch import BranchSkeleton as JBranch
from smart_tree_tpu.data.cloud import Cloud as JCloud
from smart_tree_tpu.data.tree import DisjointTreeSkeleton as JDisjoint
from smart_tree_tpu.data.tree import TreeSkeleton as JTree
from smart_tree_tpu.skeleton.connect import connect_skeletons as jconnect
from smart_tree_tpu.viz import view_npz as jview_npz
from smart_tree_tpu.viz import viewer as jviewer
from smart_tree_tpu_torch.data.branch import BranchSkeleton
from smart_tree_tpu_torch.data.cloud import Cloud
from smart_tree_tpu_torch.data.file import save_data_npz
from smart_tree_tpu_torch.data.synthetic import generate_tree
from smart_tree_tpu_torch.data.tree import DisjointTreeSkeleton, TreeSkeleton
from smart_tree_tpu_torch.infer.pipeline import Pipeline
from smart_tree_tpu_torch.skeleton import connect_skeletons
from smart_tree_tpu_torch.viz import view_npz, viewer

GEOM_TOL = dict(rtol=1e-5, atol=1e-6)


def _line(bid, parent, start, end, n=5, r=0.05):
    t = np.linspace(0, 1, n)[:, None]
    return bid, parent, np.asarray(start) * (1 - t) + np.asarray(end) * t, np.full((n, 1), r)


# (skeleton id, [branch (id, parent, start, end, n, r)]) per skeleton
CASES = {
    # tests/test_connect.py: sec merged 0.1 m from the trunk, far kept apart
    "graft-near-keep-far": [
        (0, [(0, -1, [0, 0, 0], [0, 2, 0])]),
        (1, [(0, -1, [0.1, 1.0, 0], [1.0, 1.5, 0])]),
        (2, [(0, -1, [5, 0, 0], [5, 1, 0])]),
    ],
    "single": [(0, [(0, -1, [0, 0, 0], [0, 2, 0])])],
    # a trunk of two branches and two secondaries of several branches, one
    # of whose children is listed before its parent
    "branchy": [
        (0, [(0, -1, [0, 0, 0], [0, 2, 0], 6, 0.08), (3, 0, [0, 1, 0], [0.8, 1.6, 0], 4, 0.04)]),
        (4, [(5, -1, [0.3, 1.2, 0.1], [0.9, 2.5, 0.2], 7, 0.03),
             (2, 5, [0.9, 2.5, 0.2], [1.2, 3.0, 0.0], 3, 0.02),
             (7, 2, [1.2, 3.0, 0.0], [1.0, 3.4, 0.3], 3, 0.01)]),
        (5, [(1, 8, [0.05, 0.4, 0.0], [0.2, 0.9, -0.3], 5, 0.02),
             (8, -1, [-0.1, 0.3, 0.0], [0.05, 0.4, 0.0], 4, 0.02)]),
        (6, [(0, -1, [0.0, 3.3, 0.0], [0.0, 4.0, 0.0], 5, 0.05)]),
    ],
}


def _build(spec, branch_cls, tree_cls, disjoint_cls):
    skeletons = []
    for sid, branches in spec:
        made = {}
        for b in branches:
            bid, parent, xyz, radii = _line(*b)
            made[bid] = branch_cls(bid, parent, xyz, radii)
        skeletons.append(tree_cls(sid, made))
    return disjoint_cls(skeletons)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("max_distance", [0.5, 0.2])
def test_connect_skeletons_matches_jax(case, max_distance):
    ours = _build(CASES[case], BranchSkeleton, TreeSkeleton, DisjointTreeSkeleton)
    ref_in = _build(CASES[case], JBranch, JTree, JDisjoint)
    got = connect_skeletons(ours, max_distance=max_distance, device="cpu")
    ref = jconnect(ref_in, max_distance=max_distance)
    if len(CASES[case]) == 1:
        assert got is ours and ref is ref_in
    assert [s._id for s in got.skeletons] == [s._id for s in ref.skeletons]
    for a, b in zip(got.skeletons, ref.skeletons):
        assert list(a.branches) == list(b.branches)
        for k, x in a.branches.items():
            y = b.branches[k]
            assert (x._id, x.parent_id, len(x)) == (y._id, y.parent_id, len(y))
            np.testing.assert_allclose(x.xyz, y.xyz, **GEOM_TOL)
            np.testing.assert_allclose(x.radii, y.radii, **GEOM_TOL)
    if case == "graft-near-keep-far":
        assert len(got.skeletons) == 2 and len(got.skeletons[0].branches) == 2
        grafted = got.skeletons[0].branches[1]
        assert grafted.parent_id == 0 and len(grafted) == 6
        assert np.linalg.norm(grafted.xyz[0] - [0, 1.0, 0]) < 0.08


def test_connect_skeletons_runs_on_the_card_unless_told(monkeypatch):
    d = _build(CASES["graft-near-keep-far"], BranchSkeleton, TreeSkeleton, DisjointTreeSkeleton)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        connect_skeletons(copy.deepcopy(d))
    assert len(connect_skeletons(d, device="cpu").skeletons) == 2


def _cloud_and_skeleton(cloud_cls, branch_cls, tree_cls):
    """tests/test_viewer_contract.py's fixture."""
    rng = np.random.default_rng(0)
    n = 200
    xyz = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    cloud = cloud_cls(xyz=xyz, rgb=rng.uniform(0, 1, (n, 3)).astype(np.float32),
                      medial_vector=rng.normal(0, 0.05, (n, 3)).astype(np.float32),
                      class_l=(np.arange(n) % 2).astype(np.float32).reshape(-1, 1))
    trunk = branch_cls(0, -1, np.stack([np.zeros(5), np.linspace(0, 2, 5), np.zeros(5)], axis=1),
                       np.full((5, 1), 0.1))
    limb = branch_cls(1, 0, np.stack([np.linspace(0, 1, 4), np.full(4, 2.0), np.zeros(4)], axis=1),
                      np.full((4, 1), 0.05))
    return cloud, tree_cls(0, {0: trunk, 1: limb})


def _same_items(got, ref):
    assert [(i.name, i.kind, sorted(i.data)) for i in got] == \
        [(i.name, i.kind, sorted(i.data)) for i in ref]
    for a, b in zip(got, ref):
        for k in a.data:
            assert a.data[k].dtype == b.data[k].dtype, (a.name, k)
            np.testing.assert_array_equal(a.data[k], b.data[k], err_msg=f"{a.name}.{k}")


@pytest.mark.parametrize("what", ["cloud+skeleton", "cloud", "skeleton", "bare-cloud"])
def test_viewer_items_equal_jax(what):
    cloud, skel = _cloud_and_skeleton(Cloud, BranchSkeleton, TreeSkeleton)
    jcloud, jskel = _cloud_and_skeleton(JCloud, JBranch, JTree)
    if what == "bare-cloud":
        cloud, jcloud = Cloud(xyz=cloud.xyz), JCloud(xyz=jcloud.xyz)
    cmap = np.asarray([[1.0, 0, 0], [0, 1.0, 0]])
    kw = dict(cmap=cmap)
    if what != "skeleton":
        kw.update(cloud=cloud)
    if "skeleton" in what:
        kw.update(skeleton=skel)
    jkw = {k: {"cloud": jcloud, "skeleton": jskel}.get(k, v) for k, v in kw.items()}
    got, ref = viewer.viewer_items(**kw), jviewer.viewer_items(**jkw)
    _same_items(got, ref)
    names = {"cloud+skeleton": 5, "cloud": 3, "skeleton": 2, "bare-cloud": 1}[what]
    assert len(got) == names


def test_views_warn_and_return_without_open3d(caplog):
    assert viewer.HAVE_O3D is jviewer.HAVE_O3D is False
    cloud, skel = _cloud_and_skeleton(Cloud, BranchSkeleton, TreeSkeleton)
    with caplog.at_level(logging.WARNING):
        assert viewer.view_cloud(cloud) is None
        assert viewer.view_skeleton(skel, cloud) is None
    warned = [r.getMessage() for r in caplog.records if r.name == viewer.__name__]
    assert warned == [
        "open3d not available; skipping interactive view (use save_outputs: True for PLY export)"
    ] * 2
    # the JAX package's words
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        jviewer.view_cloud(cloud)
    assert [r.getMessage() for r in caplog.records] == warned[:1]


def test_view_npz_main_equals_jax(tmp_path, capsys):
    paths = []
    for seed in (3, 4):
        cloud, skel = generate_tree(seed=seed, height=1.5, trunk_radius=0.05,
                                    points_per_m2=400.0, foliage_points=50)
        paths.append(str(tmp_path / f"tree_{seed}.npz"))
        save_data_npz(paths[-1], skel, cloud)
    assert view_npz.main(paths + ["--export-ply", str(tmp_path / "ours.ply")]) == 0
    ours = capsys.readouterr().out
    assert jview_npz.main(paths + ["--export-ply", str(tmp_path / "ref.ply")]) == 0
    ref = capsys.readouterr().out
    assert ours.replace("ours.ply", "X") == ref.replace("ref.ply", "X")
    assert "points, classes [" in ours and "branches" in ours
    assert (tmp_path / "ours.ply").read_bytes() == (tmp_path / "ref.ply").read_bytes()


def test_pipeline_views_go_through_the_viewer(monkeypatch):
    """Pipeline._view_cloud / _view_skeleton call the viewer with the
    pipeline's colour map, as the JAX pipeline does."""
    calls = []
    monkeypatch.setattr(viewer, "view_cloud", lambda *a: calls.append(("cloud", a)))
    monkeypatch.setattr(viewer, "view_skeleton", lambda *a: calls.append(("skeleton", a)))
    p = Pipeline(None, None, None, cmap=((1, 0, 0), (0, 0, 1)))
    p._view_cloud("c")
    p._view_skeleton("s", "c")
    assert calls[0][0] == "cloud" and calls[0][1][0] == "c"
    np.testing.assert_array_equal(calls[0][1][1], np.asarray([[1, 0, 0], [0, 0, 1]], np.float32))
    assert calls[1] == ("skeleton", ("s", "c"))
