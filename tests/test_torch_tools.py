"""The port's remaining small modules and loose functions against the JAX
package on the same numpy inputs: utils/misc.py, scripts/{split_data,
bench_dataloader,vis_dataloader,laz2ply}.py, `rotation_matrix_from_vectors`,
the `Cloud` helpers (`filter_by_skeleton`, `root_idx`, `number_classes`),
`graph.sssp`, `skeleton.select_path_points` and `skeleton.sample_tree`.

Host numpy functions are held equal. `sssp`: predecessors equal, distances
rtol 1e-6 (fp32 path sums, min-reduced in another order; the weights are
tie-free). `select_path_points`: masks equal. `sample_tree`: the same branch
ids and parents, xyz and radii within rtol 1e-5 / atol 1e-6, except the one
documented difference: the JAX tracer on the CPU drops vertex 0 from a path
it lies on (tests/test_torch_skeleton.py::test_tracer_writes_only_real_path_vertices).
"""

import importlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_tree_tpu import graph as jgraph
from smart_tree_tpu.data.branch import BranchSkeleton as JBranch
from smart_tree_tpu.data.cloud import Cloud as JCloud
from smart_tree_tpu.data.tree import TreeSkeleton as JTree
from smart_tree_tpu.scripts import split_data as jsplit
from smart_tree_tpu.utils import maths as jmaths
from smart_tree_tpu.utils import misc as jmisc
from smart_tree_tpu_torch import graph as tgraph
from smart_tree_tpu_torch.data.branch import BranchSkeleton
from smart_tree_tpu_torch.data.cloud import Cloud
from smart_tree_tpu_torch.data.file import save_data_npz
from smart_tree_tpu_torch.data.synthetic import generate_tree
from smart_tree_tpu_torch.data.tree import TreeSkeleton
from smart_tree_tpu_torch.scripts import bench_dataloader, laz2ply, split_data, vis_dataloader
from smart_tree_tpu_torch.skeleton import sample_tree, select_path_points
from smart_tree_tpu_torch.utils import maths as tmaths
from smart_tree_tpu_torch.utils import misc as tmisc

jpath = importlib.import_module("smart_tree_tpu.skeleton.path")
GEOM_TOL = dict(rtol=1e-5, atol=1e-6)
SMALL_TREE = dict(seed=3, height=2.0, trunk_radius=0.08, points_per_m2=3000.0,
                  foliage_points=300)


def _t(a):
    a = np.array(a)  # a writable copy
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind == "i" else a)


def test_misc_equals_jax():
    rng = np.random.default_rng(0)
    lists = [[1, 2], [], [3], ["a", "b", "c"]]
    assert tmisc.flatten_list(lists) == jmisc.flatten_list(lists)
    for arr in (np.arange(5), np.ones((3, 2)), [1.0, 2.0]):
        np.testing.assert_array_equal(tmisc.at_least_2d(arr), jmisc.at_least_2d(arr))
    assert tmisc.at_least_2d(np.arange(5)).shape == (5, 1)
    for n in (1, 2, 7):
        np.testing.assert_array_equal(tmisc.unique_n_colours(n), jmisc.unique_n_colours(n))
    np.testing.assert_array_equal(tmisc.unique_n_colours(4, "viridis"),
                                  jmisc.unique_n_colours(4, "viridis"))
    pts = rng.normal(size=(6, 3))
    np.testing.assert_array_equal(tmisc.points_to_edges(pts), jmisc.points_to_edges(pts))
    xyz = rng.uniform(-1, 1, size=(500, 3))
    for vs in (0.1, 0.37):
        got = tmisc.voxel_downsample(xyz, vs)
        np.testing.assert_array_equal(got, jmisc.voxel_downsample(xyz, vs))
        assert len(got) < len(xyz)
    for d1, d2 in (({1: "a", 2: "b"}, {2: "c", "x": "d"}), ({}, {0: 1}),
                   ({1: 0, 2: 0, 3: 0}, {1: 5, 2: 6})):
        assert tmisc.merge_dictionaries(d1, d2) == jmisc.merge_dictionaries(d1, d2)


VECTOR_PAIRS = [
    ([1, 0, 0], [0, 1, 0]),
    ([0.3, -2.0, 0.5], [1.5, 0.2, -0.7]),
    ([0, 0, 2], [0, 0, 5]),          # parallel: the identity
    ([0, 1, 0], [0, -3, 0]),         # antiparallel: -I, a reflection
    ([1, 1, 1], [-1, -1, -1 + 1e-13]),
]


@pytest.mark.parametrize("a,b", VECTOR_PAIRS)
def test_rotation_matrix_from_vectors_equals_jax(a, b):
    got = tmaths.rotation_matrix_from_vectors(a, b)
    np.testing.assert_array_equal(got, jmaths.rotation_matrix_from_vectors(a, b))
    ua, ub = (np.asarray(v, float) / np.linalg.norm(v) for v in (a, b))
    if np.dot(ua, ub) < -1 + 1e-9:
        # kept from the JAX package: -I maps a onto b, but is no rotation
        np.testing.assert_array_equal(got, -np.eye(3))
        assert np.linalg.det(got) == -1.0
    else:
        np.testing.assert_allclose(got @ ua, ub, atol=1e-12)
        np.testing.assert_allclose(got @ got.T, np.eye(3), atol=1e-12)


def _skeleton(branch_cls, tree_cls):
    trunk = branch_cls(0, -1, np.stack([np.zeros(6), np.linspace(0, 2, 6), np.zeros(6)], 1),
                       np.full((6, 1), 0.1))
    limb = branch_cls(1, 0, np.stack([np.linspace(0, 1, 4), np.full(4, 1.5), np.zeros(4)], 1),
                      np.full((4, 1), 0.05))
    return tree_cls(0, {0: trunk, 1: limb})


def test_cloud_helpers_equal_jax():
    rng = np.random.default_rng(1)
    xyz = np.concatenate([rng.uniform(-0.3, 0.3, (300, 3)) + [0, 1, 0],
                          rng.uniform(-2, 2, (200, 3))]).astype(np.float32)
    cls = rng.integers(0, 3, (500, 1)).astype(np.float32)
    cloud, jcloud = Cloud(xyz=xyz, class_l=cls), JCloud(xyz=xyz, class_l=cls)
    for threshold in (1.1, 2.5):
        got = cloud.filter_by_skeleton(_skeleton(BranchSkeleton, TreeSkeleton), threshold,
                                       device="cpu")
        ref = jcloud.filter_by_skeleton(_skeleton(JBranch, JTree), threshold)
        np.testing.assert_array_equal(got.xyz, np.asarray(ref.xyz))
        np.testing.assert_array_equal(got.class_l, np.asarray(ref.class_l))
        assert 0 < len(got) < len(cloud)
    assert cloud.root_idx == jcloud.root_idx == int(np.argmin(xyz[:, 1]))
    assert cloud.number_classes == jcloud.number_classes == 3
    assert Cloud(xyz=xyz).number_classes == JCloud(xyz=xyz).number_classes == 1


def _random_graph(seed, n, e):
    """tests/test_torch_graph.py's graph: tie-free weights, no parallel edges."""
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, size=(e, 2)).astype(np.int32)
    weights = rng.uniform(0.1, 1.0, size=e).astype(np.float32)
    valid = rng.uniform(size=e) > 0.1
    _, first = np.unique(np.stack([edges.min(1), edges.max(1)], axis=1), axis=0,
                         return_index=True)
    dup = np.ones(e, bool)
    dup[first] = False
    return edges, weights, valid & ~dup


@pytest.mark.parametrize("seed,source", [(0, 3), (1, 0), (2, 211)])
def test_sssp_equals_jax(seed, source):
    n = 300
    edges, weights, valid = _random_graph(seed, n, 900)
    dist, pred = tgraph.sssp(_t(edges), _t(weights), _t(valid), source, n)
    rd, rp = jgraph.sssp(edges, weights, valid, source, n)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(rp))
    fin = np.isfinite(np.asarray(rd))
    np.testing.assert_array_equal(np.isfinite(dist.numpy()), fin)
    np.testing.assert_allclose(dist.numpy()[fin], np.asarray(rd)[fin], rtol=1e-6, atol=0)
    assert dist[source] == 0 and pred[source] == -1 and fin.sum() > n // 2
    # the single source is sssp_multi's
    mdist, mpred = tgraph.sssp_multi(_t(edges), _t(weights), _t(valid), _t([source]), n)
    assert torch.equal(mdist, dist) and torch.equal(mpred, pred)


@pytest.mark.parametrize("seed", [0, 1])
def test_select_path_points_equals_jax(seed):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 6, 800))
    pts = (np.stack([0.3 * np.sin(t), t, 0.3 * np.cos(t)], 1)
           + rng.normal(scale=0.02, size=(800, 3))).astype(np.float32)
    pvalid = rng.uniform(size=800) > 0.1
    path = pts[rng.choice(800, 120, replace=False)]
    radii = rng.uniform(0.01, 0.08, 120).astype(np.float32)
    path_valid = rng.uniform(size=120) > 0.2
    got = select_path_points(_t(pts), _t(pvalid), _t(path), _t(radii), _t(path_valid))
    ref = jpath.select_path_points(jnp.asarray(pts), jnp.asarray(pvalid), jnp.asarray(path),
                                   jnp.asarray(radii), jnp.asarray(path_valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.any() and not got.all() and not got[~_t(pvalid)].any()


@pytest.fixture(scope="module")
def tree_inputs():
    """The tracer's inputs on the small tree's branch points, from the
    port's skeleton stages on the CPU: (points, radii, preds, root
    distances, component mask), numpy."""
    from smart_tree_tpu_torch.skeleton.graph import nn_graph

    branch = generate_tree(**SMALL_TREE)[0].filter_by_class([0])
    pts = torch.from_numpy(branch.medial_pts.astype(np.float32))[::3].contiguous()
    radii = torch.from_numpy(branch.radius.astype(np.float32))[::3].clamp_min(0.02)
    n = pts.shape[0]
    graph = nn_graph(pts, radii, k=16, valid=torch.ones(n, dtype=torch.bool))
    labels = tgraph.connected_components(graph.edges, graph.valid, n)
    biggest = torch.bincount(labels).argmax()
    mask = labels == biggest
    root = int(torch.nonzero(mask)[pts[mask][:, 1].argmin()])
    _, preds = tgraph.sssp(graph.edges, graph.weights, graph.valid, root, n)
    hop = pts - pts[preds.clamp_min(0)]
    dist = tgraph.tree_distances(preds, (hop * hop).sum(1).sqrt(), n)
    return pts.numpy(), radii.numpy(), preds.numpy(), dist.numpy(), mask.numpy()


def _same_branches(got, ref, lost_vertex):
    assert list(got) == list(ref) and len(got) >= 3
    for k, x in got.items():
        y = ref[k]
        assert x._id == y._id == k and x.parent_id == y.parent_id
        if len(x) == len(y) + 1:   # vertex 0, dropped by the JAX tracer
            at = np.nonzero((x.xyz == lost_vertex).all(1))[0]
            assert len(at) == 1
            x = x.filter(np.arange(len(x)) != at[0])
        np.testing.assert_allclose(x.xyz, y.xyz, **GEOM_TOL)
        np.testing.assert_allclose(x.radii, y.radii, **GEOM_TOL)


def test_sample_tree_equals_jax(tree_inputs):
    pts, radii, preds, dist, mask = tree_inputs
    got = sample_tree(pts, radii, preds, dist, mask, device="cpu")
    ref = jpath.sample_tree(pts, radii, preds.astype(np.int32), dist, mask)
    _same_branches(got, ref, pts[0])
    # tensors in, the same branches
    again = sample_tree(*(_t(a) for a in tree_inputs), device="cpu",
                        host_pts=pts, host_radii=radii)
    assert list(again) == list(got)
    for k in got:
        np.testing.assert_array_equal(again[k].xyz, got[k].xyz)


def test_sample_tree_caps_and_device(tree_inputs, monkeypatch):
    pts, radii, preds, dist, mask = tree_inputs
    with pytest.raises(RuntimeError, match="sample_tree: .* truncated at hop_cap=4"):
        sample_tree(pts, radii, preds, dist, mask, hop_cap=4, device="cpu")
    with pytest.raises(RuntimeError, match="sample_tree: unallocated .* max_branches=2"):
        sample_tree(pts, radii, preds, dist, mask, max_branches=2, device="cpu")
    got = sample_tree(pts, radii, preds, dist, mask, max_branches=3, strict=False,
                      device="cpu")
    ref = jpath.sample_tree(pts, radii, preds.astype(np.int32), dist, mask, max_branches=3,
                            strict=False)
    assert list(got) == list(ref) and len(got) <= 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample_tree(pts, radii, preds, dist, mask)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Five small trees of two species as npz files."""
    d = tmp_path_factory.mktemp("corpus")
    for i, (species, seed) in enumerate([("apple", 1), ("apple", 2), ("pine", 3),
                                         ("pine", 4), ("pine", 5)]):
        cloud, skel = generate_tree(seed=seed, height=1.5, trunk_radius=0.05,
                                    points_per_m2=500.0, foliage_points=60)
        save_data_npz(str(d / f"{species}_{i}.npz"), skel, cloud)
    return d


def test_split_data_equals_jax(corpus, tmp_path, capsys):
    files = [p.name for p in sorted(corpus.glob("*.npz"))] * 3
    for seed in (0, 4):
        for kw in (dict(), dict(train=0.6, test=0.2)):
            assert split_data.random_sample(files, seed=seed, **kw) == \
                jsplit.random_sample(files, seed=seed, **kw)
            assert split_data.stratified_sample(files, seed=seed, **kw) == \
                jsplit.stratified_sample(files, seed=seed, **kw)
    for flags in ([], ["--stratified", "--seed", "3"]):
        assert split_data.main([str(corpus), "-o", str(tmp_path / "ours.json")] + flags) == 0
        assert jsplit.main([str(corpus), "-o", str(tmp_path / "ref.json")] + flags) == 0
        ours, ref = capsys.readouterr().out.splitlines()
        assert ours.replace("ours.json", "X") == ref.replace("ref.json", "X")
        assert json.loads((tmp_path / "ours.json").read_text()) == \
            json.loads((tmp_path / "ref.json").read_text())
    empty = tmp_path / "empty"
    empty.mkdir()
    assert split_data.main([str(empty)]) == jsplit.main([str(empty)]) == 1


def test_bench_and_vis_dataloader(corpus, tmp_path, capsys):
    split = {"train": sorted(p.name for p in corpus.glob("*.npz")), "validation": [],
             "test": []}
    (tmp_path / "split.json").write_text(json.dumps(split))
    stats = []
    argv = [str(corpus), "--json-path", str(tmp_path / "split.json"), "--batch-size", "2",
            "--voxel-size", "0.02"]
    assert bench_dataloader.main(argv + ["--epochs", "2"], stats=stats) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(stats) == len(lines) == 2 and lines[0].startswith("epoch 0: ")
    for s in stats:
        assert s["items"] == 5 and s["voxels"] > 0 and s["items_per_s"] > 0
    assert vis_dataloader.main([str(corpus), "--json-path", str(tmp_path / "split.json"),
                                "--out", str(tmp_path / "vis"), "--batches", "2",
                                "--batch-size", "2"]) == 0
    pngs = sorted(p.name for p in (tmp_path / "vis").glob("*.png"))
    assert pngs == ["batch000.png", "batch001.png"]
    assert all((tmp_path / "vis" / p).stat().st_size > 1000 for p in pngs)


def test_laz2ply_without_laspy(tmp_path, capsys):
    jlaz = importlib.import_module("smart_tree_tpu.scripts.laz2ply")
    argv = [str(tmp_path / "in.laz"), str(tmp_path / "out.ply")]
    assert laz2ply.main(argv) == 1
    ours = capsys.readouterr().out
    assert jlaz.main(argv) == 1
    assert ours == capsys.readouterr().out == "laz2ply requires laspy: pip install laspy[lazrs]\n"
