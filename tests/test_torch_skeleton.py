"""Port parity for the skeleton stage of smart_tree_tpu_torch (outlier
filter, cell reduction, KNN graph, branch tracer, Skeletonizer.forward)
against smart_tree_tpu on the same numpy inputs made from a seed.

Masks, indices, branch counts and parent ids must be equal; branch xyz and
radii are held at rtol 1e-5 / atol 1e-6 (they are gathered medial points, so
they are in fact equal wherever the same vertices were chosen).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_tree_tpu.data.cloud import Cloud as JCloud
from smart_tree_tpu.skeleton.skeletonize import Skeletonizer as JSkeletonizer
from smart_tree_tpu_torch.data.cloud import Cloud
from smart_tree_tpu_torch.data.synthetic import generate_tree
from smart_tree_tpu_torch.skeleton.skeletonize import Skeletonizer
from tracer_trees import grown_tree

jfilter = importlib.import_module("smart_tree_tpu.skeleton.filter")
jquant = importlib.import_module("smart_tree_tpu.skeleton.quantize")
jgraph = importlib.import_module("smart_tree_tpu.skeleton.graph")
jpath = importlib.import_module("smart_tree_tpu.skeleton.path")
tfilter = importlib.import_module("smart_tree_tpu_torch.skeleton.filter")
tquant = importlib.import_module("smart_tree_tpu_torch.skeleton.quantize")
tgraph = importlib.import_module("smart_tree_tpu_torch.skeleton.graph")
tpath = importlib.import_module("smart_tree_tpu_torch.skeleton.path")

SMALL_TREE = dict(seed=3, height=2.0, trunk_radius=0.08, points_per_m2=3000.0,
                  foliage_points=300)
GEOM_TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    a = np.array(a)  # a writable copy
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind == "i" else a)


@pytest.fixture(scope="module")
def branch_cloud():
    return generate_tree(**SMALL_TREE)[0].filter_by_class([0])


def _jittered(cloud, seed=0, scale=0.004):
    """Medial points and radii with noise, so that the filter has outliers
    and cells hold several points."""
    rng = np.random.default_rng(seed)
    mp = (cloud.medial_pts + rng.normal(scale=scale, size=cloud.xyz.shape)).astype(np.float32)
    return mp, cloud.radius.astype(np.float32), cloud.xyz[:, 1].copy()


@pytest.mark.parametrize("min_radius", [None, 0.02])
@pytest.mark.parametrize("masked", [False, True], ids=["all-valid", "masked"])
def test_outlier_removal_matches_jax(branch_cloud, min_radius, masked):
    mp, r, _ = _jittered(branch_cloud)
    valid = np.random.default_rng(1).uniform(size=len(mp)) > 0.2 if masked else None
    got = tfilter.outlier_removal(_t(mp), _t(r), 8, None if valid is None else _t(valid),
                                  min_radius)
    ref = jfilter.outlier_removal(mp, r, 8, None if valid is None else jnp.asarray(valid),
                                  min_radius)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < int(got.sum()) < len(mp)


def test_outlier_removal_resolves_the_shell_exactly(monkeypatch):
    """With a margin so wide that every row is undecided, the exact KNN
    gives the brute-force answer."""
    rng = np.random.default_rng(2)
    p = rng.normal(scale=0.05, size=(600, 3)).astype(np.float32)
    r = rng.uniform(0.01, 0.05, 600).astype(np.float32)

    def undecided(src, dst, radii, src_valid=None, dst_valid=None, cap=8, **kw):
        n = src.shape[0]
        return torch.zeros(n, dtype=torch.int32), torch.full((n,), cap, dtype=torch.int32)

    monkeypatch.setattr(tfilter, "grid_radius_count", undecided)
    got = tfilter.outlier_removal(_t(p), _t(r), 8)
    d = np.sqrt(((p[:, None].astype(np.float64) - p[None]) ** 2).sum(-1))
    kth = np.sort(d, axis=1)[:, 7]
    sure = np.abs(kth - r) > 1e-6  # away from fp32 rounding of the boundary
    np.testing.assert_array_equal(got.numpy()[sure], (kth < r)[sure])


@pytest.mark.parametrize("cell", [0.01, 0.05])
def test_medial_reduce_matches_jax(branch_cloud, cell):
    mp, _, y = _jittered(branch_cloud)
    mp[:50] = -mp[:50]  # negative cells: floor, not truncation
    y[100:200] = y[100]  # equal heights fall back to the index
    keep = np.random.default_rng(3).uniform(size=len(mp)) > 0.3
    rep, n_unique = tquant.medial_reduce(_t(mp), _t(y), _t(keep), cell)
    jrep, jn = jquant.medial_reduce(jnp.asarray(mp), jnp.asarray(y), jnp.asarray(keep), cell)
    assert n_unique == jn == rep.shape[0]
    jrep = np.asarray(jrep)
    np.testing.assert_array_equal(rep.numpy(), jrep[:jn])  # the same order, no padding
    assert (jrep[jn:] == len(mp)).all()
    assert n_unique < keep.sum()


@pytest.mark.parametrize("drop_vertex_zero", [False, True])
def test_nn_graph_matches_jax(branch_cloud, drop_vertex_zero):
    mp, r, _ = _jittered(branch_cloud)
    mp, r = mp[:1500], np.maximum(r[:1500], 0.02)
    valid = np.random.default_rng(4).uniform(size=1500) > 0.1
    got = tgraph.nn_graph(_t(mp), _t(r), 16, _t(valid), drop_vertex_zero)
    ref = jgraph.nn_graph(jnp.asarray(mp), jnp.asarray(r), 16, jnp.asarray(valid),
                          drop_vertex_zero)
    np.testing.assert_array_equal(got.edges.numpy(), np.asarray(ref.edges))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    ok = got.valid.numpy()
    assert np.isinf(got.weights.numpy()[~ok]).all()
    # 1 ulp: the exact recomputation rounds its sum of squares differently
    np.testing.assert_allclose(got.weights.numpy()[ok], np.asarray(ref.weights)[ok], rtol=1e-6)


def test_nn_graph_refuses_what_needs_the_grid_knn(monkeypatch):
    """Nothing is refused any more: past the threshold the graph comes from
    the grid KNN (held against the brute force in test_torch_grid_knn.py)."""
    monkeypatch.setattr(tgraph, "GRID_KNN_THRESHOLD", 10)
    monkeypatch.setattr(tgraph, "knn", None)
    pts = torch.arange(33, dtype=torch.float32).reshape(11, 3) * 0.01
    got = tgraph.nn_graph(pts, torch.ones(11), k=4)
    assert got.valid.all() and (got.edges[::4, 1] == torch.arange(11)).all()


def _random_forest(seed, n):
    rng = np.random.default_rng(seed)
    preds = np.asarray([-1] + [rng.integers(max(0, v - 5), v) for v in range(1, n)], np.int32)
    preds[rng.uniform(size=n) < 0.02] = -1
    return preds, rng.uniform(size=n) < 0.1


@pytest.mark.parametrize("hop_cap", [7, 64, 300])
def test_trace_route_jump_matches_oracle_and_jax(hop_cap):
    n = 400
    preds, allocated = _random_forest(hop_cap, n)
    jumps = tpath.build_jump_tables(_t(preds), hop_cap)
    jjumps = jpath.build_jump_tables(jnp.asarray(preds), hop_cap)
    np.testing.assert_array_equal(jumps.numpy(), np.asarray(jjumps))
    for start in (n - 1, n - 2, 250, 37, 1, 0):
        for alloc in (allocated, np.zeros(n, bool)):
            if alloc[start]:
                continue
            path, length, term = tpath.trace_route_jump(jumps, start, _t(alloc), hop_cap)
            opath, olength, oterm = tpath.trace_route(_t(preds), start, _t(alloc), hop_cap)
            assert (length, term) == (olength, oterm) and torch.equal(path, opath)
            jp, jl, jt = jpath.trace_route_jump(jjumps, jnp.int32(start), jnp.asarray(alloc),
                                                hop_cap)
            assert (length, term) == (int(jl), int(jt))
            np.testing.assert_array_equal(path.numpy(), np.asarray(jp)[:length])
            assert (np.asarray(jp)[length:] == -1).all()


@pytest.mark.parametrize("length", [1, 3, 128, 129, 657])
def test_select_path_points_chunked_matches_jax(length):
    rng = np.random.default_rng(length)
    n, hop_cap = 1200, 1024
    t = np.sort(rng.uniform(0, 8, n))
    medial = (np.stack([0.3 * np.sin(t), t, 0.3 * np.cos(t)], 1)
              + rng.normal(scale=0.01, size=(n, 3))).astype(np.float32)
    radii = rng.uniform(0.01, 0.06, n).astype(np.float32)
    pvalid = rng.uniform(size=n) > 0.2
    path = rng.choice(n, length, replace=False).astype(np.int32)
    got = tpath._select_path_points_windowed(_t(medial), _t(pvalid), _t(medial), _t(radii),
                                             _t(path))
    padded = np.full(hop_cap, -1, np.int32)
    padded[:length] = path
    ref = jpath._select_path_points_chunked(
        jnp.asarray(medial), jnp.asarray(pvalid), jnp.asarray(medial), jnp.asarray(radii),
        jnp.asarray(padded), jnp.int32(length), hop_cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.any() and not got[~_t(pvalid)].any()


def _chain_tree(vertex_zero_on_path: bool):
    """A trunk of 40 vertices with a side branch; vertex ids are shuffled so
    that vertex 0 is a trunk vertex, or (not on any path) a far outlier."""
    trunk = np.stack([np.zeros(40), np.arange(40) * 0.05, np.zeros(40)], 1)
    side = np.stack([np.arange(1, 15) * 0.05, np.full(14, 1.0), np.zeros(14)], 1)
    pts = np.concatenate([trunk, side, [[9.0, 9.0, 9.0]]]).astype(np.float32)
    n = len(pts)
    preds = np.concatenate([[-1], np.arange(39), [20], 40 + np.arange(13), [-1]])
    order = np.arange(n)
    swap = 10 if vertex_zero_on_path else n - 1
    order[[0, swap]] = order[[swap, 0]]  # new id -> old id
    new_of_old = np.argsort(order)
    preds = np.where(preds[order] >= 0, new_of_old[np.maximum(preds[order], 0)], -1)
    pts = pts[order]
    step = np.linalg.norm(pts - pts[np.maximum(preds, 0)], axis=1) * (preds >= 0)
    return pts, np.full(n, 0.03, np.float32), preds.astype(np.int32), step.astype(np.float32)


@pytest.mark.parametrize("vertex_zero_on_path", [True, False])
def test_tracer_writes_only_real_path_vertices(vertex_zero_on_path):
    """The JAX tracer writes its padded path through clamped indices, where
    every pad slot aliases vertex 0. The port writes path[:length] only.
    When vertex 0 is on no path both agree everywhere; when it is on a path
    the port must record it there (the JAX result on the CPU loses exactly
    that vertex to its pad slots and is equal everywhere else)."""
    from smart_tree_tpu.graph import tree_distances as jtree_distances
    from smart_tree_tpu_torch.graph import tree_distances

    pts, radii, preds, step = _chain_tree(vertex_zero_on_path)
    n = len(pts)
    rd = tree_distances(_t(preds), _t(step), n)
    np.testing.assert_allclose(rd.numpy(), np.asarray(
        jtree_distances(jnp.asarray(preds), jnp.asarray(step), n)), rtol=1e-6)
    mask = np.ones(n, bool)
    got = tpath.sample_tree_device(_t(pts), _t(radii), _t(preds), rd, _t(mask), 64, 16)
    ref = jpath.sample_tree_device(jnp.asarray(pts), jnp.asarray(radii), jnp.asarray(preds),
                                   jnp.asarray(rd.numpy()), jnp.asarray(mask), 64, 16)
    assert got.branch_count == int(ref.branch_count) == 2
    assert got.hop_cap_hits == int(ref.hop_cap_hits) == 0 and not got.branch_cap_hit
    np.testing.assert_array_equal(got.branch_parents, np.asarray(ref.branch_parents)[:2])
    np.testing.assert_array_equal(got.branch_ids.numpy(), np.asarray(ref.branch_ids))
    rest = slice(1, None)
    for name in ("path_branch", "path_pos"):
        np.testing.assert_array_equal(getattr(got, name).numpy()[rest],
                                      np.asarray(getattr(ref, name))[rest])
    if vertex_zero_on_path:
        assert got.path_branch[0] == 0 and got.path_pos[0] == 10
    else:
        assert got.path_branch[0] == -1 == int(ref.path_branch[0])
    runs = dict(tpath._branch_vertex_runs(got.path_branch.numpy(), got.path_pos.numpy(), 2))
    assert len(runs[0]) == 40 and len(runs[1]) == 14  # the whole trunk, the whole side


@pytest.mark.parametrize("hop_cap,max_branches", [(512, 4096), (512, 3), (40, 4096)],
                         ids=["all-branches", "branch-cap", "hop-cap"])
def test_tracer_rounds_of_one_and_of_many_agree(monkeypatch, hop_cap, max_branches):
    """Iterations queued past the end of the trace (no work, or the branch
    cap) change nothing: rounds of 1 and of 32 give the same result, with a
    fetch a round."""
    inputs = [_t(a) for a in grown_tree(5, 600, 150, dropped=0.02)]
    got = {}
    for rnd in (1, 32):
        monkeypatch.setattr(tpath, "ROUND", rnd)
        stats = {}
        got[rnd] = tpath.sample_tree_device(*inputs, hop_cap, max_branches, stats), stats
    (a, sa), (b, sb) = got[1], got[32]
    for name in ("path_branch", "path_pos", "branch_ids"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    np.testing.assert_array_equal(a.branch_parents, b.branch_parents)
    assert (a.branch_count, a.hop_cap_hits, a.branch_cap_hit) == (
        b.branch_count, b.hop_cap_hits, b.branch_cap_hit)
    iters = sa["tracer_iterations"]
    assert sb["tracer_iterations"] == iters
    assert sa["tracer_fetches"] == iters + 1 and sb["tracer_fetches"] == iters // 32 + 1
    if max_branches == 3:
        assert a.branch_count == 3 and a.branch_cap_hit
    else:
        assert iters > 32 and not a.branch_cap_hit
        assert (a.hop_cap_hits > 0) == (hop_cap == 40)


def _assert_same_skeletons(got, ref, lost_vertex=None):
    """Same skeletons, branches, parents and geometry. `lost_vertex`: the
    medial point of vertex 0, which the JAX tracer drops from its path when
    it lies on one (see test_tracer_writes_only_real_path_vertices)."""
    assert len(got.skeletons) == len(ref.skeletons)
    for a, b in zip(got.skeletons, ref.skeletons):
        assert a._id == b._id and list(a.branches) == list(b.branches)
        for k, x in a.branches.items():
            y = b.branches[k]
            assert x.parent_id == y.parent_id
            if lost_vertex is not None and len(x) == len(y) + 1:
                at = np.nonzero((x.xyz == lost_vertex).all(1))[0]
                assert len(at) == 1
                x = x.filter(np.arange(len(x)) != at[0])
            np.testing.assert_allclose(x.xyz, y.xyz, **GEOM_TOL)
            np.testing.assert_allclose(x.radii, y.radii, **GEOM_TOL)


def _jcloud(c):
    return JCloud(xyz=c.xyz, rgb=c.rgb, medial_vector=c.medial_vector, class_l=c.class_l)


@pytest.mark.parametrize("medial_quantize", [0.01, None], ids=["quantize-1cm", "unreduced"])
def test_skeletonizer_forward_matches_jax(branch_cloud, medial_quantize):
    stats = {}
    got = Skeletonizer(device="cpu", medial_quantize=medial_quantize).forward(
        branch_cloud, stats=stats)
    ref = JSkeletonizer(medial_quantize=medial_quantize).forward(_jcloud(branch_cloud))
    assert len(got.skeletons) >= 1 and len(got.skeletons[0].branches) >= 5
    lost = None if medial_quantize else branch_cloud.medial_pts[0]
    _assert_same_skeletons(got, ref, lost)
    assert stats["medial_points"] == len(branch_cloud) and stats["branches"] >= 5
    for key in ("outlier_filter_s", "reduce_s", "knn_graph_s", "table_shortcuts_s",
                "components_s", "sssp_s", "tracer_s", "sssp_rounds", "graph_vertices"):
        assert key in stats


def test_skeletonizer_separates_two_trees():
    c1 = generate_tree(seed=10, height=2.0, points_per_m2=2500.0, max_depth=1)[0]
    c2 = generate_tree(seed=11, height=2.0, points_per_m2=2500.0, max_depth=1)[0]
    cloud = Cloud(xyz=np.concatenate([c1.xyz, c2.xyz + np.float32([5.0, 0, 0])]),
                  medial_vector=np.concatenate([c1.medial_vector, c2.medial_vector]))
    assert 2000 < len(cloud) < 12000
    got = Skeletonizer(device="cpu").forward(cloud)
    ref = JSkeletonizer().forward(JCloud(xyz=cloud.xyz, medial_vector=cloud.medial_vector))
    assert len(got.skeletons) >= 2
    _assert_same_skeletons(got, ref)
    sides = set()
    for s in got.skeletons:
        xs = np.concatenate([b.xyz for b in s.branches.values()])[:, 0]
        assert xs.max() - xs.min() < 4.0, "a skeleton spans both trees"
        sides.add(bool(xs.mean() > 2.5))
    assert sides == {False, True}


def test_skeletonizer_without_shortcuts_matches_jax(branch_cloud):
    got = Skeletonizer(device="cpu", sssp_shortcuts=False).forward(branch_cloud)
    ref = JSkeletonizer(sssp_shortcuts=False).forward(_jcloud(branch_cloud))
    _assert_same_skeletons(got, ref)


def test_strict_caps_raise(branch_cloud):
    with pytest.raises(RuntimeError, match="truncated at hop_cap=8"):
        Skeletonizer(device="cpu", hop_cap=8).forward(branch_cloud)
    with pytest.raises(RuntimeError, match="max_branches=2"):
        Skeletonizer(device="cpu", max_branches=2).forward(branch_cloud)
    with pytest.raises(RuntimeError, match="hop_cap=8"):
        JSkeletonizer(hop_cap=8).forward(_jcloud(branch_cloud))
    loose = Skeletonizer(device="cpu", max_branches=2, strict=False).forward(branch_cloud)
    assert sum(len(s.branches) for s in loose.skeletons) == 2


def test_empty_and_tiny_clouds():
    empty = Cloud(xyz=np.zeros((0, 3), np.float32), medial_vector=np.zeros((0, 3), np.float32))
    assert Skeletonizer(device="cpu").forward(empty).skeletons == []
    few = Cloud(xyz=np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32),
                medial_vector=np.full((5, 3), 0.01, np.float32))
    assert Skeletonizer(device="cpu").forward(few).skeletons == []
