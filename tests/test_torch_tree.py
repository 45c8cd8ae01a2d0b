"""Port parity for the host-side skeleton types and output of
smart_tree_tpu_torch (branch / tube / tree containers with prune, repair and
smooth, point -> tube queries, tube mesh and lineset, PLY and npz writers)
against smart_tree_tpu on the same numpy inputs made from a seed.

These are numpy computations copied operation for operation, so arrays must
be equal; only `pts_to_nearest_tube` (torch against XLA einsums) is held at
rtol 1e-5 / atol 1e-6.
"""

import numpy as np
import pytest

from smart_tree_tpu.data import branch as jbranch
from smart_tree_tpu.data import file as jfile
from smart_tree_tpu.data import tree as jtree
from smart_tree_tpu.data import tube as jtube
from smart_tree_tpu.data.cloud import Cloud as JCloud
from smart_tree_tpu.data.synthetic import generate_tree as jgenerate
from smart_tree_tpu.utils import maths as jmaths
from smart_tree_tpu.utils import queries as jqueries
from smart_tree_tpu.viz import mesh as jmesh
from smart_tree_tpu_torch.data import branch as tbranch
from smart_tree_tpu_torch.data import file as tfile
from smart_tree_tpu_torch.data import tree as ttree
from smart_tree_tpu_torch.data import tube as ttube
from smart_tree_tpu_torch.data.synthetic import generate_tree
from smart_tree_tpu_torch.utils import maths as tmaths
from smart_tree_tpu_torch.utils import queries as tqueries
from smart_tree_tpu_torch.viz import mesh as tmesh

TREE = dict(seed=3, height=2.0, trunk_radius=0.08, points_per_m2=300.0)
QUERY_TOL = dict(rtol=1e-5, atol=1e-6)


def _pair(seed=3, noise=0.0):
    """The same synthetic skeleton as both packages' TreeSkeleton, with
    optional noise on the radii (so that smoothing and pruning bite)."""
    kw = dict(TREE, seed=seed)
    tsk, jsk = generate_tree(**kw)[1], jgenerate(**kw)[1]
    if noise:
        rng = np.random.default_rng(seed)
        for bid in tsk.branches:
            jitter = rng.normal(scale=noise, size=tsk.branches[bid].radii.shape)
            for sk in (tsk, jsk):
                b = sk.branches[bid]
                b.radii = np.abs(b.radii + jitter).astype(np.float32)
    return tsk, jsk


def _assert_trees_equal(t, j):
    assert list(t.branches) == list(j.branches)
    for bid, b in t.branches.items():
        jb = j.branches[bid]
        assert (b._id, b.parent_id) == (jb._id, jb.parent_id)
        np.testing.assert_array_equal(b.xyz, jb.xyz)
        np.testing.assert_array_equal(b.radii, jb.radii)
        assert b.xyz.dtype == jb.xyz.dtype and b.radii.dtype == jb.radii.dtype


def test_branch_properties_and_contract():
    tsk, jsk = _pair()
    for bid, b in tsk.branches.items():
        jb = jsk.branches[bid]
        assert (len(b), b.length, b.initial_radius, b.biggest_radius) == \
            (len(jb), jb.length, jb.initial_radius, jb.biggest_radius)
        mask = np.arange(len(b)) % 2 == 0
        np.testing.assert_array_equal(b.filter(mask).xyz, jb.filter(mask).xyz)
    for mod in (tbranch, jbranch):
        b = mod.BranchSkeleton(0, -1, np.zeros((4, 3)), np.ones(4))
        assert b.radii.shape == (4, 1) and b.xyz.dtype == np.float32
        with pytest.raises(TypeError):
            mod.BranchSkeleton(0, -1, np.zeros((4, 2)), np.ones(4))
        with pytest.raises(TypeError):
            mod.BranchSkeleton(0, -1, np.zeros((4, 3)), np.ones(5))


def test_tubes_collate_and_sample():
    tsk, jsk = _pair()
    tt, jt = tsk.to_tubes(), jsk.to_tubes()
    assert len(tt) == len(jt) == sum(len(b) - 1 for b in tsk.branches.values())
    tc, jc = ttube.collate_tubes(tt), jtube.collate_tubes(jt)
    assert len(tc) == len(jc)
    for f in ("a", "b", "r1", "r2"):
        np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f))
    for spacing in (0.01, 0.2):
        tp, tr = ttube.sample_tubes(tt, spacing)
        jp, jr = jtube.sample_tubes(jt, spacing)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tr, jr)


@pytest.mark.parametrize("min_radius,min_length", [(0.01, 0.02), (0.02, 0.3), (0.0, 1000.0)])
def test_prune_matches_jax(min_radius, min_length):
    tsk, jsk = _pair(noise=0.004)
    removed_t = tsk.prune(min_radius=min_radius, min_length=min_length)
    removed_j = jsk.prune(min_radius=min_radius, min_length=min_length)
    _assert_trees_equal(tsk, jsk)
    _assert_trees_equal(removed_t, removed_j)
    # the root always stays (even when it is also listed as removed)
    assert set(tsk.branches) | set(removed_t.branches) == set(_pair()[0].branches)
    assert 0 in tsk.branches


def test_repair_matches_jax():
    tsk, jsk = _pair()
    before = {bid: len(b) for bid, b in tsk.branches.items()}
    tsk.repair()
    jsk.repair()
    assert list(tsk.branches) == list(jsk.branches)
    grown = 0
    for bid, b in tsk.branches.items():
        jb = jsk.branches[bid]
        assert len(b) == len(jb) == before[bid] + (b.parent_id in before)
        grown += len(b) - before[bid]
        np.testing.assert_array_equal(b.xyz[1:], jb.xyz[1:])
        # the connection point comes from the tube query
        np.testing.assert_allclose(b.xyz[0], jb.xyz[0], **QUERY_TOL)
        np.testing.assert_array_equal(b.radii, jb.radii)
    assert grown == len(before) - 1


@pytest.mark.parametrize("kernel_size", [3, 7, 11])
def test_smooth_matches_jax(kernel_size):
    tsk, jsk = _pair(noise=0.004)
    tsk.smooth(kernel_size)
    jsk.smooth(kernel_size)
    _assert_trees_equal(tsk, jsk)


def test_disjoint_skeleton_quirks_match_jax(tmp_path):
    """prune touches skeletons[0] only; repair and smooth touch all."""
    parts = [_pair(seed=s, noise=0.004) for s in (3, 4)]
    td = ttree.DisjointTreeSkeleton([p[0] for p in parts])
    jd = jtree.DisjointTreeSkeleton([p[1] for p in parts])
    n_second = len(td.skeletons[1])
    for d in (td, jd):
        d.prune(min_radius=0.02, min_length=0.3)
        d.repair()
        d.smooth(kernel_size=7)
    assert len(td.skeletons[1]) == n_second and len(td.skeletons[0]) < len(_pair()[0])
    for t, j in zip(td.skeletons, jd.skeletons):
        assert list(t.branches) == list(j.branches)
        for bid, b in t.branches.items():
            np.testing.assert_allclose(b.xyz, j.branches[bid].xyz, **QUERY_TOL)
            np.testing.assert_array_equal(b.radii, j.branches[bid].radii)
        assert t.key_branch_with_biggest_radius == j.key_branch_with_biggest_radius
        assert t.max_branch_id == j.max_branch_id
        assert t.length == pytest.approx(j.length, rel=1e-6)
    ttree.DisjointTreeSkeleton([]).prune(0.1, 0.1)  # no skeleton: nothing to prune
    td.to_pickle(tmp_path / "sk.pkl")
    back = ttree.DisjointTreeSkeleton.from_pickle(tmp_path / "sk.pkl")
    _assert_trees_equal(back.skeletons[1], td.skeletons[1])


@pytest.mark.parametrize("n_pts", [1, 257])
def test_pts_to_nearest_tube_matches_jax(n_pts):
    tsk, jsk = _pair()
    tc, jc = ttube.collate_tubes(tsk.to_tubes()), jtube.collate_tubes(jsk.to_tubes())
    rng = np.random.default_rng(n_pts)
    pts = (tc.a[rng.integers(0, len(tc), n_pts)]
           + rng.normal(scale=0.05, size=(n_pts, 3))).astype(np.float32)
    v, idx, r = tqueries.pts_to_nearest_tube(pts, tc, device="cpu")
    jv, jidx, jr = jqueries.pts_to_nearest_tube(pts, jc)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_allclose(v, jv, **QUERY_TOL)
    np.testing.assert_allclose(r, jr, **QUERY_TOL)
    assert v.dtype == np.float32 and v.shape == (n_pts, 3)


def test_skeleton_to_points_matches_jax():
    tsk, jsk = _pair()
    tc, jc = ttube.collate_tubes(tsk.to_tubes()), jtube.collate_tubes(jsk.to_tubes())
    xyz = generate_tree(**TREE)[0].xyz[:700]
    got = tqueries.skeleton_to_points(xyz, tc, chunk_size=256, device="cpu")
    ref = jqueries.skeleton_to_points(xyz, jc, chunk_size=256)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, **QUERY_TOL)


def test_queries_default_to_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tc = ttube.collate_tubes(_pair()[0].to_tubes())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tqueries.pts_to_nearest_tube(np.zeros((1, 3), np.float32), tc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tqueries.skeleton_to_points(np.zeros((3, 3), np.float32), tc)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_polyline_frames_match_jax(seed):
    rng = np.random.default_rng(seed)
    pts = np.cumsum(rng.normal(size=(2 + 9 * seed, 3)), axis=0)
    for got, ref in zip(tmaths.polyline_frames(pts), jmaths.polyline_frames(pts)):
        np.testing.assert_array_equal(got, ref)
    straight = np.stack([np.zeros(5), np.arange(5.0), np.zeros(5)], 1)
    for got, ref in zip(tmaths.polyline_frames(straight), jmaths.polyline_frames(straight)):
        np.testing.assert_array_equal(got, ref)


def _disjoint_pair():
    parts = [_pair(seed=s) for s in (3, 4)]
    return (ttree.DisjointTreeSkeleton([p[0] for p in parts]),
            jtree.DisjointTreeSkeleton([p[1] for p in parts]))


def test_mesh_and_lineset_arrays_match_jax():
    td, jd = _disjoint_pair()
    for t, j in ((td, jd), (td.skeletons[0], jd.skeletons[0])):
        for got, ref in zip(tmesh.skeleton_tube_mesh(t), jmesh.skeleton_tube_mesh(j)):
            np.testing.assert_array_equal(got, ref)
        for got, ref in zip(tmesh.skeleton_lineset(t), jmesh.skeleton_lineset(j)):
            np.testing.assert_array_equal(got, ref)
    verts, tris, cols = tmesh.skeleton_tube_mesh(td)
    n_vertex = sum(len(b) for s in td.skeletons for b in s.branches.values())
    assert len(verts) == len(cols) == 10 * n_vertex and tris.max() == len(verts) - 1
    empty = ttree.DisjointTreeSkeleton([])
    assert tmesh.skeleton_tube_mesh(empty)[0].shape == (0, 3)
    assert tmesh.skeleton_lineset(empty)[1].shape == (0, 2)
    np.testing.assert_array_equal(tmesh.ring_strip_triangles(4, 6), jmesh.ring_strip_triangles(4, 6))


def test_ply_bytes_match_jax(tmp_path):
    td, jd = _disjoint_pair()
    cloud = generate_tree(**TREE)[0]
    verts, edges = tmesh.skeleton_lineset(td)
    mv, mt, mc = tmesh.skeleton_tube_mesh(td)
    jobs = [
        ("save_ply_lineset", (verts, edges)),
        ("save_ply_mesh", (mv, mt, mc)),
        ("save_ply_mesh", (mv, mt)),
        ("save_ply_cloud", (cloud.xyz, cloud.rgb)),
        ("save_ply_cloud", (cloud.xyz,)),
    ]
    for i, (fn, args) in enumerate(jobs):
        getattr(tfile, fn)(tmp_path / f"t{i}.ply", *args)
        getattr(jfile, fn)(tmp_path / f"j{i}.ply", *args)
        assert (tmp_path / f"t{i}.ply").read_bytes() == (tmp_path / f"j{i}.ply").read_bytes()
    assert tfile.ply_element_counts(tmp_path / "t0.ply") == {
        "vertex": len(verts), "edge": len(edges)}
    assert tfile.ply_element_counts(tmp_path / "t1.ply") == {"vertex": len(mv), "face": len(mt)}
    back = tfile.load_ply_cloud(tmp_path / "t3.ply")
    np.testing.assert_array_equal(back.xyz, cloud.xyz)
    (tmp_path / "bad.ply").write_bytes(b"plx\n")
    with pytest.raises(ValueError):
        tfile.ply_element_counts(tmp_path / "bad.ply")


def test_npz_round_trip_matches_jax(tmp_path):
    cloud, tsk = generate_tree(**TREE)
    jcloud, jsk = jgenerate(**TREE)
    tdata, jdata = tfile.package_data(tsk, cloud), jfile.package_data(jsk, jcloud)
    assert sorted(tdata) == sorted(jdata)
    for key in tdata:
        np.testing.assert_array_equal(tdata[key], jdata[key], err_msg=key)
    tfile.save_data_npz(tmp_path / "t.npz", tsk, cloud)
    for load in (tfile.load_data_npz, jfile.load_data_npz):  # each reads the port's file
        back_cloud, back_sk = load(tmp_path / "t.npz")
        np.testing.assert_array_equal(np.asarray(back_cloud.medial_vector), cloud.medial_vector)
        _assert_trees_equal(back_sk, tsk)
    tfile.save_skeleton(tmp_path / "sk.npz", tsk)
    _assert_trees_equal(tfile.load_skeleton(tmp_path / "sk.npz"), jfile.load_skeleton(tmp_path / "sk.npz"))
    no_skeleton = tmp_path / "c.npz"
    np.savez(no_skeleton, xyz=cloud.xyz, vector=cloud.medial_vector)
    c, sk = tfile.load_data_npz(no_skeleton)
    assert sk is None
    np.testing.assert_array_equal(c.medial_vector, cloud.medial_vector)
