"""The port's KNN family held against exact distances: a float64 numpy
recompute of the pairs each function returns, from the fp32 inputs as given.

Where the bound comes from. Every distance the port returns is recomputed
elementwise in fp32 from the coordinates of the selected pair: the brute force
(`knn`, `nn`, the tracer's k = 1 `_knn_impl`) on coordinates centred on the
destination box, the grid KNN on the coordinates as given (and so without
the absolute term below). The recompute is
three differences, three products and two sums in fp32, then a square root:
each rounds by at most half an ulp of its result, which keeps the root within
2 fp32 ulps of the exact distance of the fp32 coordinates it was given, rtol
2.4e-7 (2 * 2^-23). Centring rounds each coordinate by up to half an ulp of
its magnitude, which moves a distance by up to about an ulp of the largest
coordinate: atol 2 * ulp(max |coordinate|) over the valid points. At 50 m from
the origin that is 7.6e-6 m.

Indices are held equal to the float64 ranking (nearest first, equal
distances in index order) on every row whose ranking has no near tie: no two
of its first k + 1 distances, and none of them and the radius, closer than
twice the bound (each side of a gap may move by the bound). Exact
duplicates tie exactly in fp32 too, and `knn` orders them by index, so for it
they are no tie; the grid KNN gives them in candidate order, so for it they
are.

Clouds sit at the origin and 20 and 50 m from it, the way the trees of a
forest scan do. The functions run on the CPU; no JAX here.
"""

import importlib

import numpy as np
import pytest
import torch

tknn = importlib.import_module("smart_tree_tpu_torch.neighbors.knn")
tgrid = importlib.import_module("smart_tree_tpu_torch.neighbors.grid")
tpath = importlib.import_module("smart_tree_tpu_torch.skeleton.path")

RTOL = 2.4e-7  # 2 fp32 ulps
CENTRES = {"origin": (0.0, 0.0, 0.0), "20m": (12.0, -16.0, 0.0), "50m": (30.0, 0.0, 40.0)}


def _cloud(seed, n, centre, scale=1.0, dup=False):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(n, 3)) * scale
    if dup:  # every point of the second half coincides with one of the first
        p[n // 2:] = p[rng.integers(0, n // 2, n - n // 2)]
    return (p + np.asarray(centre)).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _atol(*clouds):
    """2 ulps of the largest coordinate magnitude among the valid points."""
    return 2.0 * float(np.spacing(np.float32(max(np.abs(c).max() for c in clouds if c.size))))


def _exact(src, dst, idx):
    """float64 distances of the pairs (row, idx), inf where idx is -1."""
    diff = src.astype(np.float64)[:, None, :] - dst.astype(np.float64)[np.maximum(idx, 0)]
    return np.where(idx >= 0, np.sqrt((diff * diff).sum(-1)), np.inf)


def _all_pairs(src, dst):
    """[N, M] float64 distances."""
    diff = src.astype(np.float64)[:, None, :] - dst.astype(np.float64)[None]
    return np.sqrt((diff * diff).sum(-1))


def _ranking(src, dst, k, r, sv, dv, atol, dup_ties):
    """(indices, clean rows) of the float64 ranking: the k nearest valid dst
    within r per valid src, -1 past them; a row is clean where no gap among
    its first k + 1 distances, and none of them and r, is within twice the
    bound."""
    d = _all_pairs(src, dst)
    d[:, ~dv] = np.inf
    # the k + 8 nearest (room for a tie across the cut), then by distance
    # and index: equal distances by index
    part = np.argpartition(d, min(k + 8, len(dst) - 1), axis=1)[:, : k + 9]
    dp = np.take_along_axis(d, part, axis=1)
    order = np.take_along_axis(part, np.lexsort((part, dp), axis=1), axis=1)[:, : k + 1]
    dk = np.take_along_axis(d, order, axis=1)
    slack = 2 * (RTOL * dk + atol)
    gap = np.diff(dk, axis=1)
    near = (gap <= slack[:, 1:]) & np.isfinite(dk[:, 1:])
    if not dup_ties:
        same = (dst[order[:, 1:]] == dst[order[:, :-1]]).all(axis=2)
        near &= ~(same & (gap == 0))
    near_r = (np.abs(dk - r) <= slack).any(axis=1)
    want = np.where((dk[:, :k] <= r) & sv[:, None], order[:, :k], -1)
    return want, ~near.any(axis=1) & ~near_r


def _check_exact(got, src, dst, k, r, sv=None, dv=None, dup_ties=False, centred=True):
    """Distances within the bound of the float64 recompute of the pairs
    returned; indices equal to the float64 ranking on clean rows. A function
    that does not centre (`centred=False`) gets no absolute term."""
    sv = np.ones(len(src), bool) if sv is None else sv
    dv = np.ones(len(dst), bool) if dv is None else dv
    d, i = (x.numpy() for x in got)
    assert d.dtype == np.float32 and i.dtype == np.int64 and d.shape == i.shape == (len(src), k)
    hit = i >= 0
    assert np.isinf(d[~hit]).all() and not hit[~sv].any() and dv[i[hit]].all()
    atol = _atol(src[sv], dst[dv]) if centred else 0.0
    exact = _exact(src, dst, i)
    err = np.abs(d[hit] - exact[hit])
    bound = RTOL * exact[hit] + atol
    assert (err <= bound).all(), (
        f"{int((err > bound).sum())} of {int(hit.sum())} distances off the float64 recompute, "
        f"worst {float((err / bound).max()):.3g} x the bound")
    assert (exact[hit] <= r + RTOL * r + atol).all()
    want, clean = _ranking(src, dst, k, r, sv, dv, atol, dup_ties)
    assert clean.sum() >= 0.5 * len(src), f"only {int(clean.sum())} rows without near ties"
    np.testing.assert_array_equal(i[clean], want[clean])


@pytest.mark.parametrize("centre", CENTRES, ids=list(CENTRES))
@pytest.mark.parametrize("masked", [False, True], ids=["all-valid", "masked"])
@pytest.mark.parametrize("dup", [False, True], ids=["distinct", "duplicated"])
@pytest.mark.parametrize("k,r", [(16, 0.6), (1, 0.2), (8, 1e9)])
def test_knn_distances_are_exact(k, r, dup, masked, centre):
    src = _cloud(1, 400, CENTRES[centre], dup=dup)
    dst = _cloud(2, 500, CENTRES[centre], dup=dup)
    sv = dv = None
    if masked:
        rng = np.random.default_rng(3)
        sv, dv = rng.uniform(size=400) > 0.2, rng.uniform(size=500) > 0.3
        dst[~dv] = 1e6  # far padding must not shift the centre
    got = tknn.knn(_t(src), _t(dst), k, r, _t(sv), _t(dv), device="cpu")
    _check_exact(got, src, dst, k, r, sv, dv, dup_ties=False)


@pytest.mark.parametrize("centre", CENTRES, ids=list(CENTRES))
def test_knn_self_query_is_exact(centre):
    """A tree-like spread (0.3 m) queried against itself: the query comes
    first at exactly 0."""
    p = _cloud(5, 500, CENTRES[centre], scale=0.3)
    d, i = tknn.knn(_t(p), _t(p), 16, 0.1, device="cpu")
    _check_exact((d, i), p, p, 16, 0.1)
    assert (i[:, 0] == torch.arange(500)).all() and (d[:, 0] == 0).all()


@pytest.mark.parametrize("centre", CENTRES, ids=list(CENTRES))
def test_nn_distances_are_exact(centre):
    src, dst = _cloud(7, 300, CENTRES[centre]), _cloud(8, 500, CENTRES[centre])
    d, i = tknn.nn(_t(src), _t(dst), 0.5, device="cpu")
    assert d.shape == i.shape == (300,)
    _check_exact((d[:, None], i[:, None]), src, dst, 1, 0.5)


@pytest.mark.parametrize("centre", CENTRES, ids=list(CENTRES))
@pytest.mark.parametrize("masked", [False, True], ids=["all-valid", "masked"])
@pytest.mark.parametrize("k,r", [(16, 0.5), (1, 0.25)])
def test_grid_knn_distances_are_exact(k, r, masked, centre):
    src, dst = _cloud(1, 400, CENTRES[centre]), _cloud(2, 500, CENTRES[centre])
    sv = dv = None
    if masked:
        rng = np.random.default_rng(3)
        sv, dv = rng.uniform(size=400) > 0.2, rng.uniform(size=500) > 0.3
        dst[~dv] = 1e6  # far padding must not stretch the grid
    got = tgrid.grid_knn(_t(src), _t(dst), k, r, _t(sv), _t(dv), device="cpu")
    _check_exact(got, src, dst, k, r, sv, dv, dup_ties=True, centred=False)


@pytest.mark.parametrize("centre", CENTRES, ids=list(CENTRES))
@pytest.mark.parametrize("masked", [False, True], ids=["all-valid", "masked"])
def test_radius_count_is_exact_off_the_shell(masked, centre):
    """certain <= true <= possible against float64 counts, and certain ==
    possible == true on every row with no pair inside the margin shell."""
    p = _cloud(21, 1000, CENTRES[centre])
    rng = np.random.default_rng(22)
    radii = rng.uniform(0.05, 0.4, 1000).astype(np.float32)
    valid = rng.uniform(size=1000) > 0.25 if masked else np.ones(1000, bool)
    cap = 8
    lo, hi = (x.numpy() for x in tknn.radius_count(_t(p), _t(p), _t(radii), _t(valid),
                                                     _t(valid), cap=cap, device="cpu"))
    d2 = _all_pairs(p, p) ** 2
    d2[:, ~valid] = np.inf
    r2 = radii.astype(np.float64)[:, None] ** 2
    true = np.where(valid, np.minimum((d2 < r2).sum(1), cap), 0)
    assert (lo <= true).all() and (true <= hi).all()
    # the margin the port allows itself (radius_count's delta2), from the
    # centred half extent of the valid points
    pv = p[valid].astype(np.float64)
    half = (pv.max(0) - pv.min(0)) / 2
    shell = (np.abs(d2 - r2) <= 2 * max(32 * 1.2e-7 * (half ** 2).sum(), 1e-7)).any(axis=1)
    assert (~shell).sum() >= 0.5 * len(p)
    np.testing.assert_array_equal(lo[~shell], true[~shell])
    np.testing.assert_array_equal(hi[~shell], true[~shell])


def _path_case(centre, n_path=300, n_pts=2000):
    """A bent path of vertices with radii, and points scattered around it."""
    rng = np.random.default_rng(41)
    s = np.linspace(0.0, 3.0, n_path)
    path = np.stack([0.2 * np.sin(2 * s), 0.1 * np.cos(3 * s), s], axis=1) + np.asarray(centre)
    radii = rng.uniform(0.02, 0.08, n_path).astype(np.float32)
    pts = path[rng.integers(0, n_path, n_pts)] + rng.normal(scale=0.05, size=(n_pts, 3))
    return path.astype(np.float32), radii, pts.astype(np.float32)


@pytest.mark.parametrize("centre", CENTRES, ids=list(CENTRES))
def test_tracer_nearest_vertex_is_exact(centre):
    """The tracer's k = 1 query (`_knn_impl` as `select_path_points` calls
    it), and the point selection both tracer forms make from it."""
    path, radii, pts = _path_case(CENTRES[centre])
    rng = np.random.default_rng(42)
    pv = rng.uniform(size=len(pts)) > 0.1
    path_valid = rng.uniform(size=len(path)) > 0.05
    r_max = float(radii[path_valid].max())
    got = tknn._knn_impl(_t(pts), _t(path), _t(pv), _t(path_valid),
                         torch.tensor(r_max, dtype=torch.float32) ** 2, 1)
    _check_exact(got, pts, path, 1, r_max, pv, path_valid)

    # selection: the nearest valid vertex lies within its own radius
    d = _all_pairs(pts, path)
    d[:, ~path_valid] = np.inf
    two = np.sort(d, axis=1)[:, :2]
    near = np.argmin(d, axis=1)
    want = pv & (two[:, 0] < radii[near])
    atol = _atol(pts[pv], path[path_valid])
    slack = 2 * (RTOL * two + atol)
    clean = (two[:, 1] - two[:, 0] > slack[:, 1]) & (np.abs(two[:, 0] - radii[near]) > slack[:, 0])
    assert clean.mean() > 0.9
    sel = tpath.select_path_points(_t(pts), _t(pv), _t(path), _t(radii), _t(path_valid)).numpy()
    np.testing.assert_array_equal(sel[clean], want[clean])
    # the windowed form on the valid vertices only, at several windows
    order = np.flatnonzero(path_valid)
    swept = tpath._select_path_points_chunked(_t(pts), _t(pv), _t(path), _t(radii),
                                              torch.from_numpy(order)).numpy()
    np.testing.assert_array_equal(swept[clean], want[clean])


# A fresh interpreter that imports the port and touches no torch math, then
# forks children one at a time; each child's first torch math is one call of
# one of the port's entry points, held against the float64 recompute. It
# prints how many children of each entry point missed the bound.
_FRESH_PROCESS_CHILDREN = r"""
import json, os, sys
import numpy as np
import torch
from smart_tree_tpu_torch.neighbors import grid_knn, knn
from smart_tree_tpu_torch.neighbors.knn import _knn_impl

children = json.loads(sys.argv[1])  # per entry point
rng = np.random.default_rng(1)
src = rng.normal(size=(3000, 3)).astype(np.float32)
dst = rng.normal(size=(900, 3)).astype(np.float32)
atol = 2 * float(np.spacing(np.float32(max(np.abs(src).max(), np.abs(dst).max()))))
s, d = torch.from_numpy(src), torch.from_numpy(dst)
ones = torch.ones(len(src), dtype=torch.bool)
ENTRIES = {
    "knn": lambda: knn(s[:700], d, 16, 0.6, device="cpu"),
    "grid_knn": lambda: grid_knn(s[:700], d, 16, 0.6, device="cpu"),
    # the tracer's k = 1 query, over as many points as makes its root parallel
    "tracer": lambda: _knn_impl(s, d, ones, ones[: len(dst)], torch.tensor(0.36), 1),
}


def exact(entry):
    dist, idx = (t.numpy() for t in ENTRIES[entry]())
    hit = idx >= 0
    diff = src[: len(idx)].astype(np.float64)[:, None] - dst.astype(np.float64)[np.maximum(idx, 0)]
    want = np.sqrt((diff * diff).sum(-1))
    return hit.any() and (np.abs(dist[hit] - want[hit]) <= 2.4e-7 * want[hit] + atol).all()


missed = dict.fromkeys(children, 0)
for entry, count in children.items():
    for _ in range(count):
        pid = os.fork()
        if pid == 0:
            os._exit(0 if exact(entry) else 1)
        missed[entry] += os.waitstatus_to_exitcode(os.waitpid(pid, 0)[1]) != 0
print(json.dumps(missed))
"""


def test_first_distances_of_a_process_are_exact():
    """The first torch root of a process runs in chunks on several threads,
    and MKL's vector math picks its code during that call: a thread that
    comes in early computes its chunk with a 12-bit estimate. Children
    forked from a clean interpreter each make that first call through
    `knn`, `grid_knn` or the tracer's `_knn_impl`, which settle the library
    on one thread first (`device.settle_cpu_math`); before they did, a
    quarter to a third of such children got `knn` distances up to 3e-4 off,
    so twelve of them all passing is a 3 % chance without the repair."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1]))
    children = {"knn": 12, "grid_knn": 3, "tracer": 3}
    run = subprocess.run([sys.executable, "-c", _FRESH_PROCESS_CHILDREN, json.dumps(children)],
                         env=env, capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    missed = json.loads(run.stdout.splitlines()[-1])
    assert not any(missed.values()), (
        f"fresh processes off the float64 recompute: {missed} of {children}")
