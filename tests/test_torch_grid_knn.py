"""Port parity for smart_tree_tpu_torch.neighbors.grid.grid_knn against
smart_tree_tpu.neighbors.grid.grid_knn and against the port's brute-force
`knn`, on numpy inputs made from a seed.

Against the JAX grid KNN distances are held at rtol 1e-6 (XLA and torch round
the three-term sum of squares differently in the last bit). The brute force
subtracts the box centre from both points first, which costs it up to an ulp
of the coordinates per point: against it an absolute term of 4 ulps of the
largest coordinate is added. Indices are held equal on rows whose
distances have no ties: equal distances come out in candidate order from the
grid and in index order from the brute force.
"""

import importlib

import numpy as np
import pytest
import torch

jgrid = importlib.import_module("smart_tree_tpu.neighbors.grid")
tgrid = importlib.import_module("smart_tree_tpu_torch.neighbors.grid")
tknn_mod = importlib.import_module("smart_tree_tpu_torch.neighbors.knn")
tgraph = importlib.import_module("smart_tree_tpu_torch.skeleton.graph")


def _cloud(seed, n, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(n, 3)) * scale).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _check(got, ref, coord=0.0):
    """Same hits, distances within tolerance, indices equal on rows whose
    finite distances are all different. `coord` is the largest coordinate
    magnitude where the reference is the centred brute force."""
    td, ti = (np.asarray(x) for x in got)
    rd, ri = (np.asarray(x) for x in ref)
    hit = ri >= 0
    np.testing.assert_array_equal(ti >= 0, hit)
    assert np.isinf(td[~hit]).all()
    np.testing.assert_allclose(td[hit], rd[hit], rtol=1e-6, atol=4 * 1.2e-7 * coord)
    near = np.isclose(rd[:, 1:], rd[:, :-1], rtol=1e-5, atol=8 * 1.2e-7 * coord) & hit[:, 1:]
    clean = ~near.any(axis=1)
    assert clean.sum() > 0.5 * len(clean)
    np.testing.assert_array_equal(ti[clean], ri[clean])


@pytest.mark.parametrize("masked", [False, True], ids=["all-valid", "masked"])
@pytest.mark.parametrize("k,r", [(16, 0.5), (1, 0.25), (8, 1.0)])
def test_grid_knn_matches_jax_and_brute_force(k, r, masked):
    src, dst = _cloud(1, 600), _cloud(2, 800)
    sv = dv = None
    if masked:
        rng = np.random.default_rng(3)
        sv, dv = rng.uniform(size=600) > 0.2, rng.uniform(size=800) > 0.3
        dst[~dv] = 1e6  # far padding must not stretch the grid
    got = tgrid.grid_knn(_t(src), _t(dst), k, r, _t(sv), _t(dv))
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int64
    _check(got, jgrid.grid_knn(src, dst, k, r, sv, dv))
    _check(got, tknn_mod.knn(_t(src), _t(dst), k, r, _t(sv), _t(dv)), coord=np.abs(src).max())
    if masked:
        assert (got[1][~_t(sv)] == -1).all()
        assert not np.isin(got[1].numpy(), np.flatnonzero(~dv)).any()


def test_grid_knn_self_query_in_chunks(monkeypatch):
    """Several query chunks give what one chunk gives; the query itself
    comes first at distance 0."""
    p = _cloud(5, 900, scale=0.3)
    one = tgrid.grid_knn(_t(p), _t(p), 16, 0.1)
    monkeypatch.setattr(tgrid, "TILE_PAIRS", 9 * 3 * 64 * 100)  # 100 queries per chunk
    many = tgrid.grid_knn(_t(p), _t(p), 16, 0.1)
    assert torch.equal(one[0], many[0]) and torch.equal(one[1], many[1])
    assert (one[1][:, 0] == torch.arange(900)).all() and (one[0][:, 0] == 0).all()
    _check(one, jgrid.grid_knn(p, p, 16, 0.1))
    _check(one, tknn_mod.knn(_t(p), _t(p), 16, 0.1), coord=np.abs(p).max())


def test_grid_knn_reruns_when_a_cell_is_over_cell_cap(monkeypatch):
    p = _cloud(7, 500, scale=0.05)  # nearly everything in a few cells of edge 0.2
    calls = []
    impl = tgrid._grid_knn_impl

    def spy(*args):
        calls.append(args[-1])
        return impl(*args)

    monkeypatch.setattr(tgrid, "_grid_knn_impl", spy)
    got = tgrid.grid_knn(_t(p), _t(p), 8, 0.2, cell_cap=4)
    assert len(calls) == 2 and calls[0] == 4
    assert calls[1] >= 64 and calls[1] & (calls[1] - 1) == 0  # next power of two
    _check(got, tknn_mod.knn(_t(p), _t(p), 8, 0.2), coord=np.abs(p).max())
    _check(got, jgrid.grid_knn(p, p, 8, 0.2, cell_cap=4))


def test_grid_knn_strict_raises_and_lenient_returns():
    p = _t(_cloud(7, 500, scale=0.05))
    with pytest.raises(RuntimeError, match="cell_cap=4"):
        tgrid.grid_knn(p, p, 8, 0.2, cell_cap=4, auto_grow=False)
    d, i = tgrid.grid_knn(p, p, 8, 0.2, cell_cap=4, auto_grow=False, strict=False)
    assert d.shape == i.shape == (500, 8)


def test_grid_knn_refuses_a_grid_past_32_key_bits():
    p = _cloud(8, 50, scale=100.0)
    with pytest.raises(ValueError, match="key bits > 32"):
        tgrid.grid_knn(_t(p), _t(p), 4, 1e-3)
    with pytest.raises(ValueError, match="key bits > 32"):
        jgrid.grid_knn(p, p, 4, 1e-3)


def test_grid_knn_source_outside_the_dst_box_and_empty_dst():
    dst = _cloud(9, 300, scale=0.2)
    src = np.concatenate([dst[:20] + np.float32(0.6), dst[[dst[:, 0].argmax()]] + np.float32([0.05, 0, 0]),
                          np.full((1, 3), 50.0, np.float32)])
    got = tgrid.grid_knn(_t(src), _t(dst), 4, 0.3)
    _check(got, tknn_mod.knn(_t(src), _t(dst), 4, 0.3), coord=np.abs(src).max())
    assert (got[1][-1] == -1).all() and (got[1][-2] >= 0).any()
    d, i = tgrid.grid_knn(_t(src), torch.zeros((0, 3)), 4, 0.3)
    assert torch.isinf(d).all() and (i == -1).all()


@pytest.mark.parametrize("drop_vertex_zero", [False, True])
def test_nn_graph_past_the_threshold_equals_the_brute_force_graph(monkeypatch, drop_vertex_zero):
    rng = np.random.default_rng(11)
    p = _cloud(10, 1200, scale=0.3)
    radii = rng.uniform(0.02, 0.12, size=1200).astype(np.float32)
    valid = rng.uniform(size=1200) > 0.1
    brute = tgraph.nn_graph(_t(p), _t(radii), 16, _t(valid), drop_vertex_zero)
    monkeypatch.setattr(tgraph, "GRID_KNN_THRESHOLD", 10)
    monkeypatch.setattr(tgraph, "knn", None)  # the grid route, or a TypeError
    grid = tgraph.nn_graph(_t(p), _t(radii), 16, _t(valid), drop_vertex_zero)
    assert torch.equal(grid.valid, brute.valid)
    assert torch.equal(grid.edges, brute.edges)  # continuous coordinates: no ties
    ok = brute.valid.numpy()
    assert np.isinf(grid.weights.numpy()[~ok]).all()
    np.testing.assert_allclose(grid.weights.numpy()[ok], brute.weights.numpy()[ok],
                               rtol=1e-6, atol=4 * 1.2e-7 * np.abs(p).max())
