"""Port parity for smart_tree_tpu_torch.graph (neighbor table, chain
shortcuts, connected components, SSSP, tree distances) and the component
helpers of the skeletonizer, against smart_tree_tpu.graph on the same numpy
inputs made from a seed.

Integer results (table rows, labels, sizes, predecessors, roots) must be
equal. Distances are held at rtol 1e-6: the same fp32 path sums, min-reduced
in another order.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_tree_tpu import graph as jgraph
from smart_tree_tpu.neighbors.knn import knn as jknn
from smart_tree_tpu.skeleton import skeletonize as jskel
from smart_tree_tpu_torch import graph as tgraph
from smart_tree_tpu_torch.graph.table import _build, symmetrized
from smart_tree_tpu_torch.skeleton import skeletonize as tskel

# the JAX package's `graph.sssp` attribute is a function, not the module
jsssp = importlib.import_module("smart_tree_tpu.graph.sssp")
tsssp = importlib.import_module("smart_tree_tpu_torch.graph.sssp")

DIST_TOL = dict(rtol=1e-6, atol=0)


def _t(a):
    a = np.array(a)  # a writable copy
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind == "i" else a)


def random_graph(seed, n, e):
    """Random undirected graph with tie-free weights and no parallel edges."""
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, size=(e, 2)).astype(np.int32)
    weights = rng.uniform(0.1, 1.0, size=e).astype(np.float32)
    valid = rng.uniform(size=e) > 0.1
    key = np.stack([edges.min(1), edges.max(1)], axis=1)
    _, first = np.unique(key, axis=0, return_index=True)
    dup = np.ones(e, bool)
    dup[first] = False
    return edges, weights, valid & ~dup


def knn_adjacency(seed, n, k, r, noise=0.01):
    """[n,k] adjacency of a filament-like cloud, from the JAX KNN."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 6, n))
    pts = np.stack([np.cos(t), t, np.sin(t)], 1) + rng.normal(scale=noise, size=(n, 3))
    d, i = jknn(pts.astype(np.float32), pts.astype(np.float32), k, r)
    d, i = np.asarray(d), np.asarray(i)
    valid = i >= 0
    edges = np.stack([np.repeat(np.arange(n, dtype=np.int32), k), i.reshape(-1)], 1)
    return pts.astype(np.float32), i, d, valid, edges


def _rows_as_sets(tbl):
    idx, w, real = (np.asarray(x) for x in tbl)
    return [sorted((int(i), float(ww), bool(r)) for i, ww, r in zip(ri, rw, rr) if np.isfinite(ww))
            for ri, rw, rr in zip(idx, w, real)]


@pytest.mark.parametrize("seed,n,e", [(0, 200, 300), (1, 300, 900), (2, 64, 400)])
def test_neighbor_table_rows_match_jax(seed, n, e):
    edges, weights, valid = random_graph(seed, n, e)
    got = tgraph.build_neighbor_table(_t(edges), _t(weights), _t(valid), n, cap=8)
    ref = jgraph.build_neighbor_table(edges, weights, valid, n, cap=8)
    assert got.idx.shape == tuple(ref.idx.shape)  # the same cap doublings
    assert _rows_as_sets((got.idx.numpy(), got.w.numpy(), got.real.numpy())) == _rows_as_sets(ref)


def test_neighbor_table_extra_edges_are_not_real():
    edges, weights, valid = random_graph(5, 100, 200)
    extra_e = np.stack([np.arange(100, dtype=np.int32)] * 2, axis=1)
    extra_w, extra_v = np.full(100, 0.5, np.float32), np.ones(100, bool)
    got = tgraph.build_neighbor_table(_t(edges), _t(weights), _t(valid), 100,
                                      extra=(_t(extra_e), _t(extra_w), _t(extra_v)))
    ref = jgraph.build_neighbor_table(edges, weights, valid, 100, extra=(
        jnp.asarray(extra_e), jnp.asarray(extra_w), jnp.asarray(extra_v)))
    assert _rows_as_sets((got.idx.numpy(), got.w.numpy(), got.real.numpy())) == _rows_as_sets(ref)


def test_neighbor_table_overflow_retry_and_limit():
    """A hub past the first cap doubles the cap until every edge fits; past
    max_cap it raises instead of dropping edges."""
    n = 140
    hub = np.stack([np.zeros(n - 1, np.int32), np.arange(1, n, dtype=np.int32)], 1)
    w = np.linspace(0.1, 1.0, n - 1).astype(np.float32)
    v = np.ones(n - 1, bool)
    tbl = tgraph.build_neighbor_table(_t(hub), _t(w), _t(v), n, cap=8)
    assert tbl.idx.shape[1] == 256 == jgraph.build_neighbor_table(hub, w, v, n, cap=8).idx.shape[1]
    _, overflow = _build(*symmetrized(_t(hub), _t(w), _t(v)), n, 8)
    assert overflow == n - 1 - 8
    dist, pred = tgraph.sssp_multi(_t(hub), _t(w), _t(v), torch.tensor([0]), n)
    np.testing.assert_allclose(dist[1:].numpy(), w, **DIST_TOL)
    assert (pred[1:] == 0).all() and pred[0] == -1
    with pytest.raises(RuntimeError, match="neighbor table overflow"):
        tgraph.build_neighbor_table(_t(hub), _t(w), _t(v), n, cap=8, max_cap=64)


@pytest.mark.parametrize("levels,keep", [(10, 4), (4, 3)])
def test_chain_shortcut_table_matches_jax(levels, keep):
    _, i, d, valid, _ = knn_adjacency(0, 400, 8, 0.25)
    gi, gw = tgraph.chain_shortcut_table(_t(i), _t(d), _t(valid), levels, keep)
    ri, rw = jgraph.chain_shortcut_table(jnp.asarray(i), jnp.asarray(d), jnp.asarray(valid),
                                         levels=levels, keep=keep)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(np.isfinite(gw.numpy()), np.isfinite(np.asarray(rw)))
    fin = np.isfinite(np.asarray(rw))
    np.testing.assert_allclose(gw.numpy()[fin], np.asarray(rw)[fin], **DIST_TOL)


def test_chain_shortcuts_flat_matches_jax():
    _, i, d, valid, _ = knn_adjacency(1, 300, 6, 0.25)
    ge, gw, gv = tgraph.chain_shortcuts(_t(i), _t(d), _t(valid), 4, 3)
    re, rw, rv = jgraph.chain_shortcuts(jnp.asarray(i), jnp.asarray(d), jnp.asarray(valid),
                                        levels=4, keep=3)
    np.testing.assert_array_equal(ge.numpy(), np.asarray(re))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    np.testing.assert_allclose(gw.numpy()[gv.numpy()], np.asarray(rw)[np.asarray(rv)], **DIST_TOL)


@pytest.mark.parametrize("seed,n,e", [(0, 200, 150), (3, 500, 450), (4, 300, 900)])
def test_labels_and_sizes_match_jax(seed, n, e):
    edges, weights, valid = random_graph(seed, n, e)
    vv = np.random.default_rng(seed).uniform(size=n) > 0.1
    got = tgraph.connected_components(_t(edges), _t(valid), n, vertex_valid=_t(vv))
    ref = jgraph.connected_components(edges, valid, n, vertex_valid=jnp.asarray(vv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        tgraph.component_sizes(got, _t(vv)).numpy(),
        np.asarray(jgraph.component_sizes(ref, jnp.asarray(vv))))


def test_labels_with_shortcut_table_match_jax():
    _, i, d, valid, edges = knn_adjacency(2, 600, 6, 0.12)
    ev = valid.reshape(-1)
    sct = tgraph.chain_shortcut_table(_t(i), _t(d), _t(valid))
    base = tgraph.connected_components(_t(edges), _t(ev), 600)
    fast = tgraph.connected_components(_t(edges), _t(ev), 600, shortcut_tbl=sct)
    assert torch.equal(base, fast)
    np.testing.assert_array_equal(
        base.numpy(), np.asarray(jgraph.connected_components(edges, ev, 600)))
    assert len(np.unique(base.numpy())) > 1  # the radius leaves gaps


@pytest.mark.parametrize("jax_method", ["gather", "scatter"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sssp_multi_matches_jax(seed, jax_method):
    n = 300
    edges, weights, valid = random_graph(seed, n, 900)
    sources = np.asarray([3, 77, -1], np.int32)
    dist, pred, rounds = tgraph.sssp_multi(_t(edges), _t(weights), _t(valid), _t(sources), n,
                                           return_rounds=True)
    rd, rp, rr = jgraph.sssp_multi(edges, weights, valid, sources, n, return_rounds=True,
                                   method=jax_method)
    np.testing.assert_array_equal(np.isfinite(dist.numpy()), np.isfinite(np.asarray(rd)))
    fin = np.isfinite(np.asarray(rd))
    np.testing.assert_allclose(dist.numpy()[fin], np.asarray(rd)[fin], **DIST_TOL)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(rp))  # tie-free weights
    if jax_method == "gather":
        assert rounds == int(rr)


def test_sssp_padding_source_leaves_a_root_at_vertex_zero_alone():
    """A -1 padding source must not clear or set anything at vertex 0."""
    edges, weights, valid = random_graph(7, 50, 120)
    for sources in ([0, -1, -1], [9, -1]):
        dist, pred = tgraph.sssp_multi(_t(edges), _t(weights), _t(valid),
                                       torch.tensor(sources), 50)
        rd, rp = jgraph.sssp_multi(edges, weights, valid, np.asarray(sources, np.int32), 50,
                                   method="gather")
        np.testing.assert_array_equal(pred.numpy(), np.asarray(rp))
        assert (dist[0] == 0) == (sources[0] == 0)


def test_sssp_with_shortcut_table_matches_jax_and_needs_fewer_rounds():
    n = 600
    pts, i, d, valid, edges = knn_adjacency(3, n, 8, 0.3, noise=0.0)
    ev = valid.reshape(-1)
    w = np.where(ev, d.reshape(-1), np.inf).astype(np.float32)
    src = np.asarray([0], np.int32)
    d0, p0, r0 = tgraph.sssp_multi(_t(edges), _t(w), _t(ev), _t(src), n, return_rounds=True)
    sct = tgraph.chain_shortcut_table(_t(i), _t(d), _t(valid))
    d1, p1, r1 = tgraph.sssp_multi(_t(edges), _t(w), _t(ev), _t(src), n, return_rounds=True,
                                   shortcut_tbl=sct)
    jsct = jgraph.chain_shortcut_table(jnp.asarray(i), jnp.asarray(d), jnp.asarray(valid))
    jd, jp, jr = jgraph.sssp_multi(edges, w, ev, src, n, return_rounds=True, shortcut_tbl=jsct,
                                   method="gather")
    fin = np.isfinite(np.asarray(jd))
    assert fin.sum() > 100 and r1 < r0
    np.testing.assert_array_equal(np.isfinite(d1.numpy()), fin)
    # composite sums differ from sequential ones by addition order: rtol 1e-5
    np.testing.assert_allclose(d1.numpy()[fin], d0.numpy()[fin], rtol=1e-5)
    np.testing.assert_allclose(d1.numpy()[fin], np.asarray(jd)[fin], **DIST_TOL)
    np.testing.assert_array_equal(p1.numpy(), np.asarray(jp))
    assert r1 == int(jr)


def test_stopping_rule_is_the_relative_tolerance():
    """A round whose only improvement is below dist - tol*dist - tol is
    applied but does not start another round."""
    idx = torch.tensor([[0, 0], [0, 2], [1, 1]])
    w = torch.tensor([[np.inf, np.inf], [1.0, 1.0], [1.0, np.inf]])
    start = torch.tensor([0.0, 1.0, 2.0 + 1e-6])
    dist, rounds = tsssp._bf_rounds(idx, w, start.clone(), 1e-6)
    assert rounds == 1 and dist[2] == 2.0  # sub-tolerance: applied, no new round
    dist, rounds = tsssp._bf_rounds(idx, w, start.clone(), 0.0)
    assert rounds == 2


@pytest.mark.parametrize("n", [1, 2, 97, 1000])
def test_tree_distances_match_jax(n):
    rng = np.random.default_rng(n)
    pred = np.asarray([-1] + [rng.integers(0, v) for v in range(1, n)], np.int32)
    pred[rng.uniform(size=n) < 0.05] = -1  # a few more roots
    step = rng.uniform(0.01, 1.0, n).astype(np.float32)
    got = tgraph.tree_distances(_t(pred), _t(step), n)
    ref = jgraph.tree_distances(jnp.asarray(pred), jnp.asarray(step), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **DIST_TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_component_roots_match_jax(seed):
    rng = np.random.default_rng(seed)
    n = 400
    edges, _, valid = random_graph(seed, n, 350)
    keep = rng.uniform(size=n) > 0.15
    y = rng.integers(0, 20, n).astype(np.float32)  # many equal heights
    labels = tgraph.connected_components(_t(edges), _t(valid), n, vertex_valid=_t(keep))
    sizes = tgraph.component_sizes(labels, _t(keep))
    comp_ids = tskel._select_components(sizes, 3, 16)
    roots = tskel._component_roots(labels, _t(keep), _t(y), comp_ids)
    ref = jskel._component_roots(jnp.asarray(labels.numpy(), jnp.int32), jnp.asarray(keep),
                                 jnp.asarray(y), jnp.asarray(comp_ids.numpy(), jnp.int32))
    np.testing.assert_array_equal(roots.numpy(), np.asarray(ref))
    for c, r in zip(comp_ids.tolist(), roots.tolist()):
        if c >= 0:
            members = np.nonzero((labels.numpy() == c) & keep)[0]
            assert r == members[np.argmin(y[members])]  # lowest y, then lowest id


def test_select_components_orders_by_size_then_id():
    sizes = torch.tensor([5, 0, 9, 5, 2, 9, 40])
    got = tskel._select_components(sizes, 5, 4)
    assert got.tolist() == [6, 2, 5, 0]  # equal sizes: the lowest id first
    assert tskel._select_components(sizes, 6, 5).tolist() == [6, 2, 5, -1, -1]
    # the JAX device program selects with top_k, which breaks ties the same way
    import jax

    top, ids = jax.lax.top_k(jnp.asarray(sizes.numpy()), 4)
    assert np.asarray(ids).tolist() == got.tolist()
    assert tskel._select_components(sizes[:2], 1, 64).tolist() == [0, -1]


def test_dist_init_matches_jax():
    src = np.asarray([4, -1, 0, -1], np.int32)
    np.testing.assert_array_equal(
        tsssp._dist_init(_t(src), 6).numpy(), np.asarray(jsssp._dist_init(jnp.asarray(src), 6)))
