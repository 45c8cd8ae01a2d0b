"""The port's cell-sorted radius count (`smart_tree_tpu_torch/neighbors/
grid_count.py`) held against float64 counts of the same fp32 inputs, and the
outlier filter that counts through it held against the JAX package's, bit for
bit.

The bound. On every row certain <= true <= possible, where true is the
float64 count of d^2 < r^2 over the valid dst points, saturated at `cap`. On
every row with no pair whose float64 d^2 lies within twice the margin m of
r^2 (m = (hi2 - lo2) / 2, the module's thresholds) certain == possible ==
true: the count's own fp32 rounding of d^2 (5 * 2^-24 relative) and of r^2
(2^-24) lie far inside one margin (at least 8 * 1.2e-7 r^2), so a pair
outside twice the margin falls on the same side of both thresholds.

The counts run on the CPU, where `grid_radius_count` is its plain version;
tests/test_torch_cuda.py holds the CUDA kernel to it on the card. Clouds sit
at the origin and 20 and 50 m from it, as the trees of a forest scan do.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_tree_tpu_torch.data.synthetic import generate_tree

tgc = importlib.import_module("smart_tree_tpu_torch.neighbors.grid_count")
tfilter = importlib.import_module("smart_tree_tpu_torch.skeleton.filter")
jfilter = importlib.import_module("smart_tree_tpu.skeleton.filter")
jknn = importlib.import_module("smart_tree_tpu.neighbors.knn")

CENTRES = {"origin": (0.0, 0.0, 0.0), "20m": (12.0, -16.0, 0.0), "50m": (30.0, 0.0, 40.0)}
SMALL_TREE = dict(height=2.0, trunk_radius=0.08, points_per_m2=3000.0, foliage_points=300)
NB = 8


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _cloud(seed, n, centre, dup=False):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(n, 3))
    if dup:  # every point of the second half coincides with one of the first
        p[n // 2:] = p[rng.integers(0, n // 2, n - n // 2)]
    return (p + np.asarray(centre)).astype(np.float32)


def _count(src, dst, radii, sv=None, dv=None, cap=NB, fn=None):
    fn = fn or tgc.grid_radius_count_plain
    c, p = fn(_t(src), _t(dst), _t(radii), _t(sv), _t(dv), cap=cap, device="cpu")
    assert c.dtype == p.dtype == torch.int32
    return c.numpy(), p.numpy()


def _check(src, dst, radii, sv, dv, cap, got, clean_share=0.5):
    """The bound of the module docstring against float64 counts."""
    n = len(src)
    sv = np.ones(n, bool) if sv is None else sv
    dv = np.ones(len(dst), bool) if dv is None else dv
    d2 = ((src.astype(np.float64)[:, None] - dst.astype(np.float64)[None]) ** 2).sum(-1)
    d2[:, ~dv] = np.inf
    r2 = radii.astype(np.float64)[:, None] ** 2
    true = np.where(sv, np.minimum((d2 < r2).sum(1), cap), 0)
    lo, hi = got
    assert (lo <= true).all() and (true <= hi).all()
    g = tgc.build_grid(_t(src), _t(dst), _t(radii), _t(sv), _t(dv))
    m = ((g.hi2.double() - g.lo2.double()) / 2).numpy()[:, None]
    with np.errstate(invalid="ignore"):  # inf - inf where a radius is infinite
        near = (np.abs(d2 - r2) <= 2 * m).any(axis=1) & sv
    assert (~near).sum() >= clean_share * n
    np.testing.assert_array_equal(lo[~near], true[~near])
    np.testing.assert_array_equal(hi[~near], true[~near])
    return true


@pytest.mark.parametrize("cap", [NB, 1 << 20], ids=["cap8", "unsaturated"])
@pytest.mark.parametrize("dup", [False, True], ids=["distinct", "duplicated"])
@pytest.mark.parametrize("masked", [False, True], ids=["all-valid", "masked"])
@pytest.mark.parametrize("centre", CENTRES, ids=list(CENTRES))
def test_self_counts_bracket_float64(centre, masked, dup, cap):
    """The filter's query: every point against the cloud it belongs to."""
    p = _cloud(1, 600, CENTRES[centre], dup=dup)
    rng = np.random.default_rng(2)
    radii = rng.uniform(0.05, 0.6, len(p)).astype(np.float32)
    valid = rng.uniform(size=len(p)) > 0.25 if masked else None
    got = _count(p, p, radii, valid, valid, cap)
    true = _check(p, p, radii, valid, valid, cap, got)
    if cap == NB:
        assert (got[0] == cap).any()
    else:
        assert true.max() > NB


@pytest.mark.parametrize("centre", CENTRES, ids=list(CENTRES))
def test_counts_of_other_queries_bracket_float64(centre):
    """Queries that are not dst points, some outside the dst box."""
    src = (_cloud(3, 300, (0.0, 0.0, 0.0)) * 1.5 + np.asarray(CENTRES[centre])).astype(np.float32)
    dst = _cloud(4, 500, CENTRES[centre])
    rng = np.random.default_rng(5)
    radii = rng.uniform(0.1, 0.8, len(src)).astype(np.float32)
    dv = rng.uniform(size=len(dst)) > 0.2
    for cap in (NB, 1 << 20):
        _check(src, dst, radii, None, dv, cap, _count(src, dst, radii, None, dv, cap))


@pytest.mark.parametrize("centre", CENTRES, ids=list(CENTRES))
def test_dense_axis_rows(centre):
    """Duplicated points on rows along the axes, 1 cm apart, with radii that
    put whole neighbours exactly on the boundary (d == r in the reals)."""
    steps = np.arange(60, dtype=np.float64) * 0.01
    rows = [np.stack([steps, np.zeros(60), np.zeros(60)], 1),
            np.stack([np.zeros(60), steps, np.full(60, 0.3)], 1),
            np.stack([np.full(60, 0.2), np.zeros(60), steps], 1)]
    p = np.concatenate(rows + rows[:1]) + np.asarray(CENTRES[centre])
    p = p.astype(np.float32)
    rng = np.random.default_rng(6)
    radii = rng.choice([0.01, 0.02, 0.035, 0.05], size=len(p)).astype(np.float32)
    for cap in (NB, 1 << 20):
        got = _count(p, p, radii, cap=cap)
        _check(p, p, radii, None, None, cap, got, clean_share=0.2)


@pytest.mark.parametrize("cap", [NB, 1 << 20], ids=["cap8", "unsaturated"])
def test_infinite_and_nan_radii(cap):
    """An infinite radius (or one whose square passes the fp32 range) counts
    every valid point, a NaN radius none, and neither has a NaN threshold
    where the other has a number; a NaN row does not scan, an infinite one
    scans the whole grid."""
    p = _cloud(7, 200, CENTRES["20m"])
    dv = np.random.default_rng(8).uniform(size=len(p)) > 0.3
    radii = np.full(len(p), 0.3, np.float32)
    radii[[3, 4]] = np.inf
    radii[5] = 2e19          # finite, r^2 past the fp32 range
    radii[[6, 7]] = np.nan
    c, q = _count(p, p, radii, None, dv, cap)
    everyone = min(int(dv.sum()), cap)
    for i in (3, 4, 5):
        assert c[i] == q[i] == everyone
    assert (c[[6, 7]] == 0).all() and (q[[6, 7]] == 0).all()
    g = tgc.build_grid(_t(p), _t(p), _t(radii), torch.ones(len(p), dtype=torch.bool), _t(dv))
    assert torch.isinf(g.lo2[[3, 4, 5]]).all() and torch.isinf(g.hi2[[3, 4, 5]]).all()
    assert torch.isnan(g.lo2[[6, 7]]).all()
    a, b, scan = tgc._ranges(_t(p), g)
    assert not scan[[6, 7]].any() and scan[[3, 4, 5]].all()
    top = torch.tensor(g.dims) - 1
    assert (a[3] == 0).all() and (b[3] == top).all()
    _check(p, p, radii, None, dv, cap, (c, q))


def test_invalid_and_non_finite_src_rows_count_zero():
    p = _cloud(9, 300, CENTRES["origin"])
    radii = np.full(len(p), 0.5, np.float32)
    sv = np.ones(len(p), bool)
    sv[:20] = False
    src = p.copy()
    src[20] = np.nan
    src[21, 1] = np.inf
    c, q = _count(src, p, radii, sv, None)
    assert (c[:22] == 0).all() and (q[:22] == 0).all()
    assert (q[22:] > 0).all()
    _check(src[22:], p, radii[22:], None, None, NB, (c[22:], q[22:]))


@pytest.mark.parametrize("dst", ["none", "all-invalid", "non-finite"])
def test_empty_dst(dst):
    src = _cloud(10, 50, CENTRES["origin"])
    radii = np.full(len(src), 1.0, np.float32)
    if dst == "none":
        d, dv = np.zeros((0, 3), np.float32), None
    elif dst == "all-invalid":
        d, dv = _cloud(11, 40, CENTRES["origin"]), np.zeros(40, bool)
    else:
        d, dv = np.full((40, 3), np.inf, np.float32), None
    for fn in (tgc.grid_radius_count_plain, tgc.grid_radius_count):
        c, q = _count(src, d, radii, None, dv, fn=fn)
        assert c.shape == q.shape == (len(src),) and not c.any() and not q.any()


@pytest.mark.parametrize("scale", [1 / 16, 64.0], ids=["far-below", "far-above"])
def test_cell_edge_far_from_the_radii(scale, monkeypatch):
    """The edge changes which cells are visited, never a count."""
    p = _cloud(12, 500, CENTRES["50m"])
    rng = np.random.default_rng(13)
    radii = rng.uniform(0.1, 0.5, len(p)).astype(np.float32)
    ref = _count(p, p, radii, cap=1 << 20)
    edge = float(np.median(radii)) * scale
    monkeypatch.setattr(tgc, "_edge", lambda reach, counted, extent: edge)
    ones = torch.ones(len(p), dtype=torch.bool)
    assert float(tgc.build_grid(_t(p), _t(p), _t(radii), ones, ones).cell) == pytest.approx(edge)
    got = _count(p, p, radii, cap=1 << 20)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    _check(p, p, radii, None, None, 1 << 20, got)


def test_chunks_do_not_change_counts(monkeypatch):
    """Columns and pairs cut into chunks far smaller than one query's."""
    p = _cloud(14, 400, CENTRES["20m"])
    radii = np.random.default_rng(15).uniform(0.1, 0.9, len(p)).astype(np.float32)
    ref = _count(p, p, radii, cap=1 << 20)
    monkeypatch.setattr(tgc, "TILE_PAIRS", 7)
    got = _count(p, p, radii, cap=1 << 20)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])


def test_wrapper_on_cpu_is_the_plain_version():
    p = _cloud(16, 300, CENTRES["origin"])
    radii = np.random.default_rng(17).uniform(0.1, 0.5, len(p)).astype(np.float32)
    tgc.grid_radius_count.launches = 0
    got = _count(p, p, radii, fn=tgc.grid_radius_count)
    ref = _count(p, p, radii)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert tgc.grid_radius_count.launches == 0
    with pytest.raises(ValueError, match="cap"):
        _count(p, p, radii, cap=0, fn=tgc.grid_radius_count)


def _jittered(cloud, seed, offset=(0.0, 0.0, 0.0)):
    rng = np.random.default_rng(seed)
    mp = cloud.medial_pts + rng.normal(scale=0.004, size=cloud.xyz.shape) + np.asarray(offset)
    return mp.astype(np.float32), cloud.radius.astype(np.float32)


def _branch(seed):
    return generate_tree(seed=seed, **SMALL_TREE)[0].filter_by_class([0])


@pytest.mark.parametrize("min_radius", [None, 0.02])
@pytest.mark.parametrize("centre", CENTRES, ids=list(CENTRES))
def test_outlier_removal_matches_jax_on_the_branch_cloud(centre, min_radius):
    """tests/test_torch_skeleton.py's branch cloud, at the origin and moved
    20 and 50 m from it."""
    mp, r = _jittered(_branch(3), 0, CENTRES[centre])
    got = tfilter.outlier_removal(_t(mp), _t(r), NB, None, min_radius)
    ref = jfilter.outlier_removal(mp, r, NB, None, min_radius)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < int(got.sum()) < len(mp)


@pytest.mark.parametrize("min_radius", [None, 0.02])
def test_outlier_removal_matches_jax_at_forest_extent(min_radius):
    """Two small trees 39 m apart: JAX's margin (32 ulps of the squared half
    extent, 1.5e-3 m^2 here) is wider than most r^2, so about half of the
    rows fall into its shell; the port's margin, relative to r^2, leaves a
    handful."""
    a, b = _jittered(_branch(3), 0), _jittered(_branch(4), 1, offset=(30.0, 0.0, 25.0))
    mp, r = np.concatenate([a[0], b[0]]), np.concatenate([a[1], b[1]])
    valid = np.random.default_rng(2).uniform(size=len(mp)) > 0.1
    got = tfilter.outlier_removal(_t(mp), _t(r), NB, _t(valid), min_radius)
    ref = jfilter.outlier_removal(mp, r, NB, jnp.asarray(valid), min_radius)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < int(got.sum()) < int(valid.sum())

    rr = r if min_radius is None else np.maximum(r, np.float32(min_radius))
    jlo, jhi = (np.asarray(x) for x in jknn.radius_count(mp, mp, rr, jnp.asarray(valid),
                                                          jnp.asarray(valid), cap=NB))
    lo, hi = _count(mp, mp, rr, valid, valid)
    jax_shell = int(((jhi >= NB) & (jlo < NB) & valid).sum())
    port_shell = int(((hi >= NB) & (lo < NB) & valid).sum())
    assert jax_shell > 0.3 * valid.sum()
    assert port_shell <= 0.01 * jax_shell
