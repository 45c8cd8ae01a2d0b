"""Port parity for smart_tree_tpu_torch.neighbors.knn against
smart_tree_tpu.neighbors.knn on the same numpy inputs made from a seed.

Indices must be equal. Distances are held at rtol 1e-6: both sides recompute
the selected pairs exactly in fp32, but XLA's fused loop and torch round the
three-term sum of squares differently in the last bit.
"""

import importlib

import numpy as np
import pytest
import torch

# the packages' `neighbors.knn` attribute is the function, not the module
jknn_mod = importlib.import_module("smart_tree_tpu.neighbors.knn")
tknn_mod = importlib.import_module("smart_tree_tpu_torch.neighbors.knn")

DIST_TOL = dict(rtol=1e-6, atol=0)


def _cloud(seed, n, dup=False, scale=1.0):
    rng = np.random.default_rng(seed)
    p = (rng.normal(size=(n, 3)) * scale).astype(np.float32)
    if dup:  # every point of the second half coincides with one of the first
        p[n // 2:] = p[rng.integers(0, n // 2, n - n // 2)]
    return p


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _check_knn(got, ref):
    td, ti = (x.numpy() for x in got)
    jd, ji = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(ti, ji)
    hit = ji >= 0
    assert np.isinf(td[~hit]).all()
    np.testing.assert_allclose(td[hit], jd[hit], **DIST_TOL)


@pytest.mark.parametrize("dup", [False, True], ids=["distinct", "duplicated"])
@pytest.mark.parametrize("masked", [False, True], ids=["all-valid", "masked"])
@pytest.mark.parametrize("k,r", [(16, 0.6), (1, 0.2), (8, 1e9)])
def test_knn_matches_jax(k, r, masked, dup):
    src, dst = _cloud(1, 700, dup), _cloud(2, 900, dup)
    sv = dv = None
    if masked:
        rng = np.random.default_rng(3)
        sv, dv = rng.uniform(size=700) > 0.2, rng.uniform(size=900) > 0.3
        dst[~dv] = 1e6  # far padding must not shift the centre
    got = tknn_mod.knn(_t(src), _t(dst), k, r, None if sv is None else _t(sv),
                       None if dv is None else _t(dv))
    _check_knn(got, jknn_mod.knn(src, dst, k, r, sv, dv))


@pytest.mark.parametrize("dup", [False, True], ids=["distinct", "duplicated"])
def test_knn_self_query_matches_jax(dup):
    p = _cloud(5, 800, dup, scale=0.3)
    got = tknn_mod.knn(_t(p), _t(p), 16, 0.1)
    _check_knn(got, jknn_mod.knn(p, p, 16, 0.1))
    d, i = got
    if not dup:  # the query itself comes first, at distance 0
        assert (i[:, 0] == torch.arange(800)).all() and (d[:, 0] == 0).all()
    else:  # equal distances come in index order
        tie = (d[:, 1:] == d[:, :-1]) & (i[:, 1:] >= 0)
        assert tie.any() and (i[:, 1:][tie] > i[:, :-1][tie]).all()


def test_nn_matches_jax():
    src, dst = _cloud(7, 300), _cloud(8, 500)
    d, i = tknn_mod.nn(_t(src), _t(dst), 0.5)
    jd, ji = jknn_mod.nn(src, dst, 0.5)
    assert d.shape == (300,) and i.dtype == torch.int64
    _check_knn((d[:, None], i[:, None]), (np.asarray(jd)[:, None], np.asarray(ji)[:, None]))


@pytest.mark.parametrize("src_tile,dst_chunk", [(64, 128), (100, 37), (4096, 16384)])
@pytest.mark.parametrize("dup", [False, True], ids=["distinct", "duplicated"])
def test_knn_independent_of_tile_size(src_tile, dst_chunk, dup):
    src, dst = _cloud(11, 500, dup), _cloud(12, 600, dup)
    rng = np.random.default_rng(13)
    dv = _t(rng.uniform(size=600) > 0.2)
    ref = tknn_mod.knn(_t(src), _t(dst), 12, 0.7, dst_valid=dv, src_tile=2048, dst_chunk=16384)  # fixed tiles
    got = tknn_mod.knn(_t(src), _t(dst), 12, 0.7, dst_valid=dv, src_tile=src_tile,
                       dst_chunk=dst_chunk)
    assert torch.equal(got[1], ref[1]) and torch.equal(got[0], ref[0])  # bit-equal


def test_knn_empty_and_short_dst():
    src = _cloud(1, 10)
    d, i = tknn_mod.knn(_t(src), torch.zeros((0, 3)), 4, 1.0)
    assert d.shape == (10, 4) and torch.isinf(d).all() and (i == -1).all()
    d, i = tknn_mod.knn(_t(src), _t(src[:3]), 8, 1e9)  # fewer dst than k
    assert (i[:, :3] >= 0).all() and (i[:, 3:] == -1).all()
    _check_knn((d, i), jknn_mod.knn(src, src[:3], 8, 1e9))


def _true_counts(src, dst, radii, dv, cap):
    d2 = ((src[:, None, :].astype(np.float64) - dst[None].astype(np.float64)) ** 2).sum(-1)
    return np.minimum((d2[:, dv] < radii[:, None].astype(np.float64) ** 2).sum(1), cap)


@pytest.mark.parametrize("masked", [False, True], ids=["all-valid", "masked"])
@pytest.mark.parametrize("dup", [False, True], ids=["distinct", "duplicated"])
def test_radius_count_matches_jax(masked, dup):
    p = _cloud(21, 1500, dup)
    rng = np.random.default_rng(22)
    radii = rng.uniform(0.05, 0.4, 1500).astype(np.float32)
    valid = rng.uniform(size=1500) > 0.25 if masked else np.ones(1500, bool)
    lo, hi = (x.numpy() for x in tknn_mod.radius_count(
        _t(p), _t(p), _t(radii), _t(valid), _t(valid), cap=8))
    jlo, jhi = (np.asarray(x) for x in jknn_mod.radius_count(p, p, radii, valid, valid, cap=8))
    true = np.where(valid, _true_counts(p, p, radii, valid, 8), 0)
    # the contract: certain <= true <= possible, exactly
    assert (lo <= true).all() and (true <= hi).all()
    assert (lo[~valid] == 0).all() and (hi[~valid] == 0).all()
    # and the same counts as the JAX function except in the margin shell
    # (the two round the distance form differently): at most 0.5 % of rows
    assert (lo != jlo).mean() <= 0.005 and (hi != jhi).mean() <= 0.005


@pytest.mark.parametrize("src_tile,dst_chunk", [(64, 128), (333, 77)])
def test_radius_count_independent_of_tile_size(src_tile, dst_chunk):
    p = _cloud(31, 900)
    radii = np.full(900, 0.3, np.float32)
    ref = tknn_mod.radius_count(_t(p), _t(p), _t(radii), cap=8)
    got = tknn_mod.radius_count(_t(p), _t(p), _t(radii), cap=8, src_tile=src_tile,
                                dst_chunk=dst_chunk)
    true = _true_counts(p, p, radii, np.ones(900, bool), 8)
    for lo, hi in (ref, got):
        assert (lo.numpy() <= true).all() and (true <= hi.numpy()).all()
    # tiles change how the matmul rounds, never more than the margin: the
    # two answers may differ only on rows in the shell, at most 0.5 % here
    assert (got[0] != ref[0]).float().mean() <= 0.005
    assert (got[1] != ref[1]).float().mean() <= 0.005


def test_tf32_is_switched_off_for_a_card(monkeypatch):
    from smart_tree_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert resolve_device(None).type == "cuda"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
