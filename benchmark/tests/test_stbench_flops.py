"""The pair and operation counter against brute force on small voxel sets,
and the reference's neighbour tables entry for entry."""

import itertools

import numpy as np
import pytest
import torch

from reference.unet import build_levels
from stbench import flops

OFFS = list(itertools.product(range(3), repeat=3))   # kx major, as the weights


def _voxels(seed, n=300, side=14, blocks=2):
    rng = np.random.default_rng(seed)
    c = np.concatenate([rng.integers(0, blocks, (n, 1)), rng.integers(0, side, (n, 3))], 1)
    return np.unique(c, axis=0).astype(np.int32), side


def _coarse(fine, side):
    out = set()
    for b, *c in fine:
        for cand in itertools.product(*[{(v - 1) // 2, (v + 1) // 2} for v in c]):
            if all(0 <= o < side and 2 * o - 1 <= v <= 2 * o + 1 for o, v in zip(cand, c)):
                out.add((b, *cand))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pairs_and_tables_brute_force(seed):
    coords, side = _voxels(seed)
    levels = build_levels(coords, side)
    fine = {tuple(int(v) for v in r) for r in coords}
    for lvl, lv in enumerate(levels):
        rows = {tuple(int(v) for v in r): i for i, r in enumerate(lv.coords.tolist())}
        assert len(rows) == lv.coords.shape[0] == len(fine)
        for (b, *c), i in rows.items():
            want = [rows.get((b, *(v + o - 1 for v, o in zip(c, off))), -1) for off in OFFS]
            assert lv.subm[i].tolist() == want
        if lvl + 1 < len(levels):
            coarse = _coarse(fine, (lv.shape - 1) // 2 + 1)
            nxt = levels[lvl + 1]
            crow = {tuple(int(v) for v in r): i for i, r in enumerate(nxt.coords.tolist())}
            assert set(crow) == coarse
            for (b, *o), i in crow.items():
                want = [rows.get((b, *(2 * v - 1 + k for v, k in zip(o, off))), -1)
                        for off in OFFS]
                assert nxt.down[i].tolist() == want
            fine = coarse
    inv = flops.inventory(levels)
    n = [len(lv.keys) for lv in levels]
    subm = [int((lv.subm >= 0).sum()) for lv in levels]
    strided = [int((lv.down >= 0).sum()) for lv in levels[1:]]
    planes = (8, 16, 32, 64)
    want = 2 * n[0] * 3 * 8
    for lvl, p in enumerate(planes):
        want += 2 * 2 * subm[lvl] * p * p
        if lvl < 3:
            q = planes[lvl + 1]
            want += 2 * 2 * strided[lvl] * p * q + 2 * n[lvl] * 2 * p * p \
                + 2 * subm[lvl] * (2 * p * p + p * p)
    want += 3 * 2 * n[0] * (64 + 32) + 2 * n[0] * 4 * (1 + 3 + 2)
    assert sum(c.flops() for c in inv) == want
    assert sum(c.k3 == 27 for c in inv) == 20


def test_up_is_the_transpose():
    coords, side = _voxels(5)
    levels = build_levels(coords, side)
    for fine, coarse in zip(levels, levels[1:]):
        for o, row in enumerate(coarse.down.tolist()):
            for k, f in enumerate(row):
                if f >= 0:
                    assert fine.up[f, k] == o
        assert int((fine.up >= 0).sum()) == int((coarse.down >= 0).sum())


def test_bound_is_the_larger_side():
    c = flops.Conv(pairs=1000, rows_in=100, rows_out=50, cin=8, cout=16, k3=27)
    assert c.flops() == 2 * 1000 * 8 * 16
    assert c.bytes(2) == 2 * (100 * 8 + 27 * 8 * 16 + 50 * 16)
    assert c.bound_s("bfloat16") == max(c.flops() / 989e12, c.bytes(2) / 3.35e12)
    assert torch.is_tensor(build_levels(*_voxels(6))[0].keys)
