"""Port parity: rulebooks and UNet plans
(smart_tree_tpu_torch/core/{rulebook,plan}.py vs smart_tree_tpu/core/).

Integer functions: every rulebook entry, key and count must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_tree_tpu.core import plan as jplan
from smart_tree_tpu.core import rulebook as jrb
from smart_tree_tpu.core.sparse_tensor import SparseVoxelTensor as JSVT
from smart_tree_tpu_torch.core import plan as tplan
from smart_tree_tpu_torch.core import rulebook as trb
from smart_tree_tpu_torch.core.sparse_tensor import SparseVoxelTensor as TSVT


def _clustered(seed, grid=20, batch=1, clusters=6, per=40, cap_pad=13):
    """Clustered voxels on a grid^3 (as tests/test_model_parity.py builds
    them), padded with -1 rows."""
    rng = np.random.default_rng(seed)
    rows = []
    for b in range(batch):
        centers = rng.integers(3, grid - 3, size=(clusters, 3))
        pts = np.concatenate(
            [c + rng.integers(-3, 4, size=(per, 3)) for c in centers], axis=0
        )
        pts = np.clip(pts, 0, grid - 1)
        rows.append(np.concatenate([np.full((len(pts), 1), b), pts], axis=1))
    coords = np.unique(np.concatenate(rows), axis=0).astype(np.int32)
    coords = np.concatenate([coords, np.full((cap_pad, 4), -1, np.int32)])
    feats = rng.normal(size=(len(coords), 3)).astype(np.float32)
    return coords, feats, (grid,) * 3, batch


def _both(coords, feats, shape, batch):
    valid = coords[:, 0] >= 0
    jx = JSVT.from_coords(jnp.asarray(coords), jnp.asarray(feats), shape, batch,
                          valid=jnp.asarray(valid))
    tx = TSVT.from_coords(torch.from_numpy(coords), torch.from_numpy(feats), shape,
                          batch, valid=torch.from_numpy(valid))
    return jx, tx


INPUTS = {
    "one-item": dict(seed=0),
    "batch-3": dict(seed=1, grid=24, batch=3, clusters=4, per=60),
    "sparse": dict(seed=2, grid=40, clusters=10, per=15),
}


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_sparse_tensor_and_subm_rulebook(name):
    jx, tx = _both(*_clustered(**INPUTS[name]))
    np.testing.assert_array_equal(tx.keys.numpy(), np.asarray(jx.keys).astype(np.int64))
    np.testing.assert_array_equal(tx.feats.numpy(), np.asarray(jx.feats))
    np.testing.assert_array_equal(tx.active.numpy(), np.asarray(jx.active))
    for k in (1, 3):
        np.testing.assert_array_equal(
            trb.subm_rulebook(tx.keys, tx.spatial_shape, tx.batch_size, k).numpy(),
            np.asarray(jrb.subm_rulebook(jx.keys, jx.spatial_shape, jx.batch_size, k)),
        )


@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("out_cap", [512, 64])
def test_downsample_and_inverse(name, out_cap):
    """out_cap 64 truncates the coarse table (overflow): keys, count and
    both rulebooks must still agree entry for entry."""
    jx, tx = _both(*_clustered(**INPUTS[name]))
    jk, jshape, jn, jd = jrb.downsample_with_rulebook(
        jx.keys, jx.spatial_shape, jx.batch_size, out_cap)
    tk, tshape, tn, td = trb.downsample_with_rulebook(
        tx.keys, tx.spatial_shape, tx.batch_size, out_cap)
    assert tshape == jshape and int(tn) == int(jn)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk).astype(np.int64))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    ck, cshape, cn = trb.downsample_coords(tx.keys, tx.spatial_shape, tx.batch_size, out_cap)
    np.testing.assert_array_equal(ck.numpy(), tk.numpy())
    assert cshape == tshape and int(cn) == int(tn)
    np.testing.assert_array_equal(
        trb.inverse_from_strided(td, tx.capacity).numpy(),
        np.asarray(jrb.inverse_from_strided(jd, jx.capacity)),
    )


def _assert_plans_equal(tp, jp):
    assert tp.batch_size == jp.batch_size and len(tp.levels) == len(jp.levels)
    for tl, jl in zip(tp.levels, jp.levels):
        assert tl.spatial_shape == jl.spatial_shape
        assert int(tl.count) == int(jl.count)
        np.testing.assert_array_equal(tl.keys.numpy(), np.asarray(jl.keys).astype(np.int64))
        np.testing.assert_array_equal(tl.active.numpy(), np.asarray(jl.active))
        np.testing.assert_array_equal(tl.subm_rb.numpy(), np.asarray(jl.subm_rb))
        for t_rb, j_rb in ((tl.down_rb, jl.down_rb), (tl.up_rb, jl.up_rb)):
            assert (t_rb is None) == (j_rb is None)
            if t_rb is not None:
                np.testing.assert_array_equal(t_rb.numpy(), np.asarray(j_rb))


@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize(
    "kw",
    [
        dict(level_capacity_factor=1.0, min_capacity=256),
        dict(level_capacity_factor=0.5, min_capacity=16),
        # overflowing explicit capacities: the true count must exceed them
        dict(level_capacities=(0, 32, 16, 8)),
    ],
    ids=["factor1", "factor0.5", "overflow"],
)
def test_build_plan(name, kw):
    jx, tx = _both(*_clustered(**INPUTS[name]))
    tp = tplan.build_plan(tx, 4, **kw)
    # one jitted program per case: eager JAX compiles every op per shape
    jp = jax.jit(lambda x: jplan.build_plan(x, 4, **kw))(jx)
    _assert_plans_equal(tp, jp)
    if "level_capacities" in kw:
        assert any(int(lv.count) > lv.keys.shape[0] for lv in tp.levels)
