"""The port's device voxeliser (smart_tree_tpu_torch/core/voxelize.py)
against smart_tree_tpu/core/voxelize.py and the reference sparse_quantize
semantics (floor-divide, ravel-hash dedup, the first original row per voxel),
following tests/test_voxelize.py. Keys, survivors, inverse and counts are
integers, and features are gathered, not computed: every comparison is exact.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_tree_tpu_torch.core import voxelize as tvox
from smart_tree_tpu_torch.core.coords import ravel_hash_np

# the JAX package's core/__init__.py binds the name `voxelize` to the function
jvox = importlib.import_module("smart_tree_tpu.core.voxelize")


def _both(xyz, feats, voxel, origin, spatial, capacity, batch_idx=None, batch_size=1, valid=None):
    t = lambda a: None if a is None else torch.from_numpy(np.asarray(a))
    j = lambda a: None if a is None else jnp.asarray(a)
    got = tvox.voxelize(t(xyz), t(feats), voxel, t(origin), spatial, capacity,
                        batch_idx=t(batch_idx), batch_size=batch_size, valid=t(valid))
    ref = jvox.voxelize(j(xyz), j(feats), voxel, j(origin), spatial, capacity,
                        batch_idx=j(batch_idx), batch_size=batch_size, valid=j(valid))
    return got, ref


def _assert_equal(got, ref):
    for f in got._fields:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        np.testing.assert_array_equal(a.astype(b.dtype), b, err_msg=f)


def reference_quantize(xyz, voxel_size):
    coords = np.floor(xyz / np.float32(voxel_size)).astype(np.int32)
    h = ravel_hash_np(coords)
    _, index, inverse = np.unique(h, return_index=True, return_inverse=True)
    return coords[index], index, inverse


@pytest.mark.parametrize("seed,n,capacity", [(0, 500, 512), (1, 2000, 4096), (2, 64, 64)])
def test_voxelize_matches_jax_and_reference(seed, n, capacity):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(0, 1.0, size=(n, 3)).astype(np.float32)
    xyz[n // 2:] = xyz[: n - n // 2]                     # duplicate points
    feats = rng.normal(size=(n, 4)).astype(np.float32)
    origin = xyz.min(axis=0)
    got, ref = _both(xyz, feats, 0.05, origin, (32, 32, 32), capacity)
    _assert_equal(got, ref)
    valid = got.valid.numpy()
    coords, idx = got.coords.numpy()[valid], got.point_idx.numpy()[valid]
    ref_coords, ref_index, _ = reference_quantize(xyz - origin, 0.05)
    assert int(got.count) == len(ref_coords) == len(coords)
    ref_map = {tuple(c): i for c, i in zip(ref_coords.tolist(), ref_index.tolist())}
    assert all(ref_map[tuple(c[1:])] == i for c, i in zip(coords.tolist(), idx.tolist()))
    np.testing.assert_array_equal(got.feats.numpy()[valid], feats[idx])
    inv = got.inverse.numpy()
    grid = np.floor((xyz - origin) / np.float32(0.05)).astype(np.int32)
    np.testing.assert_array_equal(got.coords.numpy()[inv][:, 1:], grid)


def test_voxelize_batched_and_masked_matches_jax():
    rng = np.random.default_rng(1)
    xyz = rng.uniform(0, 0.5, size=(300, 3)).astype(np.float32)
    batch = (np.arange(300) % 3).astype(np.int32)
    valid = rng.random(300) < 0.7
    got, ref = _both(xyz, xyz, 0.05, np.zeros(3, np.float32), (16, 16, 16), 512,
                     batch_idx=batch, batch_size=3, valid=valid)
    _assert_equal(got, ref)
    coords = got.coords.numpy()[got.valid.numpy()]
    assert set(np.unique(coords[:, 0])) == {0, 1, 2}
    assert (got.inverse.numpy()[~valid] == -1).all()


def test_voxelize_overflow_counts_every_voxel():
    rng = np.random.default_rng(2)
    xyz = rng.uniform(0, 1.0, size=(400, 3)).astype(np.float32)
    got, ref = _both(xyz, xyz, 0.05, xyz.min(axis=0), (32, 32, 32), 64)
    _assert_equal(got, ref)
    assert int(got.count) > 64 and bool(got.valid.all())


@pytest.mark.parametrize("case", ["plain", "masked", "out-of-grid"])
def test_voxel_downsample_indices_matches_jax(case):
    rng = np.random.default_rng(3)
    n = 1000
    xyz = rng.uniform(-2.0, 2.0, size=(n, 3)).astype(np.float32)
    valid = None
    if case == "masked":
        valid = rng.random(n) < 0.6
    if case == "out-of-grid":
        xyz[:5] += np.float32(30.0)                      # past 1024 voxels of 0.02 m
    got = tvox.voxel_downsample_indices(torch.from_numpy(xyz), 0.02, 2048,
                                        valid=None if valid is None else torch.from_numpy(valid))
    ref = jvox.voxel_downsample_indices(jnp.asarray(xyz), 0.02, 2048,
                                        valid=None if valid is None else jnp.asarray(valid))
    for a, b in zip(got, ref):
        b = np.asarray(b)
        np.testing.assert_array_equal(a.numpy().astype(b.dtype), b)
    assert int(got[3]) == (5 if case == "out-of-grid" else 0)
