"""The device tiler (smart_tree_tpu_torch/core/tiler.py) in its plain form,
on the CPU, against the host path it replaces in the forward: the batches of
`BlockTiler(...).batches()`, each batch's `key_order()` and
`_stage_sorted(..., with_mask=True)`, bit for bit: capacities, keys, int8
and fp16 residuals, interior bits, origins, and the point index of every row
against the block's halo rows at the dedup's `first`. The kernels are held
to this plain version on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from smart_tree_tpu_torch import native
from smart_tree_tpu_torch.core import tiler
from smart_tree_tpu_torch.data import dataset as tds
from smart_tree_tpu_torch.data.augmentations import CentreCloud
from smart_tree_tpu_torch.data.cloud import Cloud
from smart_tree_tpu_torch.data.synthetic import generate_tree
from smart_tree_tpu_torch.tools.bench_scan import make_forest

TREE = dict(seed=3, height=2.0, trunk_radius=0.08, points_per_m2=3000.0,
            foliage_points=300)
CPU = torch.device("cpu")
RES = {"int8": np.int8, "fp16": np.float16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree():
    return CentreCloud()(generate_tree(**TREE)[0])


def _halo_first(cloud, grid):
    """The original point index of each voxel of each block, in the host
    tiler's order: the block's halo rows at the dedup's `first`."""
    voxel, block, buffer = grid
    xyz = np.asarray(cloud.xyz, np.float32)
    ids = tds.kept_blocks(xyz, block)
    offsets, rows, _, _ = native.tile_blocks(xyz, ids, block, buffer)
    out = []
    for lo, hi in zip(offsets[:-1], offsets[1:]):
        halo = rows[lo:hi]
        _, first = native.voxelize(xyz[halo], voxel, xyz[halo].min(axis=0))
        out.append(halo[first])
    return out


def _host_batches(cloud, grid, batch_size, max_capacity):
    host = tds.BlockTiler(cloud, *grid)
    firsts = _halo_first(cloud, grid)
    sizes = np.asarray([len(b.coords) for b in host.blocks], np.int64)
    chunks = tds.group_blocks(sizes, batch_size, max_capacity)
    batches = list(host.batches(batch_size, max_capacity=max_capacity))
    assert len(chunks) == len(batches)
    # each batch's rows' point indices, in the batch's row order
    index = [np.concatenate([firsts[i] for i in c]) for c in chunks]
    return host, batches, index


def _assert_batch_equal(vb, index, tb, inputs, res_dtype):
    """One device batch (or half) against the host's, for one residual kind."""
    keys, order, n_act = vb.key_order()
    skeys, res, orig, n, bits = vb._stage_sorted(keys, order, n_act, 4096, res_dtype)
    got_keys, got_res, interior, got_index, origins = inputs
    assert (tb.capacity, tb.rows, tb.spatial_shape, tb.batch_size) == \
        (vb.capacity, n_act, vb.spatial_shape, vb.batch_size)
    assert got_keys.dtype == torch.int64 and got_index.dtype == torch.int32
    np.testing.assert_array_equal(got_keys.numpy(), skeys[:n_act].astype(np.int64))
    width = np.uint8 if res_dtype == np.int8 else np.uint16
    np.testing.assert_array_equal(got_res.numpy().view(width), res[:n_act].view(width))
    np.testing.assert_array_equal(interior.numpy(),
                                  np.unpackbits(bits, count=n_act).astype(bool))
    np.testing.assert_array_equal(origins.numpy(), orig)
    np.testing.assert_array_equal(got_index.numpy(), index[order[:n_act]])
    assert tb.n_interior == int(vb.mask[:n_act].sum())


def _check(cloud, grid, batch_size=4, max_capacity=262144, min_batches=1):
    """The plain device tiling of `cloud` against the host path; returns the
    device batches."""
    host, batches, index = _host_batches(cloud, grid, batch_size, max_capacity)
    stats = {}
    tiling = tiler.tile_cloud(cloud, *grid, CPU, stats=stats)
    got = tiling.batches(batch_size, max_capacity)
    assert len(got) == len(batches) >= min_batches
    assert tiling.box_tests == host.box_tests
    assert stats == ({"tile_fetches": 2, "tile_box_tests": host.box_tests} if host.blocks
                     else {})
    for tb, vb, idx in zip(got, batches, index):
        for res_dtype in RES.values():
            table = torch.from_numpy(tb.table())
            inputs = tiler.gather(tb, table, res_dtype == np.int8)
            _assert_batch_equal(vb, idx, tb, inputs, res_dtype)
    return got


def test_a_synthetic_tree_equals_the_host_tiling():
    _check(_tree(), (0.01, 4.0, 0.4))


def test_a_tree_in_small_blocks_with_a_small_capacity():
    """Many blocks, and batches that close early at max_capacity."""
    got = _check(_tree(), (0.01, 1.0, 0.1), batch_size=4, max_capacity=2048, min_batches=3)
    assert any(len(tb.blocks) < 4 for tb in got[:-1])


def test_a_multi_block_forest_equals_the_host_tiling():
    forest = make_forest(3, 1500.0, seed=2)
    got = _check(forest, (0.02, 2.0, 0.2), batch_size=4, min_batches=3)
    assert sum(len(tb.blocks) for tb in got) >= 10


@pytest.mark.parametrize("buffer", [0.6, 1.3], ids=["over-half-a-block", "over-a-block"])
def test_a_buffer_wider_than_half_a_block(buffer):
    """A point lies in the halos of three (or five) blocks an axis."""
    _check(_tree(), (0.02, 1.0, buffer))


def test_points_on_block_and_voxel_faces():
    """Points exactly on the blocks' faces, on the buffered faces, on voxel
    faces from the points' minimum and one float32 step either side."""
    block, buffer, voxel = 1.0, 0.25, 0.05
    rng = np.random.default_rng(5)
    base = rng.uniform(-1.5, 1.5, size=(3000, 3)).astype(np.float32)
    faces = np.arange(-2, 3) * block
    faces = np.concatenate([faces, faces + block / 2 - (block + 2 * buffer) / 2,
                            faces + block / 2 + (block + 2 * buffer) / 2])
    faces = np.concatenate([faces, -1.5 + voxel * np.arange(0, 60)]).astype(np.float32)
    faces = np.concatenate([faces, np.nextafter(faces, np.float32(np.inf)),
                            np.nextafter(faces, np.float32(-np.inf))])
    on = rng.choice(faces, size=(4000, 3)).astype(np.float32)
    mixed = np.where(rng.random((4000, 3)) < 0.5, on, rng.uniform(-1.5, 1.5, (4000, 3)))
    xyz = np.concatenate([base, on, mixed.astype(np.float32)])
    xyz[0] = -1.5           # the minimum of the halos on every axis
    cloud = Cloud(xyz=xyz, rgb=rng.random(xyz.shape).astype(np.float32))
    _check(cloud, (voxel, block, buffer), min_batches=2)


def test_non_finite_points_are_in_no_block():
    cloud = _tree()
    xyz = cloud.xyz.astype(np.float32).copy()
    rows = np.random.default_rng(6).choice(len(xyz), size=12, replace=False)
    xyz[rows[:4]] = np.nan
    xyz[rows[4:7]] = np.inf
    xyz[rows[7:9]] = -np.inf
    xyz[rows[9], 1] = np.nan
    xyz[rows[10], 2] = np.inf
    xyz[rows[11], 0] = -np.inf
    (tb, *_) = _check(Cloud(xyz=xyz, rgb=cloud.rgb), (0.01, 4.0, 0.4))
    assert not np.isin(rows, tb.tiling.first.numpy()).any()


def test_a_cloud_too_sparse_for_any_block():
    cloud = Cloud(xyz=np.random.default_rng(7).random((15, 3)).astype(np.float32))
    assert _check(cloud, (0.01, 4.0, 0.4), min_batches=0) == []
    stats = {}
    tiling = tiler.tile_cloud(cloud, 0.01, 4.0, 0.4, CPU, stats=stats)
    assert tiling.box_tests == 0 and stats == {} and len(tiling.counts) == 0


def test_halving_a_batch_equals_halve_batch():
    """`TileBatch.halves` (and the halves of a half) against `halve_batch`:
    the same blocks, capacities, rows, keys (slots unchanged) and origins;
    the halves take their rows of the inputs the batch gathered."""
    cloud, grid = _tree(), (0.01, 1.0, 0.1)
    host, batches, index = _host_batches(cloud, grid, 8, None)
    tiling = tiler.tile_cloud(cloud, *grid, CPU)
    (tb, *_), (vb, *_), (idx, *_) = tiling.batches(8), batches, index
    assert len(tb.blocks) >= 4
    tb.inputs = tiler.gather(tb, torch.from_numpy(tb.table()), True)
    pending = [(tb, vb, idx)]
    seen = 0
    while pending:
        t, v, i = pending.pop()
        _assert_batch_equal(v, i, t, t.part(), np.int8)
        seen += 1
        host_halves, dev_halves = tds.halve_batch(v), t.halves()
        if host_halves is None:
            assert dev_halves is None and t.hi - t.lo == 1
            continue
        for hv, dv in zip(host_halves, dev_halves):
            assert dv.inputs is tb.inputs
            # the host half keeps the batch's rows in order: its point
            # indices are the batch's at the rows of its slots
            rows = np.isin(v.coords[:v.n_valid, 0], np.arange(dv.lo, dv.hi))
            pending.append((dv, hv, i[rows]))
    assert seen == 2 * len(tb.blocks) - 1


def test_group_blocks_is_the_host_batching():
    sizes = np.random.default_rng(8).integers(1, 5000, size=40).astype(np.int64)
    chunks = tds.group_blocks(sizes, 4, 8192)
    assert sorted(np.concatenate(chunks).tolist()) == list(range(40))
    order = np.argsort(sizes)
    assert np.concatenate(chunks).tolist() == order.tolist()
    for c in chunks:
        assert len(c) <= 4
        assert tds._ceil_pow2(int(sizes[c].sum())) <= 8192 or len(c) == 1


def test_the_tiler_runs_on_cuda_or_cpu_only():
    with pytest.raises(ValueError, match="cuda or cpu"):
        tiler.tile_cloud(_tree(), 0.01, 4.0, 0.4, torch.device("meta"))
    with pytest.raises(ValueError, match="key bits"):
        tiler.tile_cloud(_tree(), 0.001, 4.0, 0.4, CPU)
