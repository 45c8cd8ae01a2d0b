"""Batch sizing of the port (core/memory.py, ModelInference): the budget
read from the card's memory, the JAX package's 12 GiB and model on the CPU,
the footprint model with the card's terms against the JAX one, forwards
under two batch ceilings against each other and against the JAX forward,
the bench's batches following `max_batch_capacity`, and exact plans held
to the budget (a batch past it split in halves before it runs).

The card's properties are a stand-in here (monkeypatched
`torch.cuda.get_device_properties`); chip_smoke.py phase 20 reads the real
card and holds the model against the allocator's peaks."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import smart_tree_tpu.infer.inference as jinf
from smart_tree_tpu.core import memory as jmem
from smart_tree_tpu.data.cloud import Cloud as JCloud
from smart_tree_tpu_torch import bench
from smart_tree_tpu_torch.core import memory
from smart_tree_tpu_torch.data.augmentations import CentreCloud
from smart_tree_tpu_torch.data.cloud import Cloud
from smart_tree_tpu_torch.data.dataset import BlockTiler, halve_batch
from smart_tree_tpu_torch.data.synthetic import generate_tree
from smart_tree_tpu_torch.infer.inference import ModelInference

WEIGHTS = "smart_tree_tpu/weights/noble-elevator-58.npz"
GIB = 1 << 30
PLANES = (8, 16, 32, 64)
MODEL_TOL = dict(rtol=1e-3, atol=1e-4)
# a 20^3 grid of 5 cm voxels split into 2 x 2 x 2 blocks of 0.5 m: one batch
# of capacity 4096 at batch size 8, two under a 2048 ceiling; factor 1.0, so
# that no level overflows and the JAX side compiles one forward
GRID = dict(voxel_size=0.05, block_size=0.5, buffer_size=0.05, batch_size=8,
            precision="float32", compact_transfers=False, level_capacity_factor=1.0)
TWO_BATCH_CEILING = 2048
# 1,500 points scattered over a 40^3 grid of 2.5 cm voxels, eight 0.5 m
# blocks: one batch of capacity 2048 whose level 1 holds several times its
# voxels (the JAX package reruns it at factor 0.5 with levels past the batch
# capacity; the port's exact plan holds them)
SPARSE = dict(voxel_size=0.025, block_size=0.5, buffer_size=0.05, batch_size=8,
              precision="float32", level_capacity_factor=0.5)


def _cards(monkeypatch, totals):
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: SimpleNamespace(total_memory=totals[torch.device(d).index]))


@pytest.mark.parametrize("devices,totals,expected", [
    (["cuda:0"], {0: 80 * GIB}, 60 * GIB),
    (["cuda:0", "cuda:0"], {0: 80 * GIB}, 30 * GIB),
    (["cuda:0", "cuda:1"], {0: 80 * GIB, 1: 40 * GIB}, 30 * GIB),
    (["cuda:0", "cuda:0", "cuda:1"], {0: 80 * GIB, 1: 80 * GIB}, 30 * GIB),
    (["cpu"], {}, 12 * GIB),
    (["cpu"] * 8, {}, 12 * GIB),
    (["cuda:0", "cpu"], {0: 80 * GIB}, 12 * GIB),
], ids=["one-card", "two-replicas-one-card", "two-cards", "three-replicas", "cpu",
        "eight-cpu", "card-and-cpu"])
def test_device_budget(monkeypatch, devices, totals, expected):
    """0.75 of a card's total memory, split between the replicas on it; the
    JAX package's 12 GiB on the CPU; the smallest over the devices."""
    _cards(monkeypatch, totals)
    assert memory.device_budget_bytes([torch.device(d) for d in devices]) == expected


@pytest.mark.parametrize("factor", [0.5, 1.0])
@pytest.mark.parametrize("in_flight", [1, 2])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_card_terms_read_at_or_above_jax(factor, in_flight, itemsize):
    """With the port's int64 indices and whole route-3 gathers the model
    never reads below the JAX package's, at every pow2 capacity it sizes."""
    for e in range(10, 23):
        args = (1 << e, PLANES, factor, itemsize, in_flight)
        card = memory.estimate_forward_hbm(*args, **memory.CARD_FOOTPRINT)
        ref = jmem.estimate_forward_hbm(*args)
        for key in ("peak", "transient", "persistent"):
            assert card[key] >= ref[key], (e, key)


def test_footprint_terms_by_device():
    assert memory.footprint_terms([torch.device("cpu")] * 8) == {}
    assert memory.footprint_terms([torch.device("cuda", 0)]) == memory.CARD_FOOTPRINT
    assert memory.footprint_terms([torch.device("cuda", 0), torch.device("cpu")]) == \
        memory.CARD_FOOTPRINT
    # at its defaults the model is the JAX package's
    cpu_terms = memory.footprint_terms([torch.device("cpu")])
    assert memory.estimate_forward_hbm(1 << 20, PLANES, 1.0, in_flight=2, **cpu_terms) == \
        jmem.estimate_forward_hbm(1 << 20, PLANES, 1.0, in_flight=2)


def test_cpu_default_budget_is_jax():
    port = ModelInference(WEIGHTS, device="cpu")
    jmi = jinf.ModelInference(WEIGHTS)
    assert port.hbm_budget_bytes == jmi.hbm_budget_bytes == 12 * GIB
    assert port.max_batch_capacity == jmi.max_batch_capacity
    # an explicit budget wins
    assert ModelInference(WEIGHTS, device="cpu", hbm_budget_bytes=GIB).hbm_budget_bytes == GIB


def _grid_cloud():
    rng = np.random.default_rng(0)
    cells = rng.choice(20 ** 3, 3000, replace=False)
    ijk = np.stack(np.unravel_index(cells, (20, 20, 20)), axis=1)
    xyz = ((ijk + 0.5 + rng.uniform(-0.2, 0.2, ijk.shape)) * 0.05).astype(np.float32)
    return xyz, rng.uniform(0, 1, xyz.shape).astype(np.float32)


def _sorted(xyz, *arrays):
    order = np.lexsort(np.asarray(xyz).T)
    return [np.asarray(a)[order] for a in (xyz, *arrays)]


def test_ceilings_agree_and_match_jax(monkeypatch):
    """Two batches under a ceiling and one without give the same fp32
    predictions, and both the JAX forward's."""
    xyz, rgb = _grid_cloud()
    cloud = Cloud(xyz=xyz, rgb=rgb)
    one = ModelInference(WEIGHTS, device="cpu", **GRID)
    two = ModelInference(WEIGHTS, device="cpu", **GRID)
    two.max_batch_capacity = TWO_BATCH_CEILING
    tiler = BlockTiler(cloud, GRID["voxel_size"], GRID["block_size"], GRID["buffer_size"])
    assert len(tiler) == 8
    assert len(list(tiler.batches(8, max_capacity=one.max_batch_capacity))) == 1
    assert len(list(tiler.batches(8, max_capacity=two.max_batch_capacity))) == 2
    got = [_sorted(p["xyz"], p["radius"], p["direction"], p["class_logits"])
           for p in (one.predict(cloud), two.predict(cloud))]
    for a, b in zip(*got):
        np.testing.assert_allclose(a, b, **MODEL_TOL)

    # the JAX forward at full precision (compress_preds an identity), one batch
    monkeypatch.setattr(jinf, "compress_preds", lambda p: {
        "radius": p["radius"], "direction": p["direction"], "class_l": p["class_l"]})
    monkeypatch.setattr(jinf.ModelInference, "_submit_multichip",
                        lambda *a, **k: pytest.fail("took the multichip path"))
    ref = jinf.ModelInference(WEIGHTS, medial_classes=None, **GRID).forward(
        JCloud(xyz=xyz, rgb=rgb))
    mv = np.asarray(ref.medial_vector)
    radius = np.log(np.linalg.norm(mv, axis=1, keepdims=True))
    ref_xyz, ref_radius, ref_logits = _sorted(ref.xyz, radius,
                                              np.asarray(ref.class_l).reshape(-1, 2))
    for xyz_p, radius_p, _, logits_p in got:
        np.testing.assert_array_equal(xyz_p, ref_xyz)
        np.testing.assert_allclose(radius_p, ref_radius, **MODEL_TOL)
        np.testing.assert_allclose(logits_p, ref_logits, **MODEL_TOL)


def test_bench_batches_follow_the_budget(monkeypatch):
    """The bench runs at `max_batch_capacity` as ModelInference sizes it: under
    a CPU budget that admits 1024-voxel batches, the tiny bench tree's five."""
    planes = ModelInference(WEIGHTS, device="cpu").model.unet_planes
    budget = memory.estimate_forward_hbm(1024, planes, 1.0, in_flight=2)["peak"]
    monkeypatch.setattr(memory, "CPU_BUDGET_BYTES", budget)
    mi = ModelInference(WEIGHTS, device="cpu")
    assert mi.max_batch_capacity == 1024
    cloud, _ = generate_tree(seed=0, height=bench.TINY["height"], trunk_radius=0.25,
                             points_per_m2=bench.TINY["points_per_m2"],
                             foliage_points=bench.TINY["foliage_points"])
    expected = [len(vb.coords) for vb in BlockTiler(CentreCloud()(cloud), 0.01, 4.0, 0.4)
                .batches(4, max_capacity=mi.max_batch_capacity)]
    assert len(expected) > 2
    out = bench.run_bench(device="cpu", **bench.TINY)
    assert out["batch_capacities"] == expected


def test_level_caps_default_to_the_schedule():
    for factor in (0.5, 1.0):
        caps = memory.level_capacities(1 << 16, len(PLANES), factor)
        assert memory.estimate_forward_hbm(1 << 16, PLANES, factor, level_caps=caps) == \
            memory.estimate_forward_hbm(1 << 16, PLANES, factor)
    # a rerun's larger level reads above the schedule's
    big = memory.estimate_forward_hbm(1 << 16, PLANES, 1.0, level_caps=(1 << 16, 1 << 18, 1 << 16, 1 << 16))
    assert big["peak"] > memory.estimate_forward_hbm(1 << 16, PLANES, 1.0)["peak"]
    assert big["level_capacities"] == (1 << 16, 1 << 18, 1 << 16, 1 << 16)


def _sparse_cloud():
    rng = np.random.default_rng(0)
    cells = rng.choice(40 ** 3, 1500, replace=False)
    ijk = np.stack(np.unravel_index(cells, (40, 40, 40)), axis=1)
    xyz = ((ijk + 0.5 + rng.uniform(-0.2, 0.2, ijk.shape)) * 0.025).astype(np.float32)
    return Cloud(xyz=xyz, rgb=rng.uniform(0, 1, xyz.shape).astype(np.float32))


def test_halve_batch():
    cloud = _sparse_cloud()
    (vb,) = BlockTiler(cloud, SPARSE["voxel_size"], SPARSE["block_size"],
                       SPARSE["buffer_size"]).batches(8)
    a, b = halve_batch(vb)
    n = vb.n_valid
    assert a.n_valid + b.n_valid == n
    for half in (a, b):
        assert len(half.coords) >= half.n_valid and len(half.coords) & (len(half.coords) - 1) == 0
        assert half.batch_size == vb.batch_size and half.origins is vb.origins
    np.testing.assert_array_equal(np.concatenate([a.coords[:a.n_valid], b.coords[:b.n_valid]]),
                                  vb.coords[:n])
    np.testing.assert_array_equal(np.concatenate([a.mask[:a.n_valid], b.mask[:b.n_valid]]),
                                  vb.mask[:n])
    assert set(a.coords[:a.n_valid, 0]).isdisjoint(b.coords[:b.n_valid, 0])
    assert halve_batch(a._replace(coords=np.where(a.valid[:, None], 0, a.coords))) is None


@pytest.mark.parametrize("mode", ["predict", "culled"])
def test_rerun_past_the_budget_splits(mode):
    """An exact plan past the budget splits before it runs: a batch whose
    exact levels (level 1 several times the batch's voxels) pass a budget
    sized for its capacity at factor 1.0 runs no UNet pass whole, but two
    halves of its blocks, each planned afresh within the budget, which give
    the predictions of the whole batch's one pass under a larger budget."""
    cloud = _sparse_cloud()
    budget = memory.estimate_forward_hbm(2048, PLANES, 1.0, in_flight=2)["peak"]
    outs, runs, passes = [], [], []
    for hbm in (12 * GIB, budget):
        mi = ModelInference(WEIGHTS, device="cpu", hbm_budget_bytes=hbm, compact_transfers=False,
                            medial_classes=(0,) if mode == "culled" else None, **SPARSE)
        if mode == "culled":
            mi.compact_transfers = True
        assert mi.max_batch_capacity >= 2048   # the tiler's one batch, whole
        name = "_run_batch" if mode == "predict" else "_run_batch_culled"
        inner = getattr(mi, name)
        calls = []
        setattr(mi, name, lambda vb, inner=inner, calls=calls: (
            calls.append(len(vb.coords)), inner(vb))[1])
        runs.append(calls)
        if mode == "predict":
            p = mi.predict(cloud)
            outs.append(_sorted(p["xyz"], p["radius"], p["direction"], p["class_logits"]))
        else:
            c = mi.forward(cloud)
            outs.append(_sorted(c.xyz, c.medial_vector, c.class_l))
        passes.append(list(mi.plan_rows))
    (whole,), split = passes
    assert runs[0] == [2048] and whole[1] > 2 * whole[0]   # one pass, level 1 past level 0
    assert memory.estimate_forward_hbm(whole[0], PLANES, in_flight=2,
                                       level_caps=whole)["peak"] > budget
    # the first run planned the whole batch, then the halves ran, each within the budget
    assert runs[1][0] == 2048 and len(runs[1]) >= 3 and all(c <= 2048 for c in runs[1])
    assert len(split) >= 2 and whole not in split and sum(r[0] for r in split) == whole[0]
    for rows in split:
        assert memory.estimate_forward_hbm(rows[0], PLANES, in_flight=2,
                                           level_caps=rows)["peak"] <= budget
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, b, **MODEL_TOL)
