"""Exact plans (smart_tree_tpu_torch/core/plan.py, level_capacity_factor
None) and the inference that runs on them (infer/inference.py).

The JAX package plans every level into a fixed buffer and reruns a batch
whose level overflowed at larger capacities until none does. The port's
exact plan holds each level at its voxel count, so it must equal the valid
prefix of the plan those reruns settle on, and a forward takes one UNet pass
a batch where JAX takes several.

Tolerances: plans are integers, equal entry for entry; forwards at the model
tolerance rtol 1e-3 / atol 1e-4 (fp32 summation order); route 3 in ragged
chunks against the whole gather at rtol / atol 1e-5 (a short last chunk may
take another BLAS path, and the weight gradient sums the chunks one after
the other).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smart_tree_tpu.infer.inference as jinf
from smart_tree_tpu.core import plan as jplan
from smart_tree_tpu.core.sparse_tensor import SparseVoxelTensor as JSVT
from smart_tree_tpu.data.cloud import Cloud as JCloud
from smart_tree_tpu_torch.core import coords as tcoords
from smart_tree_tpu_torch.core import memory
from smart_tree_tpu_torch.core import plan as tplan
from smart_tree_tpu_torch.core import tiler
from smart_tree_tpu_torch.core import rulebook as trb
from smart_tree_tpu_torch.core.sparse_ops import ConvConfig, gather_conv
from smart_tree_tpu_torch.core.sparse_tensor import SparseVoxelTensor as TSVT
from smart_tree_tpu_torch.data.cloud import Cloud
from smart_tree_tpu_torch.data.dataset import BlockTiler
from smart_tree_tpu_torch.infer import inference as tinf
from smart_tree_tpu_torch.infer.inference import ModelInference

WEIGHTS = "smart_tree_tpu/weights/noble-elevator-58.npz"
MODEL_TOL = dict(rtol=1e-3, atol=1e-4)
PLANES = (8, 16, 32, 64)
# tests/test_torch_rulebook.py's clustered voxels on 20^3 to 40^3 grids
INPUTS = {
    "one-item": dict(seed=0),
    "batch-3": dict(seed=1, grid=24, batch=3, clusters=4, per=60),
    "sparse": dict(seed=2, grid=40, clusters=10, per=15),
}
# tests/test_torch_sizing.py's sparse cloud: one batch of capacity 2048
# whose level 1 holds several times its voxels; at factor 0.5 the JAX
# forward reruns it three times (the port's plans are exact)
SPARSE = dict(voxel_size=0.025, block_size=0.5, buffer_size=0.05, batch_size=8,
              precision="float32")
JAX_SPARSE = dict(SPARSE, level_capacity_factor=0.5)


def _clustered(seed, grid=20, batch=1, clusters=6, per=40, cap_pad=13):
    rng = np.random.default_rng(seed)
    rows = []
    for b in range(batch):
        centers = rng.integers(3, grid - 3, size=(clusters, 3))
        pts = np.concatenate([c + rng.integers(-3, 4, size=(per, 3)) for c in centers])
        pts = np.clip(pts, 0, grid - 1)
        rows.append(np.concatenate([np.full((len(pts), 1), b), pts], axis=1))
    coords = np.unique(np.concatenate(rows), axis=0).astype(np.int32)
    coords = np.concatenate([coords, np.full((cap_pad, 4), -1, np.int32)])
    feats = rng.normal(size=(len(coords), 3)).astype(np.float32)
    valid = coords[:, 0] >= 0
    shape = (grid,) * 3
    jx = JSVT.from_coords(jnp.asarray(coords), jnp.asarray(feats), shape, batch,
                          valid=jnp.asarray(valid))
    tx = TSVT.from_coords(torch.from_numpy(coords), torch.from_numpy(feats), shape, batch,
                          valid=torch.from_numpy(valid))
    return jx, tx


def _active_prefix(tx):
    """x at its active rows alone: level 0 of an exact plan."""
    n = int(tx.active.sum())
    return TSVT(tx.keys[:n], tx.feats[:n], tx.active[:n], tx.spatial_shape, tx.batch_size)


def _settled_caps(tx, factor):
    """The level capacities the JAX forward's reruns settle on for a plan of
    tx from `factor` (min capacity 16): the JAX package's `_retry_caps` on
    each attempt's counts until no level overflows, the attempts planned by
    the port's static form (equal to JAX's, tests/test_torch_rulebook.py).
    (capacities, reruns)."""
    kw, reruns = dict(level_capacity_factor=factor, min_capacity=16), 0
    while True:
        tp = tplan.build_plan(tx, 4, **kw)
        counts = [int(lv.count) for lv in tp.levels]
        caps = [lv.keys.shape[0] for lv in tp.levels]
        if all(c <= k for c, k in zip(counts, caps)):
            return tuple(caps), reruns
        kw = dict(level_capacities=jinf.ModelInference._retry_caps(counts, caps))
        reruns += 1


@pytest.mark.parametrize("mode", ["full", "z9"])
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_exact_plan_is_the_valid_prefix_of_the_settled_jax_plan(name, mode):
    """At a forced overflow (factor 0.1): the JAX plan at the capacities its
    reruns settle on holds no overflow, and the exact plan is its valid
    prefix, keys, counts and rulebooks entry for entry."""
    jx, tx = _clustered(**INPUTS[name])
    caps, reruns = _settled_caps(tx, 0.1)
    assert reruns > 0
    jp = jax.jit(lambda x: jplan.build_plan(x, 4, subm_mode=mode, level_capacities=caps))(jx)
    counts = [int(lv.count) for lv in jp.levels]
    assert all(c <= lv.keys.shape[0] for c, lv in zip(counts, jp.levels))
    tp = tplan.build_plan(_active_prefix(tx), 4, level_capacity_factor=None, subm_mode=mode)
    counts.append(0)
    for lvl, (tl, jl) in enumerate(zip(tp.levels, jp.levels)):
        n, n_next = counts[lvl], counts[lvl + 1]
        assert tl.keys.shape[0] == int(tl.count) == n and bool(tl.active.all())
        assert tl.spatial_shape == jl.spatial_shape
        np.testing.assert_array_equal(tl.keys.numpy(), np.asarray(jl.keys)[:n].astype(np.int64))
        if mode == "z9":
            assert (tl.subm_rb.zbits, tl.subm_rb.zmax) == (jl.subm_rb.zbits, jl.subm_rb.zmax)
            np.testing.assert_array_equal(tl.subm_rb.pos.numpy(), np.asarray(jl.subm_rb.pos)[:n])
            np.testing.assert_array_equal(tl.subm_rb.qkey.numpy(),
                                          np.asarray(jl.subm_rb.qkey)[:n].astype(np.int64))
        else:
            np.testing.assert_array_equal(tl.subm_rb.numpy(), np.asarray(jl.subm_rb)[:n])
        if tl.down_rb is None:
            assert jl.down_rb is None
            continue
        np.testing.assert_array_equal(tl.down_rb.numpy(), np.asarray(jl.down_rb)[:n_next])
        np.testing.assert_array_equal(tl.up_rb.numpy(), np.asarray(jl.up_rb)[:n])


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_exact_dedup_and_downsample_are_the_static_forms_at_the_count(name):
    """unique_keys and downsample_with_rulebook without a capacity equal
    their static forms (held against JAX in test_torch_coords.py /
    test_torch_rulebook.py) at capacity = the count, and the prefix of a
    static form with room to spare."""
    _, tx = _clustered(**INPUTS[name])
    keys = torch.cat([tx.keys.flip(0), tx.keys[:50]])      # unsorted, with duplicates
    exact = tcoords.unique_keys(keys, None)
    n = int(exact[3])
    assert exact[0].shape[0] == exact[1].shape[0] == n
    for got, ref in zip(exact, tcoords.unique_keys(keys, n)):
        assert torch.equal(got, ref)
    roomy = tcoords.unique_keys(keys, n + 40)
    assert torch.equal(exact[0], roomy[0][:n]) and torch.equal(exact[1], roomy[1][:n])
    assert torch.equal(exact[2], roomy[2])
    ek, eshape, ecount, edrb = trb.downsample_with_rulebook(tx.keys, tx.spatial_shape,
                                                            tx.batch_size, None)
    m = int(ecount)
    sk, sshape, scount, sdrb = trb.downsample_with_rulebook(tx.keys, tx.spatial_shape,
                                                            tx.batch_size, 2 * m)
    assert eshape == sshape and m == int(scount) == ek.shape[0] == edrb.shape[0]
    assert torch.equal(ek, sk[:m]) and torch.equal(edrb, sdrb[:m])


def _sparse_cloud():
    rng = np.random.default_rng(0)
    cells = rng.choice(40 ** 3, 1500, replace=False)
    ijk = np.stack(np.unravel_index(cells, (40, 40, 40)), axis=1)
    xyz = ((ijk + 0.5 + rng.uniform(-0.2, 0.2, ijk.shape)) * 0.025).astype(np.float32)
    return Cloud(xyz=xyz, rgb=rng.uniform(0, 1, xyz.shape).astype(np.float32))


@pytest.fixture(scope="module")
def sparse_jax():
    """The sparse cloud and the JAX full-download forward of it at full
    precision (compress_preds an identity), with the runs it took."""
    cloud = _sparse_cloud()
    taken = []
    run_batch = jinf.ModelInference._run_batch
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jinf, "compress_preds", lambda p: {
            "radius": p["radius"], "direction": p["direction"], "class_l": p["class_l"]})
        mp.setattr(jinf.ModelInference, "_run_batch", lambda self, vb, level_caps=None:
                   taken.append(level_caps) or run_batch(self, vb, level_caps))
        mp.setattr(jinf.ModelInference, "_submit_multichip",
                   lambda *a, **k: pytest.fail("took the multichip path"))
        ref = jinf.ModelInference(WEIGHTS, compact_transfers=False, medial_classes=None,
                                  **JAX_SPARSE).forward(JCloud(xyz=cloud.xyz, rgb=cloud.rgb))
    return cloud, ref, taken


def _sorted_rows(xyz, *arrays):
    order = np.lexsort(np.asarray(xyz).T)
    return [np.asarray(a)[order] for a in (xyz, *arrays)]


@pytest.mark.parametrize("mode", ["predict", "culled"])
def test_one_pass_a_batch_gives_the_rows_of_the_jax_reruns(sparse_jax, mode, monkeypatch):
    cloud, ref, taken = sparse_jax
    assert taken[0] is None and len(taken) >= 2          # JAX reran the batch
    mi = ModelInference(WEIGHTS, device="cpu", medial_classes=(0,) if mode == "culled" else None,
                        **SPARSE)
    passes = []
    unet = mi._unet
    monkeypatch.setattr(mi, "_unet", lambda x, plan: passes.append(
        [lv.keys.shape[0] for lv in plan.levels]) or unet(x, plan))
    (vb,) = BlockTiler(cloud, 0.025, 0.5, 0.05).batches(8, max_capacity=mi.max_batch_capacity)
    ref_logits = np.asarray(ref.class_l).reshape(-1, 2)
    ref_mv = np.asarray(ref.medial_vector)
    ref_xyz, ref_logits, ref_mv = _sorted_rows(ref.xyz, ref_logits, ref_mv)
    if mode == "predict":
        p = mi.predict(cloud)
        xyz, radius, logits = _sorted_rows(p["xyz"], p["radius"], p["class_logits"])
        np.testing.assert_array_equal(xyz, ref_xyz)
        np.testing.assert_allclose(logits, ref_logits, **MODEL_TOL)
        ref_radius = np.log(np.linalg.norm(ref_mv, axis=1, keepdims=True))
        np.testing.assert_allclose(radius, ref_radius, **MODEL_TOL)
    else:
        out = mi.forward(cloud)
        xyz, cls = _sorted_rows(out.xyz, out.class_l[:, 0])
        np.testing.assert_array_equal(xyz, ref_xyz)
        clear = np.abs(ref_logits[:, 0] - ref_logits[:, 1]) > 1e-3
        np.testing.assert_array_equal(cls[clear], ref_logits[clear].argmax(1))
    # one pass, at the batch's voxels, with level 1 past them (JAX's overflow)
    assert len(passes) == 1 and passes[0][0] == vb.n_valid and passes[0][1] > vb.n_valid
    assert mi.plan_rows == [tuple(passes[0])]


def _ragged_inputs(m, n=300, k3=27, cin=8, cout=16, seed=3):
    rng = np.random.default_rng(seed)
    feats = torch.from_numpy(rng.normal(size=(n, cin)).astype(np.float32))
    rb = rng.integers(0, n, size=(m, k3)).astype(np.int32)
    rb[rng.random((m, k3)) < 0.6] = -1
    w = torch.from_numpy(rng.normal(size=(k3, cin, cout)).astype(np.float32))
    dout = torch.from_numpy(rng.normal(size=(m, cout)).astype(np.float32))
    return feats, torch.from_numpy(rb), w, dout


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [65, 250])
def test_ragged_rows_chunk_with_a_short_last_chunk(m, precision):
    """Route 3 chunks a row count that is not a multiple of the chunk (the
    last chunk short) and equals the whole gather, forward and gradients,
    at rtol / atol 1e-5: a one-row last chunk takes another BLAS path (a
    vector product), which sums in another order."""
    feats, rb, w, dout = _ragged_inputs(m)
    forced = ConvConfig(precision, row_chunk=64, chunk_bytes=0)
    assert forced.chunked(m, 27 * 8) and m % 64 != 0
    outs = []
    for cfg in (forced, ConvConfig(precision)):
        f, ww = feats.clone().requires_grad_(True), w.clone().requires_grad_(True)
        out = gather_conv(f, rb, ww, cfg)
        out.backward(dout)
        outs.append((out.detach(), f.grad, ww.grad, type(out.grad_fn).__name__))
    chunked, whole = outs
    assert chunked[3].startswith("_ChunkedGatherConv") and not whole[3].startswith("_Chunked")
    for a, b in zip(chunked[:3], whole[:3]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_ragged_z9_conv_chunks_like_route_3():
    """The z-window conv chunks a ragged row count too, and equals the
    full rulebook's conv."""
    _, tx = _clustered(**INPUTS["sparse"])
    x = _active_prefix(tx)
    rb9 = trb.subm_rulebook9(x.keys, x.spatial_shape, x.batch_size)
    rb27 = trb.subm_rulebook(x.keys, x.spatial_shape, x.batch_size, 3)
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.normal(size=(27, 3, 8)).astype(np.float32))
    cfg = ConvConfig("float32", row_chunk=64, chunk_bytes=0)
    assert x.capacity % 64 != 0 and cfg.chunked(x.capacity, 27 * 3)
    assert torch.equal(gather_conv(x.feats, rb9, w, cfg), gather_conv(x.feats, rb27, w))


@pytest.mark.parametrize("blocks", ["eight", "one"])
def test_a_plan_past_the_budget_splits_before_it_runs(blocks, monkeypatch, caplog):
    """Under a budget that the batch's exact plan passes, the run half
    queues no UNet pass for the whole batch: it returns the two halves of
    its blocks, each planned afresh and within the budget. A one-block batch
    cannot split: it runs past the budget, with a warning."""
    cloud = _sparse_cloud()
    (host,) = BlockTiler(cloud, 0.025, 0.5, 0.05).batches(8)
    (vb,) = tiler.tile_cloud(cloud, 0.025, 0.5, 0.05, "cpu").batches(8)
    interior = int(host.mask.sum())
    if blocks == "one":     # the batch's first slot alone
        vb = tiler.TileBatch(vb.tiling, vb.blocks, vb.batch_size, 0, 1)
        interior = int(host.mask[host.coords[:, 0] == 0].sum())
    budget = memory.estimate_forward_hbm(vb.rows, PLANES, 1.0, in_flight=2)["peak"]
    mi = ModelInference(WEIGHTS, device="cpu", hbm_budget_bytes=budget, medial_classes=(0,),
                        **SPARSE)
    passes = []
    unet = mi._unet
    monkeypatch.setattr(mi, "_unet", lambda x, plan: passes.append(
        tuple(lv.keys.shape[0] for lv in plan.levels)) or unet(x, plan))
    keys, res, _, _, origins = mi._gathered(vb)
    whole = tuple(lv.keys.shape[0] for lv in mi._plan(mi._sorted_input(
        vb, vb.rows, keys, res, origins)).levels)
    assert memory.estimate_forward_hbm(whole[0], PLANES, in_flight=2,
                                       level_caps=whole)["peak"] > budget
    with caplog.at_level("WARNING", logger=tinf.__name__):
        out = mi._run_batch_culled(vb)
    if blocks == "one":
        assert passes == [whole] and "passes the budget" in caplog.text
        return
    assert isinstance(out, tinf._Split) and len(out.parts) == 2
    assert whole not in passes and sum(p[0] for p in passes) == whole[0]
    for rows in passes:
        assert memory.estimate_forward_hbm(rows[0], PLANES, in_flight=2,
                                           level_caps=rows)["peak"] <= budget
    sinks = ([], [], [], [])
    mi._collect_culled(vb, out, sinks)
    assert sum(len(a) for a in sinks[0]) == interior


def test_level_caps_set_every_level():
    """estimate_forward_hbm(level_caps=) counts every level at the rows
    given, level 0 included (an exact plan's level 0 is below the batch
    capacity); `capacity` is then not read."""
    rows = (3000, 9000, 5000, 1200)
    est = memory.estimate_forward_hbm(4096, PLANES, level_caps=rows)
    assert est["level_capacities"] == rows
    assert est == memory.estimate_forward_hbm(1 << 20, PLANES, level_caps=rows)
    assert est["peak"] < memory.estimate_forward_hbm(4096, PLANES, level_caps=(4096,) + rows[1:])[
        "peak"]
