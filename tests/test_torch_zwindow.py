"""The compact z-window submanifold conv and the sorted-lookup rulebook
builders of the port (smart_tree_tpu_torch/core/{rulebook,sparse_ops,plan}.py:
`subm_rulebook9`, `SubmRB9`, `_gather_conv_z`, `build_plan(subm_mode="z9")`,
`strided_rulebook`, `inverse_rulebook`) against the JAX package.

Tolerances:
  - rulebooks (pos, qkey, strided, inverse) are integers: equal entry for
    entry;
  - the z9 conv against JAX's z9 conv: rtol / atol 1e-6
    (tests/test_sparse_conv.py's own), at fp32 and at bf16 (both sides round
    the operands to bf16, so only fp32 summation order differs), with the
    weights fan-in scaled as the model's are: torch's and XLA's CPU GEMMs sum
    the 216 products of a row in different orders, which at the unscaled
    weights of tests/test_sparse_conv.py (outputs ~15) is 2 ulps past 1e-6
    on 2 of 8,192 outputs; against the port's full-rulebook conv it is equal
    bit for bit (the window rulebook equals the full one, and route 3
    gathers it);
  - gradients (feats and weights) against `jax.grad` of JAX's z9 conv:
    rtol / atol 1e-5 (fp32 sums in another order), unchunked and chunked;
  - a SmartTree forward on a z9 plan against the flax model on its z9 plan:
    rtol 1e-3 / atol 1e-4, the model tolerance of tests/test_model_parity.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_tree_tpu.core import rulebook as jrb
from smart_tree_tpu.core import sparse_ops as jsparse
from smart_tree_tpu.core.plan import build_plan as jbuild
from smart_tree_tpu.core.sparse_tensor import SparseVoxelTensor as JSVT
from smart_tree_tpu.infer.inference import load_variables
from smart_tree_tpu.infer.inference import model_from_variables as jmodel_from
from smart_tree_tpu_torch.core import rulebook as trb
from smart_tree_tpu_torch.core import sparse_ops
from smart_tree_tpu_torch.core.plan import build_plan as tbuild
from smart_tree_tpu_torch.core.sparse_ops import ConvConfig, gather_conv
from smart_tree_tpu_torch.core.sparse_tensor import SparseVoxelTensor as TSVT
from smart_tree_tpu_torch.nn.convert import load_model, params_from_jax

# tests/test_sparse_conv.py::test_subm_rulebook9_conv_matches_full's shapes:
# (32, 4, 4) has z fill its 2-bit field, so a +1 at z = 3 carries into y
SHAPES = [((16, 16, 16), 2, 300), ((8, 8, 8), 1, 64), ((32, 4, 4), 1, 100)]
CAP, CIN, COUT = 512, 8, 16
TOL = dict(rtol=1e-6, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)


def _tensors(shape, batch, n, seed=7):
    rng = np.random.default_rng(seed)
    coords = np.concatenate([rng.integers(0, batch, size=(n, 1))]
                            + [rng.integers(0, s, size=(n, 1)) for s in shape], axis=1)
    coords = np.unique(coords.astype(np.int32), axis=0)
    coords = np.concatenate([coords, np.full((CAP - len(coords), 4), -1, np.int32)])
    feats = rng.normal(size=(CAP, CIN)).astype(np.float32)
    # fan-in scaled, as the model's weights are: unit-variance outputs, so
    # that 1e-6 is a few ulps of them whichever order a GEMM sums in
    w = (rng.normal(size=(27, CIN, COUT)) / np.sqrt(27 * CIN)).astype(np.float32)
    dout = rng.normal(size=(CAP, COUT)).astype(np.float32)
    valid = coords[:, 0] >= 0
    jx = JSVT.from_coords(jnp.asarray(coords), jnp.asarray(feats), shape, batch,
                          valid=jnp.asarray(valid))
    tx = TSVT.from_coords(torch.from_numpy(coords), torch.from_numpy(feats), shape, batch,
                          valid=torch.from_numpy(valid))
    return jx, tx, w, dout


def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("case", range(len(SHAPES)), ids=[str(s[0]) for s in SHAPES])
def test_subm_rulebook9_equals_jax_and_names_the_full_rulebook(case):
    shape, batch, n = SHAPES[case]
    jx, tx, _, _ = _tensors(shape, batch, n)
    got = trb.subm_rulebook9(tx.keys, shape, batch)
    ref = jax.jit(lambda k: jrb.subm_rulebook9(k, shape, batch))(jx.keys)
    assert (got.zbits, got.zmax) == (ref.zbits, ref.zmax)
    assert got.pos.dtype == torch.int32 and got.qkey.dtype == torch.int64
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(ref.pos))
    np.testing.assert_array_equal(got.qkey.numpy(), np.asarray(ref.qkey).astype(np.int64))
    assert got.keys is tx.keys
    # the rows the window routing picks are the full rulebook's, entry for entry
    window = sparse_ops._window_rulebook(got, got.pos, got.qkey)
    np.testing.assert_array_equal(window.numpy(),
                                  trb.subm_rulebook(tx.keys, shape, batch, 3).numpy())
    np.testing.assert_array_equal(trb.xy_offsets(), jrb.xy_offsets())


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(SHAPES)), ids=[str(s[0]) for s in SHAPES])
def test_z9_conv_equals_jax_and_the_full_rulebook(case, precision):
    shape, batch, n = SHAPES[case]
    jx, tx, w, _ = _tensors(shape, batch, n)
    rb9 = trb.subm_rulebook9(tx.keys, shape, batch)
    rb27 = trb.subm_rulebook(tx.keys, shape, batch, 3)
    cfg = ConvConfig(precision)
    got = gather_conv(tx.feats, rb9, torch.from_numpy(w), cfg)
    full = gather_conv(tx.feats, rb27, torch.from_numpy(w), cfg)
    assert torch.equal(got, full)
    # JAX on the CPU multiplies in fp32: give it the operands bf16 rounds to
    feats, wj = (np.asarray(jx.feats), w) if precision == "float32" else \
        (_bf16(jx.feats), _bf16(w))

    @jax.jit
    def jconv(k, f, ww):
        return jsparse.gather_conv(f, jrb.subm_rulebook9(k, shape, batch), ww)

    ref = np.asarray(jconv(jx.keys, jnp.asarray(feats), jnp.asarray(wj)))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def _graph(fn):
    """Names of every node of an autograd graph."""
    names, todo = set(), [fn]
    while todo:
        fn = todo.pop()
        if fn is not None and type(fn).__name__ not in names:
            names.add(type(fn).__name__)
            todo += [f for f, _ in fn.next_functions]
    return names


def _port_grads(tx, rb9, w, dout, cfg):
    f = tx.feats.clone().requires_grad_(True)
    ww = torch.from_numpy(w).requires_grad_(True)
    out = gather_conv(f, rb9, ww, cfg)
    graph = _graph(out.grad_fn)
    out.backward(torch.from_numpy(dout))
    return out.detach(), f.grad, ww.grad, graph


@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunked"])
@pytest.mark.parametrize("case", range(len(SHAPES)), ids=[str(s[0]) for s in SHAPES])
def test_z9_gradients_equal_jax_grad(case, chunked):
    shape, batch, n = SHAPES[case]
    jx, tx, w, dout = _tensors(shape, batch, n)
    rb9 = trb.subm_rulebook9(tx.keys, shape, batch)
    cfg = ConvConfig("float32", row_chunk=64, chunk_bytes=0) if chunked else ConvConfig()
    assert cfg.chunked(CAP, 27 * CIN) == chunked
    out, df, dw, graph = _port_grads(tx, rb9, w, dout, cfg)
    # route 3's compacted backwards, never autograd's of an index
    assert ("_ChunkedGatherConvBackward" in graph) == chunked
    assert ("_GatherRowsBackward" in graph) != chunked
    assert not any(name.startswith("Index") for name in graph), graph

    @jax.jit
    def jgrads(k, f, ww, d):
        rb = jrb.subm_rulebook9(k, shape, batch)
        return jax.grad(lambda f, ww: jnp.sum(jsparse.gather_conv(f, rb, ww) * d),
                        argnums=(0, 1))(f, ww)

    jdf, jdw = jgrads(jx.keys, jx.feats, jnp.asarray(w), jnp.asarray(dout))
    np.testing.assert_allclose(df.numpy(), np.asarray(jdf), **GRAD_TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), **GRAD_TOL)
    # the same gradients as the full rulebook's conv
    rb27 = trb.subm_rulebook(tx.keys, shape, batch, 3)
    _, df27, dw27, _ = _port_grads(tx, rb27, w, dout, cfg)
    assert torch.equal(df, df27)
    np.testing.assert_allclose(dw.numpy(), dw27.numpy(), **GRAD_TOL)


def test_z9_conv_never_takes_a_hand_kernel(monkeypatch):
    """On a z9 rulebook the dispatch goes to the window conv before the slab
    and fused checks, whatever the precision, threshold or opt-in."""
    jx, tx, w, _ = _tensors(*SHAPES[0])
    rb9 = trb.subm_rulebook9(tx.keys, SHAPES[0][0], SHAPES[0][1])

    def refuse(*a):
        raise AssertionError("a hand kernel was called on a SubmRB9")

    monkeypatch.setattr(sparse_ops.slab_conv, "slab_gather_conv", refuse)
    monkeypatch.setattr(sparse_ops.fused_conv, "fused_gather_gemm", refuse)
    cfg = ConvConfig("bfloat16", fused=True)   # every bf16 row count takes the slab kernel
    out = gather_conv(tx.feats, rb9, torch.from_numpy(w), cfg)
    assert out.shape == (CAP, COUT)
    with pytest.raises(ValueError, match="27 kernel offsets"):
        gather_conv(tx.feats, rb9, torch.from_numpy(w[:8]))


def test_smart_tree_on_z9_plans_matches_flax():
    name = "smart_tree_tpu/weights/noble-elevator-58.npz"
    variables = load_variables(name)
    jmodel = jmodel_from(variables)
    model = load_model(params_from_jax(variables), torch.device("cpu"))
    rng = np.random.default_rng(0)
    centers = rng.integers(3, 17, size=(6, 3))
    pts = np.clip(np.concatenate([c + rng.integers(-3, 4, size=(40, 3)) for c in centers]),
                  0, 19)
    coords = np.unique(np.concatenate([np.zeros((len(pts), 1), int), pts], axis=1),
                       axis=0).astype(np.int32)
    coords = np.concatenate([coords, np.full((13, 4), -1, np.int32)])
    feats = rng.normal(scale=5.0, size=(len(coords), model.input_channels)).astype(np.float32)
    valid = coords[:, 0] >= 0
    shape = (20, 20, 20)
    jx = JSVT.from_coords(jnp.asarray(coords), jnp.asarray(feats), shape, 1,
                          valid=jnp.asarray(valid))
    tx = TSVT.from_coords(torch.from_numpy(coords), torch.from_numpy(feats), shape, 1,
                          valid=torch.from_numpy(valid))

    @jax.jit
    def jforward(x):
        plan = jmodel.build_plan(x, min_capacity=2048, subm_mode="z9")
        return jmodel.apply(variables, plan, x.feats, train=False)

    ref = jforward(jx)
    plan = model.build_plan(tx, min_capacity=2048, subm_mode="z9")
    full = tbuild(tx, len(model.unet_planes), min_capacity=2048)
    assert all(isinstance(lv.subm_rb, trb.SubmRB9) for lv in plan.levels)
    for lv, lf in zip(plan.levels, full.levels):   # the level transitions are shared
        assert int(lv.count) <= lv.keys.shape[0]
        for a, b in ((lv.keys, lf.keys), (lv.down_rb, lf.down_rb), (lv.up_rb, lf.up_rb)):
            assert (a is None and b is None) or torch.equal(a, b)
    with torch.no_grad():
        got = model(plan, tx.feats, ConvConfig("float32"))
        got_full = model(full, tx.feats, ConvConfig("float32"))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-3, atol=1e-4,
                                   err_msg=k)
        assert torch.equal(got[k], got_full[k]), k
    with pytest.raises(ValueError, match="subm_mode"):
        tbuild(tx, 2, subm_mode="z3")


def test_sparse_voxel_tensor_helpers():
    jx, tx, _, _ = _tensors(*SHAPES[0])
    assert tx.num_features == jx.num_features == CIN
    np.testing.assert_array_equal(tx.coords().numpy(), np.asarray(jx.coords()))
    assert tx.coords().dtype == torch.int32
    assert int(tx.n_active()) == int(jx.n_active()) and tx.n_active().dtype == torch.int32
    y = tx.replace_feats(tx.feats * 2)
    assert torch.equal(y.feats, tx.feats * 2) and y.keys is tx.keys
    assert (y.spatial_shape, y.batch_size) == (tx.spatial_shape, tx.batch_size)


def _sparse(seed, n, shape=(14, 11, 13), batch=2):
    """tests/test_sparse_conv.py::make_sparse's voxels (cin 2, capacity n + 7)."""
    rng = np.random.default_rng(seed)
    c = np.unique(np.stack([rng.integers(0, batch, n)]
                           + [rng.integers(0, s, n) for s in shape], axis=1).astype(np.int32),
                  axis=0)
    cap = n + 7
    cpad = np.concatenate([c, np.full((cap - len(c), 4), -1, np.int32)])
    f = np.zeros((cap, 2), np.float32)
    jx = JSVT.from_coords(jnp.asarray(cpad), jnp.asarray(f), shape, batch)
    tx = TSVT.from_coords(torch.from_numpy(cpad), torch.from_numpy(f), shape, batch)
    return jx, tx


@pytest.mark.parametrize("seed,n", [(0, 40), (5, 150)])
def test_lookup_builders_equal_jax_and_the_scatter_builders(seed, n):
    """tests/test_sparse_conv.py::test_scatter_rulebooks_match_lookup_oracles'
    builders at its two smaller sizes: the port's lookup forms equal JAX's
    and the port's own scatter forms, entry for entry."""
    jx, tx = _sparse(seed, n)
    shape, batch, cap = tx.spatial_shape, tx.batch_size, 256
    ok, os_, cnt, drb = trb.downsample_with_rulebook(tx.keys, shape, batch, cap)
    srb = trb.strided_rulebook(tx.keys, ok, shape, os_, batch)
    irb = trb.inverse_rulebook(tx.keys, ok, shape, os_, batch)
    assert srb.dtype == irb.dtype == torch.int32
    np.testing.assert_array_equal(srb.numpy(), drb.numpy())
    np.testing.assert_array_equal(irb.numpy(), trb.inverse_from_strided(drb, tx.capacity).numpy())

    @jax.jit
    def jlookups(keys):
        jok, jos, _, _ = jrb.downsample_with_rulebook(keys, shape, batch, cap)
        return (jrb.strided_rulebook(keys, jok, shape, jos, batch),
                jrb.inverse_rulebook(keys, jok, shape, jos, batch))

    jsrb, jirb = jlookups(jx.keys)
    np.testing.assert_array_equal(srb.numpy(), np.asarray(jsrb))
    np.testing.assert_array_equal(irb.numpy(), np.asarray(jirb))
    assert (srb >= 0).any() and (irb >= 0).any()
