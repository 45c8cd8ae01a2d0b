"""Port parity: the slab gather-conv (smart_tree_tpu_torch/core/slab_conv.py)
against the Pallas kernel smart_tree_tpu/core/pallas_slab.py in interpret
mode and against the bf16 reference of tests/test_pallas_slab.py.

Tolerance: both sides round the operands to bf16 and accumulate in fp32, so
they differ only in fp32 summation order: atol 2e-4 at these magnitudes
(inputs N(0,1), up to 27 * 64 terms). The CUDA kernel is held against the
plain version on the card (tests/test_torch_cuda.py, and chip_smoke.py at
the bench shapes). `slab_gather_conv_tiled`, the torch-op emulation of that
kernel's tile walk (slab bounds from the raw rulebook, chunked slabs, zero
row for misses), is held to the same tolerance here, and its bounds to
`_precompute` at the kernel's tile, slab and alignment.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_tree_tpu.core import pallas_slab as jslab
from smart_tree_tpu_torch.core import slab_conv as tslab

ATOL = 2e-4


def _bf16_reference(feats, rb, w):
    """gather -> GEMM with bf16-rounded operands and fp32 accumulation
    (tests/test_pallas_slab.py)."""
    n, cin = feats.shape
    m, k3 = rb.shape
    cout = w.shape[-1]
    fe = np.concatenate(
        [
            np.asarray(jnp.asarray(feats).astype(jnp.bfloat16).astype(jnp.float32)),
            np.zeros((1, cin), np.float32),
        ],
        axis=0,
    )
    g = fe[np.where(rb >= 0, rb, n)].reshape(m, k3 * cin)
    w2 = np.asarray(
        jnp.asarray(w).reshape(k3 * cin, cout).astype(jnp.bfloat16).astype(jnp.float32)
    )
    return g @ w2


def _monotone_rulebook(rng, m, n, density=0.8, group_drift=False):
    rb = np.full((m, 27), -1, np.int32)
    for g in range(9):
        base = np.sort(rng.choice(n - 2, size=m, replace=n - 2 < m)) + 1
        for dz in range(3):
            col = base + (dz - 1 if group_drift else 0)
            mask = rng.random(m) < density
            rb[mask, 3 * g + dz] = col[mask]
    return rb


def _case_monotone(rng):
    n, m, cin, cout = 900, 700, 16, 8
    return rng.normal(size=(n, cin)), _monotone_rulebook(rng, m, n, group_drift=True), cin, cout


def _case_multi_chunk(rng):
    # columns spanning many slabs: chunk loops must accumulate
    n, m, cin, cout = 4 * jslab._SLAB_S + 37, jslab._TILE_T, 8, 8
    rb = np.full((m, 27), -1, np.int32)
    for k in range(27):
        col = np.sort(rng.choice(n, size=m, replace=False))
        mask = rng.random(m) < 0.9
        rb[mask, k] = col[mask]
    return rng.normal(size=(n, cin)), rb, cin, cout


def _case_ragged(rng):
    # m not a multiple of the tile, and a fully invalid tile
    n, cin, cout = 600, 8, 16
    m = jslab._TILE_T + 123
    rb = _monotone_rulebook(rng, m, n)
    rb[jslab._TILE_T // 2:] = -1
    return rng.normal(size=(n, cin)), rb, cin, cout


def _case_wide(rng):
    n, m, cin, cout = 500, 400, 64, 32
    return rng.normal(size=(n, cin)), _monotone_rulebook(rng, m, n, group_drift=True), cin, cout


def _real_plan_rulebooks():
    """Subm, inverse and coarse-subm rulebooks of a real two-level plan."""
    from smart_tree_tpu_torch.core.plan import build_plan
    from smart_tree_tpu_torch.core.sparse_tensor import SparseVoxelTensor

    rng = np.random.default_rng(4)
    n_pts, grid, cap = 1500, 48, 2048
    coords = np.unique(
        np.concatenate(
            [np.zeros((n_pts, 1), np.int32), rng.integers(0, grid, size=(n_pts, 3))],
            axis=1,
        ).astype(np.int32),
        axis=0,
    )
    coords = np.concatenate([coords, np.full((cap - len(coords), 4), -1, np.int32)])
    x = SparseVoxelTensor.from_coords(
        torch.from_numpy(coords), torch.zeros(cap, 3), (grid,) * 3, 1,
        valid=torch.from_numpy(coords[:, 0] >= 0),
    )
    lv0, lv1 = build_plan(x, 2).levels
    return {"subm": lv0.subm_rb.numpy(), "up": lv0.up_rb.numpy(), "coarse": lv1.subm_rb.numpy()}


def _case_real(kind):
    def make(rng):
        rb = _real_plan_rulebooks()[kind]
        n = int(rb.max()) + 1
        return rng.normal(size=(max(n, rb.shape[0]), 8)), rb, 8, 16
    return make


CASES = {
    "monotone": _case_monotone,
    "multi-chunk": _case_multi_chunk,
    "ragged": _case_ragged,
    "wide": _case_wide,
    "real-subm": _case_real("subm"),
    "real-up": _case_real("up"),
    "real-coarse": _case_real("coarse"),
}


def _inputs(name, seed=0):
    rng = np.random.default_rng(seed)
    feats, rb, cin, cout = CASES[name](rng)
    feats = feats.astype(np.float32)
    w = rng.normal(size=(27, cin, cout)).astype(np.float32)
    return feats, rb.astype(np.int32), w


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_slab(name):
    feats, rb, w = _inputs(name)
    got = tslab.slab_gather_conv_plain(
        torch.from_numpy(feats), torch.from_numpy(rb), torch.from_numpy(w)
    ).numpy()
    jax_out = np.asarray(
        jslab.slab_gather_conv(jnp.asarray(feats), jnp.asarray(rb), jnp.asarray(w),
                               interpret=True)
    )
    np.testing.assert_allclose(got, jax_out, atol=ATOL)
    np.testing.assert_allclose(got, _bf16_reference(feats, rb, w), atol=ATOL)
    empty = np.all(rb < 0, axis=1)
    assert np.all(got[empty] == 0)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize(
    "tile,slab",
    [(jslab._TILE_T, jslab._SLAB_S), (64, 256), (tslab.TILE_ROWS, 256), (tslab.TILE_ROWS, 128)],
    ids=["tpu-tile", "small-tile", "hopper-tile", "hopper-tile-wide-cin"],
)
def test_precompute_matches_jax(name, tile, slab):
    _, rb, _ = _inputs(name)
    j_rel, j_starts, j_nch, j_tiles = jslab._precompute(jnp.asarray(rb), tile, slab)
    t_rel, t_starts, t_nch, t_tiles = tslab._precompute(
        torch.from_numpy(rb), tile, slab, blk=jslab._BLK
    )
    assert t_tiles == j_tiles
    np.testing.assert_array_equal(t_rel.numpy(), np.asarray(j_rel))
    np.testing.assert_array_equal(t_starts.numpy(), np.asarray(j_starts))
    np.testing.assert_array_equal(t_nch.numpy(), np.asarray(j_nch))


def test_cpu_wrapper_takes_plain_version():
    feats, rb, w = _inputs("monotone")
    launches = tslab.slab_gather_conv.launches
    args = (torch.from_numpy(feats), torch.from_numpy(rb), torch.from_numpy(w))
    np.testing.assert_array_equal(
        tslab.slab_gather_conv(*args).numpy(), tslab.slab_gather_conv_plain(*args).numpy()
    )
    assert tslab.slab_gather_conv.launches == launches  # no kernel on the CPU



@pytest.mark.parametrize("name", sorted(CASES))
def test_tiled_emulation_matches_plain_and_jax(name):
    feats, rb, w = _inputs(name)
    args = (torch.from_numpy(feats), torch.from_numpy(rb), torch.from_numpy(w))
    got = tslab.slab_gather_conv_tiled(*args, slab=tslab.slab_rows(feats.shape[1])).numpy()
    np.testing.assert_allclose(got, tslab.slab_gather_conv_plain(*args).numpy(), atol=ATOL)
    jax_out = np.asarray(
        jslab.slab_gather_conv(jnp.asarray(feats), jnp.asarray(rb), jnp.asarray(w),
                               interpret=True)
    )
    np.testing.assert_allclose(got, jax_out, atol=ATOL)
    empty = np.all(rb < 0, axis=1)
    assert np.all(got[empty] == 0)


@pytest.mark.parametrize("slab", [64, 128, 256])
def test_tiled_emulation_chunks_accumulate(slab):
    # slabs far shorter than the spans: every group walks several chunks
    feats, rb, w = _inputs("multi-chunk")
    args = (torch.from_numpy(feats), torch.from_numpy(rb), torch.from_numpy(w))
    got = tslab.slab_gather_conv_tiled(*args, slab=slab).numpy()
    np.testing.assert_allclose(got, tslab.slab_gather_conv_plain(*args).numpy(), atol=ATOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_tile_bounds_match_precompute(name):
    """The bounds the kernel derives per tile from the raw rulebook are
    `_precompute`'s starts, chunk counts and relative rows."""
    _, rb, _ = _inputs(name)
    tile, blk = tslab.TILE_ROWS, tslab.BLOCK_ROWS
    slab = tslab.slab_rows(8)
    rb_t = torch.from_numpy(rb)
    rel, starts_b, nchunks, tiles = tslab._precompute(rb_t, tile, slab, blk)
    assert tiles == -(-rb.shape[0] // tile)
    for t in range(tiles):
        rows = rb_t[t * tile : (t + 1) * tile]
        starts, spans = tslab._tile_bounds(rows, blk)
        assert [s // blk for s in starts] == starts_b[t].tolist()
        assert [-(-s // slab) for s in spans] == nchunks[t].tolist()
        for g in range(9):
            e = rows[:, 3 * g : 3 * g + 3]
            want = torch.where(e >= 0, e - starts[g], -1)
            got = rel[t * tile : t * tile + len(rows), 3 * g : 3 * g + 3]
            assert torch.equal(got, want.to(torch.int32))


def test_tiled_emulation_edges():
    # an entry equal to N - 1, a slab that ends at N, a tile with an empty
    # group, M not a multiple of the tile
    rng = np.random.default_rng(7)
    n, m, cin, cout = 300, tslab.TILE_ROWS + 5, 8, 8
    rb = _monotone_rulebook(rng, m, n)
    rb[:, 3:6] = -1          # group 1 empty in every tile
    rb[-1, 26] = n - 1
    feats = torch.from_numpy(rng.normal(size=(n, cin)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(27, cin, cout)).astype(np.float32))
    rb_t = torch.from_numpy(rb)
    got = tslab.slab_gather_conv_tiled(feats, rb_t, w).numpy()
    np.testing.assert_allclose(got, tslab.slab_gather_conv_plain(feats, rb_t, w).numpy(),
                               atol=ATOL)
