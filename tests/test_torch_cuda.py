"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports no JAX, so it runs on a GPU host without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(--noconftest: tests/conftest.py configures JAX). Without a card every test
here skips. Tolerances: slab kernel atol 2e-4 (bf16 operands on both sides,
fp32 summation order only); fused kernel rtol 1e-4 / atol 1e-5 (fp32).
"""

import numpy as np
import pytest
import torch

from smart_tree_tpu_torch.core import fused_conv, slab_conv
from smart_tree_tpu_torch.core.plan import build_plan
from smart_tree_tpu_torch.core.sparse_tensor import SparseVoxelTensor

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _monotone(rng, m, n, density=0.8):
    rb = np.full((m, 27), -1, np.int32)
    for g in range(9):
        base = np.sort(rng.choice(n - 2, size=m, replace=n - 2 < m)) + 1
        for dz in range(3):
            mask = rng.random(m) < density
            rb[mask, 3 * g + dz] = (base + dz - 1)[mask]
    return rb


def _spread(rng, m, n):
    """Every column spans the whole table: many slab chunks per tile."""
    rb = np.full((m, 27), -1, np.int32)
    for k in range(27):
        col = np.sort(rng.choice(n, size=m, replace=False))
        mask = rng.random(m) < 0.9
        rb[mask, k] = col[mask]
    return rb


def _plan_rulebook(kind):
    rng = np.random.default_rng(4)
    coords = np.unique(
        np.concatenate([np.zeros((6000, 1)), rng.integers(0, 64, size=(6000, 3))],
                       axis=1).astype(np.int32), axis=0)
    cap = 8192
    coords = np.concatenate([coords, np.full((cap - len(coords), 4), -1, np.int32)])
    x = SparseVoxelTensor.from_coords(torch.from_numpy(coords), torch.zeros(cap, 3),
                                      (64,) * 3, 1,
                                      valid=torch.from_numpy(coords[:, 0] >= 0))
    lv0, lv1 = build_plan(x, 2).levels
    return {"subm": lv0.subm_rb, "down": lv0.down_rb, "up": lv0.up_rb}[kind].numpy()


def _with_table(rb):
    return rb, int(rb.max()) + 1


SLAB_CASES = {
    # name: (rulebook maker (rng) -> (rb, n), cin, cout)
    "monotone-8-8": (lambda r: (_monotone(r, 700, 900), 900), 8, 8),
    "monotone-16-16": (lambda r: (_monotone(r, 1000, 1200), 1200), 16, 16),
    "monotone-64-32": (lambda r: (_monotone(r, 400, 500), 500), 64, 32),
    "monotone-32-64": (lambda r: (_monotone(r, 300, 400), 400), 32, 64),
    "multi-chunk": (lambda r: (_spread(r, 512, 4 * 1024 + 37), 4 * 1024 + 37), 8, 8),
    "ragged-empty": (lambda r: (np.concatenate([_monotone(r, 300, 600),
                                                np.full((423, 27), -1, np.int32)]), 600), 8, 16),
    "plan-subm": (lambda r: _with_table(_plan_rulebook("subm")), 16, 8),
    "plan-down": (lambda r: _with_table(_plan_rulebook("down")), 8, 16),
    "plan-up": (lambda r: _with_table(_plan_rulebook("up")), 32, 16),
}


@pytest.mark.parametrize("name", sorted(SLAB_CASES))
def test_slab_kernel_matches_plain(cuda, name):
    make, cin, cout = SLAB_CASES[name]
    rng = np.random.default_rng(0)
    rb, n = make(rng)
    feats = torch.from_numpy(rng.normal(size=(n, cin)).astype(np.float32)).to(cuda)
    w = torch.from_numpy(
        (rng.normal(size=(27, cin, cout)) / np.sqrt(27 * cin)).astype(np.float32)
    ).to(cuda)
    rb = torch.from_numpy(rb).to(cuda)
    launches = slab_conv.slab_gather_conv.launches
    got = slab_conv.slab_gather_conv(feats, rb, w)
    torch.cuda.synchronize()
    assert slab_conv.slab_gather_conv.launches == launches + 1
    ref = slab_conv.slab_gather_conv_plain(feats, rb, w)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), atol=2e-4)


FUSED_SHAPES = [
    # (n, m, k3, cin, cout)
    (300, 200, 27, 8, 16),
    (513, 700, 27, 32, 8),
    (64, 100, 8, 16, 32),
    (40, 50, 1, 4, 8),
    (5000, 3000, 27, 64, 64),
]


@pytest.mark.parametrize("n,m,k3,cin,cout", FUSED_SHAPES)
def test_fused_kernel_matches_plain(cuda, n, m, k3, cin, cout):
    rng = np.random.default_rng(4)
    feats = torch.from_numpy(rng.normal(size=(n, cin)).astype(np.float32)).to(cuda)
    rb = torch.from_numpy(rng.integers(-1, n, size=(m, k3)).astype(np.int32)).to(cuda)
    w = torch.from_numpy(
        (rng.normal(size=(k3, cin, cout)) / np.sqrt(k3 * cin)).astype(np.float32)
    ).to(cuda)
    launches = fused_conv.fused_gather_gemm.launches
    got = fused_conv.fused_gather_gemm(feats, rb, w)
    torch.cuda.synchronize()
    assert fused_conv.fused_gather_gemm.launches == launches + 1
    ref = fused_conv.fused_gather_gemm_plain(feats, rb, w)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=1e-4, atol=1e-5)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    feats = torch.zeros((10, 12), device=cuda)  # Cin 12: not a multiple of 8
    rb = torch.zeros((4, 27), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        slab_conv.slab_gather_conv(feats, rb, torch.zeros((27, 12, 8), device=cuda))
    with pytest.raises(ValueError):
        fused_conv.fused_gather_gemm(feats[:, :8], rb, torch.zeros((27, 8, 8), device=cuda))
    with pytest.raises(ValueError):  # Cout 12
        fused_conv.fused_gather_gemm(feats[:, :8].contiguous(), rb,
                                     torch.zeros((27, 8, 12), device=cuda))
