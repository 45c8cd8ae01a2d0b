"""Port parity: the fused gather-GEMM (smart_tree_tpu_torch/core/fused_conv.py)
against the Pallas kernel smart_tree_tpu/core/pallas_ops.py in interpret
mode, and the conv dispatch of smart_tree_tpu_torch/core/sparse_ops.py.

Tolerance: fp32 on both sides, differing only in summation order:
rtol 1e-4 / atol 1e-5, as tests/test_sparse_conv.py holds the Pallas kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_tree_tpu.core import pallas_ops as jops
from smart_tree_tpu_torch.core import fused_conv as tfused
from smart_tree_tpu_torch.core import slab_conv as tslab
from smart_tree_tpu_torch.core import sparse_ops as tops

SHAPES = [
    # (n, m, k3, cin, cout)
    (300, 200, 27, 8, 16),
    (513, 700, 27, 32, 8),   # m past one 512-row Pallas tile
    (64, 100, 8, 16, 32),
    (40, 50, 1, 4, 8),
]


def _inputs(n, m, k3, cin, cout, seed=4):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, cin)).astype(np.float32)
    rb = rng.integers(-1, n, size=(m, k3)).astype(np.int32)
    # fan-in scaled weights (as a trained conv's): outputs stay O(1), so
    # the fp32 summation-order error stays well inside atol
    w = (rng.normal(size=(k3, cin, cout)) / np.sqrt(k3 * cin)).astype(np.float32)
    return feats, rb, w


@pytest.mark.parametrize("n,m,k3,cin,cout", SHAPES)
def test_plain_matches_jax_fused(n, m, k3, cin, cout):
    feats, rb, w = _inputs(n, m, k3, cin, cout)
    got = tfused.fused_gather_gemm_plain(
        torch.from_numpy(feats), torch.from_numpy(rb), torch.from_numpy(w)
    ).numpy()
    ref = np.asarray(
        jops.fused_gather_gemm(jnp.asarray(feats), jnp.asarray(rb), jnp.asarray(w))
    )
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    # and the CPU wrapper is the plain version
    launches = tfused.fused_gather_gemm.launches
    np.testing.assert_array_equal(
        tfused.fused_gather_gemm(
            torch.from_numpy(feats), torch.from_numpy(rb), torch.from_numpy(w)
        ).numpy(),
        got,
    )
    assert tfused.fused_gather_gemm.launches == launches


@pytest.mark.parametrize(
    "m,cin", [(262144, 8), (262144, 16), (131072, 16), (65536, 64), (1000, 3)]
)
def test_gate_matches_jax(monkeypatch, m, cin):
    """The JAX package's gate (m * cin * 4 <= 8 MiB, the TPU kernel's VMEM)
    is not the port's: the H100 kernel reads its table from device memory
    and was the faster at every table size measured, so the port takes it
    past 8 MiB too; only a 64 -> 64 conv under WIDE_MIN_ROWS rows stays on
    route 3. The opt-in is an argument, not the environment."""
    monkeypatch.setenv("SMART_TREE_TPU_PALLAS", "1")
    jax_gate = jops.should_use_pallas(m, 27, cin, 8)
    assert jax_gate == (m * cin * 4 <= 8 * 1024 * 1024)
    assert tfused.should_use_fused(m, 27, cin, 8)
    assert tfused.should_use_fused(m, 27, 64, 64) == (m >= tfused.WIDE_MIN_ROWS)


ROUTES = [
    # (m, k3, precision, fused, cin, cout) -> route
    ((65536, 27, "bfloat16", False, 4, 8), "slab"),
    ((65536, 27, "bfloat16", True, 4, 8), "slab"),
    ((37, 27, "bfloat16", False, 4, 8), "slab"),          # no row floor on the card
    ((131073, 27, "bfloat16", False, 4, 8), "slab"),      # ragged, past JAX's cap // 4
    ((65535, 27, "bfloat16", False, 4, 8), "slab"),
    ((65536, 27, "float32", False, 4, 8), "plain"),
    ((65536, 27, "float32", True, 4, 8), "fused"),
    ((65536, 8, "bfloat16", True, 4, 8), "fused"),
    ((600000, 27, "float32", True, 4, 8), "fused"),       # table over JAX's 8 MiB
    ((4095, 27, "float32", True, 64, 64), "plain"),       # wide and short: route 3
    ((4096, 27, "float32", True, 64, 64), "fused"),
]


@pytest.mark.parametrize("args,route", ROUTES)
def test_gather_conv_dispatch(monkeypatch, args, route):
    """sparse_ops.gather_conv keeps the JAX package's routes in their order
    (smart_tree_tpu/core/sparse_ops.py:120-132) at the H100's thresholds."""
    m, k3, precision, fused, cin, cout = args
    taken = []

    def spy(name):
        def f(feats, rb, w):
            taken.append(name)
            return torch.zeros((rb.shape[0], w.shape[2]))
        return f

    monkeypatch.setattr(tslab, "slab_gather_conv", spy("slab"))
    monkeypatch.setattr(tfused, "fused_gather_gemm", spy("fused"))
    feats = torch.zeros((4, cin))
    rb = torch.full((m, k3), -1, dtype=torch.int32)
    w = torch.zeros((k3, cin, cout))
    cfg = tops.ConvConfig(precision, fused=fused)
    out = tops.gather_conv(feats, rb, w, cfg)
    assert out.shape == (m, cout)
    assert taken == ([] if route == "plain" else [route])


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_plain_route_precision(precision):
    """The XLA-path counterpart: gather + matmul, operands rounded to bf16
    in bf16 mode (equal to the plain slab version there), exact fp32
    otherwise (equal to the plain fused version)."""
    feats, rb, w = _inputs(300, 200, 27, 8, 16)
    args = (torch.from_numpy(feats), torch.from_numpy(rb), torch.from_numpy(w))
    got = tops.gather_conv(*args, tops.ConvConfig(precision))
    ref = (tslab.slab_gather_conv_plain if precision == "bfloat16"
           else tfused.fused_gather_gemm_plain)(*args)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)

