"""Route 3 of the port's gather conv in row chunks
(smart_tree_tpu_torch/core/sparse_ops.py, `_ChunkedGatherConv`) against the
whole gather, and its chunking rule against the JAX package's
`_map_row_chunks`.

The chunks are forced through `ConvConfig(row_chunk=..., chunk_bytes=...)`
on a small rulebook. Tolerances: the forward is equal bit for bit (each
output row is the same product); the feature gradient too (the same
`index_add_` of the same rows in the same order); the weight gradient sums
the chunks' products one after the other, so it holds at rtol 1e-5 /
atol 1e-5 (fp32 summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_tree_tpu.core import sparse_ops as jsparse
from smart_tree_tpu_torch.core import memory, sparse_ops
from smart_tree_tpu_torch.core.sparse_ops import ConvConfig, gather_conv

M, N, CIN, COUT = 256, 300, 8, 16
FORCED = dict(row_chunk=64, chunk_bytes=0)


def _inputs(k3, seed=0):
    rng = np.random.default_rng(seed)
    feats = torch.from_numpy(rng.normal(size=(N, CIN)).astype(np.float32))
    rb = rng.integers(0, N, size=(M, k3)).astype(np.int32)
    rb[rng.random((M, k3)) < 0.6] = -1      # mostly missing, as real rulebooks
    rb[:20] = -1                            # rows with no neighbour at all
    w = torch.from_numpy(rng.normal(size=(k3, CIN, COUT)).astype(np.float32))
    dout = torch.from_numpy(rng.normal(size=(M, COUT)).astype(np.float32))
    return feats, torch.from_numpy(rb), w, dout


def _run(feats, rb, w, dout, cfg):
    f = feats.clone().requires_grad_(True)
    ww = w.clone().requires_grad_(True)
    out = gather_conv(f, rb, ww, cfg)
    out.backward(dout)
    return out.detach(), f.grad, ww.grad, type(out.grad_fn).__name__


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("k3", [27, 8])
def test_chunked_equals_whole_gather_forward_and_gradients(precision, k3):
    feats, rb, w, dout = _inputs(k3)
    whole = _run(feats, rb, w, dout, ConvConfig(precision))
    chunked = _run(feats, rb, w, dout, ConvConfig(precision, **FORCED))
    assert ConvConfig(precision, **FORCED).chunked(M, k3 * CIN)
    assert not ConvConfig(precision).chunked(M, k3 * CIN)
    assert chunked[3].startswith("_ChunkedGatherConv") and not whole[3].startswith("_Chunked")
    assert torch.equal(chunked[0], whole[0])
    assert torch.equal(chunked[1], whole[1])
    np.testing.assert_allclose(chunked[2].numpy(), whole[2].numpy(), rtol=1e-5, atol=1e-5)
    # without autograd the chunked forward is the same product
    with torch.no_grad():
        assert torch.equal(gather_conv(feats, rb, w, ConvConfig(precision, **FORCED)), whole[0])


def test_chunked_backward_takes_only_the_gradients_asked_for():
    feats, rb, w, dout = _inputs(27, seed=1)
    ww = w.clone().requires_grad_(True)
    out = gather_conv(feats, rb, ww, ConvConfig(**FORCED))
    out.backward(dout)
    assert feats.grad is None and ww.grad is not None
    f = feats.clone().requires_grad_(True)
    gather_conv(f, rb, w, ConvConfig(**FORCED)).backward(dout)
    assert f.grad is not None and w.grad is None


def test_bf16_chunked_rounds_the_operands_not_the_gradient():
    """d(out)/dW = the rounded gather; d(out)/dfeats goes straight through
    the rounding and stays fp32."""
    feats, rb, w, dout = _inputs(27, seed=2)
    out, df, dw, _ = _run(feats, rb, w, dout, ConvConfig("bfloat16", **FORCED))
    fb = feats.to(torch.bfloat16).float()
    wb = w.to(torch.bfloat16).float()
    g = sparse_ops._gather_rows(fb, rb)
    assert torch.equal(out, torch.cat([g[r : r + 64] @ wb.reshape(-1, COUT)
                                       for r in range(0, M, 64)]))
    np.testing.assert_allclose(dw.numpy(), (g.T @ dout).reshape(w.shape).numpy(),
                               rtol=1e-5, atol=1e-5)
    assert df.dtype == torch.float32
    assert not torch.equal(df, df.to(torch.bfloat16).float())   # not rounded


def _jax_chunks(m, width, row_chunk, chunk_bytes, monkeypatch):
    """Whether the JAX package's `_map_row_chunks` chunks [m, width] under
    these thresholds: the rows its function sees."""
    monkeypatch.setattr(jsparse, "_ROW_CHUNK", row_chunk)
    monkeypatch.setattr(jsparse, "_CHUNK_TRANSIENT_BYTES", chunk_bytes)
    seen = []
    jsparse._map_row_chunks(lambda a: seen.append(a.shape[0]) or a, m, width,
                            jnp.zeros((m, 1), jnp.int8))
    return seen[0] != m


@pytest.mark.parametrize("m,width,row_chunk,chunk_bytes", [
    (256, 216, 64, 0),          # chunks
    (256, 216, 64, 256 * 216 * 4),       # exactly the threshold: whole
    (256, 216, 64, 256 * 216 * 4 - 1),   # one byte past it: chunks
    (64, 216, 64, 0),           # not past the chunk
    (192, 216, 128, 0),         # not a multiple of the chunk: the port chunks, JAX not
    (1024, 8, 256, 1000),       # chunks
])
def test_chunking_rule_is_the_jax_rule(m, width, row_chunk, chunk_bytes, monkeypatch):
    """The JAX package's rule at its pow2 row counts; past the chunk, a row
    count that is not a multiple of it (an exact plan's level) chunks in
    the port, with a short last chunk, where JAX's gathers it whole."""
    cfg = ConvConfig(row_chunk=row_chunk, chunk_bytes=chunk_bytes)
    jax_rule = _jax_chunks(m, width, row_chunk, chunk_bytes, monkeypatch)
    ragged = m > row_chunk and m % row_chunk != 0 and m * width * 4 > chunk_bytes
    assert cfg.chunked(m, width) == (jax_rule or ragged)
    assert not (jax_rule and ragged)


def test_defaults_are_the_jax_thresholds_and_the_bench_tree_never_chunks():
    cfg = ConvConfig()
    assert (cfg.row_chunk, cfg.chunk_bytes) == (jsparse._ROW_CHUNK,
                                                jsparse._CHUNK_TRANSIENT_BYTES)
    assert memory.ROW_CHUNK == cfg.row_chunk
    # the widest gather of a 262,144-row batch at planes 8/16/32/64 (the
    # level-0 Tail, 27 x 16 channels) stays whole; the capacity that
    # ModelInference's 12 GiB budget admits (1,048,576) chunks it
    cap = memory.max_capacity_for_budget(12 << 30, (8, 16, 32, 64), factor=1.0, in_flight=2)
    assert cap == 1048576
    assert not cfg.chunked(262144, 27 * 16)
    assert cfg.chunked(cap, 27 * 16)
