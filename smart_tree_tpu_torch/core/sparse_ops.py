"""Sparse convolution compute: gather -> one GEMM, no scatter.

Counterpart of `smart_tree_tpu/core/sparse_ops.py` (`gather_conv`, `linear`).
Every conv is written from the output side,

    out[M, Cout] = gather(feats)[M, K3*Cin] @ W[K3*Cin, Cout],

with missing neighbours gathering a zero row. `gather_conv` keeps the JAX
dispatch rule for rule:

  1. the slab kernel (core/slab_conv.py) for k3 == 27, rows >=
     max(65536, cap_hint // 4) and bf16 precision;
  2. the fused kernel (core/fused_conv.py) when opted in and the table
     holds at most 8 MiB;
  3. otherwise gather plus torch.matmul in the precision asked for, in
     row chunks where the JAX package's `_map_row_chunks` chunks: when one
     whole [M, K3*Cin] fp32 gather would pass `chunk_bytes` (1 GiB), M is
     past `row_chunk` (32768) and a multiple of it. Below that it is one
     gather and one matmul.

Both kernels are forward-only, as their JAX counterparts are. A conv whose
`feats` or `weights` require a gradient (under grad mode) therefore takes
route 3 whatever its shape: autograd differentiates the gather and the
matmul (the chunked form has its own backward, which gathers each chunk
again, so that only one chunk's gather is alive in either direction). At
bf16 precision the forward operands are rounded as always; the
backward products take the rounded operands and the fp32 incoming gradient,
and gradients stay fp32.

Precision is an argument, not an ambient setting: "bfloat16" rounds both
operands to bf16 and accumulates in fp32 with an fp32 result, as XLA does
under `jax.default_matmul_precision('bfloat16')`; "float32" is a full fp32
product. On CUDA the fp32 product must not run in TF32, so the port's entry
points set `torch.backends.cuda.matmul.allow_tf32 = False` and
`torch.backends.cudnn.allow_tf32 = False` (infer/inference.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import fused_conv, kernels, slab_conv

# Rulebooks at least this tall take the slab kernel (the JAX package's
# measured threshold); the batch capacity scales it up past 262,144 rows.
SLAB_MIN_ROWS = 65536

PRECISIONS = ("float32", "bfloat16")

# Route 3's row chunk and the gather size past which it chunks: the JAX
# package's `_ROW_CHUNK` and `_CHUNK_TRANSIENT_BYTES` (core/memory.py counts
# the transients by them).
ROW_CHUNK = 32768
CHUNK_BYTES = 1 << 30


@dataclass(frozen=True)
class ConvConfig:
    """How the convs of one forward run.

    precision: "float32" or "bfloat16" (operand rounding of every product).
    cap_hint:  the batch's voxel capacity; the slab row threshold is
               max(SLAB_MIN_ROWS, cap_hint // 4).
    fused:     take the fused gather-GEMM kernel where the table fits.
    row_chunk, chunk_bytes: route 3 runs in chunks of `row_chunk` rows when
               a whole fp32 gather would pass `chunk_bytes` (`chunked`).
    """

    precision: str = "float32"
    cap_hint: int = 0
    fused: bool = False
    row_chunk: int = ROW_CHUNK
    chunk_bytes: int = CHUNK_BYTES

    def __post_init__(self):
        if self.precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {self.precision!r}")

    @property
    def slab_min_rows(self) -> int:
        return max(SLAB_MIN_ROWS, self.cap_hint // 4)

    def chunked(self, m: int, width: int) -> bool:
        """Whether route 3 chunks an [m, width] gather: the rule of the JAX
        package's `_map_row_chunks`."""
        return (m * width * 4 > self.chunk_bytes and m > self.row_chunk
                and m % self.row_chunk == 0)


class _RoundBf16(torch.autograd.Function):
    """fp32 -> nearest bf16 -> fp32 with the gradient passed straight through.
    Differentiating `.to(bfloat16).to(float32)` itself would round the
    gradient to bf16 on its way back."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(torch.float32)

    @staticmethod
    def backward(ctx, grad):
        return grad


def _gather_rows(feats: torch.Tensor, rulebook: torch.Tensor) -> torch.Tensor:
    """Rows of `feats` [N, Cin] by a rulebook [M, K3], a zero row where the
    rulebook holds -1 -> [M, K3 * Cin]."""
    n, cin = feats.shape
    fe = torch.cat([feats, feats.new_zeros((1, cin))])
    idx = torch.where(rulebook >= 0, rulebook, n).long()
    return fe[idx].reshape(rulebook.shape[0], rulebook.shape[1] * cin)


class _GatherRows(torch.autograd.Function):
    """`_gather_rows` with its own backward, because autograd's for `fe[idx]` accumulates every
    missing entry's (zero) gradient into the one shared zero row, and the
    rulebooks are mostly missing entries: on the card that accumulation walks
    the duplicates of an index one after the other and takes seconds a conv.
    Here only the valid entries travel back, compacted, through `index_add_`
    (at most K3 of them meet in a row)."""

    @staticmethod
    def forward(ctx, feats, rulebook):
        ctx.save_for_backward(rulebook)
        ctx.n = feats.shape[0]
        return _gather_rows(feats, rulebook)

    @staticmethod
    def backward(ctx, grad):
        (rulebook,) = ctx.saved_tensors
        m, k3 = rulebook.shape
        valid = rulebook >= 0
        grad = grad.reshape(m, k3, -1)
        out = grad.new_zeros((ctx.n, grad.shape[2]))
        out.index_add_(0, rulebook[valid].long(), grad[valid])
        return out, None


class _ChunkedGatherConv(torch.autograd.Function):
    """gather(feats by rulebook) @ w2 over row chunks: feats [N, Cin],
    rulebook [M, K3], w2 [K3 * Cin, Cout] -> [M, Cout], with M a multiple of
    `chunk`. It saves its inputs, not the gather: the forward writes each
    chunk's product into the output, the backward gathers each chunk again
    for dW += gather^T dout and sends dout w2^T back through the valid
    entries with `index_add_`, as `_GatherRows` does. The operands arrive
    rounded (`_operand`), so the bf16 rule holds: rounded operands, the fp32
    incoming gradient, fp32 gradients."""

    @staticmethod
    def forward(ctx, feats, rulebook, w2, chunk):
        ctx.save_for_backward(feats, rulebook, w2)
        ctx.chunk = chunk
        m = rulebook.shape[0]
        out = feats.new_empty((m, w2.shape[1]))
        for r in range(0, m, chunk):
            out[r : r + chunk] = _gather_rows(feats, rulebook[r : r + chunk]) @ w2
        return out

    @staticmethod
    def backward(ctx, grad):
        feats, rulebook, w2 = ctx.saved_tensors
        n, cin = feats.shape
        need_f, _, need_w, _ = ctx.needs_input_grad
        dfeats = grad.new_zeros((n, cin)) if need_f else None
        dw = torch.zeros_like(w2) if need_w else None
        for r in range(0, rulebook.shape[0], ctx.chunk):
            rb, g = rulebook[r : r + ctx.chunk], grad[r : r + ctx.chunk]
            if need_w:
                dw += _gather_rows(feats, rb).T @ g
            if need_f:
                valid = rb >= 0
                dg = (g @ w2.T).reshape(rb.shape[0], rb.shape[1], cin)
                dfeats.index_add_(0, rb[valid].long(), dg[valid])
        return dfeats, None, dw, None


def _operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    x = x.to(torch.float32)
    if precision == "bfloat16":
        return _RoundBf16.apply(x)
    return x


def gather_conv(
    feats: torch.Tensor,
    rulebook: torch.Tensor,
    weights: torch.Tensor,
    cfg: ConvConfig = ConvConfig(),
) -> torch.Tensor:
    """Sparse conv from a gather rulebook.

    feats [N, Cin] (zero rows at padding), rulebook [M, K3] int32 rows into
    feats (-1 missing), weights [K3, Cin, Cout] -> [M, Cout].

    Routes 1 and 2 (the hand kernels) are taken only where no gradient is
    needed; inputs that require grad go down route 3."""
    k3, cin, cout = weights.shape
    hand = not kernels.needs_grad(feats, weights)
    if hand and k3 == 27 and rulebook.shape[0] >= cfg.slab_min_rows and cfg.precision == "bfloat16":
        return slab_conv.slab_gather_conv(feats, rulebook, weights).to(feats.dtype)
    if hand and cfg.fused and fused_conv.should_use_fused(rulebook.shape[0], k3, cin, cout):
        return fused_conv.fused_gather_gemm(feats, rulebook, weights)
    f = _operand(feats, cfg.precision)
    w2 = _operand(weights, cfg.precision).reshape(k3 * cin, cout)
    if cfg.chunked(rulebook.shape[0], k3 * cin):
        return _ChunkedGatherConv.apply(f, rulebook, w2, cfg.row_chunk).to(feats.dtype)
    return (_GatherRows.apply(f, rulebook) @ w2).to(feats.dtype)


def linear(feats: torch.Tensor, weights: torch.Tensor, precision: str = "float32") -> torch.Tensor:
    """Per-voxel linear layer (1x1x1 conv, bias-free): [N, Cin] @ [Cin, Cout]."""
    return (_operand(feats, precision) @ _operand(weights, precision)).to(feats.dtype)
