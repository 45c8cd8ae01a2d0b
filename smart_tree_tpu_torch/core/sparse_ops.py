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
  3. otherwise gather plus torch.matmul in the precision asked for.

Both kernels are forward-only, as their JAX counterparts are. A conv whose
`feats` or `weights` require a gradient (under grad mode) therefore takes
route 3 whatever its shape: autograd differentiates the gather and the
matmul. At bf16 precision the forward operands are rounded as always; the
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


@dataclass(frozen=True)
class ConvConfig:
    """How the convs of one forward run.

    precision: "float32" or "bfloat16" (operand rounding of every product).
    cap_hint:  the batch's voxel capacity; the slab row threshold is
               max(SLAB_MIN_ROWS, cap_hint // 4).
    fused:     take the fused gather-GEMM kernel where the table fits.
    """

    precision: str = "float32"
    cap_hint: int = 0
    fused: bool = False

    def __post_init__(self):
        if self.precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {self.precision!r}")

    @property
    def slab_min_rows(self) -> int:
        return max(SLAB_MIN_ROWS, self.cap_hint // 4)


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


class _GatherRows(torch.autograd.Function):
    """Rows of `feats` [N, Cin] by a rulebook [M, K3], a zero row where the
    rulebook holds -1 -> [M, K3 * Cin].

    Its own backward, because autograd's for `fe[idx]` accumulates every
    missing entry's (zero) gradient into the one shared zero row, and the
    rulebooks are mostly missing entries: on the card that accumulation walks
    the duplicates of an index one after the other and takes seconds a conv.
    Here only the valid entries travel back, compacted, through `index_add_`
    (at most K3 of them meet in a row)."""

    @staticmethod
    def forward(ctx, feats, rulebook):
        n, cin = feats.shape
        ctx.save_for_backward(rulebook)
        ctx.n = n
        fe = torch.cat([feats, feats.new_zeros((1, cin))])
        idx = torch.where(rulebook >= 0, rulebook, n).long()
        return fe[idx].reshape(rulebook.shape[0], rulebook.shape[1] * cin)

    @staticmethod
    def backward(ctx, grad):
        (rulebook,) = ctx.saved_tensors
        m, k3 = rulebook.shape
        valid = rulebook >= 0
        grad = grad.reshape(m, k3, -1)
        out = grad.new_zeros((ctx.n, grad.shape[2]))
        out.index_add_(0, rulebook[valid].long(), grad[valid])
        return out, None


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
    g = _GatherRows.apply(_operand(feats, cfg.precision), rulebook)
    w2 = _operand(weights, cfg.precision).reshape(k3 * cin, cout)
    return (g @ w2).to(feats.dtype)


def linear(feats: torch.Tensor, weights: torch.Tensor, precision: str = "float32") -> torch.Tensor:
    """Per-voxel linear layer (1x1x1 conv, bias-free): [N, Cin] @ [Cin, Cout]."""
    return (_operand(feats, precision) @ _operand(weights, precision)).to(feats.dtype)
