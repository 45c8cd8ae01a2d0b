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

from . import fused_conv, slab_conv

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


def _operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    x = x.to(torch.float32)
    if precision == "bfloat16":
        return x.to(torch.bfloat16).to(torch.float32)
    return x


def gather_conv(
    feats: torch.Tensor,
    rulebook: torch.Tensor,
    weights: torch.Tensor,
    cfg: ConvConfig = ConvConfig(),
) -> torch.Tensor:
    """Sparse conv from a gather rulebook.

    feats [N, Cin] (zero rows at padding), rulebook [M, K3] int32 rows into
    feats (-1 missing), weights [K3, Cin, Cout] -> [M, Cout]."""
    n = feats.shape[0]
    k3, cin, cout = weights.shape
    if k3 == 27 and rulebook.shape[0] >= cfg.slab_min_rows and cfg.precision == "bfloat16":
        return slab_conv.slab_gather_conv(feats, rulebook, weights).to(feats.dtype)
    if cfg.fused and fused_conv.should_use_fused(rulebook.shape[0], k3, cin, cout):
        return fused_conv.fused_gather_gemm(feats, rulebook, weights)
    fe = torch.cat([_operand(feats, cfg.precision), feats.new_zeros((1, cin), dtype=torch.float32)])
    idx = torch.where(rulebook >= 0, rulebook, n).long()
    g = fe[idx].reshape(rulebook.shape[0], k3 * cin)
    w2 = _operand(weights, cfg.precision).reshape(k3 * cin, cout)
    return (g @ w2).to(feats.dtype)


def linear(feats: torch.Tensor, weights: torch.Tensor, precision: str = "float32") -> torch.Tensor:
    """Per-voxel linear layer (1x1x1 conv, bias-free): [N, Cin] @ [Cin, Cout]."""
    return (_operand(feats, precision) @ _operand(weights, precision)).to(feats.dtype)
