"""Sparse convolution compute: gather -> one GEMM, no scatter.

Counterpart of `smart_tree_tpu/core/sparse_ops.py` (`gather_conv`, `linear`).
Every conv is written from the output side,

    out[M, Cout] = gather(feats)[M, K3*Cin] @ W[K3*Cin, Cout],

with missing neighbours gathering a zero row. `gather_conv` keeps the JAX
package's three routes in its order; the thresholds between them are the
H100's (chip_smoke.py phase 3 (b), NVIDIA H100 80GB HBM3, 700.00 W), not
the TPU's:

  1. the slab kernel (core/slab_conv.py) for k3 == 27 at bf16 precision
     inside its widths (`slab_conv.takes`: Cin up to 64, Cout 8/16/32/64;
     every conv of SmartTree's 8/16/32/64 planes, none of PTv3's CPE convs
     past 64 channels or its 125-column stem), whatever the row count:
     against route 3 it was faster at every count
     measured, 37 to 4,194,304 rows, at each (Cin, Cout) of the 8/16/32/64
     model, in three runs (0.039 to 0.116 ms against 0.157 to 0.522 ms at 37
     rows, 0.71 to 7.70 ms against 86 to 190 ms at 4,194,304). The JAX
     package's 65,536-row and capacity / 4 floors were measured on a TPU;
  2. the fused kernel (core/fused_conv.py) when opted in, at the sizes
     `fused_conv.should_use_fused` measured;
  3. otherwise gather plus torch.matmul in the precision asked for, in
     row chunks of `row_chunk` (32768) rows, the last one short, when one
     whole [M, K3*Cin] fp32 gather would pass `chunk_bytes` (1 GiB) and M
     is past `row_chunk`. Below that it is one gather and one matmul. (The
     JAX package's `_map_row_chunks` chunks only an M that is a multiple of
     the chunk, which its pow2 level capacities are; the port's exact plans
     give any M.)

A compact submanifold rulebook (`SubmRB9`, plans built with
subm_mode="z9") is checked before the three routes, as in the JAX package:
such a conv never takes a hand kernel (`_gather_conv_z`).

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
from .coords import INVALID_KEY
from .rulebook import SubmRB9

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
    fused:     take the fused gather-GEMM kernel where it is the faster.
    row_chunk, chunk_bytes: route 3 runs in chunks of `row_chunk` rows when
               a whole fp32 gather would pass `chunk_bytes` (`chunked`).
    """

    precision: str = "float32"
    fused: bool = False
    row_chunk: int = ROW_CHUNK
    chunk_bytes: int = CHUNK_BYTES

    def __post_init__(self):
        if self.precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {self.precision!r}")

    def chunked(self, m: int, width: int) -> bool:
        """Whether route 3 chunks an [m, width] gather: the rule of the JAX
        package's `_map_row_chunks` for any m, a multiple of the chunk or
        not."""
        return m * width * 4 > self.chunk_bytes and m > self.row_chunk


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
    rulebook [M, K3], w2 [K3 * Cin, Cout] -> [M, Cout], the last chunk
    short where M is not a multiple of `chunk`. It saves its inputs, not the gather: the forward writes each
    chunk's product into the output, the backward gathers each chunk again
    for dW += gather^T dout and sends dout w2^T back through the valid
    entries with `index_add_`, as `_GatherRows` does. The operands arrive
    rounded (`operand`), so the bf16 rule holds: rounded operands, the fp32
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


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """`x` as a product's operand: float32, rounded to bfloat16's values
    under "bfloat16"."""
    x = x.to(torch.float32)
    if precision == "bfloat16":
        return _RoundBf16.apply(x)
    return x


def gather_conv(
    feats: torch.Tensor,
    rulebook: torch.Tensor | SubmRB9,
    weights: torch.Tensor,
    cfg: ConvConfig = ConvConfig(),
) -> torch.Tensor:
    """Sparse conv from a gather rulebook.

    feats [N, Cin] (zero rows at padding), rulebook [M, K3] int32 rows into
    feats (-1 missing) or a SubmRB9 over feats' own table, weights
    [K3, Cin, Cout] -> [M, Cout].

    Routes 1 and 2 (the hand kernels) are taken only where no gradient is
    needed; inputs that require grad go down route 3."""
    if isinstance(rulebook, SubmRB9):
        return _gather_conv_z(feats, rulebook, weights, cfg)
    k3, cin, cout = weights.shape
    hand = not kernels.needs_grad(feats, weights)
    if hand and k3 == 27 and cfg.precision == "bfloat16" and slab_conv.takes(cin, cout):
        return slab_conv.slab_gather_conv(feats, rulebook, weights).to(feats.dtype)
    if hand and cfg.fused and fused_conv.should_use_fused(rulebook.shape[0], k3, cin, cout):
        return fused_conv.fused_gather_gemm(feats, rulebook, weights)
    chunked = cfg.chunked(rulebook.shape[0], k3 * cin)
    return _gather_gemm(feats, rulebook, weights, cfg, chunked)


def _gather_gemm(feats, rulebook, weights, cfg: ConvConfig, chunked: bool) -> torch.Tensor:
    """Route 3: gather(feats by rulebook) @ W in cfg's precision, in row
    chunks when `chunked`."""
    k3, cin, cout = weights.shape
    f = operand(feats, cfg.precision)
    w2 = operand(weights, cfg.precision).reshape(k3 * cin, cout)
    if chunked:
        return _ChunkedGatherConv.apply(f, rulebook, w2, cfg.row_chunk).to(feats.dtype)
    return (_GatherRows.apply(f, rulebook) @ w2).to(feats.dtype)


def _window_rulebook(rb: SubmRB9, pos: torch.Tensor, qkey: torch.Tensor) -> torch.Tensor:
    """The [m, 27] gather rulebook that rows `pos` / `qkey` [m, 9] of a
    SubmRB9 stand for, in kernel_offsets(3) order ((dx, dy) kx-major, dz
    fastest).

    For each (dx, dy) column the keys of the 3-row window [pos-1, pos+1]
    (INVALID_KEY sentinels past either end) are matched against the query
    key walked by dz in {-1, 0, +1}; the matching row, or -1. Keys hold
    uint32 values in int64, so q - 1 is wrapped mod 2^32 as the JAX
    package's uint32 sum is, and the z-field edges are guarded as there
    (at z = 0 a -1 borrows into y, at z = zmax - 1 a +1 may carry into it)."""
    keys = rb.keys
    n = keys.shape[0]
    dev = keys.device
    inv = keys.new_full((1,), INVALID_KEY)
    kpad = torch.cat([inv, keys, inv])                      # row r at r + 1
    posc = pos.long().clamp(0, n - 1)[..., None]            # [m, 9, 1]
    kw = kpad[posc + torch.arange(3, device=dev)]           # [m, 9, 3 slots]: rows pos-1+s
    dz = torch.tensor([-1, 0, 1], dtype=torch.int64, device=dev)
    tgt = (qkey[..., None] + dz) & 0xFFFFFFFF               # [m, 9, 3 dz]
    zq = qkey & ((1 << rb.zbits) - 1)
    ok = torch.stack([zq >= 1, torch.ones_like(zq, dtype=torch.bool), zq + 1 < rb.zmax],
                     dim=-1) & (qkey != INVALID_KEY)[..., None]
    row = torch.full_like(tgt, -1)
    for s in (2, 1, 0):                                     # the first matching slot wins
        row = torch.where(kw[..., s : s + 1] == tgt, posc + (s - 1), row)
    hit = ok & (row >= 0) & (row < n)
    return torch.where(hit, row, -1).to(torch.int32).reshape(pos.shape[0], 27)


def _gather_conv_z(feats: torch.Tensor, rb: SubmRB9, weights: torch.Tensor,
                   cfg: ConvConfig) -> torch.Tensor:
    """Submanifold conv from the compact z-window rulebook (the JAX
    package's `_gather_conv_z`).

    The JAX form gathers nine 3*Cin-wide windows [pos-1, pos+1] of feats and
    routes their slots to the dz columns by a key-match product before one
    GEMM. Routing the window's row numbers instead of its rows gives the
    same product with no [M, 9, 3, 3, Cin] routing operands: the matched
    rows make a 27-column rulebook (`_window_rulebook`, equal to the full
    subm rulebook entry for entry), which route 3 gathers. So the gradient is
    route 3's: only matched entries travel back, through `index_add_`, and
    no hand kernel is taken. Rows are chunked by route 3's rule
    (`ConvConfig.chunked` over pos / qkey at width 27 * Cin, the JAX
    package's `_map_row_chunks` at its pow2 sizes); the window rulebook is
    then made chunk by chunk too."""
    k3, cin, _ = weights.shape
    if k3 != 27:
        raise ValueError(f"a SubmRB9 rulebook needs 27 kernel offsets, got {k3}")
    m = rb.pos.shape[0]
    chunked = cfg.chunked(m, 27 * cin)
    step = cfg.row_chunk if chunked else max(m, 1)
    rulebook = torch.cat([_window_rulebook(rb, rb.pos[r : r + step], rb.qkey[r : r + step])
                          for r in range(0, max(m, 1), step)])
    return _gather_gemm(feats, rulebook, weights, cfg, chunked)


def linear(feats: torch.Tensor, weights: torch.Tensor, precision: str = "float32") -> torch.Tensor:
    """Per-voxel linear layer (1x1x1 conv, bias-free): [N, Cin] @ [Cin, Cout]."""
    return (operand(feats, precision) @ operand(weights, precision)).to(feats.dtype)
