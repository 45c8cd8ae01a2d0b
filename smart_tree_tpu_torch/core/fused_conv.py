"""Fused gather-GEMM: the Hopper port of the Pallas kernel
`smart_tree_tpu/core/pallas_ops.py::fused_gather_gemm`.

    out[M, Cout] = gather(feats U zero row, rb)[M, K3 * Cin] @ W[K3 * Cin, Cout]

for any K3, fp32 with fp32 accumulation, output in the feats dtype. The
CUDA kernel (csrc/fused_conv.cu) compacts, per 128-row output tile and
kernel offset, the rows that have a neighbour, gathers only those table rows
into shared memory with asynchronous copies one pass ahead of the fp32 FMAs
(a register block of up to 4 rows by 8 columns per thread), and sums into
the tile's accumulators in shared memory; see the source note there for its
design and bound.

`fused_gather_gemm` launches the kernel on CUDA tensors and raises on input
the kernel does not take; on CPU tensors it runs `fused_gather_gemm_plain`
(gather plus fp32 matmul). `should_use_fused` is the JAX package's gate
(`pallas_ops.should_use_pallas`): the table must hold at most 8 MiB.
"""

from __future__ import annotations

import torch

from . import kernels

_TABLE_BYTES = 8 * 1024 * 1024


def should_use_fused(m: int, k3: int, cin: int, cout: int) -> bool:
    """The JAX package's size gate, as it states it: m * cin * 4 <= 8 MiB
    (m is the rulebook's row count)."""
    return m * cin * 4 <= _TABLE_BYTES


def fused_gather_gemm_plain(
    feats: torch.Tensor, rulebook: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version: gather with a zero row for -1, fp32 matmul."""
    n, cin = feats.shape
    m, k3 = rulebook.shape
    cout = weights.shape[-1]
    fe = torch.cat([feats, feats.new_zeros((1, cin))])
    idx = torch.where(rulebook >= 0, rulebook, n).long()
    g = fe[idx].reshape(m, k3 * cin).float()
    out = g @ weights.float().reshape(k3 * cin, cout)
    return out.to(feats.dtype)


def _check_cuda(feats, rulebook, weights) -> None:
    dev = feats.device
    for name, t in (("rulebook", rulebook), ("weights", weights)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, feats on {dev}")
    if feats.dtype != torch.float32 or feats.dim() != 2 or not feats.is_contiguous():
        raise ValueError("feats must be a contiguous [N, Cin] float32 tensor")
    n, cin = feats.shape
    if cin % 4 != 0 or cin > 128 or feats.data_ptr() % 16 != 0:
        raise ValueError(f"fused kernel takes Cin a multiple of 4 up to 128 (got {cin})")
    if rulebook.dtype != torch.int32 or rulebook.dim() != 2 or not rulebook.is_contiguous():
        raise ValueError("rulebook must be a contiguous [M, K3] int32 tensor")
    k3 = rulebook.shape[1]
    if (
        weights.dtype != torch.float32
        or weights.dim() != 3
        or tuple(weights.shape[:2]) != (k3, cin)
        or not weights.is_contiguous()
        or weights.data_ptr() % 16 != 0
    ):
        raise ValueError(
            f"weights must be a contiguous, 16-byte-aligned [{k3}, {cin}, Cout] float32 tensor"
        )
    if weights.shape[2] not in (8, 16, 32, 64):
        raise ValueError(f"fused kernel takes Cout in 8/16/32/64 (got {weights.shape[2]})")


def _launch(feats, rulebook, weights, out) -> None:
    """One launch of the CUDA kernel (counts nothing)."""
    lib = kernels.load()
    n, cin = feats.shape
    m, k3 = rulebook.shape
    rc = lib.st_fused_conv(
        feats.data_ptr(), n, cin, rulebook.data_ptr(), m, k3,
        weights.data_ptr(), weights.shape[2], out.data_ptr(),
        torch.cuda.current_stream(feats.device).cuda_stream,
    )
    kernels.check(rc, "st_fused_conv")


def fused_gather_gemm(
    feats: torch.Tensor, rulebook: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """out[M, Cout] = gather(feats by rulebook) @ weights in fp32.
    feats [N, Cin] float32, rulebook [M, K3] int32 (-1 missing), weights
    [K3, Cin, Cout]. CUDA tensors launch the kernel; CPU tensors take the
    plain version. Forward only: raises when autograd would need a gradient
    from it."""
    kernels.refuse_grad("fused_gather_gemm", feats, weights)
    if feats.device.type == "cpu":
        if rulebook.device.type != "cpu" or weights.device.type != "cpu":
            raise ValueError("feats is on the CPU but rulebook or weights are not")
        return fused_gather_gemm_plain(feats, rulebook, weights)
    if feats.device.type != "cuda":
        raise ValueError(f"fused_gather_gemm runs on cuda or cpu, not {feats.device}")
    _check_cuda(feats, rulebook, weights)
    m = rulebook.shape[0]
    out = torch.empty((m, weights.shape[2]), dtype=torch.float32, device=feats.device)
    if m == 0:
        return out
    _launch(feats, rulebook, weights, out)
    fused_gather_gemm.launches += 1
    return out


fused_gather_gemm.launches = 0
