"""Slab gather-conv: the Hopper port of the Pallas kernel
`smart_tree_tpu/core/pallas_slab.py::slab_gather_conv`.

    out[M, Cout] = sum_k bf16(feats[rb[i, k]]) . bf16(W[k])   (fp32 accumulation)

Each rulebook column is monotone over the sorted keys, so a tile of
consecutive output rows reads, per (dx, dy) group of three dz columns, one
contiguous slab of the table. `_precompute` (plain torch ops, the contract of
the JAX `_precompute`) gives per tile and group the block-aligned slab start,
the chunk count, and the slab-relative rulebook; the CUDA kernel
(csrc/slab_conv.cu) stages each slab in shared memory as bf16 and reads rows
from it by relative index. See the source note there for its design and
bound.

`slab_gather_conv` launches the kernel on CUDA tensors and raises on input
the kernel does not take; on CPU tensors it runs `slab_gather_conv_plain`,
the same function in plain PyTorch (gather, bf16-rounded operands, fp32
matmul), which the tests hold against the JAX kernel in interpret mode.
"""

from __future__ import annotations

import torch

from . import kernels

SLAB_ROWS = 512  # table rows per staged slab chunk
BLOCK_ROWS = 32  # slab starts are rounded down to this many rows


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round fp32 to bf16 (nearest even) and back."""
    return x.to(torch.bfloat16).to(torch.float32)


def _precompute(rulebook: torch.Tensor, tile: int, slab: int, blk: int = 128):
    """Per-(tile, xy-group) slab starts (rounded down to `blk` rows, in
    block units) and chunk counts, plus the rulebook rebased to
    slab-relative rows.

    rulebook: [M, 27] int32 (-1 missing), columns k = 9*kx + 3*ky + kz, so
    columns [3g, 3g+3) share the (dx, dy) group g. Returns (rel [M_pad, 27]
    int32, starts_b [tiles, 9] int32, nchunks [tiles, 9] int32, tiles)."""
    m, k3 = rulebook.shape
    assert k3 == 27
    tiles = -(-m // tile)
    m_pad = tiles * tile
    if m_pad != m:
        rulebook = torch.cat(
            [rulebook, rulebook.new_full((m_pad - m, 27), -1)], dim=0
        )
    rbt = rulebook.reshape(tiles, tile, 9, 3)
    valid = rbt >= 0
    start = torch.where(valid, rbt, 2**30).amin(dim=(1, 3))
    any_valid = valid.to(torch.int8).amax(dim=(1, 3)) > 0
    start = torch.where(any_valid, start, 0)
    start = (start // blk) * blk
    maxrel = torch.where(valid, rbt, -1).amax(dim=(1, 3)) - start
    nchunks = torch.where(any_valid, maxrel // slab + 1, 0).to(torch.int32)
    rel = torch.where(valid, rbt - start[:, None, :, None], -1)
    return (
        rel.reshape(m_pad, 27).to(torch.int32),
        (start // blk).to(torch.int32),
        nchunks,
        tiles,
    )


def slab_gather_conv_plain(
    feats: torch.Tensor, rulebook: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version: gather with a zero row for -1, operands
    rounded to bf16, fp32 matmul."""
    n, cin = feats.shape
    m, k3 = rulebook.shape
    cout = weights.shape[-1]
    fe = torch.cat([_bf16(feats.float()), feats.new_zeros((1, cin), dtype=torch.float32)])
    idx = torch.where(rulebook >= 0, rulebook, n).long()
    g = fe[idx].reshape(m, k3 * cin)
    return g @ _bf16(weights.float()).reshape(k3 * cin, cout)


def _check_cuda(feats, rulebook, weights) -> None:
    dev = feats.device
    for name, t in (("rulebook", rulebook), ("weights", weights)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, feats on {dev}")
    if feats.dtype != torch.float32 or feats.dim() != 2 or not feats.is_contiguous():
        raise ValueError("feats must be a contiguous [N, Cin] float32 tensor")
    n, cin = feats.shape
    if cin % 8 != 0 or cin > 64 or feats.data_ptr() % 16 != 0:
        raise ValueError(f"slab kernel takes Cin a multiple of 8 up to 64 (got {cin})")
    if (
        rulebook.dtype != torch.int32
        or rulebook.dim() != 2
        or rulebook.shape[1] != 27
        or not rulebook.is_contiguous()
    ):
        raise ValueError("rulebook must be a contiguous [M, 27] int32 tensor")
    if (
        weights.dtype != torch.float32
        or weights.dim() != 3
        or tuple(weights.shape[:2]) != (27, cin)
        or not weights.is_contiguous()
    ):
        raise ValueError(f"weights must be a contiguous [27, {cin}, Cout] float32 tensor")
    if weights.shape[2] not in (8, 16, 32, 64):
        raise ValueError(f"slab kernel takes Cout in 8/16/32/64 (got {weights.shape[2]})")


def _launch(feats, rel, starts, nchunks, tiles, weights, out, slab) -> None:
    """One launch of the CUDA kernel on precomputed inputs (counts nothing)."""
    lib = kernels.load()
    n, cin = feats.shape
    rc = lib.st_slab_conv(
        feats.data_ptr(), n, cin, rel.data_ptr(), starts.data_ptr(),
        nchunks.data_ptr(), tiles, weights.data_ptr(), weights.shape[2],
        out.data_ptr(), out.shape[0], slab,
        torch.cuda.current_stream(feats.device).cuda_stream,
    )
    kernels.check(rc, "st_slab_conv")


def prepare(rulebook: torch.Tensor, cout: int):
    """`_precompute` at the kernel's tile for this Cout: (rel, starts in
    table rows, nchunks, tiles)."""
    tile = kernels.load().st_slab_conv_tile(cout)
    rel, starts_b, nchunks, tiles = _precompute(rulebook, tile, SLAB_ROWS, BLOCK_ROWS)
    return rel, (starts_b * BLOCK_ROWS).contiguous(), nchunks.contiguous(), tiles


def slab_gather_conv(
    feats: torch.Tensor, rulebook: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """out[M, Cout] = gather(feats by rulebook) @ weights at bf16 operand
    precision with fp32 accumulation. feats [N, Cin] float32, rulebook
    [M, 27] int32 (-1 missing, columns monotone), weights [27, Cin, Cout].
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    if feats.device.type == "cpu":
        if rulebook.device.type != "cpu" or weights.device.type != "cpu":
            raise ValueError("feats is on the CPU but rulebook or weights are not")
        return slab_gather_conv_plain(feats, rulebook, weights)
    if feats.device.type != "cuda":
        raise ValueError(f"slab_gather_conv runs on cuda or cpu, not {feats.device}")
    _check_cuda(feats, rulebook, weights)
    m = rulebook.shape[0]
    out = torch.empty((m, weights.shape[2]), dtype=torch.float32, device=feats.device)
    if m == 0:
        return out
    rel, starts, nchunks, tiles = prepare(rulebook, weights.shape[2])
    _launch(feats, rel, starts, nchunks, tiles, weights, out, SLAB_ROWS)
    slab_gather_conv.launches += 1
    return out


slab_gather_conv.launches = 0
