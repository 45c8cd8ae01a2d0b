"""Slab gather-conv: the Hopper port of the Pallas kernel
`smart_tree_tpu/core/pallas_slab.py::slab_gather_conv`.

    out[M, Cout] = sum_k bf16(feats[rb[i, k]]) . bf16(W[k])   (fp32 accumulation)

Each rulebook column is monotone over the sorted keys, so a tile of
consecutive output rows reads, per (dx, dy) group of three dz columns, one
contiguous slab of the table. The CUDA kernel (csrc/slab_conv.cu) takes the
raw rulebook: a CTA of TILE_ROWS output rows finds each group's slab bounds
itself (start rounded down to BLOCK_ROWS rows, chunks of `slab_rows(Cin)` rows),
stages the slab in shared memory as bf16 and feeds the gathered rows to the
bf16 tensor cores. See the source note there for its design and bound.

`_precompute` (plain torch ops, equal to the JAX `_precompute`) states the
contract those in-kernel bounds follow; `slab_gather_conv_tiled` is a torch-op
emulation of the kernel's tile walk. Both serve the tests only.

`slab_gather_conv` launches the kernel on CUDA tensors and raises on input
the kernel does not take; on CPU tensors it runs `slab_gather_conv_plain`,
the same function in plain PyTorch (gather, bf16-rounded operands, fp32
matmul), which the tests hold against the JAX kernel in interpret mode.
"""

from __future__ import annotations

import torch

from . import kernels

TILE_ROWS = 128  # output rows per CTA, whatever Cout is (kTile in the source)
BLOCK_ROWS = 8  # slab starts are rounded down to this many rows


MAX_CIN = 64  # the widest input the kernel stages (Cin a multiple of 8 up to it)
COUTS = (8, 16, 32, 64)  # the output widths it is built for


def takes(cin: int, cout: int) -> bool:
    """Whether a conv of these widths is inside the kernel's envelope
    (`_check_cuda` raises past it): Cin up to MAX_CIN, Cout one of COUTS."""
    return cin <= MAX_CIN and cout in COUTS


def slab_rows(cin: int) -> int:
    """Table rows per staged slab chunk: 256, and 128 past Cin 32, where the
    smaller staging buffers measured faster on the H100 (two CTAs share an
    SM's shared memory up to Cout 32)."""
    return 256 if cin <= 32 else 128


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
    if cin % 8 != 0 or cin > MAX_CIN or feats.data_ptr() % 16 != 0:
        raise ValueError(f"slab kernel takes Cin a multiple of 8 up to 64 (got {cin})")
    if (
        rulebook.dtype != torch.int32
        or rulebook.dim() != 2
        or rulebook.shape[1] != 27
        or not rulebook.is_contiguous()
        or rulebook.data_ptr() % 16 != 0
    ):
        raise ValueError("rulebook must be a contiguous, 16-byte-aligned [M, 27] int32 tensor")
    if (
        weights.dtype != torch.float32
        or weights.dim() != 3
        or tuple(weights.shape[:2]) != (27, cin)
        or not weights.is_contiguous()
        or weights.data_ptr() % 16 != 0
    ):
        raise ValueError(f"weights must be a contiguous [27, {cin}, Cout] float32 tensor")
    if weights.shape[2] not in COUTS:
        raise ValueError(f"slab kernel takes Cout in 8/16/32/64 (got {weights.shape[2]})")


def _tile_bounds(rb_tile: torch.Tensor, blk: int):
    """Slab bounds of one tile as the kernel derives them from the raw
    rulebook rows: per (dx, dy) group the first referenced table row rounded
    down to `blk`, and the rows spanned up to the last referenced one (0 for
    a group without a valid entry). rb_tile [rows, 27] -> two lists of 9."""
    starts, spans = [], []
    for g in range(9):
        e = rb_tile[:, 3 * g : 3 * g + 3]
        e = e[e >= 0]
        if e.numel() == 0:
            starts.append(0)
            spans.append(0)
            continue
        start = int(e.min()) // blk * blk
        starts.append(start)
        spans.append(int(e.max()) - start + 1)
    return starts, spans


def slab_gather_conv_tiled(
    feats: torch.Tensor,
    rulebook: torch.Tensor,
    weights: torch.Tensor,
    tile: int = TILE_ROWS,
    slab: int = 256,
    blk: int = BLOCK_ROWS,
) -> torch.Tensor:
    """Torch-op emulation of the CUDA kernel's tile walk, for the tests: per
    tile the slab bounds from the raw rulebook, per group and chunk a slab
    of the table rounded to bf16, rows gathered from it by relative index
    (a zero row for misses and for entries outside the chunk), bf16 weights,
    fp32 sum. Nothing on the main path calls it."""
    n, cin = feats.shape
    m = rulebook.shape[0]
    cout = weights.shape[-1]
    w = _bf16(weights.float()).reshape(9, 3 * cin, cout)
    zero = feats.new_zeros((1, cin), dtype=torch.float32)
    out = feats.new_zeros((m, cout), dtype=torch.float32)
    for r0 in range(0, m, tile):
        rb_t = rulebook[r0 : r0 + tile]
        starts, spans = _tile_bounds(rb_t, blk)
        acc = out[r0 : r0 + tile]
        for g in range(9):
            e = rb_t[:, 3 * g : 3 * g + 3].long()
            for c in range(-(-spans[g] // slab)):
                base = starts[g] + c * slab
                rows = min(slab, spans[g] - c * slab, n - base)
                staged = torch.cat([_bf16(feats[base : base + rows].float()), zero])
                rel = e - base
                ok = (e >= 0) & (rel >= 0) & (rel < rows)
                a = staged[torch.where(ok, rel, rows)].reshape(-1, 3 * cin)
                acc += a @ w[g]
    return out


def _launch(feats, rulebook, weights, scratch, out) -> None:
    """One launch of the CUDA kernel on the raw rulebook (counts nothing)."""
    lib = kernels.load()
    n, cin = feats.shape
    rc = lib.st_slab_conv(
        feats.data_ptr(), n, cin, rulebook.data_ptr(), rulebook.shape[0],
        weights.data_ptr(), weights.shape[2], scratch.data_ptr(), out.data_ptr(),
        slab_rows(cin), BLOCK_ROWS, torch.cuda.current_stream(feats.device).cuda_stream,
    )
    kernels.check(rc, "st_slab_conv")


def _scratch(weights: torch.Tensor) -> torch.Tensor:
    """Room for the kernel's bf16 weight fragments."""
    _, cin, cout = weights.shape
    nbytes = kernels.load().st_slab_conv_scratch_bytes(cin, cout)
    return torch.empty(nbytes, dtype=torch.uint8, device=weights.device)


def slab_gather_conv(
    feats: torch.Tensor, rulebook: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """out[M, Cout] = gather(feats by rulebook) @ weights at bf16 operand
    precision with fp32 accumulation. feats [N, Cin] float32, rulebook
    [M, 27] int32 (-1 missing, columns monotone), weights [27, Cin, Cout].
    CUDA tensors launch the kernel; CPU tensors take the plain version.
    Forward only: raises when autograd would need a gradient from it."""
    kernels.refuse_grad("slab_gather_conv", feats, weights)
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
    _launch(feats, rulebook, weights, _scratch(weights), out)
    slab_gather_conv.launches += 1
    return out


slab_gather_conv.launches = 0
