"""Rulebooks (kernel-offset gather maps) for sparse 3D convolution.

Counterpart of `smart_tree_tpu/core/rulebook.py`. A rulebook is an [N, K^3]
int32 matrix: idx[i, k] is the row of voxel i's neighbour at kernel offset k
in the input table, or -1. A conv is then a gather followed by one GEMM
(core/sparse_ops.py).

Conventions (cross-correlation, torch-compatible):
  submanifold:               in_coord = out_coord + (k_off - (K-1)//2)
  strided K=3,s=2,p=1:       in_coord = 2*out_coord - 1 + k_off
  inverse of the strided:    fine f reads coarse o where 2*o - 1 + k_off = f

Scatters into a buffer with one spare row stand in for JAX's mode="drop":
out-of-range targets route to the spare row, which is then cut off.

Besides the builders the plan uses, the module has the JAX package's
compact submanifold form (`subm_rulebook9`, `SubmRB9`) and the sorted-lookup
builders `strided_rulebook` / `inverse_rulebook` that the scatter builders
are held against.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from .coords import INVALID_KEY, key_bits, lookup, pack_coords, unique_keys, unpack_keys


def kernel_offsets(kernel_size: int) -> np.ndarray:
    """[K^3, 3] int32 offsets in spconv/torch weight order (kx major)."""
    r = np.arange(kernel_size)
    kx, ky, kz = np.meshgrid(r, r, r, indexing="ij")
    return np.stack([kx, ky, kz], axis=-1).reshape(-1, 3).astype(np.int32)


def _query_keys(
    coords: torch.Tensor,
    offsets: np.ndarray,
    spatial_shape: Sequence[int],
    batch_size: int,
    active: torch.Tensor,
) -> torch.Tensor:
    """Packed keys of coords + each offset: [N, K3] int64."""
    n, k3 = coords.shape[0], offsets.shape[0]
    c = coords[:, None, :].to(torch.int32)
    off = torch.as_tensor(offsets, dtype=torch.int32, device=coords.device)
    q = torch.cat(
        [c[..., :1].expand(n, k3, 1), c[..., 1:] + off[None, :, :]], dim=-1
    )
    keys = pack_coords(
        q.reshape(-1, 4),
        spatial_shape,
        batch_size,
        valid=active.repeat_interleave(k3),
    )
    return keys.reshape(n, k3)


def subm_rulebook(
    keys: torch.Tensor,
    spatial_shape: Sequence[int],
    batch_size: int,
    kernel_size: int = 3,
) -> torch.Tensor:
    """Submanifold rulebook [N, K^3] into the same sorted table.

    Odd kernels use the offset symmetry idx[i, k] = j <=> idx[j, K3-1-k] = i:
    only the first (K3-1)/2 columns are searched, the centre column is the
    identity and the mirror half is one scatter (unique targets)."""
    n = keys.shape[0]
    dev = keys.device
    active = keys != INVALID_KEY
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    if kernel_size == 1:
        return torch.where(active, rows, -1)[:, None]
    coords = unpack_keys(keys, spatial_shape, batch_size)
    half = (kernel_size - 1) // 2
    offs = kernel_offsets(kernel_size) - half
    if kernel_size % 2 == 0:
        q = _query_keys(coords, offs, spatial_shape, batch_size, active)
        return lookup(keys, q.reshape(-1)).reshape(q.shape)
    k3 = offs.shape[0]
    c = (k3 - 1) // 2
    q = _query_keys(coords, offs[:c], spatial_shape, batch_size, active)
    idx_half = lookup(keys, q.reshape(-1)).reshape(n, c)
    rb = torch.full((n + 1, k3), -1, dtype=torch.int32, device=dev)
    rb[:n, :c] = idx_half
    rb[:n, c] = torch.where(active, rows, -1)
    jrow = torch.where(idx_half >= 0, idx_half, n).long()
    cols = torch.arange(k3 - 1, c, -1, device=dev)[None, :].expand(n, c)
    rb[jrow, cols] = rows[:, None].expand(n, c)
    return rb[:n]


def xy_offsets() -> np.ndarray:
    """[9, 3] int32 (dx, dy, 0) offsets, kx-major (the first two axes of
    kernel_offsets(3) order)."""
    r = np.arange(-1, 2)
    dx, dy = np.meshgrid(r, r, indexing="ij")
    return np.stack([dx, dy, np.zeros_like(dx)], axis=-1).reshape(-1, 3).astype(np.int32)


@dataclass(frozen=True)
class SubmRB9:
    """Compact submanifold rulebook: per voxel and (dx, dy) offset, the
    sorted-table insertion position of the (dx, dy, 0) query key. The dz
    neighbours lie in the 3-row window around it (see subm_rulebook9)."""

    keys: torch.Tensor  # [N] the level's sorted voxel keys (int64)
    pos: torch.Tensor   # [N, 9] int32 insertion positions
    qkey: torch.Tensor  # [N, 9] int64 query keys (uint32 values; INVALID_KEY out of range)
    zbits: int
    zmax: int


def subm_rulebook9(
    keys: torch.Tensor, spatial_shape: Sequence[int], batch_size: int
) -> SubmRB9:
    """Compact submanifold rulebook from the z-contiguity of sorted keys.

    Keys order z fastest, so for a query (x+dx, y+dy, z) with key q the rows
    holding q-1, q and q+1 (all three dz neighbours) lie in [pos-1, pos+1],
    pos = searchsorted(keys, q): 8 searches for the 8 off-centre (dx, dy)
    columns; the (0, 0) column is the row's own index (keys are unique)."""
    coords = unpack_keys(keys, spatial_shape, batch_size)
    active = keys != INVALID_KEY
    offs = xy_offsets()
    q = _query_keys(coords, offs, spatial_shape, batch_size, active)  # [N, 9]
    cols = []
    for k in range(9):
        if offs[k, 0] == 0 and offs[k, 1] == 0:
            cols.append(torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device))
        else:
            cols.append(torch.searchsorted(keys, q[:, k].contiguous(), side="left")
                        .to(torch.int32))
    _, _, _, bz = key_bits(spatial_shape, batch_size)
    return SubmRB9(keys=keys, pos=torch.stack(cols, dim=1), qkey=q, zbits=int(bz),
                   zmax=int(spatial_shape[2]))


def _corner_candidates(coords: torch.Tensor, active: torch.Tensor):
    """The 8 coarse-cell candidates of every fine voxel for a K=3, s=2, p=1
    strided conv: per axis o in {(c-1)//2, (c+1)//2}, kept where
    2o-1 <= c <= 2o+1. Yields (cand [N,4], ok [N], kernel column [N])."""
    c = coords[:, 1:]
    lo = torch.div(c - 1, 2, rounding_mode="floor")
    hi = torch.div(c + 1, 2, rounding_mode="floor")
    for mx in (0, 1):
        for my in (0, 1):
            for mz in (0, 1):
                o = torch.stack(
                    [
                        (hi if mx else lo)[:, 0],
                        (hi if my else lo)[:, 1],
                        (hi if mz else lo)[:, 2],
                    ],
                    dim=1,
                )
                ok = ((2 * o - 1 <= c) & (c <= 2 * o + 1)).all(dim=1) & active
                koff = c - (2 * o - 1)
                kcol = koff[:, 0] * 9 + koff[:, 1] * 3 + koff[:, 2]
                yield torch.cat([coords[:, :1], o], dim=1), ok, kcol


def _downsample_shape(spatial_shape: Sequence[int]) -> Tuple[int, int, int]:
    return tuple((int(s) + 2 - 3) // 2 + 1 for s in spatial_shape)


def downsample_coords(
    keys: torch.Tensor,
    spatial_shape: Sequence[int],
    batch_size: int,
    out_capacity: int | None,
) -> Tuple[torch.Tensor, Tuple[int, int, int], torch.Tensor]:
    """Output key table of a K=3, s=2, p=1 strided conv.

    Returns (sorted out_keys [out_capacity], out_spatial_shape, count);
    out_capacity None: exactly `count` rows (`unique_keys`' exact form)."""
    out_keys, out_shape, count, _ = downsample_with_rulebook(
        keys, spatial_shape, batch_size, out_capacity
    )
    return out_keys, out_shape, count


def downsample_with_rulebook(
    keys: torch.Tensor,
    spatial_shape: Sequence[int],
    batch_size: int,
    out_capacity: int | None,
) -> Tuple[torch.Tensor, Tuple[int, int, int], torch.Tensor, torch.Tensor]:
    """`downsample_coords` plus the strided gather rulebook, from one sweep
    over the 8N candidates: candidate (input i, corner) targets output row
    inverse[candidate] at kernel column k = c - (2o - 1). (o, k) pairs are
    unique, so the scatter is collision-free.

    Returns (sorted out_keys, out_spatial_shape, count, drb [out_capacity, 27]).
    out_capacity None is the exact form: one host read of the count, and
    the key table and the rulebook hold exactly `count` rows."""
    out_shape = _downsample_shape(spatial_shape)
    coords = unpack_keys(keys, spatial_shape, batch_size)
    active = keys != INVALID_KEY
    n = keys.shape[0]
    dev = keys.device
    cand, cvalid, kflat = (
        torch.cat(parts) for parts in zip(*_corner_candidates(coords, active))
    )
    ckeys = pack_coords(cand, out_shape, batch_size, valid=cvalid)
    out_keys, _, inverse, count = unique_keys(ckeys, out_capacity)
    out_capacity = out_keys.shape[0]
    irows = torch.arange(n, dtype=torch.int32, device=dev).repeat(8)
    orow = torch.where(
        cvalid & (inverse >= 0) & (inverse < out_capacity), inverse, out_capacity
    ).long()
    drb = torch.full((out_capacity + 1, 27), -1, dtype=torch.int32, device=dev)
    drb[orow, kflat.clamp(0, 26).long()] = irows
    return out_keys, out_shape, count, drb[:out_capacity]


def pooling_map(
    keys: torch.Tensor, spatial_shape: Sequence[int], batch_size: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Tuple[int, int, int]]:
    """The grid pooling of Point Transformer V3 (stride 2): each voxel's
    parent is the cell at coords >> 1 of the same batch item. Unlike
    `downsample_with_rulebook` (a 3^3 conv of stride 2, whose outputs reach
    up to 8 parents a voxel) every voxel has exactly one parent.

    Returns (parent keys [N] sorted, INVALID_KEY past the parents' count;
    the lowest child row of each parent [N] (N past the count); the parent
    row of each voxel [N] int32 (-1 for an invalid key); the parents'
    spatial shape). Nothing is read to the host: the parents are at most N
    (`unique_keys`' static form at capacity N), and the caller takes the
    count."""
    coords = unpack_keys(keys, spatial_shape, batch_size)
    out_shape = tuple((int(s) - 1) // 2 + 1 for s in spatial_shape)
    parents = torch.cat([coords[:, :1], coords[:, 1:] >> 1], dim=1)
    pkeys = pack_coords(parents, out_shape, batch_size, valid=keys != INVALID_KEY)
    out_keys, first, inverse, _ = unique_keys(pkeys, keys.shape[0])
    return out_keys, first, inverse, out_shape


def inverse_from_strided(drb: torch.Tensor, fine_capacity: int) -> torch.Tensor:
    """Inverse-conv rulebook [fine_capacity, 27] as the transpose of the
    strided one: drb[o, k] = f <=> urb[f, k] = o."""
    m, k3 = drb.shape
    dev = drb.device
    frow = torch.where(drb >= 0, drb, fine_capacity).long()
    orows = torch.arange(m, dtype=torch.int32, device=dev)[:, None].expand(m, k3)
    cols = torch.arange(k3, device=dev)[None, :].expand(m, k3)
    urb = torch.full((fine_capacity + 1, k3), -1, dtype=torch.int32, device=dev)
    urb[frow, cols] = orows
    return urb[:fine_capacity]


def strided_rulebook(
    in_keys: torch.Tensor,
    out_keys: torch.Tensor,
    in_spatial_shape: Sequence[int],
    out_spatial_shape: Sequence[int],
    batch_size: int,
) -> torch.Tensor:
    """Strided gather rulebook [N_out, 27] by sorted lookup: per output voxel
    o and offset k, the input row at 2*o - 1 + k (or -1). The lookup form of
    `downsample_with_rulebook`'s scatter."""
    out_coords = unpack_keys(out_keys, out_spatial_shape, batch_size)
    base = torch.cat([out_coords[:, :1], 2 * out_coords[:, 1:] - 1], dim=1)
    q = _query_keys(base, kernel_offsets(3), in_spatial_shape, batch_size,
                    out_keys != INVALID_KEY)
    return lookup(in_keys, q.reshape(-1)).reshape(q.shape)


def inverse_rulebook(
    fine_keys: torch.Tensor,
    coarse_keys: torch.Tensor,
    fine_spatial_shape: Sequence[int],
    coarse_spatial_shape: Sequence[int],
    batch_size: int,
) -> torch.Tensor:
    """Inverse-conv gather rulebook [N_fine, 27] by sorted lookup: per fine
    voxel f and offset k, the coarse row o with 2*o - 1 + k = f, that is
    o = (f + 1 - k) / 2 where the division is exact; -1 otherwise. The lookup
    form of `inverse_from_strided`'s transpose."""
    fine_coords = unpack_keys(fine_keys, fine_spatial_shape, batch_size)
    offs = torch.as_tensor(kernel_offsets(3), device=fine_keys.device)
    n, k3 = fine_keys.shape[0], offs.shape[0]
    num = fine_coords[:, None, 1:] + 1 - offs[None]  # [N, 27, 3]
    exact = (torch.remainder(num, 2) == 0).all(dim=-1)
    o = torch.div(num, 2, rounding_mode="floor")
    q = torch.cat([fine_coords[:, None, :1].expand(n, k3, 1), o], dim=-1).reshape(-1, 4)
    keys = pack_coords(q, coarse_spatial_shape, batch_size,
                       valid=(exact & (fine_keys != INVALID_KEY)[:, None]).reshape(-1))
    return lookup(coarse_keys, keys).reshape(n, k3)
