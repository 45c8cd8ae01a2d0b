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
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .coords import INVALID_KEY, lookup, pack_coords, unique_keys, unpack_keys


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
    out_capacity: int,
) -> Tuple[torch.Tensor, Tuple[int, int, int], torch.Tensor]:
    """Output key table of a K=3, s=2, p=1 strided conv.

    Returns (sorted out_keys [out_capacity], out_spatial_shape, count)."""
    out_keys, out_shape, count, _ = downsample_with_rulebook(
        keys, spatial_shape, batch_size, out_capacity
    )
    return out_keys, out_shape, count


def downsample_with_rulebook(
    keys: torch.Tensor,
    spatial_shape: Sequence[int],
    batch_size: int,
    out_capacity: int,
) -> Tuple[torch.Tensor, Tuple[int, int, int], torch.Tensor, torch.Tensor]:
    """`downsample_coords` plus the strided gather rulebook, from one sweep
    over the 8N candidates: candidate (input i, corner) targets output row
    inverse[candidate] at kernel column k = c - (2o - 1). (o, k) pairs are
    unique, so the scatter is collision-free.

    Returns (sorted out_keys, out_spatial_shape, count, drb [out_capacity, 27])."""
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
    irows = torch.arange(n, dtype=torch.int32, device=dev).repeat(8)
    orow = torch.where(
        cvalid & (inverse >= 0) & (inverse < out_capacity), inverse, out_capacity
    ).long()
    drb = torch.full((out_capacity + 1, 27), -1, dtype=torch.int32, device=dev)
    drb[orow, kflat.clamp(0, 26).long()] = irows
    return out_keys, out_shape, count, drb[:out_capacity]


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
