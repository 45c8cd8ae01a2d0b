"""Point -> voxel quantisation on the device with a static capacity.

Counterpart of `smart_tree_tpu/core/voxelize.py`: floor-quantise, pack the
(b, x, y, z) keys and deduplicate them with `coords.unique_keys`, keeping one
point per voxel. The survivor is the lowest original row (np.unique's
return_index), `inverse` is -1 where a point is invalid and `count` is the
true occupied count, which exceeds `capacity` when the output overflowed.
Static output shapes and no host synchronisation. Off the main path (the
tiler voxelises on the host, `data/dataset.py::voxelize_host`), as in the
JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from .coords import INVALID_KEY, pack_coords, unique_keys, unpack_keys


class VoxelizeResult(NamedTuple):
    coords: torch.Tensor     # [capacity, 4] int32 (b,x,y,z); padding rows = -1
    feats: torch.Tensor      # [capacity, C] features of the surviving point
    point_idx: torch.Tensor  # [capacity] int32 original point row (N at padding)
    valid: torch.Tensor      # [capacity] bool
    inverse: torch.Tensor    # [N] int32 voxel id per point (-1 where invalid)
    count: torch.Tensor      # scalar int32 number of occupied voxels


def voxelize(
    xyz: torch.Tensor,
    feats: torch.Tensor,
    voxel_size: float,
    origin: torch.Tensor,
    spatial_shape: Sequence[int],
    capacity: int,
    batch_idx: torch.Tensor | None = None,
    batch_size: int = 1,
    valid: torch.Tensor | None = None,
) -> VoxelizeResult:
    """Quantise points [N,3] to voxels of a static (X,Y,Z) grid whose (0,0,0)
    corner is `origin`, keeping one point per voxel; `feats` [N,C] are
    carried through, `batch_idx` [N] names each point's batch item."""
    n = xyz.shape[0]
    g = torch.floor((xyz - origin[None, :]) / voxel_size).to(torch.int32)
    if batch_idx is None:
        b = torch.zeros((n,), dtype=torch.int32, device=xyz.device)
    else:
        b = batch_idx.to(torch.int32)
    coords = torch.cat([b[:, None], g], dim=1)
    keys = pack_coords(coords, spatial_shape, batch_size, valid=valid)
    ukeys, first_idx, inverse, count = unique_keys(keys, capacity)

    vvalid = ukeys != INVALID_KEY
    safe_idx = first_idx.clamp(0, n - 1).long()
    out_feats = torch.where(vvalid[:, None], feats[safe_idx], 0)
    out_coords = torch.where(vvalid[:, None], unpack_keys(ukeys, spatial_shape, batch_size), -1)
    return VoxelizeResult(
        coords=out_coords,
        feats=out_feats,
        point_idx=first_idx,
        valid=vvalid,
        inverse=inverse,
        count=count,
    )


def voxel_downsample_indices(
    xyz: torch.Tensor,
    voxel_size: float,
    capacity: int,
    valid: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Indices of one representative point per voxel (the lowest original
    row) on a 1024^3 grid from the valid points' min corner.

    Returns (point_idx [capacity], valid [capacity], count, n_out_of_grid):
    points beyond the grid are clipped onto its faces and COUNTED in
    n_out_of_grid, so a caller can detect them and re-tile."""
    vmask = valid if valid is not None else torch.ones(xyz.shape[0], dtype=torch.bool,
                                                        device=xyz.device)
    inf = torch.full((), float("inf"), dtype=xyz.dtype, device=xyz.device)
    mn = torch.where(vmask[:, None], xyz, inf).amin(dim=0)
    g = torch.floor((xyz - mn[None, :]) / voxel_size).to(torch.int32)
    oob = (((g > 1023).any(dim=1) | (g < 0).any(dim=1)) & vmask).sum()
    g = g.clamp(0, 1023)
    coords = torch.cat([torch.zeros_like(g[:, :1]), g], dim=1)
    keys = pack_coords(coords, (1024, 1024, 1024), 1, valid=valid)  # 30 key bits
    ukeys, first_idx, _, count = unique_keys(keys, capacity)
    return first_idx, ukeys != INVALID_KEY, count, oob
