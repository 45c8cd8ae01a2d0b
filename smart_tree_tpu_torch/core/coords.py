"""Packed coordinate keys for sparse voxel tensors.

Counterpart of `smart_tree_tpu/core/coords.py`. A sparse tensor keeps a
sorted array of packed (batch, x, y, z) keys; neighbour lookups are
vectorised binary searches into it.

The JAX package holds keys as uint32. PyTorch has no general uint32 sort, so
the port holds the SAME key values in int64: every valid key is below 2**32
and `INVALID_KEY` (0xFFFFFFFF) still sorts after every valid key. Sorts are
stable, so the sort permutation equals the JAX one entry for entry.

`pack_coords_np` is the host twin: numpy uint32 keys bit-equal to the JAX
package's and to this module's int64 keys, so the host can sort an upload
in the device's order and rebuild that order after a download.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

INVALID_KEY = 0xFFFFFFFF


def _bits_for(n: int) -> int:
    """Number of bits needed to represent values in [0, n)."""
    if n <= 1:
        return 1
    return int(n - 1).bit_length()


def key_bits(spatial_shape: Sequence[int], batch_size: int) -> Tuple[int, int, int, int]:
    """Per-field bit widths (b, x, y, z) of a packed key; raises if the grid
    does not fit in 32 bits."""
    bb = _bits_for(batch_size)
    bx, by, bz = (_bits_for(int(s)) for s in spatial_shape)
    total = bb + bx + by + bz
    if total > 32:
        raise ValueError(
            f"spatial shape {tuple(spatial_shape)} x batch {batch_size} needs "
            f"{total} key bits > 32; use smaller blocks or coarser voxels"
        )
    return bb, bx, by, bz


def pack_coords(
    coords: torch.Tensor,
    spatial_shape: Sequence[int],
    batch_size: int,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Pack integer coords [N,4] (b,x,y,z) into sortable int64 keys [N].

    Out-of-range or invalid rows map to INVALID_KEY."""
    _, bx, by, bz = key_bits(spatial_shape, batch_size)
    c = coords.to(torch.int64)
    in_range = (
        (c[:, 0] >= 0)
        & (c[:, 0] < batch_size)
        & (c[:, 1] >= 0)
        & (c[:, 1] < spatial_shape[0])
        & (c[:, 2] >= 0)
        & (c[:, 2] < spatial_shape[1])
        & (c[:, 3] >= 0)
        & (c[:, 3] < spatial_shape[2])
    )
    if valid is not None:
        in_range = in_range & valid
    key = (
        (c[:, 0] << (bx + by + bz))
        | (c[:, 1] << (by + bz))
        | (c[:, 2] << bz)
        | c[:, 3]
    )
    return torch.where(in_range, key, torch.full_like(key, INVALID_KEY))


def unpack_keys(
    keys: torch.Tensor, spatial_shape: Sequence[int], batch_size: int
) -> torch.Tensor:
    """Inverse of pack_coords -> int32 coords [N,4]. INVALID rows unpack to
    the same (meaningless) values as in the JAX package."""
    _, bx, by, bz = key_bits(spatial_shape, batch_size)
    z = keys & ((1 << bz) - 1)
    y = (keys >> bz) & ((1 << by) - 1)
    x = (keys >> (bz + by)) & ((1 << bx) - 1)
    b = keys >> (bz + by + bx)
    return torch.stack([b, x, y, z], dim=1).to(torch.int32)


def sort_keys(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable ascending sort; returns (sorted_keys, order)."""
    skeys, order = torch.sort(keys, stable=True)
    return skeys, order


def lookup(sorted_keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Row of each query key in a sorted key table, int32 with -1 where the
    key is absent (INVALID queries never match)."""
    pos = torch.searchsorted(sorted_keys, queries, side="left")
    pos_c = pos.clamp(0, sorted_keys.shape[0] - 1)
    hit = (sorted_keys[pos_c] == queries) & (queries != INVALID_KEY)
    return torch.where(hit, pos_c, -1).to(torch.int32)


def unique_keys(
    keys: torch.Tensor, capacity: int | None = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Deduplicate keys (np.unique semantics: ascending unique keys,
    first_idx at the lowest original row) into `capacity` output rows.

    Returns (ukeys [capacity] INVALID-padded, first_idx [capacity] (N where
    padded), inverse [N] (-1 for invalid rows), count (may exceed capacity
    on overflow)). With a capacity (the JAX package's static form) nothing
    is read back to the host. `capacity=None` is the exact form: one host
    read of the count, which then is the capacity, so every output row
    holds a unique key and nothing can overflow."""
    n = keys.shape[0]
    dev = keys.device
    skeys, order = sort_keys(keys)
    is_valid = skeys != INVALID_KEY
    newgrp = torch.ones_like(is_valid)
    newgrp[1:] = skeys[1:] != skeys[:-1]
    newgrp &= is_valid
    count = newgrp.sum().to(torch.int32)
    if capacity is None:
        capacity = int(count)  # the exact form's one host read
    gid_sorted = torch.cumsum(newgrp.to(torch.int32), 0) - 1
    rows = torch.arange(n, device=dev)
    # group leaders compacted to the static capacity (jnp.nonzero with
    # size=capacity, fill_value=n); slot `capacity` catches the overflow
    lead_pos = torch.full((capacity + 1,), n, dtype=torch.int64, device=dev)
    slot = torch.where(newgrp & (gid_sorted < capacity), gid_sorted, capacity)
    lead_pos[slot.long()] = rows
    lead_pos = lead_pos[:capacity]
    pad = lead_pos >= n
    ukeys = torch.where(
        pad,
        torch.full_like(lead_pos, INVALID_KEY),
        skeys[lead_pos.clamp(0, n - 1)],
    )
    inverse = torch.full((n,), -1, dtype=torch.int32, device=dev)
    inverse[order] = torch.where(is_valid, gid_sorted, -1).to(torch.int32)
    # first (minimum) original row per group; rows of groups past capacity
    # land on slot capacity-1, exactly as the JAX package's scatter-min does
    first_idx = torch.full((capacity,), n, dtype=torch.int64, device=dev)
    gid_safe = torch.where(
        is_valid & (gid_sorted < capacity), gid_sorted, capacity - 1
    ).long()
    first_idx = first_idx.scatter_reduce(
        0, gid_safe, torch.where(is_valid, order, n), reduce="amin"
    )
    first_idx = torch.where(pad, n, first_idx).to(torch.int32)
    return ukeys, first_idx, inverse, count


def pack_coords_np(
    coords: np.ndarray,
    spatial_shape: Sequence[int],
    batch_size: int,
    valid: np.ndarray | None = None,
) -> np.ndarray:
    """Host twin of `pack_coords`: uint32 keys [N] whose values equal the
    device's int64 keys (INVALID_KEY for out-of-range or invalid rows).

    The compact inference paths sort their upload by these keys on the host
    and rebuild the device's row order from them after the download: a
    stable argsort of equal key arrays is one permutation, so
    `np.argsort(keys, kind="stable")` is `torch.sort(keys, stable=True)`'s
    order."""
    _, bx, by, bz = key_bits(spatial_shape, batch_size)
    c = np.asarray(coords, np.int64)
    in_range = (
        (c[:, 0] >= 0)
        & (c[:, 0] < batch_size)
        & (c[:, 1] >= 0)
        & (c[:, 1] < spatial_shape[0])
        & (c[:, 2] >= 0)
        & (c[:, 2] < spatial_shape[1])
        & (c[:, 3] >= 0)
        & (c[:, 3] < spatial_shape[2])
    )
    if valid is not None:
        in_range = in_range & np.asarray(valid, bool)
    key = (
        (c[:, 0] << (bx + by + bz))
        | (c[:, 1] << (by + bz))
        | (c[:, 2] << bz)
        | c[:, 3]
    ).astype(np.uint32)
    return np.where(in_range, key, np.uint32(INVALID_KEY))


def ravel_hash_np(x: np.ndarray) -> np.ndarray:
    """Row-major hash of integer rows [N, D] after shifting each column to
    start at 0 (the reference `ravel_hash` semantics); for tests and tools."""
    if x.ndim != 2:
        raise ValueError(f"expected rows [N, D], got shape {x.shape}")
    x = x - np.min(x, axis=0)
    x = x.astype(np.uint64, copy=False)
    xmax = np.max(x, axis=0).astype(np.uint64) + 1
    h = np.zeros(x.shape[0], dtype=np.uint64)
    for k in range(x.shape[1] - 1):
        h += x[:, k]
        h *= xmax[k + 1]
    h += x[:, -1]
    return h
