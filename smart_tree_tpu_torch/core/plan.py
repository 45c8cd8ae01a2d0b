"""UNet sparse plan: every rulebook for one input sparsity pattern.

Counterpart of `smart_tree_tpu/core/plan.py`: the submanifold rulebook of
each level is the full [N, 27] one (subm_mode="full", the default) or the
compact z-window one (subm_mode="z9", `SubmRB9`).

`SerialPlan` is the plan of a Point Transformer V3 (nn/ptv3.py): levels
joined by grid pooling, each with its serialized orders and patch layout
(core/serialize.py). It has the exact form only.

A plan has two forms. The static one is the JAX package's: every level a
buffer of a fixed capacity, so that `jit` compiles one program per shape;
a level whose voxels do not fit is cut, and `count` shows it. The trainer
keeps it, as the JAX trainer does. The exact one (level_capacity_factor
None) is the form the eager forward wants: each level below the first
holds exactly its voxels, after one host read of its count, so nothing is
padded and nothing can overflow. Inference plans are exact.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import torch

from ..utils.trace import span
from .coords import INVALID_KEY, key_bits, unpack_keys
from .rulebook import (SubmRB9, downsample_with_rulebook, inverse_from_strided, pooling_map,
                       subm_rulebook, subm_rulebook9)
from .serialize import ORDERS, PatchLayout, coarser_codes, encode, orders_and_inverses, \
    patch_layout
from .sparse_tensor import SparseVoxelTensor


@dataclass(frozen=True)
class LevelPlan:
    keys: torch.Tensor              # [N_l] sorted voxel keys of this level
    active: torch.Tensor            # [N_l] bool
    subm_rb: torch.Tensor | SubmRB9  # [N_l, 27] submanifold rulebook, or the z9 form
    down_rb: torch.Tensor | None    # [N_{l+1}, 27] strided gather (into next)
    up_rb: torch.Tensor | None      # [N_l, 27] inverse gather (from next)
    count: torch.Tensor             # int32 true voxel count (static form: overflow check)
    spatial_shape: Tuple[int, int, int]


@dataclass(frozen=True)
class UNetPlan:
    levels: Tuple[LevelPlan, ...]
    batch_size: int


def build_plan(
    x: SparseVoxelTensor,
    num_levels: int,
    level_capacity_factor: float | None = 1.0,
    min_capacity: int = 256,
    subm_mode: str = "full",
    level_capacities: Tuple[int, ...] | None = None,
) -> UNetPlan:
    """Rulebooks for `num_levels` UNet levels. Level 0 is `x` as given.

    Static form: each level's buffer is level_capacity_factor times the
    previous one (at least min_capacity), or level_capacities[l] when given.
    A stride-2 conv can have MORE outputs than inputs, so every LevelPlan
    carries the TRUE dedup count, which exceeds the buffer on overflow.

    Exact form (level_capacity_factor=None, no level_capacities): each level
    below the first holds exactly its voxel count, read once to the host
    (`downsample_with_rulebook`'s exact form); the rulebooks are built on
    those tables, and `count` equals each table's length. On the same `x`
    the exact plan is the valid prefix of every static plan whose levels
    did not overflow: keys, counts and rulebooks entry for entry.

    subm_mode: "full" ([N, 27] lookup rulebook) or "z9" (`SubmRB9`: 8
    searches a level, the dz neighbours read from a 3-row window; the same
    convs, see core/sparse_ops.py::_gather_conv_z). The strided and inverse
    rulebooks are the same in both."""
    if subm_mode not in ("full", "z9"):
        raise ValueError(f'subm_mode must be "full" or "z9", got {subm_mode!r}')
    levels: List[LevelPlan] = []
    keys = x.keys
    shape = x.spatial_shape
    batch = x.batch_size
    cap = x.capacity
    true_count = None
    for lvl in range(num_levels):
        active = keys != INVALID_KEY
        count = active.sum().to(torch.int32) if true_count is None else true_count
        if subm_mode == "z9":
            srb = subm_rulebook9(keys, shape, batch)
        else:
            srb = subm_rulebook(keys, shape, batch, 3)
        if lvl < num_levels - 1:
            if level_capacities is not None:
                next_cap = int(level_capacities[lvl + 1])
            elif level_capacity_factor is None:
                next_cap = None
            else:
                next_cap = max(int(cap * level_capacity_factor), min_capacity)
            out_keys, out_shape, out_count, drb = downsample_with_rulebook(
                keys, shape, batch, next_cap
            )
            urb = inverse_from_strided(drb, keys.shape[0])
            levels.append(LevelPlan(keys, active, srb, drb, urb, count, shape))
            keys, shape, cap = out_keys, out_shape, out_keys.shape[0]
            true_count = out_count
        else:
            levels.append(LevelPlan(keys, active, srb, None, None, count, shape))
    return UNetPlan(levels=tuple(levels), batch_size=batch)


@dataclass(frozen=True)
class SerialLevelPlan:
    keys: torch.Tensor              # [N_l] sorted voxel keys of this level
    active: torch.Tensor            # [N_l] bool (every row: the plan is exact)
    subm_rb: torch.Tensor           # [N_l, 27] submanifold rulebook (the CPE convs)
    stem_rb: torch.Tensor | None    # [N_0, K^3] the stem's rulebook (level 0 only)
    gather: torch.Tensor            # [O, slots] row read by each patch slot, per order
    scatter: torch.Tensor           # [O, N_l] slot of each row's output, per order
    layout: PatchLayout
    parent: torch.Tensor | None     # [N_l] row of each voxel's parent in the next level
    spatial_shape: Tuple[int, int, int]


@dataclass(frozen=True)
class SerialPlan:
    levels: Tuple[SerialLevelPlan, ...]
    batch_size: int
    counters: dict = field(default_factory=dict)   # what a forward over it counts


def build_serial_plan(
    x: SparseVoxelTensor,
    num_levels: int,
    patch: int,
    stem_kernel: int = 5,
    orders: Tuple[str, ...] = ORDERS,
    stats: dict | None = None,
) -> SerialPlan:
    """The exact plan of `x` (every row a voxel) for `num_levels` levels
    joined by grid pooling (`pooling_map`). Each level's item offsets are
    read to the host once (its count and the patch layout follow from
    them). The codes are made at level 0, at the bits of the grid's edge,
    and shifted down three bits a level (`coarser_codes`); the orders,
    their inverses and the patch indices are the `infer.serialize` span."""
    keys, shape, batch = x.keys, tuple(x.spatial_shape), x.batch_size
    depth = max(key_bits(shape, batch)[1:])
    if depth < num_levels:
        raise ValueError(f"a grid of {shape} has no {num_levels} pooling levels")
    codes = first = None
    levels: List[SerialLevelPlan] = []
    for lvl in range(num_levels):
        with span(stats, "infer.serialize", "infer.serialize_s"):
            _, bx, by, bz = key_bits(shape, batch)
            bounds = torch.tensor([b << (bx + by + bz) for b in range(batch)] + [INVALID_KEY])
            offsets = torch.searchsorted(keys, bounds.to(keys.device, non_blocking=True))
            off = offsets.tolist()      # the level's one host read
            counts = [b - a for a, b in zip(off[:-1], off[1:])]
            n = off[-1]
            if lvl == 0 and n != keys.shape[0]:
                raise ValueError("a serialized plan takes every row as a voxel")
            keys = keys[:n]
            if lvl == 0:
                coords = unpack_keys(keys, shape, batch)
                codes = encode(coords[:, 1:], coords[:, 0], depth, orders)
            else:
                codes = coarser_codes(codes, first[:n].long())
            order, inverse = orders_and_inverses(codes)
            layout = patch_layout(offsets, counts, patch)
            gather, scatter = order[:, layout.gather], layout.unpad[inverse]
        subm = subm_rulebook(keys, shape, batch, 3)
        stem = subm_rulebook(keys, shape, batch, stem_kernel) if lvl == 0 else None
        parent = None
        if lvl < num_levels - 1:
            pkeys, first, inv, pshape = pooling_map(keys, shape, batch)
            parent = inv.long()
        levels.append(SerialLevelPlan(keys, torch.ones_like(keys, dtype=torch.bool), subm, stem,
                                      gather, scatter, layout, parent, shape))
        if parent is not None:
            keys, shape = pkeys, pshape
    return SerialPlan(levels=tuple(levels), batch_size=batch)
