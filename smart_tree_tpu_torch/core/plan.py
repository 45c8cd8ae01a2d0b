"""UNet sparse plan: every rulebook for one input sparsity pattern.

Counterpart of `smart_tree_tpu/core/plan.py`: the submanifold rulebook of
each level is the full [N, 27] one (subm_mode="full", the default) or the
compact z-window one (subm_mode="z9", `SubmRB9`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch

from .coords import INVALID_KEY
from .rulebook import (SubmRB9, downsample_with_rulebook, inverse_from_strided, subm_rulebook,
                       subm_rulebook9)
from .sparse_tensor import SparseVoxelTensor


@dataclass(frozen=True)
class LevelPlan:
    keys: torch.Tensor              # [N_l] sorted voxel keys of this level
    active: torch.Tensor            # [N_l] bool
    subm_rb: torch.Tensor | SubmRB9  # [N_l, 27] submanifold rulebook, or the z9 form
    down_rb: torch.Tensor | None    # [N_{l+1}, 27] strided gather (into next)
    up_rb: torch.Tensor | None      # [N_l, 27] inverse gather (from next)
    count: torch.Tensor             # int32 true voxel count (overflow check)
    spatial_shape: Tuple[int, int, int]


@dataclass(frozen=True)
class UNetPlan:
    levels: Tuple[LevelPlan, ...]
    batch_size: int


def build_plan(
    x: SparseVoxelTensor,
    num_levels: int,
    level_capacity_factor: float = 1.0,
    min_capacity: int = 256,
    subm_mode: str = "full",
    level_capacities: Tuple[int, ...] | None = None,
) -> UNetPlan:
    """Rulebooks for `num_levels` UNet levels.

    Each level's buffer is level_capacity_factor times the previous one
    (at least min_capacity), or level_capacities[l] when given. A stride-2
    conv can have MORE outputs than inputs, so every LevelPlan carries the
    TRUE dedup count, which exceeds the buffer on overflow and lets the
    caller retry with larger level_capacities.

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
            else:
                next_cap = max(int(cap * level_capacity_factor), min_capacity)
            out_keys, out_shape, out_count, drb = downsample_with_rulebook(
                keys, shape, batch, next_cap
            )
            urb = inverse_from_strided(drb, keys.shape[0])
            levels.append(LevelPlan(keys, active, srb, drb, urb, count, shape))
            keys, shape, cap = out_keys, out_shape, next_cap
            true_count = out_count
        else:
            levels.append(LevelPlan(keys, active, srb, None, None, count, shape))
    return UNetPlan(levels=tuple(levels), batch_size=batch)
