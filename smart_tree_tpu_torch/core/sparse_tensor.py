"""SparseVoxelTensor: counterpart of `smart_tree_tpu/core/sparse_tensor.py`.

Rows are padded to a fixed capacity. Keys are sorted packed int64 keys
(core/coords.py) with features permuted into key order; `active` marks live
rows, padding rows hold INVALID_KEY and zero features.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from .coords import INVALID_KEY, pack_coords, sort_keys


@dataclass(frozen=True)
class SparseVoxelTensor:
    keys: torch.Tensor    # [N] int64, ascending, INVALID_KEY padding
    feats: torch.Tensor   # [N, C] (zero rows at padding)
    active: torch.Tensor  # [N] bool
    spatial_shape: Tuple[int, int, int]
    batch_size: int

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    @staticmethod
    def from_coords(
        coords: torch.Tensor,
        feats: torch.Tensor,
        spatial_shape: Sequence[int],
        batch_size: int,
        valid: torch.Tensor | None = None,
    ) -> "SparseVoxelTensor":
        """Build from unsorted unique coords [N,4] + feats [N,C]; rows out of
        range (or valid=False) become padding."""
        keys = pack_coords(coords, spatial_shape, batch_size, valid=valid)
        skeys, order = sort_keys(keys)
        active = skeys != INVALID_KEY
        f = torch.where(active[:, None], feats[order], 0)
        return SparseVoxelTensor(
            keys=skeys,
            feats=f,
            active=active,
            spatial_shape=tuple(int(s) for s in spatial_shape),
            batch_size=int(batch_size),
        )
