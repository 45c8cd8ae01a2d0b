"""SparseVoxelTensor: counterpart of `smart_tree_tpu/core/sparse_tensor.py`.

Rows are padded to a fixed capacity. Keys are sorted packed int64 keys
(core/coords.py) with features permuted into key order; `active` marks live
rows, padding rows hold INVALID_KEY and zero features.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Sequence, Tuple

import torch

from .coords import INVALID_KEY, pack_coords, sort_keys, unpack_keys


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

    @property
    def num_features(self) -> int:
        return self.feats.shape[1]

    def coords(self) -> torch.Tensor:
        """int32 [N, 4] (b, x, y, z); padding rows are meaningless, mask by
        active."""
        return unpack_keys(self.keys, self.spatial_shape, self.batch_size)

    def n_active(self) -> torch.Tensor:
        return self.active.sum().to(torch.int32)

    def replace_feats(self, feats: torch.Tensor) -> "SparseVoxelTensor":
        return replace(self, feats=feats)

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
