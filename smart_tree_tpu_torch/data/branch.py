"""BranchSkeleton: one branch of a skeleton as numpy arrays on the host
(counterpart of `smart_tree_tpu/data/branch.py`)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .tube import Tube


@dataclass
class BranchSkeleton:
    _id: int
    parent_id: int
    xyz: np.ndarray   # [N,3]
    radii: np.ndarray  # [N,1]
    child_id: Optional[int] = None

    def __post_init__(self):
        # runtime shape contract: xyz [N,3], radii [N,1] (or [N])
        xyz = np.asarray(self.xyz, np.float32)
        if xyz.ndim != 2 or xyz.shape[1] != 3:
            raise TypeError(f"BranchSkeleton.xyz must be [N,3], got {xyz.shape}")
        radii = np.asarray(self.radii, np.float32)
        if radii.ndim == 1:
            radii = radii[:, None]
        if radii.ndim != 2 or radii.shape[1] != 1 or radii.shape[0] != xyz.shape[0]:
            raise TypeError(
                f"BranchSkeleton.radii must be [N,1] matching xyz, got {radii.shape}"
            )
        self.xyz = xyz
        self.radii = radii

    def __len__(self):
        return self.xyz.shape[0]

    def to_tubes(self) -> List[Tube]:
        return [
            Tube(a, b, float(r1), float(r2))
            for a, b, r1, r2 in zip(
                self.xyz[:-1], self.xyz[1:], self.radii[:-1, 0], self.radii[1:, 0]
            )
        ]

    def filter(self, mask) -> "BranchSkeleton":
        return BranchSkeleton(
            self._id, self.parent_id, self.xyz[mask], self.radii[mask], self.child_id
        )

    @property
    def length(self) -> float:
        return float(np.linalg.norm(self.xyz[1:] - self.xyz[:-1], axis=1).sum())

    @property
    def initial_radius(self) -> float:
        # max of first and last radius
        return float(max(self.radii[0, 0], self.radii[-1, 0]))

    @property
    def biggest_radius(self) -> float:
        return float(self.radii.max())
