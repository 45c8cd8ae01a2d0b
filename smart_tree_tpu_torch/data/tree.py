"""TreeSkeleton / DisjointTreeSkeleton: host skeleton containers with the
prune / repair / smooth post-processing (counterpart of
`smart_tree_tpu/data/tree.py`).

Quirks of the original smart-tree, kept on purpose:
  - prune keeps a branch only if its parent survived (walk in insertion
    order) and drops short or thin branches
  - DisjointTreeSkeleton.prune only prunes skeletons[0]
  - smooth is a box filter over per-branch radii, only for branches longer
    than the kernel
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from ..utils.queries import pts_to_nearest_tube
from ..utils.trace import span
from .branch import BranchSkeleton
from .tube import Tube, collate_tubes


@dataclass
class TreeSkeleton:
    _id: int
    branches: Dict[int, BranchSkeleton]

    def __len__(self):
        return len(self.branches)

    def to_tubes(self) -> List[Tube]:
        return [t for b in self.branches.values() for t in b.to_tubes()]

    def repair(self) -> None:
        """Connect each branch's start to the nearest point on its parent
        branch's tubes."""
        branch_ids = [b._id for b in self.branches.values()]
        for branch in self.branches.values():
            if branch.parent_id not in branch_ids:
                continue
            # a profiler range a branch names the card's idle time here
            # (utils/trace.py)
            with span(None, "post.repair_branch"):
                parent = self.branches[branch.parent_id]
                tubes = parent.to_tubes()
                if not tubes or len(branch) == 0:
                    continue
                # one point against one branch's tubes, host arrays in and
                # out: asked of the CPU, the work is smaller than a launch
                v, idx, _ = pts_to_nearest_tube(
                    branch.xyz[0].reshape(-1, 3), collate_tubes(tubes), device="cpu"
                )
                connection_pt = branch.xyz[0].reshape(-1, 3) + v[0]
                branch.xyz = np.concatenate([connection_pt, branch.xyz])
                branch.radii = np.concatenate([branch.radii[[0]], branch.radii])

    def prune(self, min_radius: float, min_length: float, root_id=None) -> "TreeSkeleton":
        root_id = min(self.branches.keys()) if root_id is None else root_id
        keep = {root_id: self.branches[root_id]}
        remove = {}
        for branch_id, branch in self.branches.items():
            if branch.parent_id not in keep and branch._id != root_id:
                remove[branch_id] = branch
            elif branch.length < min_length:
                remove[branch_id] = branch
            elif branch.initial_radius < min_radius:
                remove[branch_id] = branch
            else:
                keep[branch_id] = branch
        self.branches = keep
        return TreeSkeleton(0, remove)

    def smooth(self, kernel_size: int = 5) -> None:
        kernel = np.ones(kernel_size) / kernel_size
        for branch in self.branches.values():
            r = branch.radii.reshape(-1)
            if r.shape[0] > kernel_size:
                # 'same' box filter with zero padding
                smoothed = np.convolve(r, kernel, mode="same")
                branch.radii = smoothed.reshape(-1, 1).astype(np.float32)

    @property
    def length(self) -> float:
        return float(sum(b.length for b in self.branches.values()))

    @property
    def key_branch_with_biggest_radius(self):
        best_key, best_r = None, 0.0
        for key, branch in self.branches.items():
            if branch.biggest_radius > best_r:
                best_r = branch.biggest_radius
                best_key = key
        return best_key

    @property
    def max_branch_id(self):
        return max(self.branches.keys())


@dataclass
class DisjointTreeSkeleton:
    skeletons: List[TreeSkeleton]

    def prune(self, min_radius: float, min_length: float) -> None:
        # only the first skeleton has a known root
        if self.skeletons:
            self.skeletons[0].prune(min_radius=min_radius, min_length=min_length)

    def repair(self) -> None:
        for s in self.skeletons:
            s.repair()

    def smooth(self, kernel_size: int = 7) -> None:
        for s in self.skeletons:
            s.smooth(kernel_size=kernel_size)

    def to_pickle(self, path) -> None:
        with open(path, "wb") as f:
            pickle.dump(self, f)

    @staticmethod
    def from_pickle(path) -> "DisjointTreeSkeleton":
        """Only for files this program wrote: unpickling runs code."""
        with open(path, "rb") as f:
            return pickle.load(f)
