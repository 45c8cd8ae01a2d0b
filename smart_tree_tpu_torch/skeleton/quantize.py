"""Medial-point voxel reduction (counterpart of
`smart_tree_tpu/skeleton/quantize.py`): collapse coincident and sub-cell
medial points to one representative per grid cell before the graph is built.

Predicted medial points converge onto the branch axis, so dozens of them
share a cell; each cluster is a hub vertex of the KNN graph and pads KNN
lists with zero-length edges. Points sharing a cell at the pipeline's own
resolution are interchangeable at every later stage. The representative is
the cell's (lowest surface y, then lowest index) point, which keeps the
lowest-y root convention per cell.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _cell_codes(medial_pts, y, keep, cell: float):
    """Sort order by (kept first, cell x, cell y, cell z, y, index) and the
    head-of-cell mask in sorted space. torch has no lexsort: stable sorts
    are chained from the least significant key (the index is the starting
    order)."""
    q = torch.floor(medial_pts / torch.tensor(cell, dtype=torch.float32)).to(torch.int32)
    order = torch.sort(y, stable=True).indices
    for key in (q[:, 2], q[:, 1], q[:, 0], (~keep).to(torch.uint8)):
        order = order[torch.sort(key[order], stable=True).indices]
    qs = q[order]
    head = torch.ones(order.shape[0], dtype=torch.bool, device=order.device)
    head[1:] = (qs[1:] != qs[:-1]).any(dim=1)
    return order, head & keep[order]


@torch.no_grad()
def medial_reduce(medial_pts, surface_y, keep, cell: float) -> Tuple[torch.Tensor, int]:
    """One representative per `cell`-sized voxel among the kept points.
    Returns (rep_idx [n_unique] int64, indices into the original arrays in
    cell order; n_unique). Unlike the JAX function there is no padding to a
    bucket: the same representatives in the same order, and nothing after
    them."""
    order, is_rep = _cell_codes(medial_pts, surface_y, keep, cell)
    rep_idx = order[torch.nonzero(is_rep).squeeze(1)]
    return rep_idx, int(rep_idx.shape[0])
