"""Medial-point outlier removal (counterpart of
`smart_tree_tpu/skeleton/filter.py`): keep a point iff all of its
`nb_points` nearest neighbours (itself included) lie within its predicted
radius.

"All K nearest within r_i" is "at least K points within r_i", a counting
query with no selection: the count visits only the cells around each point
and stops at K (`neighbors.grid_count.grid_radius_count`, a CUDA kernel on
the card), with a margin relative to r_i^2, and only the thin shell of points
whose decision straddles the margin is resolved with the exact KNN, as the
JAX package resolves its own, wider shell. The keep mask is the JAX
package's.
"""

from __future__ import annotations

import torch

from ..neighbors.grid_count import grid_radius_count
from ..neighbors.knn import knn


def _exact_keep(points, radii, queries, qradii, nb_points: int, valid):
    r_max = torch.where(valid, radii, 0.0).max()
    dists, idxs = knn(queries, points, nb_points, r_max, dst_valid=valid)
    ok = (dists < qradii[:, None]) & (idxs != -1)
    return ok.sum(dim=1) == nb_points


@torch.no_grad()
def outlier_removal(points, radii, nb_points: int = 8, valid=None,
                    min_radius: float | None = None) -> torch.Tensor:
    """Keep mask [N] bool. `min_radius` (default off) clamps the acceptance
    radius from below: without it, branches thinner than about two voxels
    never survive, because after one-voxel dedup their medial points are
    spaced wider than their own radius."""
    points = torch.as_tensor(points, dtype=torch.float32)
    radii = torch.as_tensor(radii, dtype=torch.float32, device=points.device).reshape(-1)
    if min_radius is not None:
        radii = radii.clamp_min(min_radius)
    if valid is None:
        valid = torch.ones(points.shape[0], dtype=torch.bool, device=points.device)
    if points.shape[0] == 0:
        return valid

    certain, possible = grid_radius_count(
        points, points, radii, src_valid=valid, dst_valid=valid, cap=nb_points
    )
    sure = certain >= nb_points
    keep = sure & valid
    # rows the margin cannot decide, in index order (one host sync)
    shell = torch.nonzero((possible >= nb_points) & ~sure & valid).squeeze(1)
    if shell.numel():
        keep[shell] = _exact_keep(points, radii, points[shell], radii[shell], nb_points, valid)
    return keep
