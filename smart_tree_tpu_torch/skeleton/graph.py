"""Neighbourhood graph over medial points (counterpart of
`smart_tree_tpu/skeleton/graph.py`): K nearest neighbours, invalidated where
the distance exceeds the *source* point's radius.

`drop_vertex_zero=True` replicates the original smart-tree's `idxs > 0`
edge mask, which drops vertex 0 as a target; the default keeps `>= 0`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..neighbors.grid import grid_knn
from ..neighbors.knn import knn


class EdgeList(NamedTuple):
    edges: torch.Tensor    # [N*K, 2] int64 (src, dst; dst -1 where missing)
    weights: torch.Tensor  # [N*K] float32 distances, inf where invalid
    valid: torch.Tensor    # [N*K] bool


GRID_KNN_THRESHOLD = 400_000  # brute force is O(N^2); the grid KNN wins past this


@torch.no_grad()
def nn_graph(points, radii, k: int = 16, valid=None,
             drop_vertex_zero: bool = False) -> EdgeList:
    """points [N,3] medial points; radii [N] connection radii (already
    clamped by min_connection_length upstream)."""
    n = points.shape[0]
    r_max = (torch.where(valid, radii, 0.0) if valid is not None else radii).max()
    if n > GRID_KNN_THRESHOLD:
        dists, idxs = grid_knn(points, points, k, float(r_max), src_valid=valid,
                               dst_valid=valid)
    else:
        dists, idxs = knn(points, points, k, r_max, src_valid=valid, dst_valid=valid)
    # per-source radius gate
    idxs = torch.where(dists <= radii[:, None], idxs, -1)
    src = torch.arange(n, dtype=torch.int64, device=points.device)[:, None].expand(n, k)
    edges = torch.stack([src.reshape(-1), idxs.reshape(-1)], dim=1)
    weights = dists.reshape(-1)
    evalid = edges[:, 1] > 0 if drop_vertex_zero else edges[:, 1] >= 0
    if valid is not None:
        evalid = evalid & valid[edges[:, 0]]
    weights = torch.where(evalid, weights, float("inf"))
    return EdgeList(edges=edges, weights=weights, valid=evalid)
